"""Parallel layers of the port. For now, on one shard: attention over the
sequence axis (`ring_attention`) and row-sharded embedding tables
(`embedding`); the ring and the lookups across shards wait for later slices.
"""
