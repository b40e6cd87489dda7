"""Parallel layers of the port. For now: attention over the sequence axis on
one shard (`ring_attention`); the ring across shards waits for a later slice.
"""
