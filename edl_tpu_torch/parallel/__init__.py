"""Parallel layers of the port: a mesh of ranks with named axes over
``torch.distributed`` (`mesh`), batch placement over it (`sharding`), the
data-plane collectives and their byte accounting (`collective`), and
row-sharded embedding tables with both lookups across shards
(`embedding`). Attention over the sequence axis (`ring_attention`) runs
on one shard; the ring, tensor and pipeline parallelism wait for later
slices (ROADMAP queue A item 5).
"""
