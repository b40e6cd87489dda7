"""Parallel layers of the port: a mesh of ranks with named axes over
``torch.distributed`` (`mesh`), batch placement over it (`sharding`), the
data-plane and in-model collectives and their byte accounting
(`collective`), row-sharded embedding tables with both lookups across
shards (`embedding`), ring attention over the sequence axis
(`ring_attention`) and the GPipe, 1F1B and interleaved 1F1B schedules over
the pipe axis (`pipeline`).
"""
