"""Parallel layers of the port: a mesh of ranks with named axes over
``torch.distributed`` (`mesh`), batch placement over it (`sharding`), the
data-plane and in-model collectives and their byte accounting
(`collective`), row-sharded embedding tables with both lookups across
shards (`embedding`), ring attention over the sequence axis
(`ring_attention`), the GPipe, 1F1B and interleaved 1F1B schedules over
the pipe axis (`pipeline`) and the layout planner the elastic workers
consult at every rescale (`planner`), whose names this package exports as
the JAX package's does.
"""

from edl_tpu_torch.parallel.planner import (
    ModelProfile, Plan, Topology, data_only_plan, plan_layout,
)

__all__ = ["ModelProfile", "Plan", "Topology", "data_only_plan", "plan_layout"]
