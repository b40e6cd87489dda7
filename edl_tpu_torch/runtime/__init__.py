"""Trainer runtime of the port: the single-device train step for now.

Data leases, checkpoints, elasticity and data parallelism wait for later
slices (see ROADMAP.md).
"""

from edl_tpu_torch.runtime.train_loop import Trainer, TrainerConfig, TrainState

__all__ = ["Trainer", "TrainerConfig", "TrainState"]
