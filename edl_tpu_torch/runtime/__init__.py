"""Trainer runtime of the port: the single-device train step and the
serving export.

Data leases, checkpoints, elasticity and data parallelism wait for later
slices (see ROADMAP.md).
"""

from edl_tpu_torch.runtime.export import (InferenceModel, PeriodicExporter,
                                          artifact_version, load_inference_model,
                                          read_artifact, resolve_artifact_dir,
                                          save_inference_model)
from edl_tpu_torch.runtime.train_loop import Trainer, TrainerConfig, TrainState

__all__ = ["InferenceModel", "PeriodicExporter", "Trainer", "TrainerConfig",
           "TrainState", "artifact_version", "load_inference_model",
           "read_artifact", "resolve_artifact_dir", "save_inference_model"]
