"""Trainer runtime of the port: the single-device train step with its
one-device options (wire transport, gradient accumulation, pipelined
placement), the lease-driven data path, checkpoints and the serving export.

Elasticity and data parallelism wait for later slices (see ROADMAP.md).
"""

from edl_tpu_torch.runtime.checkpoint import Checkpointer
from edl_tpu_torch.runtime.data import (FileShardSource, LeaseReader,
                                        SyntheticShardSource, prefetch_iter,
                                        shard_names, write_shard)
from edl_tpu_torch.runtime.export import (InferenceModel, PeriodicExporter,
                                          artifact_version, load_inference_model,
                                          read_artifact, resolve_artifact_dir,
                                          save_inference_model)
from edl_tpu_torch.runtime.pipeline import DevicePrefetcher
from edl_tpu_torch.runtime.train_loop import Trainer, TrainerConfig, TrainState
from edl_tpu_torch.runtime.wire import WireCodec, WireOverflowError

__all__ = ["Checkpointer", "DevicePrefetcher", "FileShardSource", "InferenceModel",
           "LeaseReader", "PeriodicExporter", "SyntheticShardSource", "Trainer",
           "TrainerConfig", "TrainState", "WireCodec", "WireOverflowError",
           "artifact_version", "load_inference_model", "prefetch_iter",
           "read_artifact", "resolve_artifact_dir", "save_inference_model",
           "shard_names", "write_shard"]
