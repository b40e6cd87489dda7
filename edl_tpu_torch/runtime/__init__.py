"""Trainer runtime of the port: the train step on one device or over a
mesh of ranks (data parallelism, ZeRO-1, both grad_sync modes), its
options (wire transport with a codec agreed across ranks, gradient
accumulation, pipelined placement), the lease-driven data path, process
group bring-up from the coordinator, checkpoints and the serving export.

Elasticity (rescale, the checkpoint plane) waits for a later slice (see
ROADMAP.md).
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
from edl_tpu_torch.runtime.wire import (KVCodecChannel, WireCodec, WireOverflowError,
                                        WireRestartRequired)

__all__ = ["Checkpointer", "DevicePrefetcher", "FileShardSource", "InferenceModel",
           "KVCodecChannel", "LeaseReader", "PeriodicExporter", "SyntheticShardSource", "Trainer",
           "TrainerConfig", "TrainState", "WireCodec", "WireOverflowError",
           "WireRestartRequired",
           "artifact_version", "load_inference_model", "prefetch_iter",
           "read_artifact", "resolve_artifact_dir", "save_inference_model",
           "shard_names", "write_shard"]
