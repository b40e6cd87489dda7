"""Trainer runtime of the port: the train step on one device or over a
mesh of ranks (data parallelism, ZeRO-1, both grad_sync modes), its
options (wire transport with a codec agreed across ranks, gradient
accumulation, pipelined placement), the lease-driven data path, process
group bring-up from the coordinator, checkpoints, the serving export, and
elasticity: `ElasticWorker` (one process, checkpoint-restore rescale) and
`MultiHostWorker` (one rank a card, lockstep rounds, the exit-75 relaunch),
with the fault-tolerance policy and the straggler detector.
"""

from edl_tpu_torch.runtime.checkpoint import Checkpointer
from edl_tpu_torch.runtime.data import (FileShardSource, LeaseReader,
                                        SyntheticShardSource, pass_tasks, prefetch_iter,
                                        shard_names, write_shard)
from edl_tpu_torch.runtime.elastic import ElasticConfig, ElasticWorker, RescaleEvent
from edl_tpu_torch.runtime.export import (InferenceModel, PeriodicExporter,
                                          artifact_version, load_inference_model,
                                          read_artifact, resolve_artifact_dir,
                                          save_inference_model)
from edl_tpu_torch.runtime.ft_policy import FTPolicy, FTPolicyConfig
from edl_tpu_torch.runtime.multihost import MultiHostWorker
from edl_tpu_torch.runtime.pipeline import DevicePrefetcher
from edl_tpu_torch.runtime.straggler import StragglerConfig, StragglerDetector
from edl_tpu_torch.runtime.train_loop import Trainer, TrainerConfig, TrainState
from edl_tpu_torch.runtime.wire import (KVCodecChannel, WireCodec, WireOverflowError,
                                        WireRestartRequired)

__all__ = ["Checkpointer", "DevicePrefetcher", "ElasticConfig", "ElasticWorker",
           "FTPolicy", "FTPolicyConfig", "FileShardSource", "InferenceModel",
           "KVCodecChannel", "LeaseReader", "MultiHostWorker", "PeriodicExporter",
           "RescaleEvent", "StragglerConfig", "StragglerDetector",
           "SyntheticShardSource", "Trainer",
           "TrainerConfig", "TrainState", "WireCodec", "WireOverflowError",
           "WireRestartRequired",
           "artifact_version", "load_inference_model", "pass_tasks", "prefetch_iter",
           "read_artifact", "resolve_artifact_dir", "save_inference_model",
           "shard_names", "write_shard"]
