"""The serving tier of the port: the counterpart of `edl_tpu.serving`, with
the same names.

It serves what `edl_tpu_torch.runtime.export` publishes, in the JAX
package's artifact format, so either package serves the other's exports:

- :mod:`edl_tpu_torch.serving.batcher` — the bucket-ladder math under
  continuous batching (pick/pad/split), on two axes: batch slots and, for
  LM traffic, sequence-length capacity.
- :mod:`edl_tpu_torch.serving.worker` — :class:`ServingReplica`: runs one
  zero batch per bucket before the first request, runs the
  continuous-batching dispatch loop, and hot-swaps model versions behind
  the exporter's atomic ``LATEST`` pointer with zero dropped requests.
- :mod:`edl_tpu_torch.serving.lm` — :class:`LMServingReplica`: decode-step
  continuous batching (batch membership changes per token),
  prefill/decode phase separation, paged-KV admission, and each stream's
  K/V cache resident on the device.
- :mod:`edl_tpu_torch.serving.kvcache` — :class:`BlockPool`: the paged
  KV-cache block allocator, the LM tier's admission currency.
- :mod:`edl_tpu_torch.serving.router` — :class:`Router`: health/affinity
  routing over a mutable replica pool, with zero-drop stream migration.
- :mod:`edl_tpu_torch.serving.frontend` — ``POST /predict`` + ``POST
  /generate`` + the obs surface (`/metrics`, `/healthz`, `/spans`) on one
  stdlib HTTP port.
- :mod:`edl_tpu_torch.serving.autoscale` — the SLO signals the controller
  scales serving replicas on.

The replicas run on the CUDA device unless their config names another
(``device="cpu"``); with no CUDA device and none named they raise.
``python -m edl_tpu_torch.serving [lm]`` is the serve smoke.
"""

from edl_tpu_torch.serving.autoscale import (
    LMServeSignal,
    LMServingSLO,
    ServeSignal,
    ServingSLO,
    aggregate_lm_signals,
    aggregate_signals,
    desired_lm_replica_delta,
    desired_replica_delta,
    histogram_quantile,
    scrape_lm_signal,
    scrape_serve_signal,
)
from edl_tpu_torch.serving.batcher import (
    SeqTooLongError,
    pad_batch,
    pad_token_rows,
    pick_bucket,
    pick_seq_bucket,
    plan_chunks,
    split_rows,
    validate_buckets,
)
from edl_tpu_torch.serving.frontend import ServeRequestHandler, make_frontend
from edl_tpu_torch.serving.kvcache import (
    BlockPool,
    KVCacheConfig,
    KVCacheExhaustedError,
)
from edl_tpu_torch.serving.lm import LMServingConfig, LMServingReplica, LMStreamHandle
from edl_tpu_torch.serving.router import NoReplicaError, Router
from edl_tpu_torch.serving.worker import (
    SERVING_KV_PREFIX,
    ServeCompileError,
    ServeOverloadError,
    ServingConfig,
    ServingReplica,
)

__all__ = [
    "BlockPool",
    "KVCacheConfig",
    "KVCacheExhaustedError",
    "LMServeSignal",
    "LMServingConfig",
    "LMServingReplica",
    "LMServingSLO",
    "LMStreamHandle",
    "NoReplicaError",
    "Router",
    "SERVING_KV_PREFIX",
    "SeqTooLongError",
    "ServeCompileError",
    "ServeOverloadError",
    "ServeRequestHandler",
    "ServeSignal",
    "ServingConfig",
    "ServingReplica",
    "ServingSLO",
    "aggregate_lm_signals",
    "aggregate_signals",
    "desired_lm_replica_delta",
    "desired_replica_delta",
    "histogram_quantile",
    "make_frontend",
    "pad_batch",
    "pad_token_rows",
    "pick_bucket",
    "pick_seq_bucket",
    "plan_chunks",
    "scrape_lm_signal",
    "scrape_serve_signal",
    "split_rows",
    "validate_buckets",
]
