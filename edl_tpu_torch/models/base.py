"""The model convention the port's runtime trains against.

The counterpart of `edl_tpu.models.base.Model`. JAX's bundle is pure
functions over a params pytree; in PyTorch the params live in an
``nn.Module``, so the bundle carries a builder of that module instead of
``init``/``loss_fn``/``param_spec``:

- ``build(device=None, generator=None)`` -> ``nn.Module`` with its params on
  ``device``, drawn from the ``torch.Generator`` given; calling the module on
  a batch of tensors returns the scalar training loss.
- ``synthetic_batch(rng, batch_size)`` -> host-side numpy batch for tests and
  benchmarks, the same arrays as the JAX package's for the same ``rng``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

Batch = Dict[str, np.ndarray]


@dataclass(frozen=True)
class Model:
    name: str
    build: Callable  # (device=None, generator=None) -> nn.Module; module(batch) -> loss
    synthetic_batch: Callable  # (np.random.Generator, batch_size) -> Batch
    #: batch keys holding the training objective (labels/targets/weights)
    label_keys: Tuple[str, ...] = ()
    #: the structured config the model was built from
    config: Optional[Any] = None
    #: optional analytic (batch_size) -> train-step model FLOPs: matmul FLOPs
    #: only (2*M*N*K per matmul), causal attention halved, backward = 2x
    #: forward, recompute excluded: the numerator of model FLOPs utilization
    flops_per_step: Optional[Callable] = None
