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
- ``predict(module, batch)`` (optional) -> the model's inference outputs,
  the JAX package's ``predict(params, batch, mesh)``: each module that has
  one exposes it as its ``predict`` method.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

Batch = Dict[str, np.ndarray]


@dataclass(frozen=True)
class Model:
    name: str
    build: Callable  # (device=None, generator=None) -> nn.Module; module(batch) -> loss
    synthetic_batch: Callable  # (np.random.Generator, batch_size) -> Batch
    #: batch keys holding the training objective (labels/targets/weights)
    label_keys: Tuple[str, ...] = ()
    #: optional inference entrypoint (module, batch) -> outputs, the serving
    #: twin of the loss (the batch may omit the label keys)
    predict: Optional[Callable] = None
    #: the structured config the model was built from
    config: Optional[Any] = None
    #: optional analytic (batch_size) -> train-step model FLOPs: matmul FLOPs
    #: only (2*M*N*K per matmul), causal attention halved, backward = 2x
    #: forward, recompute excluded: the numerator of model FLOPs utilization
    flops_per_step: Optional[Callable] = None


class Params(nn.Module):
    """A named group of params: the counterpart of one dict of a JAX params
    tree (``{"w": ..., "b": ...}``), so a JAX checkpoint carries across by
    name (`models.convert`). It holds params only; each model writes out its
    own forward, casts included."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t))


def normal(generator: torch.Generator, shape, std: float,
           device: torch.device) -> torch.Tensor:
    """f32 normal * ``std``, drawn on the host from ``generator`` (so a seed
    gives the same weights on every device) and placed on ``device``."""
    return (torch.randn(shape, generator=generator) * std).to(device)
