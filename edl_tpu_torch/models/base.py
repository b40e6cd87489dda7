"""The model convention the port's runtime trains against.

The counterpart of `edl_tpu.models.base.Model`. JAX's bundle is pure
functions over a params pytree; in PyTorch the params live in an
``nn.Module``, so the bundle carries a builder of that module instead of
``init``/``loss_fn``/``param_spec``:

- ``build(device=None, generator=None)`` -> ``nn.Module`` with its params on
  ``device``, drawn from the ``torch.Generator`` given; calling the module on
  a batch of tensors returns the scalar training loss, the mean over the
  batch it is given. A model that shards params or checks axes takes
  ``mesh=`` too (`parallel.mesh.Mesh`).
- ``param_spec(mesh)`` (optional) -> ``{param name: spec}`` for the params
  that are not whole on every rank; every other param is replicated. A
  spec is a mesh axis (the param's rows, dim 0, split over it: CTR's
  tables), an ``(axis, dim)`` pair, or a tuple of `Shard`s: the param
  split on ``dim`` over ``axis``, or, with ``dim=None``, held whole by the
  ranks at ``index`` on ``axis`` only (a pipeline stage's layers). The
  JAX package's ``param_spec`` as the Trainer reads it (`normalize_spec`).
- ``grad_axes(mesh)`` (optional) -> the mesh axes the objective is a mean
  over and a param's gradient is summed over (less the axes it is sharded
  on). Default: the batch axes. The transformer takes every axis, the
  boundary rule of JAX's ``shard_map`` transpose for its ``P()`` loss.
- ``synthetic_batch(rng, batch_size)`` -> host-side numpy batch for tests and
  benchmarks, the same arrays as the JAX package's for the same ``rng``.
- ``predict(module, batch)`` (optional) -> the model's inference outputs,
  the JAX package's ``predict(params, batch, mesh)``: each module that has
  one exposes it as its ``predict`` method.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple, Union

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
    #: optional (mesh) -> {param name: spec} (see the module docstring and
    #: `normalize_spec`); None or an absent name: replicated
    param_spec: Optional[Callable] = None
    #: optional (mesh) -> the axes the objective is a mean over and
    #: gradients are summed over; None: the Trainer's batch axes
    grad_axes: Optional[Callable] = None
    #: optional (mesh) -> {batch key: (batch axes, sequence axis or None)}:
    #: the key's dim 0 splits over the batch axes and dim 1 over the
    #: sequence axis (JAX's ``batch_spec``); None: dim 0 over the batch axes
    batch_spec: Optional[Callable] = None
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


class Shard(NamedTuple):
    """Where one mesh axis puts a param: split on ``dim`` over ``axis`` (one
    axis or a tuple of axes, outermost first), or, with ``dim=None``, whole
    on the ranks at ``index`` on ``axis`` and absent from the others."""

    axis: Union[str, Tuple[str, ...]]
    dim: Optional[int] = 0
    index: Optional[int] = None


def normalize_spec(spec: Optional[Mapping[str, Any]]) -> Dict[str, Tuple[Shard, ...]]:
    """``{name: tuple of Shard}`` from a model's ``param_spec``: an axis name
    is ``(Shard(axis, 0),)``, an ``(axis, dim)`` pair one `Shard`, and a
    tuple of pairs or `Shard`s each one."""
    out: Dict[str, Tuple[Shard, ...]] = {}
    for name, s in (spec or {}).items():
        if isinstance(s, str):
            out[name] = (Shard(s, 0),)
        elif isinstance(s, Shard):
            out[name] = (s,)
        elif len(s) and isinstance(s[0], str):
            out[name] = (Shard(*s),)
        else:
            out[name] = tuple(x if isinstance(x, Shard) else Shard(*x) for x in s)
    return out
