"""Batch placement over a mesh of ranks: the port of
`edl_tpu.parallel.sharding`.

A batch axis is one mesh axis or a hierarchy of them (``("dcn",
"data")``). Each rank holds its own slice of the global batch, as each
process of a multi-process JAX job does: it passes the slice it produced
from its own leased shards to ``Trainer.place_batch`` as it is, the global
batch is never assembled, and the global batch size is the local one
times the batch axes' size. `shard_batch` is the single-process branch:
it cuts a global batch that every rank holds to this rank's rows, and,
given a model's ``batch_spec`` (the JAX package's ``_batch_specs``: the
LM's tokens and targets ``(dp, sp)``), to its sequence chunk as well.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np

#: one mesh axis or a hierarchy of them, outermost first
BatchAxis = Union[str, Sequence[str]]


def present_axes(mesh, axis: BatchAxis) -> Tuple[str, ...]:
    """The subset of ``axis`` (str or sequence) present on ``mesh``, in the
    order given."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    return tuple(a for a in names if a in mesh.axis_names)


def axis_size(mesh, axis: BatchAxis) -> int:
    """Product of the present axes' sizes (1 when none is present)."""
    n = 1
    for a in present_axes(mesh, axis):
        n *= mesh.shape[a]
    return n


def _cut(v, dim: int, mesh, axis, key: str):
    n = axis_size(mesh, axis)
    size = int(np.shape(v)[dim])
    if size % n:
        raise ValueError(f"batch key {key!r}: dim {dim} of size {size} does not split "
                         f"over {n} ranks")
    b = size // n
    i = mesh.axis_index(present_axes(mesh, axis))
    index = (slice(None),) * dim + (slice(i * b, (i + 1) * b),)
    return v[index]


def shard_batch(batch: Dict[str, Any], mesh, axis: BatchAxis = "data",
                specs: Optional[Dict[str, Tuple[Any, Optional[str]]]] = None
                ) -> Dict[str, Any]:
    """This rank's part of a global ``batch``: every leaf split on dim 0
    over ``axis``, this rank keeping rows ``[i*b, (i+1)*b)``, ``i`` its
    index over the axes in mesh order (JAX device i's rows) and ``b`` the
    global batch over the axes' size. ``specs`` ({key: (batch axes,
    sequence axis or None)}, a model's ``batch_spec``) names the axes of
    its keys instead: dim 0 over the batch axes, dim 1 over the sequence
    axis."""
    out = {}
    for k, v in batch.items():
        rows_axis, seq_axis = (specs or {}).get(k, (axis, None))
        v = _cut(v, 0, mesh, rows_axis, k)
        if seq_axis is not None:
            v = _cut(v, 1, mesh, seq_axis, k)
        out[k] = v
    return out


def global_batch_size(local_batch: int, mesh, axis: BatchAxis = "data") -> int:
    return local_batch * axis_size(mesh, axis)


__all__ = ["BatchAxis", "axis_size", "global_batch_size", "present_axes", "shard_batch"]
