"""A mesh of ranks with named axes: the port of `edl_tpu.parallel.mesh`.

The JAX package lays devices out in a ``jax.sharding.Mesh``; here every
rank of a ``torch.distributed`` process group drives one device, and a
`Mesh` names the ranks' axes. Ranks fill the axes row-major in
`AXIS_ORDER` (the JAX package's ``arrange_devices`` fallback for devices
without grid coordinates), so rank r sits where JAX device r of a mesh of
the same shape sits, and a leaf's shard on rank r is the one that JAX
device holds.

Every axis gets one process group for each of its slices (the ranks that
differ only in that axis), a batch-axis hierarchy such as ``("dcn",
"data")`` one more over the product of those axes, and so does every other
set of two or more axes of size above 1 (a model-parallel gradient is
summed over the axes its param is not sharded on). ``torch.distributed``
numbers a group's ranks in ascending global rank, which is row-major in
the slice's axes: a rank's index in a group is its index on those axes.

Axis conventions (as in the JAX package):
  dcn     — the slowest tier (across hosts); outermost
  data    — batch sharding; gradients reduced over it
  pipe    — pipeline stages
  seq     — sequence/context parallelism
  expert  — expert/embedding-row sharding
  model   — tensor parallelism; innermost
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

#: "dcn" outermost (the only axis whose collectives may cross hosts), then
#: data, pipe, and the latency-critical tensor axes innermost
AXIS_ORDER = ("dcn", "data", "pipe", "seq", "expert", "model")

#: the batch-axis hierarchies that get a group over their product when
#: their axes are on the mesh
HIERARCHIES = (("dcn", "data"),)


@dataclass(frozen=True)
class MeshSpec:
    """Logical axis sizes for a job's mesh: ``axes`` maps axis name -> size;
    unspecified axes are size 1."""

    axes: Dict[str, int] = field(default_factory=dict)

    def size(self) -> int:
        return math.prod(self.axes.values()) if self.axes else 1

    def axis(self, name: str) -> int:
        return self.axes.get(name, 1)

    def ordered_axes(self) -> List[str]:
        """Axes in canonical order: dcn and data outermost, model innermost."""
        named = [a for a in AXIS_ORDER if a in self.axes]
        extra = [a for a in self.axes if a not in AXIS_ORDER]
        return named + sorted(extra)

    @classmethod
    def for_job(cls, parallelism: Dict[str, int], num_trainers: int = 1) -> "MeshSpec":
        axes = {k: int(v) for k, v in parallelism.items() if int(v) > 1}
        if num_trainers > 1:
            axes["data"] = axes.get("data", 1) * num_trainers
        if not axes:
            axes = {"data": 1}
        return cls(axes=axes)


class Mesh:
    """Named axes over the ranks of the default process group (or over one
    rank and no group: `local_mesh`).

    ``axis_names`` in canonical order and ``shape`` {name: size} read as a
    JAX mesh's do; ``rank``/``world`` are this process's. `group` gives the
    process group of this rank's slice over one axis or an axis tuple
    (None when the mesh has no process group)."""

    def __init__(self, names: Sequence[str], sizes: Sequence[int], rank: int,
                 world: int, groups: Optional[Dict[Tuple[str, ...], object]] = None):
        self.axis_names: Tuple[str, ...] = tuple(names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.rank, self.world = int(rank), int(world)
        self._groups = dict(groups or {})

    @property
    def distributed(self) -> bool:
        """Whether collectives run: the mesh was built over a process group."""
        return bool(self._groups)

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """{axis: index} of ``rank`` (default: this rank), row-major."""
        r = self.rank if rank is None else rank
        idx = np.unravel_index(r, tuple(self.shape.values())) if self.shape else ()
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def _axes(self, axes) -> Tuple[str, ...]:
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in names)

    def axis_size(self, axes) -> int:
        """Product of the sizes of ``axes`` present on the mesh (1 if none)."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's index over ``axes`` (row-major in mesh order): the
        shard index JAX gives the device here."""
        c = self.coords()
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + c[a]
        return idx

    def slice_ranks(self, axes, rank: Optional[int] = None) -> List[int]:
        """The global ranks that differ from ``rank`` only on ``axes``, in
        ascending order."""
        axes = self._axes(axes)
        mine = self.coords(rank)
        return [r for r in range(self.world)
                if all(c == mine[a] for a, c in self.coords(r).items() if a not in axes)]

    def neighbor(self, axis: str, shift: int, wrap: bool = True) -> Optional[int]:
        """The global rank ``shift`` places along ``axis`` from this one
        (the other coordinates equal): modulo the axis size with ``wrap``,
        else None past either end. Ring neighbours are ``neighbor(axis,
        1)`` and ``neighbor(axis, -1)``; a pipeline's line drops the
        wraparound ``n-1 -> 0``."""
        c = self.coords()
        n = self.shape[axis]
        i = c[axis] + shift
        if not wrap and not 0 <= i < n:
            return None
        c[axis] = i % n
        return int(np.ravel_multi_index([c[a] for a in self.axis_names],
                                        [self.shape[a] for a in self.axis_names]))

    def group(self, axes):
        """The process group of this rank's slice over ``axes``; None when
        the mesh has no process group or ``axes`` names no axis of it (or,
        for two or more axes, none of size above 1)."""
        key = self._axes(axes)
        if not key or not self._groups:
            return None
        if key not in self._groups and len(key) > 1:
            key = tuple(a for a in key if self.shape[a] > 1)
            if len(key) <= 1:
                return self.group(key) if key else None
        if key not in self._groups:
            raise KeyError(f"no process group over {key}; the mesh has groups over "
                           f"{sorted(self._groups)}")
        return self._groups[key]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}/{self.world})"


def _group_keys(names: Sequence[str], sizes: Sequence[int]) -> List[Tuple[str, ...]]:
    """Each axis; each hierarchy on the mesh; every other set of two or more
    axes of size above 1, in mesh order."""
    keys = [(a,) for a in names]
    for tier in HIERARCHIES:
        if all(a in names for a in tier):
            keys.append(tuple(tier))
    big = [a for a, n in zip(names, sizes) if n > 1]
    for k in range(2, len(big) + 1):
        for combo in itertools.combinations(big, k):
            if combo not in keys:
                keys.append(combo)
    return keys


def _make_groups(mesh: Mesh, keys: Iterable[Tuple[str, ...]]) -> Dict[Tuple[str, ...], object]:
    """One process group for each slice of each key, created on every rank
    in the same order (as ``torch.distributed`` requires); returns this
    rank's. A slice that spans the world uses the default group."""
    groups = {}
    for key in keys:
        slices = sorted({tuple(mesh.slice_ranks(key, r)) for r in range(mesh.world)})
        if len(slices) == 1:
            groups[key] = dist.group.WORLD
            continue
        mine, _ = dist.new_subgroups_by_enumeration([list(s) for s in slices])
        groups[key] = mine
    return groups


def build_mesh(spec: MeshSpec) -> Mesh:
    """A `Mesh` over the default process group (``init_process_group`` must
    have run): the axis product must equal the world size, or this raises,
    as the JAX package's ``build_mesh`` does when the controller's trainer
    count and the runtime's world disagree. Every rank must call it, in the
    same order, since it creates the axes' process groups."""
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs a process group: call "
                           "torch.distributed.init_process_group (or "
                           "runtime.distributed.distributed_init) first, or use "
                           "local_mesh() for one rank")
    world, rank = dist.get_world_size(), dist.get_rank()
    if spec.size() != world:
        raise ValueError(f"mesh spec {spec.axes} needs {spec.size()} ranks, have {world}")
    names = spec.ordered_axes() or ["data"]
    mesh = Mesh(names, [spec.axis(n) for n in names], rank, world)
    mesh._groups = _make_groups(mesh, _group_keys(names, [spec.axis(n) for n in names]))
    return mesh


def build_hierarchical_mesh(spec: MeshSpec) -> Mesh:
    """The two-tier mesh: ``dcn`` outermost across hosts, every other axis
    inside one host. Ranks fill row-major with dcn outermost, so this is
    `build_mesh`; the ``("dcn", "data")`` group is made whenever both axes
    are present. Ranks on one host should be numbered consecutively (the
    launcher's dense ranks are)."""
    return build_mesh(spec)


def local_mesh(axes: Optional[Dict[str, int]] = None) -> Mesh:
    """One rank and no process group: world size 1, every axis of size 1,
    and no collective is issued."""
    spec = MeshSpec(axes=dict(axes) if axes else {"data": 1})
    if spec.size() != 1:
        raise ValueError(f"local_mesh is one rank; {spec.axes} needs {spec.size()}")
    names = spec.ordered_axes()
    return Mesh(names, [1] * len(names), 0, 1)


__all__ = ["AXIS_ORDER", "Mesh", "MeshSpec", "build_hierarchical_mesh", "build_mesh",
           "local_mesh"]
