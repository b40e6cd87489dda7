"""Data-plane collectives: the port of `edl_tpu.parallel.collective`.

Two halves:

- The arithmetic, copied from the JAX package: ZeRO-1 shard placement
  (`zero_shard_dim`, `zero_shard_spec`), gradient buckets
  (`GradBucket`, `assign_buckets`) and the closed-form bytes on the wire
  (`ring_bytes`, `collective_bytes`, `zero1_step_bytes`,
  `estimate_collective_seconds`). Nothing there needs a device.
- The collectives themselves, over a ``torch.distributed`` process group,
  as ``torch.autograd.Function``s whose backward passes are the JAX
  transposes: `all_gather` (tiled on dim 0) and `reduce_scatter` (tiled, on
  any dim) are each other's backward, and `all_reduce`'s backward passes
  its cotangent through unchanged. That last one is the transpose of a
  ``psum`` whose output is replicated over the reduced axis (the
  cross-axis table lookup's): every rank of the group holds the same
  output and the same cotangent, so summing the cotangents again, as
  ``torch.distributed.nn.functional.all_reduce`` does, would make it n
  times too large.

In the JAX package XLA issues the collectives (a sharding constraint makes
the partitioner lower a reduction as reduce-scatter); here the Trainer
issues them itself, one bucket at a time (`runtime.train_loop`).

The in-model collectives of the model-parallel LM, each with the transpose
JAX gives it inside a ``shard_map`` with ``check_vma=False``:

- `psum`: the sum over an axis; its backward is `psum` of the cotangent
  (under ``check_vma=False`` JAX transposes ``psum`` to ``psum``, unlike
  `all_reduce` above).
- `ppermute`: every rank of an axis sends to the rank ``shift`` places on
  (a ring, or a line without wraparound); its backward sends the
  cotangent back the other way.
- `all_to_all`: the tiled ``jax.lax.all_to_all``; its backward is the
  reverse all-to-all.
- `exchange`: the point-to-point transport under the last two and the
  pipeline schedules: one batch of sends and receives, matched by tag.

The transport is chosen by the group's backend, never by trying one and
catching its failure. On NCCL the tensors go as they are
(``batch_isend_irecv``, ``all_to_all_single``). On gloo, CUDA tensors go
through host copies: gloo's send and receive hand the buffer's pointer to
its TCP transport and stage nothing, so the host copy is the transport;
CPU tensors go as they are. (Gloo stages CUDA tensors itself for
``all_reduce``, ``all_gather_into_tensor`` and ``reduce_scatter_tensor``,
which the rest of this module uses.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "GradBucket",
    "all_to_all",
    "exchange",
    "ppermute",
    "psum",
    "ShardSpec",
    "all_gather",
    "all_reduce",
    "assign_buckets",
    "collective_bytes",
    "estimate_collective_seconds",
    "reduce_scatter",
    "ring_bytes",
    "zero1_step_bytes",
    "zero_shard_dim",
    "zero_shard_spec",
]

#: default per-GPU link rates (bytes/s, one direction) for the
#: ``collective_seconds`` estimate, from NVIDIA's data sheets, not
#: measured: NVLink 4 on an H100 SXM moves 900 GB/s both ways together
#: (450 GB/s each way), and one ConnectX-7 NDR InfiniBand port a GPU moves
#: 400 Gb/s (50 GB/s). An estimate for observability; pass ``ici_bps=`` /
#: ``dcn_bps=`` for another fabric.
NVLINK_BYTES_PER_SEC = 450e9
INFINIBAND_BYTES_PER_SEC = 50e9


# -- ZeRO shard placement ------------------------------------------------------


def zero_shard_dim(shape: Sequence[int], n: int) -> Optional[int]:
    """The dim a ZeRO-1 shard splits: the LARGEST dim divisible by ``n``
    (ties broken toward dim 0). None when nothing divides (the leaf stays
    replicated) or there is nothing to split (n <= 1)."""
    if n <= 1:
        return None
    best: Optional[int] = None
    for dim, size in enumerate(shape):
        if size > 0 and size % n == 0:
            if best is None or size > shape[best]:
                best = dim
    return best


@dataclass(frozen=True)
class ShardSpec:
    """Where a replicated leaf's ZeRO-1 shard lies: split on ``dim`` over
    the batch ``axes`` (one axis or a hierarchy, outermost first). The
    port's counterpart of the JAX package's ``PartitionSpec`` with the
    axes at ``dim``; rank r's shard is the one JAX device r of those axes
    holds."""

    dim: int
    axes: Tuple[str, ...]


def zero_shard_spec(shape: Sequence[int], mesh, axis) -> Optional[ShardSpec]:
    """The ZeRO-1 shard of a replicated leaf of ``shape`` over the batch
    axis (or axis hierarchy) of ``mesh``: `zero_shard_dim` over the product
    of the present axes. None when the mesh has no batch axis or no dim
    divides."""
    from edl_tpu_torch.parallel.sharding import axis_size, present_axes

    axes = present_axes(mesh, axis)
    if not axes:
        return None
    dim = zero_shard_dim(shape, axis_size(mesh, axes))
    return None if dim is None else ShardSpec(dim, axes)


# -- gradient buckets ----------------------------------------------------------


@dataclass(frozen=True)
class GradBucket:
    """A contiguous group of gradient leaves reduced as one unit.

    ``indices`` are flat-leaf positions; ``nbytes`` is the group's full
    (unsharded) gradient payload."""

    indices: Tuple[int, ...]
    nbytes: int


def assign_buckets(leaf_nbytes: Sequence[int], bucket_bytes: int) -> List[GradBucket]:
    """Greedy contiguous packing of gradient leaves into ~``bucket_bytes``
    buckets, walking leaves in REVERSE order: backward produces the last
    parameters' gradients first, so the first bucket filled is the first
    reduction issued. A leaf larger than ``bucket_bytes`` gets a bucket of
    its own (never split). Returned in issue order; every leaf appears in
    exactly one bucket."""
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be > 0, got {bucket_bytes}")
    buckets: List[GradBucket] = []
    pending: List[int] = []
    pending_bytes = 0
    for idx in reversed(range(len(leaf_nbytes))):
        nb = int(leaf_nbytes[idx])
        if pending and pending_bytes + nb > bucket_bytes:
            buckets.append(GradBucket(tuple(pending), pending_bytes))
            pending, pending_bytes = [], 0
        pending.append(idx)
        pending_bytes += nb
    if pending:
        buckets.append(GradBucket(tuple(pending), pending_bytes))
    return buckets


# -- closed-form bytes on wire -------------------------------------------------


def ring_bytes(nbytes: float, n: int, op: str) -> float:
    """Per-rank bytes on the wire of one ring collective over ``n`` ranks on
    a buffer whose FULL size is ``nbytes``: ``nbytes·(n−1)/n`` for
    ``reduce_scatter`` and ``all_gather``, twice that for ``all_reduce``.
    Bandwidth-optimal counts; latency terms are out of scope."""
    if n <= 1:
        return 0.0
    frac = (n - 1) / n
    if op == "all_reduce":
        return 2.0 * nbytes * frac
    if op in ("reduce_scatter", "all_gather"):
        return nbytes * frac
    raise ValueError(f"unknown collective op {op!r}")


def collective_bytes(nbytes: float, tiers: Sequence[Tuple[str, int]], op: str
                     ) -> Dict[str, float]:
    """Per-rank bytes on the wire of a (possibly hierarchical) collective.

    ``tiers`` lists (name, size) outermost -> innermost, e.g. ``[("dcn", 2),
    ("data", 4)]``. One tier is the flat ring. With more, the innermost
    tier runs first: ``all_reduce`` is inner reduce-scatter, outer
    all-reduce on the 1/k shard, inner all-gather; ``reduce_scatter`` is
    inner then outer on the shard; ``all_gather`` the reverse. Returns
    {tier name: bytes, "total": bytes}."""
    tiers = [(name, int(size)) for name, size in tiers]
    out: Dict[str, float] = {name: 0.0 for name, _ in tiers}
    if op not in ("all_reduce", "reduce_scatter", "all_gather"):
        raise ValueError(f"unknown collective op {op!r}")

    def _recurse(nbytes: float, tiers: Sequence[Tuple[str, int]], op: str):
        if not tiers:
            return
        if len(tiers) == 1:
            name, n = tiers[0]
            out[name] += ring_bytes(nbytes, n, op)
            return
        outer, (inner_name, k) = tiers[:-1], tiers[-1]
        if op == "all_reduce":
            out[inner_name] += ring_bytes(nbytes, k, "reduce_scatter")
            _recurse(nbytes / max(k, 1), outer, "all_reduce")
            out[inner_name] += ring_bytes(nbytes, k, "all_gather")
        elif op == "reduce_scatter":
            out[inner_name] += ring_bytes(nbytes, k, "reduce_scatter")
            _recurse(nbytes / max(k, 1), outer, "reduce_scatter")
        else:  # all_gather: outer assembles the shard, inner replicates it
            _recurse(nbytes / max(k, 1), outer, "all_gather")
            out[inner_name] += ring_bytes(nbytes, k, "all_gather")

    _recurse(float(nbytes), tiers, op)
    out["total"] = sum(out[name] for name, _ in tiers)
    return out


def zero1_step_bytes(sharded_bytes: float, replicated_bytes: float,
                     tiers: Sequence[Tuple[str, int]], grad_sync: str
                     ) -> Dict[str, float]:
    """Per-rank bytes on the wire of ONE step's data-plane collectives under
    ZeRO-1: ``psum`` all-reduces every gradient and all-gathers the sharded
    params; ``reduce_scatter`` reduce-scatters the sharded leaves'
    gradients, all-reduces the replicated rest and all-gathers the sharded
    params. Returns per-tier bytes plus {"grad_bytes", "param_bytes",
    "total"}."""
    if grad_sync not in ("psum", "reduce_scatter"):
        raise ValueError(f"unknown grad_sync {grad_sync!r}")
    per_tier: Dict[str, float] = {name: 0.0 for name, _ in tiers}

    def _add(acct: Dict[str, float]) -> float:
        for name, _ in tiers:
            per_tier[name] += acct[name]
        return acct["total"]

    grad = _add(collective_bytes(replicated_bytes, tiers, "all_reduce"))
    if grad_sync == "psum":
        grad += _add(collective_bytes(sharded_bytes, tiers, "all_reduce"))
    else:
        grad += _add(collective_bytes(sharded_bytes, tiers, "reduce_scatter"))
    param = _add(collective_bytes(sharded_bytes, tiers, "all_gather"))
    return {**per_tier, "grad_bytes": grad, "param_bytes": param,
            "total": grad + param}


def estimate_collective_seconds(per_tier_bytes: Dict[str, float],
                                ici_bps: float = NVLINK_BYTES_PER_SEC,
                                dcn_bps: float = INFINIBAND_BYTES_PER_SEC) -> float:
    """Bandwidth-model time for per-tier byte counts: the ``dcn`` tier (the
    hosts' InfiniBand) at ``dcn_bps``, every other tier (NVLink inside a
    host) at ``ici_bps``, tiers summed. An ESTIMATE from data-sheet rates,
    not a measurement."""
    seconds = 0.0
    for name, nbytes in per_tier_bytes.items():
        if name in ("total", "grad_bytes", "param_bytes"):
            continue
        seconds += nbytes / (dcn_bps if name == "dcn" else ici_bps)
    return seconds


# -- the collectives, with the JAX transposes as backward ----------------------


def gather_dim(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``x`` from every rank of ``group``, concatenated on ``dim`` in group
    rank order (no autograd)."""
    n = dist.get_world_size(group)
    moved = x.movedim(dim, 0).contiguous()
    out = moved.new_empty((n * moved.shape[0],) + tuple(moved.shape[1:]))
    dist.all_gather_into_tensor(out, moved, group=group)
    return out.movedim(0, dim)


def scatter_dim(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum of ``x`` over ``group``, of which this rank keeps its 1/n
    slice on ``dim`` (no autograd): ``movedim``, ``contiguous``, the
    collective, and the slice moved back, so the result is the JAX shard,
    not a transposed one."""
    n = dist.get_world_size(group)
    moved = x.movedim(dim, 0).contiguous()
    if moved.shape[0] % n:
        raise ValueError(f"dim {dim} of size {moved.shape[0]} does not split over "
                         f"{n} ranks")
    out = moved.new_empty((moved.shape[0] // n,) + tuple(moved.shape[1:]))
    dist.reduce_scatter_tensor(out, moved, group=group)
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather_dim(x, group, 0)

    @staticmethod
    def backward(ctx, g):
        return scatter_dim(g, ctx.group, 0), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return scatter_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, ctx.group, ctx.dim), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        # the output is replicated over the group: its cotangent is this
        # rank's already, as JAX transposes such a psum
        return g, None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, tiled=True)``: every rank's ``x``
    concatenated on dim 0. Backward: `reduce_scatter` of the cotangent."""
    return _AllGather.apply(x, group)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``:
    the sum over ``group``, of which this rank keeps its slice on ``dim``.
    Backward: `all_gather` of the cotangent on ``dim``."""
    return _ReduceScatter.apply(x, group, dim)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.psum(x, axis)`` into an output replicated over the axis.
    Backward: the cotangent, unchanged."""
    return _AllReduce.apply(x, group)


# -- in-model collectives: psum, ppermute, all_to_all -----------------------


def _host_staged(group, *tensors) -> bool:
    """Whether the transport goes through host copies: gloo with a CUDA
    tensor (see the module docstring)."""
    return (dist.get_backend(group) == "gloo"
            and any(t is not None and t.is_cuda for t in tensors))


def exchange(sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[Tuple[int, ...], torch.dtype, int]],
             group, device=None) -> List[torch.Tensor]:
    """One batch of point-to-point transfers over ``group``: each ``(tensor,
    peer)`` of ``sends`` goes to global rank ``peer``, and each ``(shape,
    dtype, peer)`` of ``recvs`` comes from one; returns the received
    tensors on ``device`` (default: the first sent tensor's, else the
    CPU), in order. Transfers between one pair of ranks match in the order
    they are listed (the i-th send to a peer is the peer's i-th receive
    from this rank), so both sides must list them in the same order. Every
    transfer is posted before any is waited on: no order of ranks can
    deadlock. No autograd."""
    if device is None:
        device = sends[0][0].device if sends else torch.device("cpu")
    staged = _host_staged(group, *(t for t, _ in sends)) or (
        dist.get_backend(group) == "gloo" and torch.device(device).type == "cuda")
    ops, bufs, kept = [], [], []
    tags: Dict[Tuple[str, int], int] = {}

    def tag(kind: str, peer: int) -> int:
        n = tags.get((kind, peer), 0)
        tags[(kind, peer)] = n + 1
        return n

    for t, peer in sends:
        t = t.detach().contiguous()
        if staged:
            t = t.cpu()
        kept.append(t)
        ops.append(dist.P2POp(dist.isend, t, peer, group, tag("send", peer)))
    for shape, dtype, peer in recvs:
        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if staged else device)
        bufs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, peer, group, tag("recv", peer)))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [b.to(device) for b in bufs] if staged else bufs


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.psum(x, axis)`` inside a ``shard_map`` with
    ``check_vma=False``: the sum over ``group``. Backward: `psum` of the
    cotangent. ``group=None``: one rank, the identity."""
    return x if group is None else _Psum.apply(x, group)


def _permute(xs, mesh, axis: str, shift: int, wrap: bool):
    """Send each of ``xs`` ``shift`` places along ``axis`` and receive the
    ones sent here (zeros where the line ends and nothing arrives)."""
    dst, src = mesh.neighbor(axis, shift, wrap), mesh.neighbor(axis, -shift, wrap)
    group = mesh.group(axis)
    sends = [(x, dst) for x in xs] if dst is not None else []
    recvs = ([(tuple(x.shape), x.dtype, src) for x in xs] if src is not None else [])
    got = exchange(sends, recvs, group, device=xs[0].device)
    return got if src is not None else [torch.zeros_like(x) for x in xs]


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, shift, wrap, *xs):
        ctx.args = (mesh, axis, shift, wrap)
        return tuple(_permute(xs, mesh, axis, shift, wrap))

    @staticmethod
    def backward(ctx, *gs):
        mesh, axis, shift, wrap = ctx.args
        return (None, None, None, None, *_permute(gs, mesh, axis, -shift, wrap))


def ppermute(xs: Sequence[torch.Tensor], mesh, axis: str, shift: int = 1,
             wrap: bool = True) -> List[torch.Tensor]:
    """``jax.lax.ppermute`` of the tensors ``xs`` over ``axis`` of
    ``mesh``: the rank at index i sends each to the rank at index i +
    ``shift`` (mod the axis size with ``wrap``; else the last ranks send
    nothing and the first receive zeros, as JAX's ppermute gives a rank no
    pair sends to). Backward: the cotangents travel the other way."""
    return list(_Ppermute.apply(mesh, axis, int(shift), bool(wrap), *xs))


def _a2a(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    moved = x.movedim(split_dim, 0)
    if moved.shape[0] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of size {moved.shape[0]} "
                         f"does not split over {n} ranks")
    chunks = moved.reshape(n, moved.shape[0] // n, *moved.shape[1:]).contiguous()
    staged = _host_staged(group, x)
    src = chunks.cpu() if staged else chunks
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    out = out.to(x.device) if staged else out
    # out[i]: rank i's chunk for this rank; put the split dim back, then lay
    # the source ranks' chunks side by side along the concat dim
    out = out.movedim(1, split_dim + 1).movedim(0, concat_dim)
    shape = list(out.shape)
    shape[concat_dim:concat_dim + 2] = [shape[concat_dim] * shape[concat_dim + 1]]
    return out.reshape(shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return _a2a(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return _a2a(g, group, concat_dim, split_dim), None, None, None


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
    ``x`` cut into n equal chunks along ``split_dim``, chunk i sent to the
    group's rank i, and the chunks received laid side by side along
    ``concat_dim`` in source rank order. Backward: the reverse
    all_to_all."""
    return _AllToAll.apply(x, group, int(split_dim), int(concat_dim))
