"""The train step on one device or over a mesh of ranks: the port of
`edl_tpu.runtime.train_loop`.

The JAX package differentiates a pure ``loss_fn`` and applies an optax
optimizer inside one ``jax.jit`` over a mesh, and XLA inserts the
collectives. Here the model is an ``nn.Module``: the step runs its forward,
autograd's backward, optax's ``clip_by_global_norm`` when asked, and a
``torch.optim`` update. PyTorch runs eagerly, so nothing is traced and
nothing retraces.

Unlike JAX's immutable arrays, the params and the optimizer's moments are
updated in place: `TrainState` holds the module and the optimizer, and a
step returns a state that shares them with the one it was given.

The one-device options of the JAX Trainer:

- ``grad_accum_microbatches = N > 1``: every batch leaf is split
  contiguously into N equal microbatches (the JAX package's
  ``split_microbatches``), each runs forward and backward, the gradients
  add up in f32 from zero in microbatch order and are divided by N once;
  the loss is the mean of the microbatch losses. Clipping and the update
  run once, after accumulation.
- ``wire_transport``: `WireCodec` inferred from the first batch placed;
  the step decodes as its first act. An overflow widens that key's
  encoding in place (one process).
- ``pipeline_depth > 0``: ``run`` places batches on a `DevicePrefetcher`
  pump thread (a side stream and pinned host buffers on CUDA).

Over a `parallel.mesh.Mesh` (``Trainer(model, mesh)``) each rank steps its
own slice of the global batch and the Trainer issues the collectives the
JAX partitioner would, over the mesh's process groups:

- The objective on a rank is its module's loss over ``n``, the size of
  the model's ``grad_axes`` (default: the batch axes; the transformer
  takes every axis), and gradients are SUMMED over those axes less the
  ones a param is sharded on (the model's ``param_spec``): so every
  gradient is that of the global mean. (Averaging instead would make a
  row-sharded table's gradient, which its lookup's collective backward
  already sums, n times too large.) The loss returned is the mean over
  the ``grad_axes``.
- ``grad_sync="psum"``: every gradient is all-reduced over its axes.
  ``"reduce_scatter"`` (the ZeRO-1 data plane; needs ``shard_opt_state``):
  the ZeRO-sharded leaves' gradients are reduce-scattered over the batch
  axes on their shard dim instead (after an all-reduce over their other
  axes, if any). ``"auto"`` is ``"reduce_scatter"`` whenever
  ``shard_opt_state`` is on.
- ``shard_opt_state``: a replicated leaf with a `zero_shard_dim` over the
  batch axes keeps the optimizer's moments for this rank's shard only
  (rank r's is JAX device r's shard); the optimizer updates that shard and
  the params are all-gathered back. Sharded leaves (a table's rows, a
  tensor-parallel split, a pipeline stage's layers, experts) keep the
  moments of their own part, as the JAX Trainer's ``_zero_specs`` leaves
  them; indivisible leaves keep full moments.
- Reductions go out bucket by bucket (`assign_buckets`, reverse leaf
  order), once per microbatch under accumulation; under
  ``reduce_scatter`` the accumulator holds 1/n shards.
- Clipping takes the global norm: ZeRO shards' squared sums are
  all-reduced over the batch axes, a sharded leaf's over the axes it is
  sharded on, and replicated leaves are counted once.
- `full_state` gathers every part whole (split dims, and the layers that
  other pipeline stages hold) into the one-device Trainer's state_dicts,
  the optimizer's numbered in the one-device module's order.
- A gradient that autograd leaves as None counts as zeros (every rank
  must join every collective), so on a mesh the optimizer updates every
  leaf each step, as optax does.
- ``wire_transport`` with more than one rank needs a ``codec_channel``
  (`KVCodecChannel`): rank 0 publishes the codec and the others fetch it;
  an overflow raises the floor and `WireRestartRequired`.
"""

from __future__ import annotations

import functools
import inspect
import logging
import math
import time
import weakref
from collections import defaultdict
from dataclasses import dataclass
from typing import (Any, Callable, Dict, Iterable, Iterator, List, NamedTuple,
                    Optional, Tuple)

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from edl_tpu_torch.device import DeviceLike, resolve_device
from edl_tpu_torch.models.base import Model, Shard, normalize_spec
from edl_tpu_torch.parallel.collective import (ShardSpec, assign_buckets,
                                               collective_bytes,
                                               estimate_collective_seconds,
                                               zero1_step_bytes, zero_shard_spec)
from edl_tpu_torch.parallel.sharding import axis_size, present_axes
from edl_tpu_torch.runtime.pipeline import DevicePrefetcher
from edl_tpu_torch.runtime.wire import (WireCodec, WireOverflowError,
                                        WireRestartRequired)

log = logging.getLogger("edl_tpu_torch.runtime.train_loop")


class TrainState(NamedTuple):
    step: int
    params: nn.Module  # the model, its params updated in place
    opt_state: torch.optim.Optimizer  # holds the moments, updated in place


@dataclass
class TrainerConfig:
    learning_rate: float = 1e-3
    optimizer: str = "adam"  # "adam" | "sgd" | "adagrad"
    momentum: float = 0.0
    grad_clip_norm: float = 0.0
    #: one mesh axis or a hierarchy tuple (("dcn", "data")) the batch is
    #: sharded over
    batch_axis: Any = "data"
    seed: int = 0
    #: compact host->device batch transport (bf16 floats, u8/u24 ints; see
    #: `edl_tpu_torch.runtime.wire`), decoded as the step's first act
    wire_transport: bool = False
    #: extra batch keys (besides the model's label_keys) that must never get
    #: a lossy wire encoding
    wire_raw_keys: Tuple[str, ...] = ()
    #: ZeRO-1: the optimizer's moments of each replicated leaf with a
    #: divisible dim cover this rank's 1/n shard only
    shard_opt_state: bool = False
    #: "auto" | "psum" | "reduce_scatter" (see the module docstring); one
    #: device reduces nothing
    grad_sync: str = "auto"
    #: microbatch gradient accumulation: > 1 splits the placed batch into
    #: that many equal microbatches; the batch dim must divide by it
    grad_accum_microbatches: int = 1
    grad_bucket_mb: float = 4.0
    #: ``Trainer.run``'s input pipelining: 0 places each batch on the
    #: dispatch thread; N >= 1 places on a `DevicePrefetcher` pump thread up
    #: to N batches ahead of the step
    pipeline_depth: int = 0


def _check(cfg: TrainerConfig) -> None:
    if cfg.grad_sync not in ("auto", "psum", "reduce_scatter"):
        raise ValueError(f"unknown grad_sync {cfg.grad_sync!r}; expected 'auto', "
                         "'psum' or 'reduce_scatter'")
    if cfg.grad_accum_microbatches < 1:
        raise ValueError(f"grad_accum_microbatches must be >= 1, got "
                         f"{cfg.grad_accum_microbatches}")
    if cfg.grad_sync == "reduce_scatter" and not cfg.shard_opt_state:
        raise ValueError(
            "grad_sync='reduce_scatter' needs the ZeRO-1 layout: set "
            "shard_opt_state=True (the explicit data plane updates 1/N "
            "moment+gradient shards)")


class OptaxAdagrad(torch.optim.Optimizer):
    """``optax.adagrad(lr)``: ``scale_by_rss(initial_accumulator_value=0.1,
    eps=1e-7)`` followed by ``-lr``. Each step, for every element:

        acc <- acc + g^2                      (acc starts at 0.1)
        p   <- p - lr * g * rsqrt(acc + 1e-7)

    optax writes the factor as ``where(acc > 0, rsqrt(acc + eps), 0)``; acc
    starts at 0.1 and only grows, so the ``where`` always takes the rsqrt.
    ``torch.optim.Adagrad`` is another formula (acc from 0, ``sqrt(acc) +
    1e-10``). The update is dense, as optax's is: a whole embedding table,
    padded rows included, and a row whose gradient is 0 keeps its value.
    A param whose ``grad`` is None is skipped, which is the same as a zero
    gradient. ``state[p]["sum_of_squares"]`` is optax's ``ScaleByRssState``."""

    INITIAL_ACCUMULATOR = 0.1
    EPS = 1e-7

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr))
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["sum_of_squares"] = torch.full_like(
                    p, self.INITIAL_ACCUMULATOR, memory_format=torch.preserve_format)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            accs = [self.state[p]["sum_of_squares"] for p in params]
            torch._foreach_addcmul_(accs, grads, grads)
            scaled = torch._foreach_add(accs, self.EPS)
            torch._foreach_rsqrt_(scaled)
            torch._foreach_mul_(scaled, grads)
            torch._foreach_add_(params, scaled, alpha=-group["lr"])
        return loss


def _make_optimizer(cfg: TrainerConfig, params) -> torch.optim.Optimizer:
    """optax's adam, sgd and adagrad: ``torch.optim.Adam`` has optax.adam's
    formula (b1 0.9, b2 0.999, eps 1e-8 added after the sqrt,
    bias-corrected), ``torch.optim.SGD``'s momentum buffer starts from the
    first gradient as optax's trace does from zeros, and `OptaxAdagrad` is
    optax.adagrad written out."""
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=cfg.learning_rate, betas=(0.9, 0.999),
                                eps=1e-8)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=cfg.learning_rate, momentum=cfg.momentum)
    if cfg.optimizer == "adagrad":
        return OptaxAdagrad(params, lr=cfg.learning_rate)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: ``g * max / max(norm, max)``, so
    gradients under the norm pass unchanged (``clip_grad_norm_`` instead adds
    1e-6 to the norm). Returns the global norm, on the device."""
    grads = [g for g in grads if g is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    factor = max_norm / torch.clamp(norm, min=max_norm)
    torch._foreach_mul_(grads, factor)
    return norm


def split_microbatches(batch: Dict[str, torch.Tensor], n: int
                       ) -> List[Dict[str, torch.Tensor]]:
    """Split every leaf contiguously into ``n`` equal microbatches along the
    batch dim, as the JAX package's ``split_microbatches`` reshapes each
    leaf to (n, B/n, ...). Raises when B does not divide by ``n``."""
    rows = {int(v.shape[0]) for v in batch.values()}
    if len(rows) != 1:
        raise ValueError(f"batch leaves disagree on the batch dim: {sorted(rows)}")
    (b,) = rows
    if b % n:
        raise ValueError(f"batch dim {b} does not divide into {n} microbatches")
    parts = {k: v.reshape(n, b // n, *v.shape[1:]) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _host(v):
    """A host copy of its own of a tensor; anything else as it is."""
    return v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor) else v


@dataclass
class _Leaf:
    """One param of a module on a mesh and how its gradient travels."""

    name: str
    param: nn.Parameter  # the module's: whole, or this rank's part
    #: what the optimizer updates: ``param``, or this rank's ZeRO-1 shard
    opt_param: torch.Tensor
    #: where the model's ``param_spec`` puts it (empty: replicated)
    shards: Tuple[Shard, ...]
    #: the axes its gradient is all-reduced over (empty: none)
    reduce_axes: Tuple[str, ...]
    #: its ZeRO-1 shard (replicated leaves under ``shard_opt_state``)
    zero: Optional[ShardSpec]

    @property
    def own_axes(self) -> Tuple[str, ...]:
        """The mesh axes its shards name."""
        out: List[str] = []
        for sh in self.shards:
            out += [sh.axis] if isinstance(sh.axis, str) else list(sh.axis)
        return tuple(out)

    def full_shape(self, mesh) -> Tuple[int, ...]:
        """Its shape whole: each split dim times its axes' size."""
        shape = list(self.param.shape)
        for sh in self.shards:
            if sh.dim is not None:
                shape[sh.dim] *= mesh.axis_size(sh.axis)
        return tuple(shape)

    def copies(self, mesh) -> int:
        """How many distinct leaves of its shape the mesh holds: the stage
        count for a pipeline stage's layer, else 1."""
        return math.prod(mesh.axis_size(sh.axis) for sh in self.shards if sh.dim is None)

    def moment_shards(self, v: torch.Tensor, batch_axes) -> Tuple[Shard, ...]:
        """The shards of one of its optimizer state tensors: the param's (and
        its ZeRO shard's) for a tensor of the optimizer param's shape; only
        its pipeline placement for anything else (Adam's step)."""
        if v.dim() > 0 and tuple(v.shape) == tuple(self.opt_param.shape):
            extra = (Shard(batch_axes, self.zero.dim),) if self.zero is not None else ()
            return self.shards + extra
        return tuple(sh for sh in self.shards if sh.dim is None)


#: joins a param's name and an optimizer state key in flat dicts
_KEY = "::"


class _MeshLayout:
    """The per-leaf plan of one module on a mesh: what each rank holds, what
    the optimizer updates, and which collective moves each gradient."""

    def __init__(self, module: nn.Module, mesh, spec: Dict[str, Tuple[Shard, ...]],
                 cfg: TrainerConfig, grad_sync: str, grad_axes=None):
        self.mesh, self.grad_sync = mesh, grad_sync
        self.batch_axes = present_axes(mesh, cfg.batch_axis)
        if self.batch_axes != tuple(a for a in mesh.axis_names if a in self.batch_axes):
            raise ValueError(f"batch axes {self.batch_axes} must be in mesh order "
                             f"{mesh.axis_names}")
        self.n_batch = axis_size(mesh, self.batch_axes)
        self.index = mesh.axis_index(self.batch_axes)
        #: the axes the objective is a mean over, in mesh order, and their size
        self.grad_axes = (self.batch_axes if grad_axes is None else
                          tuple(a for a in mesh.axis_names if a in tuple(grad_axes)))
        self.n_grad = axis_size(mesh, self.grad_axes)
        self.full_names = (module.full_param_names() if hasattr(module, "full_param_names")
                           else [n for n, _ in module.named_parameters()])
        self.leaves: List[_Leaf] = []
        for name, p in module.named_parameters():
            shards = spec.get(name, ())
            zero = None
            if not shards and cfg.shard_opt_state and p.dim() > 0:
                zero = zero_shard_spec(p.shape, mesh, self.batch_axes)
            opt_param = p
            if zero is not None:
                rows = p.shape[zero.dim] // self.n_batch
                opt_param = p.detach().narrow(zero.dim, self.index * rows, rows).clone()
            leaf = _Leaf(name, p, opt_param, shards, (), zero)
            leaf.reduce_axes = tuple(a for a in self.grad_axes if a not in leaf.own_axes)
            self.leaves.append(leaf)
        nbytes = [p.numel() * p.element_size() for p in module.parameters()]
        self.buckets = [b.indices for b in assign_buckets(
            nbytes, max(1, int(cfg.grad_bucket_mb * 2**20)))]

    # -- the collectives of a step ---------------------------------------------

    def _all_reduce(self, grads: List[torch.Tensor], group) -> List[torch.Tensor]:
        """One all-reduce of the leaves' gradients flattened end to end;
        returns views of the reduced buffer in their shapes."""
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        out, off = [], 0
        for g in grads:
            out.append(flat[off:off + g.numel()].view(g.shape))
            off += g.numel()
        return out

    def _reduce_scatter(self, grads: List[torch.Tensor], dims: List[int]
                        ) -> List[torch.Tensor]:
        """One reduce-scatter over the batch axes of the leaves' gradients:
        each moved to put its shard dim first and split in n rows, the rows
        laid side by side, so rank r's slice of the buffer is every leaf's
        shard r. Returns this rank's shards, each in its leaf's layout."""
        n = self.n_batch
        moved = [g.movedim(d, 0) for g, d in zip(grads, dims)]
        flat = torch.cat([m.reshape(n, -1) for m in moved], dim=1).reshape(-1)
        mine = flat.new_empty(flat.numel() // n)
        dist.reduce_scatter_tensor(mine, flat, group=self.mesh.group(self.batch_axes))
        out, off = [], 0
        for m, d in zip(moved, dims):
            k = m.numel() // n
            shard = mine[off:off + k].view((m.shape[0] // n,) + tuple(m.shape[1:]))
            out.append(shard.movedim(0, d).contiguous())
            off += k
        return out

    def _all_gather_params(self, idx: List[int]) -> None:
        """The updated ZeRO shards of leaves ``idx`` gathered back into
        their params: one all-gather of the shards laid end to end."""
        n = self.n_batch
        moved = [self.leaves[i].opt_param.detach().movedim(self.leaves[i].zero.dim, 0)
                 for i in idx]
        flat = torch.cat([m.reshape(-1) for m in moved])
        full = flat.new_empty(n * flat.numel())
        dist.all_gather_into_tensor(full, flat, group=self.mesh.group(self.batch_axes))
        rows = full.view(n, -1)
        off = 0
        for i, m in zip(idx, moved):
            leaf, k = self.leaves[i], m.numel()
            whole = rows[:, off:off + k].reshape((n * m.shape[0],) + tuple(m.shape[1:]))
            leaf.param.data.copy_(whole.movedim(0, leaf.zero.dim))
            off += k

    def sync_grads(self) -> List[torch.Tensor]:
        """This microbatch's gradients, reduced bucket by bucket: for each
        leaf its full reduced gradient, or its ZeRO shard under
        ``reduce_scatter``. Gradients autograd left as None are zeros."""
        grads = [leaf.param.grad if leaf.param.grad is not None
                 else torch.zeros_like(leaf.param) for leaf in self.leaves]
        out: List[Optional[torch.Tensor]] = list(grads)
        if not self.mesh.distributed:
            return out
        for bucket in self.buckets:
            reduce = defaultdict(list)  # (axes, dtype) -> leaf indices
            scatter = defaultdict(list)  # dtype -> leaf indices
            for i in bucket:
                leaf = self.leaves[i]
                axes = leaf.reduce_axes
                if leaf.zero is not None and self.grad_sync == "reduce_scatter":
                    scatter[grads[i].dtype].append(i)
                    # its sum over the axes other than the batch's comes first
                    axes = tuple(a for a in axes if a not in self.batch_axes)
                if axes:
                    reduce[(axes, grads[i].dtype)].append(i)
            for (axes, _), idx in reduce.items():
                group = self.mesh.group(axes)
                if group is None:
                    continue  # the axes are all of size 1
                done = self._all_reduce([out[i] for i in idx], group)
                for i, g in zip(idx, done):
                    out[i] = g
            for idx in scatter.values():
                done = self._reduce_scatter([out[i] for i in idx],
                                            [self.leaves[i].zero.dim for i in idx])
                for i, g in zip(idx, done):
                    out[i] = g
        return out

    def shard(self, leaf: _Leaf, g: torch.Tensor) -> torch.Tensor:
        """This rank's ZeRO shard of a full tensor of ``leaf``'s shape."""
        rows = g.shape[leaf.zero.dim] // self.n_batch
        return g.narrow(leaf.zero.dim, self.index * rows, rows).contiguous()

    def set_grads(self, grads: List[torch.Tensor]) -> None:
        """Hand the reduced gradients to what the optimizer updates."""
        for leaf, g in zip(self.leaves, grads):
            if leaf.zero is not None:
                if g.shape != leaf.opt_param.shape:  # psum: full, sliced here
                    g = self.shard(leaf, g)
                leaf.param.grad = None
            leaf.opt_param.grad = g

    @torch.no_grad()
    def clip(self, max_norm: float) -> torch.Tensor:
        """optax.clip_by_global_norm over the sharded gradients: each
        squared sum counted once over the mesh. Returns the global norm."""
        once, over = [], defaultdict(list)  # axes -> squared sums to all-reduce
        for leaf in self.leaves:
            sq = leaf.opt_param.grad.float().square().sum()
            if leaf.zero is not None:
                over[self.batch_axes].append(sq)
            elif leaf.shards:
                over[tuple(a for a in self.mesh.axis_names if a in leaf.own_axes)].append(sq)
            else:
                once.append(sq)
        total = torch.stack(once).sum() if once else None
        for axes, sqs in over.items():
            part = torch.stack(sqs).sum()
            group = self.mesh.group(axes)
            if group is not None:
                dist.all_reduce(part, group=group)
            total = part if total is None else total + part
        norm = torch.sqrt(total)
        factor = max_norm / torch.clamp(norm, min=max_norm)
        torch._foreach_mul_([leaf.opt_param.grad for leaf in self.leaves], factor)
        return norm

    def gather_params(self) -> None:
        """All-gather the updated ZeRO shards into the full params, bucket by
        bucket."""
        if not self.mesh.distributed:
            return  # one rank: nothing is sharded
        for bucket in self.buckets:
            idx = [i for i in bucket if self.leaves[i].zero is not None]
            if idx:
                self._all_gather_params(idx)

    # -- full state for checkpoints --------------------------------------------

    def full_optimizer_state(self, opt: torch.optim.Optimizer) -> dict:
        """``opt.state_dict()`` with every part gathered whole (collective)
        and numbered in the one-device module's order, on the host."""
        from edl_tpu_torch.models.convert import gather_state_dict

        sd = opt.state_dict()  # its per-param dicts are the live ones
        flat, spec, plain = {}, {}, {}
        for i, leaf in enumerate(self.leaves):
            for k, v in sd["state"].get(i, {}).items():
                key = f"{leaf.name}{_KEY}{k}"
                if isinstance(v, torch.Tensor):
                    flat[key] = v
                    spec[key] = leaf.moment_shards(v, self.batch_axes)
                else:
                    plain[key] = v
        whole = gather_state_dict(flat, spec, self.mesh)
        whole.update(plain)
        number = {n: i for i, n in enumerate(self.full_names)}
        state: Dict[int, dict] = {}
        for key, v in whole.items():
            name, k = key.split(_KEY)
            state.setdefault(number[name], {})[k] = _host(v)
        groups = [dict(g, params=list(range(len(self.full_names))))
                  for g in sd["param_groups"]]
        return {"state": dict(sorted(state.items())), "param_groups": groups}

    def local_optimizer_state(self, sd: dict) -> dict:
        """A whole optimizer state_dict (numbered in the one-device module's
        order) cut to this rank's parts, numbered as its optimizer's."""
        from edl_tpu_torch.models.convert import _cut

        number = {n: i for i, n in enumerate(self.full_names)}
        out = {"state": {}, "param_groups": [dict(g, params=list(range(len(self.leaves))))
                                             for g in sd["param_groups"]]}
        for i, leaf in enumerate(self.leaves):
            per = sd["state"].get(number[leaf.name])
            if per is None:
                continue
            full = leaf.full_shape(self.mesh)
            cut = {}
            for k, v in per.items():
                if isinstance(v, torch.Tensor) and v.dim() > 0 and tuple(v.shape) == full:
                    v = _cut(v, leaf.shards, self.mesh, leaf.name)
                    if leaf.zero is not None:
                        v = self.shard(leaf, v)
                    v = v.contiguous()
                cut[k] = v
            out["state"][i] = cut
        return out

    def refresh_shards(self) -> None:
        """Copy each ZeRO shard from its param (after a restore)."""
        with torch.no_grad():
            for leaf in self.leaves:
                if leaf.zero is not None:
                    leaf.opt_param.copy_(self.shard(leaf, leaf.param.detach()))


class Trainer:
    """Owns the step for (model, mesh, config, device).

    ``mesh=None`` is the one-device Trainer. With a `parallel.mesh.Mesh`
    each rank builds its part of the model (``model.build(mesh=...)`` where
    the model takes one) and steps its own batch slice; every rank must
    call every step, in the same order. ``device`` defaults to the CUDA
    device; without one, pass ``device="cpu"`` or construction raises.
    ``codec_channel`` (`KVCodecChannel`) agrees on the wire codec across
    ranks."""

    def __init__(self, model: Model, mesh=None, config: Optional[TrainerConfig] = None,
                 device: DeviceLike = None, codec_channel: Optional[Any] = None):
        self.model = model
        self.mesh = mesh
        self.device = resolve_device(device)
        self.config = config or TrainerConfig()
        _check(self.config)
        self.codec_channel = codec_channel
        #: the mode the step reduces with ("psum" | "reduce_scatter"): "auto"
        #: is the explicit plane whenever the ZeRO layout exists
        self.grad_sync = ("reduce_scatter" if self.config.shard_opt_state
                          and self.config.grad_sync != "psum" else "psum")
        #: steady-state recompilations: eager PyTorch has none
        self.retraces = 0
        #: the JAX Trainer's compile-cache outcome ("off" | "hit" | "miss"):
        #: always "off", eager PyTorch keeps no executable to cache
        self.last_compile_cache = "off"
        #: the wire codec, inferred from the first batch placed
        self._codec: Optional[WireCodec] = None
        self._warned_wire = False
        #: module -> its `_MeshLayout` (a mesh Trainer can own several states)
        self._layouts: "weakref.WeakKeyDictionary[nn.Module, _MeshLayout]" = \
            weakref.WeakKeyDictionary()
        self._data_plane: Optional[Dict[str, Any]] = None
        #: per-step wall-seconds hook (the elastic workers feed the
        #: fault-tolerance policy's step-cost EMA from it); None: no timing
        self.step_cost_cb: Optional[Callable[[float], None]] = None

    # -- state -----------------------------------------------------------------

    def init_state(self, generator: Optional[torch.Generator] = None) -> TrainState:
        """Build the model on the device, its params drawn from ``generator``
        (default: a CPU generator seeded with ``config.seed``). On a mesh
        every rank draws the same params; a sharded table keeps its rows."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.config.seed)
        kwargs = {}
        if self.mesh is not None and "mesh" in inspect.signature(self.model.build).parameters:
            kwargs["mesh"] = self.mesh
        module = self.model.build(device=self.device, generator=generator, **kwargs)
        module.train()
        if self.mesh is None:
            return TrainState(0, module, _make_optimizer(self.config, module.parameters()))
        layout = self.layout_for(module)
        opt = _make_optimizer(self.config, [leaf.opt_param for leaf in layout.leaves])
        return TrainState(0, module, opt)

    def layout_for(self, module: nn.Module) -> _MeshLayout:
        """The mesh layout of ``module`` (built on first use)."""
        layout = self._layouts.get(module)
        if layout is None:
            grad_axes = (self.model.grad_axes(self.mesh)
                         if self.model.grad_axes is not None else None)
            layout = _MeshLayout(module, self.mesh, self.param_spec(), self.config,
                                 self.grad_sync, grad_axes)
            self._layouts[module] = layout
        return layout

    def param_spec(self) -> Dict[str, Tuple[Shard, ...]]:
        """{param name: its shards} of the params not whole on every rank of
        this mesh (`models.base.normalize_spec` of the model's)."""
        if self.mesh is None or self.model.param_spec is None:
            return {}
        return normalize_spec(self.model.param_spec(self.mesh))

    def full_state(self, state: TrainState) -> dict:
        """``{"step", "module", "optimizer"}`` with every shard gathered
        whole, as host tensors of their own: the one-device Trainer's
        state_dicts. Collective on a mesh: every rank must call it."""
        module, opt = state.params, state.opt_state
        if self.mesh is None:
            sd = opt.state_dict()
            return {"step": int(state.step),
                    "module": {k: _host(v) for k, v in module.state_dict().items()},
                    "optimizer": {"state": {i: {k: _host(v) for k, v in per.items()}
                                            for i, per in sd["state"].items()},
                                  "param_groups": sd["param_groups"]}}
        from edl_tpu_torch.models.convert import gather_state_dict

        layout = self.layout_for(module)
        whole = gather_state_dict(module.state_dict(), self.param_spec(), self.mesh)
        order = [n for n in layout.full_names if n in whole]
        return {"step": int(state.step),
                "module": {**{n: whole[n] for n in order},
                           **{n: t for n, t in whole.items() if n not in order}},
                "optimizer": layout.full_optimizer_state(opt)}

    def load_full_state(self, state: TrainState, saved: dict) -> TrainState:
        """Load a whole state (`full_state`'s, or a checkpoint's) into
        ``state``: each rank keeps its shards."""
        module, opt = state.params, state.opt_state
        if self.mesh is None:
            module.load_state_dict(saved["module"])
            opt.load_state_dict(saved["optimizer"])
            return TrainState(int(saved["step"]), module, opt)
        from edl_tpu_torch.models.convert import shard_state_dict

        layout = self.layout_for(module)
        module.load_state_dict(shard_state_dict(saved["module"], self.param_spec(),
                                                self.mesh))
        layout.refresh_shards()
        opt.load_state_dict(layout.local_optimizer_state(saved["optimizer"]))
        return TrainState(int(saved["step"]), module, opt)

    # -- data-plane accounting -------------------------------------------------

    def data_plane(self, params: Any) -> Dict[str, Any]:
        """Analytic per-step data-plane accounting for the resolved
        ``grad_sync`` mode, as the JAX Trainer's: bytes on the wire per tier
        from the `parallel.collective` closed forms (a row-sharded table
        counted whole among the replicated bytes, as there), a seconds
        ESTIMATE from data-sheet link rates, and the gradient buckets.
        Gradient reductions are priced once per microbatch, the param
        all-gather once per step. ``params``: the module or its state;
        cached after the first call."""
        if self._data_plane is not None:
            return self._data_plane
        module = getattr(params, "params", params)
        cfg = self.config
        if self.mesh is None:
            axes, tiers, full = (), [], [tuple(p.shape) for p in module.parameters()]
            zero = [False] * len(full)
        else:
            layout = self.layout_for(module)
            axes = layout.batch_axes
            tiers = [(a, int(self.mesh.shape[a])) for a in axes]
            full = [leaf.full_shape(self.mesh) for leaf in layout.leaves]
            zero = [leaf.zero is not None for leaf in layout.leaves]
        # a pipeline stage's layer counts once for each stage, whose layers
        # have its shape (the JAX Trainer counts the stacked leaves whole)
        copies = ([1] * len(full) if self.mesh is None
                  else [leaf.copies(self.mesh) for leaf in layout.leaves])
        sizes = [p.element_size() for p in module.parameters()]
        leaf_nbytes = [int(np.prod(shape, dtype=np.int64)) * size * c
                       for shape, size, c in zip(full, sizes, copies)]
        sharded = float(sum(nb for nb, z in zip(leaf_nbytes, zero) if z))
        replicated = float(sum(nb for nb, z in zip(leaf_nbytes, zero) if not z))
        n_micro = max(1, cfg.grad_accum_microbatches)
        step_acct = zero1_step_bytes(sharded, replicated, tiers, self.grad_sync)
        param_acct = collective_bytes(sharded, tiers, "all_gather")
        per_tier = {name: (step_acct[name] - param_acct[name]) * n_micro
                    + param_acct[name] for name, _ in tiers}
        grad_bytes = step_acct["grad_bytes"] * n_micro
        bucket_bytes = max(1, int(cfg.grad_bucket_mb * 2**20))
        buckets = assign_buckets(leaf_nbytes, bucket_bytes)
        self._data_plane = {
            "grad_sync": self.grad_sync,
            "tiers": tiers,
            "grad_accum_microbatches": n_micro,
            "sharded_bytes": sharded,
            "replicated_bytes": replicated,
            "grad_bytes_per_step": grad_bytes,
            "param_bytes_per_step": step_acct["param_bytes"],
            "bytes_per_step": grad_bytes + step_acct["param_bytes"],
            "per_tier_bytes": per_tier,
            "collective_seconds": estimate_collective_seconds(per_tier),
            "bucket_target_bytes": bucket_bytes,
            "n_buckets": len(buckets),
            "bucket_nbytes": [int(b.nbytes) for b in buckets],
        }
        return self._data_plane

    # -- placement -------------------------------------------------------------

    def _multi_rank(self) -> bool:
        return self.mesh is not None and self.mesh.world > 1

    def _encode(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Wire-encode a host batch. One process infers the codec from the
        first batch and widens a key in place when a batch overflows its
        encoding; ranks of a mesh agree through the ``codec_channel``:
        rank 0 publishes, the others fetch, and an overflow raises the
        floor and `WireRestartRequired`."""
        multi = self._multi_rank()
        if self._codec is None:
            no_lossy = (*self.model.label_keys, *self.config.wire_raw_keys)
            if not multi:
                self._codec = WireCodec.infer(batch, no_lossy_keys=no_lossy)
                if self.codec_channel is not None:
                    # the persistent floor: a restart cannot re-learn old overflows
                    self._codec = self._codec.apply_floor(self.codec_channel.floor())
            elif self.mesh.rank == 0:
                self._codec = self.codec_channel.publish(
                    WireCodec.infer(batch, no_lossy_keys=no_lossy))
            else:
                self._codec = self.codec_channel.fetch()
        while True:
            try:
                return self._codec.encode(batch)
            except WireOverflowError as e:
                wider = self._codec.widen(e.key)
                if self.codec_channel is not None:
                    self.codec_channel.raise_floor(e.key, wider.keys[e.key].encoding)
                if multi:
                    # widening alone would leave the peers decoding the old layout
                    raise WireRestartRequired(e.key) from e
                # one process: widen that key (at most twice, then raw)
                self._codec = wider

    def _wire(self) -> bool:
        """Whether batches travel wire-encoded: on, and agreed across ranks."""
        if not self.config.wire_transport:
            return False
        if self._multi_rank() and self.codec_channel is None:
            if not self._warned_wire:
                self._warned_wire = True
                log.warning("wire_transport disabled: ranks of a mesh need a "
                            "codec_channel (KVCodecChannel) for one agreed codec")
            return False
        return True

    def place_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host numpy batch -> tensors on the device, wire-encoded when
        ``wire_transport`` is on. On CUDA each leaf is copied once into
        pinned host memory and from there with ``non_blocking=True`` on the
        current stream, so the copy overlaps whatever that stream waits on."""
        if self._wire():
            host = self._encode(batch)
        else:
            host = {k: torch.as_tensor(v) for k, v in batch.items()}
        if self.device.type != "cuda":
            return {k: v.to(self.device) for k, v in host.items()}
        return {k: v.pin_memory().to(self.device, non_blocking=True)
                for k, v in host.items()}

    def _step_callable(self, batch: Dict[str, torch.Tensor]) -> Callable:
        """The step for ``batch``: decoding with the current codec when the
        batch is wire-encoded."""
        codec = self._codec
        if codec is not None and codec.is_encoded(batch):
            return functools.partial(self._step, codec)
        return functools.partial(self._step, None)

    def place_bound(self, batch: Dict[str, np.ndarray]
                    ) -> Tuple[Dict[str, torch.Tensor], Callable]:
        """Place a batch AND bind the step that must run it: the codec that
        encoded the batch travels with it, so a widening while batches are
        in flight (`DevicePrefetcher`) does not re-route them."""
        placed = self.place_batch(batch)
        fn = self._step_callable(placed)
        cb = self.step_cost_cb
        if cb is None:
            return placed, fn

        def timed(state: TrainState, b: Dict[str, torch.Tensor]):
            t0 = time.perf_counter()
            out_state, loss = fn(state, b)
            float(loss)  # the step's wall time includes its device work
            cb(time.perf_counter() - t0)
            return out_state, loss

        return placed, timed

    def warm_compile(self, state: TrainState,
                     host_batch_shapes: Dict[str, Tuple[Tuple[int, ...], Any]]) -> float:
        """Pay before the first step what that step would pay lazily: the
        JAX Trainer AOT-compiles its step here; eager PyTorch has no
        executable, so this runs one forward under ``torch.no_grad()`` on
        zeros of the host batch's shapes (``{key: (shape, numpy dtype)}``),
        raw, not wire-encoded. That loads the flash kernels' library
        (`ops._build`) and the library handles the forward creates (cuBLAS,
        cuDNN). Returns the wall seconds. The forward only reads the params,
        so it may overlap a restore into the same state; on a mesh whose
        model issues collectives in its forward every rank must call it."""
        t0 = time.perf_counter()
        batch = {k: torch.as_tensor(np.zeros(shape, dtype)).to(self.device)
                 for k, (shape, dtype) in host_batch_shapes.items()}
        with torch.no_grad():
            loss = state.params(batch)
        float(loss)
        return time.perf_counter() - t0

    # -- stepping --------------------------------------------------------------

    def _grads_and_loss(self, module: nn.Module, batch: Dict[str, torch.Tensor]
                        ) -> torch.Tensor:
        """Leave the batch's gradient in each param's ``grad``; returns the
        loss. With N microbatches autograd adds each one's gradient to
        ``grad`` in order (the first sets it, as 0 + g does), and the sum is
        divided by N once, as the JAX scan's carry is."""
        n = self.config.grad_accum_microbatches
        if n == 1:
            loss = module(batch)
            loss.backward()
            return loss.detach()
        losses = []
        for mb in split_microbatches(batch, n):
            loss = module(mb)
            loss.backward()
            losses.append(loss.detach())
        with torch.no_grad():
            for p in module.parameters():
                if p.grad is not None:
                    p.grad.div_(n)
        return torch.stack(losses).mean()

    def _mesh_step(self, state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, torch.Tensor]:
        """The step over the mesh (see the module docstring): per
        microbatch, backward of the module's loss over n and the bucketed
        reductions; then the average over microbatches, the global-norm
        clip, the update of what each rank holds and the params'
        all-gather. Returns the global mean loss."""
        module, opt = state.params, state.opt_state
        layout = self.layout_for(module)
        n = self.config.grad_accum_microbatches
        opt.zero_grad(set_to_none=True)
        acc, losses = None, []
        for mb in ([batch] if n == 1 else split_microbatches(batch, n)):
            module.zero_grad(set_to_none=True)
            loss = module(mb)
            (loss / layout.n_grad).backward()
            losses.append(loss.detach())
            grads = layout.sync_grads()
            if acc is None:
                acc = grads
            else:
                torch._foreach_add_(acc, grads)
        module.zero_grad(set_to_none=True)
        if n > 1:
            torch._foreach_div_(acc, float(n))
        layout.set_grads(acc)
        if self.config.grad_clip_norm > 0:
            layout.clip(self.config.grad_clip_norm)
        opt.step()
        layout.gather_params()
        loss = losses[0] if n == 1 else torch.stack(losses).mean()
        group = self.mesh.group(layout.grad_axes)
        if group is not None:
            loss = loss.clone()
            dist.all_reduce(loss, group=group)
            loss = loss / layout.n_grad
        return TrainState(state.step + 1, module, opt), loss

    def _step(self, codec: Optional[WireCodec], state: TrainState,
              batch: Dict[str, torch.Tensor]) -> Tuple[TrainState, torch.Tensor]:
        if codec is not None:
            batch = codec.decode(batch)
        if self.mesh is not None:
            return self._mesh_step(state, batch)
        module, opt = state.params, state.opt_state
        opt.zero_grad(set_to_none=True)
        loss = self._grads_and_loss(module, batch)
        if self.config.grad_clip_norm > 0:
            clip_by_global_norm([p.grad for p in module.parameters()],
                                self.config.grad_clip_norm)
        opt.step()
        return TrainState(state.step + 1, module, opt), loss

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, torch.Tensor]:
        """One step; returns the new state and the loss (a 0-d tensor on the
        device, not synchronised)."""
        return self._step_callable(batch)(state, batch)

    def _dispatch_iter(self, batches: Iterable[Dict[str, np.ndarray]], depth: int
                       ) -> Iterator[Tuple[Dict[str, torch.Tensor], Callable, int, float]]:
        """Yield ``(placed, step_fn, samples, place_seconds)`` per batch:
        placed on this thread at depth 0, else on a `DevicePrefetcher` pump
        thread (``place_seconds`` is then the pump's time)."""
        if depth <= 0:
            for batch in batches:
                first = next(iter(batch.values()))
                t0 = time.perf_counter()
                placed, step_fn = self.place_bound(batch)
                yield placed, step_fn, len(first), time.perf_counter() - t0
            return
        with DevicePrefetcher(batches, self.place_bound, depth=depth,
                              device=self.device) as pf:
            for item in pf:
                placed, step_fn = item.payload
                yield placed, step_fn, item.samples, item.place_seconds

    def run(
        self,
        state: TrainState,
        batches: Iterable[Dict[str, np.ndarray]],
        max_steps: Optional[int] = None,
        on_step: Optional[Callable[[int, float], None]] = None,
        profiler: Optional[Any] = None,
        pipeline_depth: Optional[int] = None,
    ) -> Tuple[TrainState, Dict[str, float]]:
        """Drive the hot loop host-side: place batch, step, account throughput.

        ``pipeline_depth`` (default ``config.pipeline_depth``) > 0 places on
        a pump thread; exceptions from the source or the placement re-raise
        here as in the synchronous loop. Losses stay on the device until the
        loop ends; ``on_step`` forces a per-step sync (for debugging, not
        benchmarking). ``profiler`` (a `tools.profiler.StepProfiler`)
        records per-step host times without synchronising, so its step
        times follow the launch rate until the device's queue fills; the
        returned ``samples_per_sec`` is taken after the final sync. Its
        unset ``model``, ``n_chips`` (the mesh's world), ``device`` and
        ``data_plane`` are filled from this Trainer. Returns the JAX
        Trainer's metric keys; with one device the data-plane keys are 0.
        On a mesh every rank runs it over its own batches (its leased
        shards), in lockstep."""
        depth = self.config.pipeline_depth if pipeline_depth is None else pipeline_depth
        plane = self.data_plane(state.params)
        if profiler is not None:
            # the profiler's FLOP/MFU accounting without the caller
            # threading the model and mesh through twice
            if getattr(profiler, "model", None) is None:
                profiler.model = self.model
            if getattr(profiler, "n_chips", -1) is None:
                profiler.n_chips = self.mesh.world if self.mesh is not None else 1
            if getattr(profiler, "device", -1) is None:
                profiler.device = self.device
            if getattr(profiler, "data_plane", None) is None:
                profiler.data_plane = plane
            profiler.start()
        losses = []
        n = samples = 0
        place_seconds = 0.0
        t0 = time.perf_counter()
        for placed, step_fn, batch_samples, place_dt in self._dispatch_iter(batches, depth):
            samples += batch_samples
            place_seconds += place_dt
            state, loss = step_fn(state, placed)
            n += 1
            if on_step is not None:
                on_step(n, float(loss))
            if profiler is not None:
                profiler.step(batch_samples, place_seconds=place_dt,
                              collective_seconds=plane["collective_seconds"])
            losses.append(loss)
            if max_steps is not None and n >= max_steps:
                break
        losses = torch.stack(losses).float().cpu().tolist() if losses else []
        elapsed = max(time.perf_counter() - t0, 1e-9)
        metrics = {
            "steps": float(n),
            "final_loss": losses[-1] if losses else float("nan"),
            "mean_loss": float(np.mean(losses)) if losses else float("nan"),
            "samples_per_sec": samples / elapsed,
            "seconds": elapsed,
            "retraces": float(self.retraces),
            "place_seconds": place_seconds,
            # analytic data-plane accounting (`data_plane`): exact bytes for
            # the resolved grad_sync, seconds a data-sheet estimate
            "grad_bytes_per_step": plane["grad_bytes_per_step"],
            "collective_seconds_est": plane["collective_seconds"] * n,
        }
        return state, metrics


__all__ = ["OptaxAdagrad", "Trainer", "TrainerConfig", "TrainState",
           "clip_by_global_norm", "split_microbatches"]
