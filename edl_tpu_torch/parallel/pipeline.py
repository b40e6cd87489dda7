"""Pipeline parallelism over a ``pipe`` mesh axis: the port of
`edl_tpu.parallel.pipeline`.

A pipe rank holds its own stage's layers (the model builds only those),
activations hop one rank a tick (`parallel.collective.exchange`), and
stage outputs have the stage input's shape. Three schedules, as in the
JAX package:

- **GPipe** (`_pipeline_local`): the (M + n - 1)-tick forward; its backward
  replays the schedule reversed. Each stage keeps every microbatch's graph
  (an O(M) stash). The output is broadcast to every pipe rank, as the JAX
  package's ``psum`` does, so the code after it is the same on every rank.
- **1F1B** (`pipeline_train_1f1b`, ``virtual_stages=1``): forward and
  backward in one schedule. At tick t stage r runs the forward of
  microbatch t - r and the backward of microbatch t - 2(n-1) + r; the
  backward recomputes the stage from its stashed input (``torch.autograd.
  grad``, as the JAX package's ``stage_vjp``), so the stash holds at most
  ``min(M, 2n - 1)`` microbatch inputs.
- **Interleaved 1F1B** (``virtual_stages=v > 1``): rank r holds the v
  chunks ``r + k*n`` (`interleaved_layout`), activations go round the ring
  with the wraparound ``n-1 -> 0``, microbatches enter in groups of n, and
  the stash holds at most ``v * min(M, 3n)`` inputs.

The combined schedules compute the loss and every gradient in their
forward (a ``torch.autograd.Function``); the backward only scales the
stashed gradients by the upstream cotangent, with the JAX package's
correction for the loss's ``psum`` over the pipe axis (``_1f1b_bwd``).

The JAX package's SPMD scans compute the warm-up and drain ticks on masked
garbage. Here a rank skips them: it computes, sends and receives only for
the (stage, microbatch) pairs of the timetable, so no tick's result is
thrown away. A stage function may return ``(y, aux)`` (the MoE
load-balance aux, a scalar): the schedules sum it over the real (stage,
microbatch) executions, sum it over the pipe axis and fold
``aux_weight * mean over microbatches`` into the loss.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from edl_tpu_torch.parallel.collective import exchange

__all__ = ["bubble_fraction", "interleaved_layout", "pipeline_train_1f1b",
           "stash_slots"]


def bubble_fraction(schedule: str, n_stages: int, microbatches: int,
                    virtual_stages: int = 1) -> float:
    """Fraction of the schedule's stage executions that are warm-up/drain
    bubble. GPipe: (n-1)/(M+n-1) in each of the forward and backward. 1F1B:
    2(n-1)/(M+2(n-1)) of its fwd+bwd ticks. Interleaved 1F1B runs in
    chunk-ticks of 1/v the per-rank work over a span of M*v + n*v + n - 2,
    of which M*v are useful."""
    n, m, v = n_stages, microbatches, virtual_stages
    if v < 1:
        raise ValueError(f"virtual_stages must be >= 1, got {v}")
    if v != 1 and schedule != "1f1b-interleaved":
        raise ValueError(
            f"virtual_stages={v} only applies to '1f1b-interleaved', "
            f"not {schedule!r}"
        )
    if n <= 1:
        return 0.0
    if schedule == "gpipe":
        return (n - 1) / (m + n - 1)
    if schedule == "1f1b":
        return 2 * (n - 1) / (m + 2 * (n - 1))
    if schedule == "1f1b-interleaved":
        return (n * v + n - 2) / (m * v + n * v + n - 2)
    raise ValueError(f"unknown schedule {schedule!r}")


def stash_slots(schedule: str, n_stages: int, microbatches: int,
                virtual_stages: int = 1) -> int:
    """Per-rank activation-stash entries, in microbatch stage inputs. GPipe
    keeps M + n - 1 (O(M)); plain 1F1B a ring of min(M, 2n-1); interleaved
    1F1B v rings of min(M, 3n)."""
    n, m, v = n_stages, microbatches, virtual_stages
    if n <= 1:
        return 0
    if schedule == "gpipe":
        return m + n - 1
    if schedule == "1f1b":
        return min(m, 2 * n - 1)
    if schedule == "1f1b-interleaved":
        return v * min(m, 3 * n)
    raise ValueError(f"unknown schedule {schedule!r}")


def interleaved_layout(n_layers: int, n_stages: int, virtual_stages: int) -> np.ndarray:
    """Layer permutation for chunk-major interleaved storage: entry ``p`` is
    the LOGICAL layer held at stacked-storage row ``p``. Rank ``r``'s
    contiguous rows ``[r*L/n, (r+1)*L/n)`` then hold its virtual stages
    ``r + k*n`` back to back: rows ``k*Lc + j`` of its share are logical
    layer ``(r + k*n)*Lc + j`` (``Lc = L/(n*v)``). Invert with
    ``np.argsort(perm)``. Identity at v=1."""
    n, v = n_stages, virtual_stages
    if n_layers % (n * v):
        raise ValueError(
            f"n_layers={n_layers} must divide by n_stages*virtual_stages="
            f"{n * v}"
        )
    lc = n_layers // (n * v)
    rows = [
        layer
        for r in range(n)
        for k in range(v)
        for layer in range((r + k * n) * lc, (r + k * n + 1) * lc)
    ]
    return np.asarray(rows, dtype=np.int64)


def _split(x: torch.Tensor, m: int) -> torch.Tensor:
    b = x.shape[0]
    if b % m:
        raise ValueError(f"local batch {b} must be divisible by microbatches {m}")
    return x.reshape((m, b // m) + tuple(x.shape[1:]))


def _line(mesh, axis: str):
    """(pipe index, size, group, next rank or None, previous rank or None)."""
    return (mesh.axis_index(axis), mesh.shape[axis], mesh.group(axis),
            mesh.neighbor(axis, 1, wrap=False), mesh.neighbor(axis, -1, wrap=False))


def _psum_(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, group=group)
    return t


# -- GPipe -----------------------------------------------------------------------


class _GPipe(torch.autograd.Function):
    """The GPipe schedule: forward ticks keep each microbatch's graph; the
    backward runs the ticks reversed, seeding the last stage with the
    ``psum`` of the output's cotangents (the transpose of the broadcast)."""

    @staticmethod
    def forward(ctx, run, x):
        r, n, group, nxt, prv = _line(run.mesh, run.axis)
        M = run.microbatches
        mb = _split(x.detach(), M)
        train = run.train
        outs = torch.zeros_like(mb)
        aux_acc = torch.zeros((), dtype=torch.float32, device=x.device)
        stash = []
        held = None
        for t in range(M + n - 1):
            m = t - r
            y = None
            if 0 <= m < M:
                a = (mb[m] if r == 0 else held).detach().requires_grad_(train)
                with torch.enable_grad() if train else contextlib.nullcontext():
                    out = run.stage_fn(a)
                y, av = out if run.stage_aux else (out, None)
                if av is not None:
                    aux_acc = aux_acc + av.detach().float()
                if train:
                    stash.append((a, y, av))
                if r == n - 1:
                    outs[m] = y.detach()
            # hop: this tick's output to the next stage, which consumes it
            # at tick t + 1 (the same microbatch)
            sends = [(y, nxt)] if y is not None and nxt is not None else []
            want = prv is not None and 0 <= t + 1 - r < M
            recvs = [(tuple(mb.shape[1:]), mb.dtype, prv)] if want else []
            got = exchange(sends, recvs, group, device=x.device)
            held = got[0] if want else None
        if r != n - 1:
            outs.zero_()
        outs = _psum_(outs, group).reshape(x.shape)
        aux = _psum_(aux_acc.reshape(1), group)[0] / M
        ctx.run, ctx.stash, ctx.shape = run, stash, x.shape
        return outs, aux

    @staticmethod
    def backward(ctx, ct_outs, ct_aux):
        run, stash = ctx.run, ctx.stash
        r, n, group, nxt, prv = _line(run.mesh, run.axis)
        M = run.microbatches
        ct = _split(_psum_(ct_outs.contiguous().clone(), group), M)
        seed = _psum_(ct_aux.float().reshape(1).clone(), group)[0] / M
        dx = torch.zeros_like(ct)
        held = None
        for t in reversed(range(M + n - 1)):
            m = t - r
            da = None
            if 0 <= m < M:
                a, y, av = stash.pop()
                g = ct[m] if r == n - 1 else held
                if av is not None:
                    torch.autograd.backward([y, av], [g.to(y.dtype), seed.to(av.dtype)])
                else:
                    torch.autograd.backward(y, g.to(y.dtype))
                da = a.grad if a.grad is not None else torch.zeros_like(a)
                if r == 0:
                    dx[m] = da
            sends = [(da, prv)] if da is not None and prv is not None else []
            want = nxt is not None and 0 <= t - 1 - r < M
            recvs = [(tuple(ct.shape[1:]), ct.dtype, nxt)] if want else []
            got = exchange(sends, recvs, group, device=ct.device)
            held = got[0] if want else None
        return None, dx.reshape(ctx.shape)


class _GPipeRun:
    def __init__(self, stage_fn, mesh, axis, microbatches, stage_aux, train):
        self.stage_fn, self.mesh, self.axis = stage_fn, mesh, axis
        self.microbatches, self.stage_aux, self.train = microbatches, stage_aux, train


def _pipeline_local(stage_fn: Callable, x: torch.Tensor, *, mesh, pipe_axis: str,
                    n_stages: int, microbatches: int, stage_aux: bool = False):
    """The GPipe schedule over ``pipe_axis`` of ``mesh``: ``stage_fn`` is this
    rank's stage (its own layers) applied to (B/M, ...) activations. ``x``
    enters at stage 0; the result, (B, ...), is broadcast to every stage.
    With ``stage_aux`` the stage returns ``(y, aux)`` and this returns
    ``(outs, aux)``: aux summed over the real executions and the stages,
    over M."""
    if n_stages == 1:
        return stage_fn(x)
    if mesh.shape.get(pipe_axis, 1) != n_stages:
        raise ValueError(f"{n_stages} stages need a {pipe_axis!r} axis of that size: {mesh}")
    run = _GPipeRun(stage_fn, mesh, pipe_axis, microbatches, stage_aux,
                    torch.is_grad_enabled())
    outs, aux = _GPipe.apply(run, x)
    return (outs, aux) if stage_aux else outs


# -- 1F1B: combined forward/backward schedule -------------------------------------


class _Timetable:
    """The JAX package's conflict-free timetable (`_run_1f1b_interleaved`;
    at v = 1 it is the plain schedule's): which chunk and microbatch a rank
    runs forward and backward at tick t."""

    def __init__(self, n: int, v: int, M: int, r: int):
        self.n, self.v, self.M, self.r = n, v, M, r
        self.V = n * v
        self.ticks = M * v + n * v + n - 2

    def fwd(self, t: int, r: Optional[int] = None):
        """(chunk, microbatch) of the forward at tick t, or None."""
        n, v = self.n, self.v
        u = t - (self.r if r is None else r)
        rem = u % (n * v)
        k, m = rem // n, (u // (n * v)) * n + rem % n
        return (k, m) if u >= 0 and m < self.M else None

    def bwd(self, t: int, r: Optional[int] = None):
        """(chunk, microbatch) of the backward at tick t, or None."""
        n, v = self.n, self.v
        z = t - 2 * (self.V - 1) + (self.r if r is None else r) - n
        rem = z % (n * v)
        k, m = v - 1 - rem // n, (z // (n * v) + 1) * n + rem % n
        return (k, m) if 0 <= m < self.M else None


class _OneFOneB(torch.autograd.Function):
    """Forward: the whole combined schedule, returning the loss and keeping
    every gradient. Backward: those gradients times the cotangent (``ct``
    summed over the pipe axis for the stage params and x, the raw ``ct``
    for the tail params), the JAX package's ``_1f1b_bwd``."""

    @staticmethod
    def forward(ctx, run, x, *params):
        loss, grads = run.schedule(x)
        ctx.run, ctx.grads = run, grads
        return loss

    @staticmethod
    def backward(ctx, ct):
        run = ctx.run
        d_stage, d_tail, dx = ctx.grads
        ct = ct.float().reshape(1).clone()
        ct_sum = _psum_(ct.clone(), run.group)[0]
        ct = ct[0]
        return (None, (dx * ct_sum).to(dx.dtype),
                *[None if g is None else (g * ct_sum).to(g.dtype) for g in d_stage],
                *[None if g is None else (g * ct).to(g.dtype) for g in d_tail])


class _OneFOneBRun:
    def __init__(self, chunk_fn, chunk_params, tail_fn, tail_params, mesh, axis,
                 microbatches, virtual_stages, aux_weight, targets):
        self.chunk_fn, self.chunk_params = chunk_fn, chunk_params
        self.tail_fn, self.tail_params = tail_fn, list(tail_params)
        self.mesh, self.axis = mesh, axis
        self.group = mesh.group(axis)
        self.M, self.v = microbatches, virtual_stages
        self.aux_weight = float(aux_weight)
        self.targets = targets
        #: the most microbatch inputs stashed at once in the last run
        self.max_stash = 0

    def schedule(self, x: torch.Tensor):
        mesh, axis, M, v = self.mesh, self.axis, self.M, self.v
        n, r = mesh.shape[axis], mesh.axis_index(axis)
        aux_mode = bool(self.aux_weight)
        if v > 1 and M % n:
            raise ValueError(f"interleaved 1F1B needs microbatches divisible by the "
                             f"pipe size: M={M}, n={n}")
        mb = _split(x.detach(), M)
        tgt = _split(self.targets, M)
        tt = _Timetable(n, v, M, r)
        V = tt.V
        fwd_to, fwd_from = mesh.neighbor(axis, 1), mesh.neighbor(axis, -1)
        bwd_to, bwd_from = fwd_from, fwd_to
        flat = [p for ps in self.chunk_params for p in ps]
        index = {id(p): i for i, p in enumerate(flat)}
        d_stage: List[Optional[torch.Tensor]] = [None] * len(flat)
        d_tail: List[Optional[torch.Tensor]] = [None] * len(self.tail_params)
        dx = torch.zeros_like(mb)
        loss_acc = torch.zeros((), dtype=torch.float32, device=x.device)
        aux_acc = torch.zeros((), dtype=torch.float32, device=x.device)
        stash = {}
        bound = stash_slots("1f1b-interleaved" if v > 1 else "1f1b", n, M, v)
        self.max_stash = 0
        fwd_in = bwd_in = None
        shape, dtype = tuple(mb.shape[1:]), mb.dtype

        def add(acc, i, g):
            if g is not None:
                acc[i] = g if acc[i] is None else acc[i] + g

        for t in range(tt.ticks):
            y = da = None
            f = tt.fwd(t)
            if f is not None:  # F-phase: chunk k's forward of microbatch m
                k, m = f
                inp = mb[m] if (r == 0 and k == 0) else fwd_in
                with torch.no_grad():
                    out = self.chunk_fn(k, inp)
                y, av = out if aux_mode else (out, None)
                if av is not None:
                    aux_acc = aux_acc + av.float()
                stash[(k, m)] = inp
                self.max_stash = max(self.max_stash, len(stash))
                if len(stash) > bound:
                    raise RuntimeError(f"1F1B stash holds {len(stash)} inputs, over its "
                                       f"bound {bound}")
            b = tt.bwd(t)
            if b is not None:  # B-phase: recompute chunk k from its input
                k, m = b
                if r == n - 1 and k == v - 1:
                    # the last virtual stage: this tick's forward is the same
                    # microbatch, so its tail seeds the cotangent
                    y_ = y.detach().requires_grad_(True)
                    with torch.enable_grad():
                        loss_mb = self.tail_fn(y_, tgt[m])
                    got = torch.autograd.grad(loss_mb, [y_, *self.tail_params],
                                              allow_unused=True)
                    g = got[0]
                    for i, gi in enumerate(got[1:]):
                        add(d_tail, i, gi)
                    loss_acc = loss_acc + loss_mb.detach().float()
                else:
                    g = bwd_in
                a = stash.pop((k, m)).detach().requires_grad_(True)
                params = self.chunk_params[k]
                with torch.enable_grad():
                    out = self.chunk_fn(k, a)
                    ys, gs = ([out[0], out[1]], [g.to(out[0].dtype),
                                                 torch.full_like(out[1], self.aux_weight)]
                              ) if aux_mode else ([out], [g.to(out.dtype)])
                    grads = torch.autograd.grad(ys, [a, *params], gs, allow_unused=True)
                da = grads[0] if grads[0] is not None else torch.zeros_like(a)
                for p, gp in zip(params, grads[1:]):
                    add(d_stage, index[id(p)], gp)
                if r == 0 and k == 0:
                    dx[m] = da
            # hops: activations on (virtual stage s -> s + 1), cotangents back
            # (s -> s - 1); each side lists forward before backward
            sends, recvs = [], []
            if f is not None and r + f[0] * n < V - 1:
                sends.append((y, fwd_to))
            if b is not None and r + b[0] * n > 0:
                sends.append((da, bwd_to))
            f1, b1 = tt.fwd(t + 1), tt.bwd(t + 1)
            want_f = f1 is not None and r + f1[0] * n > 0
            want_b = b1 is not None and r + b1[0] * n < V - 1
            if want_f:
                recvs.append((shape, dtype, fwd_from))
            if want_b:
                recvs.append((shape, dtype, bwd_from))
            got = exchange(sends, recvs, self.group, device=x.device) \
                if (sends or recvs) else []
            fwd_in = got[0] if want_f else None
            bwd_in = got[-1] if want_b else None
        if stash:
            raise RuntimeError(f"1F1B schedule left {len(stash)} inputs unconsumed")

        inv_m = 1.0 / M
        is_last = r == n - 1
        total = loss_acc if is_last else torch.zeros_like(loss_acc)
        if aux_mode:
            total = total + self.aux_weight * aux_acc
        loss = _psum_(total.reshape(1).clone(), self.group)[0] * inv_m
        tails = []
        for p, g in zip(self.tail_params, d_tail):
            g = g if (g is not None and is_last) else torch.zeros_like(p)
            tails.append(_psum_(g.contiguous().clone(), self.group) * inv_m)
        dx = (dx * inv_m).to(x.dtype).reshape(x.shape)
        stage = [None if g is None else g * inv_m for g in d_stage]
        return loss, (stage, tails, dx)


def pipeline_train_1f1b(chunk_fn: Callable[[int, torch.Tensor], object],
                        tail_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                        mesh, pipe_axis: str, microbatches: int, virtual_stages: int,
                        aux_weight: float, chunk_params: Sequence[Sequence[torch.Tensor]],
                        tail_params: Sequence[torch.Tensor], x: torch.Tensor,
                        targets: torch.Tensor, stats: Optional[dict] = None
                        ) -> torch.Tensor:
    """1F1B training pipeline (plain at ``virtual_stages=1``, interleaved
    above): the mean over microbatches of ``tail_fn(stage_chain(x_m),
    targets_m)``, plus ``aux_weight`` times the stages' aux summed (then
    ``chunk_fn`` returns ``(y, aux)``).

    ``chunk_fn(k, h)`` applies this rank's chunk k (global virtual stage
    ``r + k*n``) and ``chunk_params[k]`` are its params; ``tail_fn(y,
    targets)`` closes over ``tail_params``. The returned loss is
    differentiable w.r.t. the params and ``x``, but the gradients were
    computed in the forward (that is what bounds the stash at O(n*v)); the
    backward scales them. Without autograd the backward work is wasted:
    use GPipe to run inference. ``stats``, if given, gets ``max_stash``:
    the most microbatch inputs the schedule held at once."""
    run = _OneFOneBRun(chunk_fn, chunk_params, tail_fn, tail_params, mesh, pipe_axis,
                       microbatches, virtual_stages, aux_weight, targets)
    params = [p for ps in chunk_params for p in ps]
    loss = _OneFOneB.apply(run, x, *params, *run.tail_params)
    if stats is not None:
        stats["max_stash"] = run.max_stash
    return loss
