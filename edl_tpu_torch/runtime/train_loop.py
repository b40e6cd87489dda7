"""The train step on one device: the port of `edl_tpu.runtime.train_loop`.

The JAX package differentiates a pure ``loss_fn`` and applies an optax
optimizer inside one ``jax.jit`` over a mesh. Here the model is an
``nn.Module`` on one device: the step runs its forward, autograd's backward,
optax's ``clip_by_global_norm`` when asked, and a ``torch.optim`` update.
PyTorch runs eagerly, so nothing is traced and nothing retraces.

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

Raise ``NotImplementedError`` until the multi-rank slice:
``shard_opt_state`` and ``grad_sync="reduce_scatter"``.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import (Any, Callable, Dict, Iterable, Iterator, List, NamedTuple,
                    Optional, Tuple)

import numpy as np
import torch
from torch import nn

from edl_tpu_torch.device import DeviceLike, resolve_device
from edl_tpu_torch.models.base import Model
from edl_tpu_torch.runtime.pipeline import DevicePrefetcher
from edl_tpu_torch.runtime.wire import WireCodec, WireOverflowError


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
    #: one mesh axis or a hierarchy tuple; one device for now
    batch_axis: Any = "data"
    seed: int = 0
    #: compact host->device batch transport (bf16 floats, u8/u24 ints; see
    #: `edl_tpu_torch.runtime.wire`), decoded as the step's first act
    wire_transport: bool = False
    #: extra batch keys (besides the model's label_keys) that must never get
    #: a lossy wire encoding
    wire_raw_keys: Tuple[str, ...] = ()
    #: ZeRO-1 optimizer-state sharding; not ported yet
    shard_opt_state: bool = False
    #: "auto" | "psum" | "reduce_scatter"; one device reduces nothing, and
    #: the explicit reduce-scatter plane is not ported yet
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
    unported = {
        "shard_opt_state": cfg.shard_opt_state,
        "grad_sync='reduce_scatter'": cfg.grad_sync == "reduce_scatter",
    }
    for name, asked in unported.items():
        if asked:
            raise NotImplementedError(f"{name} is not ported yet")


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


class Trainer:
    """Owns the step for (model, device, config).

    ``device`` defaults to the CUDA device; without one, pass ``device="cpu"``
    or construction raises."""

    def __init__(self, model: Model, device: DeviceLike = None,
                 config: Optional[TrainerConfig] = None):
        self.model = model
        self.device = resolve_device(device)
        self.config = config or TrainerConfig()
        _check(self.config)
        #: steady-state recompilations: eager PyTorch has none
        self.retraces = 0
        #: the wire codec, inferred from the first batch placed
        self._codec: Optional[WireCodec] = None

    # -- state -----------------------------------------------------------------

    def init_state(self, generator: Optional[torch.Generator] = None) -> TrainState:
        """Build the model on the device, its params drawn from ``generator``
        (default: a CPU generator seeded with ``config.seed``)."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.config.seed)
        module = self.model.build(device=self.device, generator=generator)
        module.train()
        opt = _make_optimizer(self.config, module.parameters())
        return TrainState(0, module, opt)

    # -- placement -------------------------------------------------------------

    def _encode(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Wire-encode a host batch, inferring the codec from the first one
        and widening a key in place when a batch overflows its encoding."""
        if self._codec is None:
            self._codec = WireCodec.infer(
                batch, no_lossy_keys=(*self.model.label_keys,
                                      *self.config.wire_raw_keys))
        while True:
            try:
                return self._codec.encode(batch)
            except WireOverflowError as e:
                # one process: widen that key (at most twice, then raw)
                self._codec = self._codec.widen(e.key)

    def place_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host numpy batch -> tensors on the device, wire-encoded when
        ``wire_transport`` is on. On CUDA each leaf is copied once into
        pinned host memory and from there with ``non_blocking=True`` on the
        current stream, so the copy overlaps whatever that stream waits on."""
        if self.config.wire_transport:
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
        return placed, self._step_callable(placed)

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

    def _step(self, codec: Optional[WireCodec], state: TrainState,
              batch: Dict[str, torch.Tensor]) -> Tuple[TrainState, torch.Tensor]:
        if codec is not None:
            batch = codec.decode(batch)
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
        benchmarking). ``profiler`` waits for the port of the JAX package's
        ``StepProfiler`` and raises. Returns the JAX Trainer's metric keys;
        with one device the data-plane keys are 0."""
        if profiler is not None:
            raise NotImplementedError("run(profiler=...) is not ported yet")
        depth = self.config.pipeline_depth if pipeline_depth is None else pipeline_depth
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
            "grad_bytes_per_step": 0.0,
            "collective_seconds_est": 0.0,
        }
        return state, metrics


__all__ = ["OptaxAdagrad", "Trainer", "TrainerConfig", "TrainState",
           "clip_by_global_norm", "split_microbatches"]
