"""The train step on one device: the port of `edl_tpu.runtime.train_loop`.

The JAX package differentiates a pure ``loss_fn`` and applies an optax
optimizer inside one ``jax.jit`` over a mesh. Here the model is an
``nn.Module`` on one device: the step runs its forward, autograd's backward,
optax's ``clip_by_global_norm`` when asked, and a ``torch.optim`` update.
PyTorch runs eagerly, so nothing is traced and nothing retraces.

Unlike JAX's immutable arrays, the params and the optimizer's moments are
updated in place: `TrainState` holds the module and the optimizer, and a
step returns a state that shares them with the one it was given.

Raise ``NotImplementedError`` until a later slice: ``wire_transport``,
``shard_opt_state``, ``grad_sync="reduce_scatter"``,
``grad_accum_microbatches > 1``, ``pipeline_depth > 0`` and the
``"adagrad"`` optimizer (its optax form comes with the CTR model).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from edl_tpu_torch.device import DeviceLike, resolve_device
from edl_tpu_torch.models.base import Model


class TrainState(NamedTuple):
    step: int
    params: nn.Module  # the model, its params updated in place
    opt_state: torch.optim.Optimizer  # holds the moments, updated in place


@dataclass
class TrainerConfig:
    learning_rate: float = 1e-3
    optimizer: str = "adam"  # "adam" | "sgd" | "adagrad" (not yet ported)
    momentum: float = 0.0
    grad_clip_norm: float = 0.0
    #: one mesh axis or a hierarchy tuple; one device for now
    batch_axis: Any = "data"
    seed: int = 0
    #: compact host->device batch transport; not ported yet
    wire_transport: bool = False
    wire_raw_keys: Tuple[str, ...] = ()
    #: ZeRO-1 optimizer-state sharding; not ported yet
    shard_opt_state: bool = False
    #: "auto" | "psum" | "reduce_scatter"; one device reduces nothing, and
    #: the explicit reduce-scatter plane is not ported yet
    grad_sync: str = "auto"
    #: microbatch gradient accumulation; only 1 is ported
    grad_accum_microbatches: int = 1
    grad_bucket_mb: float = 4.0
    #: background batch placement ahead of the step; only 0 is ported
    pipeline_depth: int = 0


def _check(cfg: TrainerConfig) -> None:
    if cfg.grad_sync not in ("auto", "psum", "reduce_scatter"):
        raise ValueError(f"unknown grad_sync {cfg.grad_sync!r}; expected 'auto', "
                         "'psum' or 'reduce_scatter'")
    if cfg.grad_accum_microbatches < 1:
        raise ValueError(f"grad_accum_microbatches must be >= 1, got "
                         f"{cfg.grad_accum_microbatches}")
    unported = {
        "wire_transport": cfg.wire_transport,
        "shard_opt_state": cfg.shard_opt_state,
        "grad_sync='reduce_scatter'": cfg.grad_sync == "reduce_scatter",
        "grad_accum_microbatches > 1": cfg.grad_accum_microbatches > 1,
        "pipeline_depth > 0": cfg.pipeline_depth > 0,
    }
    for name, asked in unported.items():
        if asked:
            raise NotImplementedError(f"{name} is not ported yet")


def _make_optimizer(cfg: TrainerConfig, params) -> torch.optim.Optimizer:
    """optax's adam and sgd: ``torch.optim.Adam`` has optax.adam's formula
    (b1 0.9, b2 0.999, eps 1e-8 added after the sqrt, bias-corrected), and
    ``torch.optim.SGD``'s momentum buffer starts from the first gradient as
    optax's trace does from zeros."""
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=cfg.learning_rate, betas=(0.9, 0.999),
                                eps=1e-8)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=cfg.learning_rate, momentum=cfg.momentum)
    if cfg.optimizer == "adagrad":
        raise NotImplementedError(
            "adagrad is not ported yet: optax's accumulator starts at 0.1 where "
            "torch.optim.Adagrad's starts at 0")
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

    # -- stepping --------------------------------------------------------------

    def place_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host numpy batch -> tensors on the device (one copy each)."""
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, torch.Tensor]:
        """One step; returns the new state and the loss (a 0-d tensor on the
        device, not synchronised)."""
        module, opt = state.params, state.opt_state
        opt.zero_grad(set_to_none=True)
        loss = module(batch)
        loss.backward()
        if self.config.grad_clip_norm > 0:
            clip_by_global_norm([p.grad for p in module.parameters()],
                                self.config.grad_clip_norm)
        opt.step()
        return TrainState(state.step + 1, module, opt), loss.detach()

    def run(
        self,
        state: TrainState,
        batches: Iterable[Dict[str, np.ndarray]],
        max_steps: Optional[int] = None,
        on_step: Optional[Callable[[int, float], None]] = None,
    ) -> Tuple[TrainState, Dict[str, float]]:
        """Drive the hot loop host-side: place batch, step, account throughput.

        Losses stay on the device until the loop ends; ``on_step`` forces a
        per-step sync (for debugging, not benchmarking). Returns the JAX
        Trainer's metric keys; with one device the data-plane keys are 0."""
        losses = []
        n = samples = 0
        place_seconds = 0.0
        t0 = time.perf_counter()
        for batch in batches:
            samples += len(next(iter(batch.values())))
            tp = time.perf_counter()
            placed = self.place_batch(batch)
            place_seconds += time.perf_counter() - tp
            state, loss = self.train_step(state, placed)
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


__all__ = ["Trainer", "TrainerConfig", "TrainState", "clip_by_global_norm"]
