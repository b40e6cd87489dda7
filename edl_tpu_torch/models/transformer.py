"""Decoder-only transformer LM: the port of `edl_tpu.models.transformer`.

This slice ports the single-device training path: `TransformerConfig` with
all its fields, the dense decoder block, the full forward and mean token
cross-entropy (the JAX ``_kernel``'s no-pipe path and ``tail_loss``), plus
`synthetic_batch`, the FLOP and KV-cache accounting, `make_model` and
`MODEL`. The JAX package's scan over the stacked block params becomes a
Python loop over per-layer modules (`models.convert` splits a JAX checkpoint's
stacked ``(L, ...)`` params into them).

Dtypes follow the JAX package: f32 params; bf16 residual stream and matmuls
(both operands cast to bf16); f32 RMSNorm statistics; f32 LM head and f32
cross-entropy. GELU is the tanh form (``jax.nn.gelu`` defaults to
``approximate=True``) and RMSNorm's eps is 1e-6 inside the rsqrt.

Raise ``NotImplementedError`` until a later slice: mixture-of-experts FFNs
(``moe_experts > 0``), ``remat``, and any sequence, tensor or pipeline axis
above 1.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from edl_tpu_torch.device import DeviceLike, resolve_device
from edl_tpu_torch.models.base import Model
from edl_tpu_torch.parallel.ring_attention import _ring_attention_local


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    d_ff: int = 2048
    seq_len: int = 1024
    #: one mesh axis or a hierarchy (e.g. ("dcn", "data"))
    batch_axis: Union[str, Tuple[str, ...]] = "data"
    seq_axis: str = "seq"
    tp_axis: str = "model"
    pp_axis: str = "pipe"
    #: microbatches for the pipeline schedule; None = stage count
    microbatches: Optional[int] = None
    #: "gpipe", "1f1b" or "1f1b-interleaved"; pipelines wait for a later slice
    pipeline_schedule: str = "gpipe"
    #: virtual stage chunks per pipe rank (>1 only with "1f1b-interleaved")
    virtual_stages: int = 1
    #: per-block rematerialization; raises until a later slice
    remat: bool = False
    #: attention through the flash kernels (`edl_tpu_torch.ops.
    #: flash_attention`) instead of the dense O(S^2) oracle
    flash: bool = True
    #: mixture-of-experts FFN; anything above 0 raises until a later slice
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_top_k: int = 1
    expert_axis: str = "expert"
    moe_aux_weight: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _check(cfg: TransformerConfig, axes: Optional[Mapping[str, int]]) -> None:
    """The JAX package's config validation, plus what this slice leaves out."""
    if cfg.pipeline_schedule not in ("gpipe", "1f1b", "1f1b-interleaved"):
        raise ValueError(
            f"unknown pipeline_schedule {cfg.pipeline_schedule!r}; "
            "expected 'gpipe', '1f1b' or '1f1b-interleaved'")
    if cfg.virtual_stages < 1:
        raise ValueError(f"virtual_stages={cfg.virtual_stages} must be >= 1")
    if cfg.virtual_stages > 1 and cfg.pipeline_schedule != "1f1b-interleaved":
        raise ValueError(
            f"virtual_stages={cfg.virtual_stages} requires pipeline_schedule="
            f"'1f1b-interleaved', got {cfg.pipeline_schedule!r}")
    if cfg.moe_experts > 0:
        raise NotImplementedError("mixture-of-experts FFNs are not ported yet")
    if cfg.remat:
        raise NotImplementedError("remat is not ported yet")
    for axis in (cfg.seq_axis, cfg.tp_axis, cfg.pp_axis):
        if (axes or {}).get(axis, 1) > 1:
            raise NotImplementedError(
                f"axis {axis!r} of size {axes[axis]}: sequence, tensor and "
                f"pipeline parallelism are not ported yet")


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    norm = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
    return (norm * scale).to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _bf16(w: torch.Tensor) -> torch.Tensor:
    return w.to(torch.bfloat16)


class Block(nn.Module):
    """One dense decoder block; params in the JAX package's per-layer shapes:
    wqkv (D, 3, H, Dh), bqkv (3, H, Dh), wo (H, Dh, D), win (D, F), wout (F, D)."""

    def __init__(self, cfg: TransformerConfig, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        D, H, Dh, Fd = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
        self.cfg = cfg

        def param(shape, std=None):
            t = (torch.randn(shape, generator=generator) * std if std is not None
                 else torch.zeros(shape))
            return nn.Parameter(t.to(device))

        self.ln1 = nn.Parameter(torch.ones(D, device=device))
        self.wqkv = param((D, 3, H, Dh), math.sqrt(1.0 / D))
        self.bqkv = param((3, H, Dh))
        self.wo = param((H, Dh, D), math.sqrt(1.0 / D))
        self.bo = param((D,))
        self.ln2 = nn.Parameter(torch.ones(D, device=device))
        self.win = param((D, Fd), math.sqrt(2.0 / D))
        self.bin = param((Fd,))
        self.wout = param((Fd, D), math.sqrt(1.0 / Fd))
        self.bout = param((D,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, S, D) bf16 -> (B, S, D) bf16."""
        cfg = self.cfg
        B, S, D = x.shape
        H, Dh = cfg.n_heads, cfg.head_dim
        h = _rmsnorm(x, self.ln1)
        qkv = (h @ _bf16(self.wqkv).reshape(D, 3 * H * Dh)).reshape(B, S, 3, H, Dh) \
            + _bf16(self.bqkv)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attn = _ring_attention_local(q, k, v, seq_axis=cfg.seq_axis, n_shards=1,
                                     causal=True, scale=1.0 / math.sqrt(Dh),
                                     flash=cfg.flash)  # (B, S, H, Dh)
        out = attn.reshape(B, S, H * Dh) @ _bf16(self.wo).reshape(H * Dh, D)
        x = x + (out.float() + self.bo).to(torch.bfloat16)
        h = _rmsnorm(x, self.ln2)
        f = _gelu(h @ _bf16(self.win) + _bf16(self.bin))
        o = f @ _bf16(self.wout)
        return x + (o.float() + self.bout).to(torch.bfloat16)


class TransformerLM(nn.Module):
    """Token and position embeddings, ``n_layers`` blocks, final RMSNorm and
    LM head. Calling it on ``{"tokens", "targets"}`` ((B, S) integer tensors)
    returns the mean next-token cross-entropy, f32."""

    def __init__(self, cfg: TransformerConfig, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 axes: Optional[Mapping[str, int]] = None):
        super().__init__()
        _check(cfg, axes)
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        D, V = cfg.d_model, cfg.vocab_size
        self.cfg = cfg
        self.embed = nn.Parameter((torch.randn((V, D), generator=g) * 0.02).to(device))
        self.pos = nn.Parameter(
            (torch.randn((cfg.seq_len, D), generator=g) * 0.02).to(device))
        self.blocks = nn.ModuleList(Block(cfg, g, device) for _ in range(cfg.n_layers))
        self.lnf = nn.Parameter(torch.ones(D, device=device))
        self.head = nn.Parameter((torch.randn((D, V), generator=g) * 0.02).to(device))

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        tokens, targets = batch["tokens"].long(), batch["targets"].long()
        S = tokens.shape[1]
        x = (self.embed[tokens] + self.pos[:S]).to(torch.bfloat16)
        for block in self.blocks:
            x = block(x)
        # tail: final norm, f32 LM head, mean token cross-entropy (f32)
        h = _rmsnorm(x, self.lnf).float()
        logits = h @ self.head
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))


def synthetic_batch(cfg: TransformerConfig, rng: np.random.Generator, batch_size: int):
    """PTB-style id streams: next-token prediction over seq_len tokens."""
    ids = rng.integers(
        0, cfg.vocab_size, (batch_size, cfg.seq_len + 1), dtype=np.int64
    ).astype(np.int32)
    return {"tokens": ids[:, :-1], "targets": ids[:, 1:]}


def _flops_per_step(cfg: TransformerConfig, batch_size: int) -> float:
    """Train-step model FLOPs (MFU numerator; see models.base convention).

    Per token forward: qkv 6D^2 + out-proj 2D^2 + ffn 4DF per layer, plus
    causal attention (QK^T and PV are 2*S*D each, halved by the mask) and
    the LM head 2DV. Backward = 2x forward; remat recompute excluded.
    """
    D, F_, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    if cfg.moe_experts:
        ffn = cfg.moe_top_k * 4 * D * F_ + 2 * D * cfg.moe_experts
    else:
        ffn = 4 * D * F_
    per_token = (
        L * (6 * D * D + 2 * D * D + ffn + 0.5 * (4 * cfg.seq_len * D))
        + 2 * D * cfg.vocab_size
    )
    return 3.0 * per_token * cfg.seq_len * batch_size


def lm_cache_shape(cfg: TransformerConfig) -> Tuple[int, int, int]:
    """(n_layers, n_heads, head_dim): the per-token K/V geometry."""
    return (cfg.n_layers, cfg.n_heads, cfg.head_dim)


def lm_cache_bytes_per_token(cfg: TransformerConfig) -> int:
    """Device bytes one token slot of K+V occupies (bf16 cache)."""
    L, H, Dh = lm_cache_shape(cfg)
    return 2 * L * H * Dh * 2  # K and V, 2 bytes each (bfloat16)


def make_model(cfg: Optional[TransformerConfig] = None, **overrides) -> Model:
    cfg = cfg or TransformerConfig(**overrides)
    _check(cfg, None)
    return Model(
        name="transformer",
        build=lambda device=None, generator=None: TransformerLM(
            cfg, device=device, generator=generator),
        synthetic_batch=lambda rng, bs: synthetic_batch(cfg, rng, bs),
        label_keys=("targets",),
        config=cfg,
        flops_per_step=lambda bs: _flops_per_step(cfg, bs),
    )


#: default zoo instance, the JAX package's default config
MODEL = make_model()
