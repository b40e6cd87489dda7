"""Decoder-only transformer LM: the port of `edl_tpu.models.transformer`.

The single-device training path: `TransformerConfig` with all its fields,
the decoder block with a dense or a mixture-of-experts FFN, the full forward
and mean token cross-entropy with the MoE load-balance aux term (the JAX
``_kernel``'s no-pipe path and ``tail_loss``), plus `synthetic_batch`,
the FLOP and KV-cache accounting, `make_model` and `MODEL`; and the serving
path's prefill and single-token decode (`make_prefill_step`,
`make_decode_step`). The JAX package's scan over the stacked block params
becomes a Python loop over per-layer modules (`models.convert` splits a JAX
checkpoint's stacked ``(L, ...)`` params into them).

Dtypes follow the JAX package: f32 params; bf16 residual stream and matmuls
(both operands cast to bf16); f32 RMSNorm statistics; f32 LM head and f32
cross-entropy. GELU is the tanh form (``jax.nn.gelu`` defaults to
``approximate=True``) and RMSNorm's eps is 1e-6 inside the rsqrt.

``remat=True`` checkpoints each block (``torch.utils.checkpoint``, the
counterpart of ``jax.checkpoint`` at block granularity): the forward keeps
only each block's input, and the backward runs the block's forward again,
the flash forward kernel included, before its backward.

The MoE FFN (`_moe_ffn`) computes the JAX package's ``_moe_ffn`` at one
expert shard: top-1 switch or top-k GShard routing (`_moe_route`), capacity
slots numbered over all first choices before any second choice, and the
load-balance aux from the first choices. Where the JAX package dispatches
and combines with a (k*T, E, C) one-hot and two einsums, `_moe_ffn` copies
each kept token row into its slot of an (E, C, D) buffer and gathers each
token's k slots back, times its bf16 gate, summed in f32 and rounded once:
each slot holds one token or zeros and each token reads at most k slots, so
the function is the same. `_moe_ffn_reference` keeps the einsum form as its
plain version.

On a `parallel.mesh.Mesh` the LM trains data-parallel: every param is
replicated, each rank's batch slice is sharded over ``batch_axis``, and the
module's loss is its slice's mean; the Trainer takes the mean over the
batch axes, as the JAX loss ``pmean``s over them, so the objective is the
mean over the global batch. Raise ``NotImplementedError`` until a later
slice: any sequence, tensor, pipeline or expert axis above 1 (ROADMAP
queue A item 5).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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
    #: per-block rematerialization (activation checkpointing)
    remat: bool = False
    #: attention through the flash kernels (`edl_tpu_torch.ops.
    #: flash_attention`) instead of the dense O(S^2) oracle
    flash: bool = True
    #: mixture-of-experts FFN: >0 replaces every block's dense FFN with
    #: ``moe_experts`` experts; 0 = dense FFN
    moe_experts: int = 0
    #: expert capacity = ceil(moe_top_k * tokens / moe_experts * this)
    moe_capacity_factor: float = 1.25
    #: experts per token: 1 = switch routing, >1 = GShard with renormalized
    #: gates (every first choice outranks any second choice for capacity)
    moe_top_k: int = 1
    #: the expert mesh axis; above 1 raises until a later slice
    expert_axis: str = "expert"
    #: weight of the switch load-balance aux (E * sum_e f_e * p_e a layer,
    #: averaged over the layers); 0 = off
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
    axes = axes or {}
    E, ep = cfg.moe_experts, axes.get(cfg.expert_axis, 1)
    if E > 0 and E % ep:
        raise ValueError(f"moe_experts={E} must be divisible by ep={ep}")
    if E > 0 and not 1 <= cfg.moe_top_k <= E:
        raise ValueError(f"moe_top_k={cfg.moe_top_k} must be in [1, moe_experts={E}]")
    for axis in (cfg.seq_axis, cfg.tp_axis, cfg.pp_axis, cfg.expert_axis):
        if axes.get(axis, 1) > 1:
            raise NotImplementedError(
                f"axis {axis!r} of size {axes[axis]}: sequence, tensor, pipeline "
                f"and expert parallelism are not ported yet (ROADMAP queue A item 5)")


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
    """One decoder block; params in the JAX package's per-layer shapes:
    wqkv (D, 3, H, Dh), bqkv (3, H, Dh), wo (H, Dh, D), and a dense FFN's
    win (D, F), wout (F, D) or, with ``moe_experts`` E > 0, the router
    (D, E) and the experts' w_up (E, D, F), b_up (E, F), w_down (E, F, D),
    b_down (E, D)."""

    def __init__(self, cfg: TransformerConfig, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        D, H, Dh, Fd, E = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.moe_experts
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
        if E > 0:
            self.router = param((D, E), 0.02)
            self.w_up = param((E, D, Fd), math.sqrt(2.0 / D))
            self.b_up = param((E, Fd))
            self.w_down = param((E, Fd, D), math.sqrt(1.0 / Fd))
            self.b_down = param((E, D))
        else:
            self.win = param((D, Fd), math.sqrt(2.0 / D))
            self.bin = param((Fd,))
            self.wout = param((Fd, D), math.sqrt(1.0 / Fd))
            self.bout = param((D,))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x: (B, S, D) bf16 -> (the block's output (B, S, D) bf16, the MoE
        layer's load-balance aux as an f32 scalar, or None for a dense FFN)."""
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
        if cfg.moe_experts > 0:
            o, aux = _moe_ffn(cfg, h, self)  # o: f32 holding bf16 values; no bias
            return x + o.to(torch.bfloat16), aux
        f = _gelu(h @ _bf16(self.win) + _bf16(self.bin))
        o = f @ _bf16(self.wout)
        return x + (o.float() + self.bout).to(torch.bfloat16), None


# -- mixture-of-experts FFN ----------------------------------------------------


def _moe_capacity(cfg: TransformerConfig, n_tokens: int) -> int:
    """Slots per expert, with the JAX package's float operations in its
    order (another order can move the ceil at a boundary)."""
    return max(1, math.ceil(cfg.moe_top_k * n_tokens / cfg.moe_experts
                            * cfg.moe_capacity_factor))


class MoERouting(NamedTuple):
    """`_moe_route`'s decisions for T tokens and k choices each. Rows of the
    (k*T,) fields are choice-major: row ``j * T + t`` is token t's (j+1)-th
    choice."""
    probs: torch.Tensor   # (T, E) f32 router softmax
    expert: torch.Tensor  # (k*T,) int64 chosen expert
    slot: torch.Tensor    # (k*T,) int64 capacity slot in that expert (may be >= C)
    keep: torch.Tensor    # (k*T,) bool: the slot is below the capacity C
    gate: torch.Tensor    # (k, T) f32: 0 for a dropped choice; renormalized if k > 1
    aux: torch.Tensor     # () f32 load-balance aux


def _moe_route(cfg: TransformerConfig, tok: torch.Tensor, router: torch.Tensor,
               capacity: int) -> MoERouting:
    """Routing shared by both forms of the MoE FFN (`edl_tpu/models/
    transformer.py:333-372`): an f32 router, the k choices as successive
    argmaxes (each masking the last choice out; ties go to the first
    expert, as ``jnp.argmax`` breaks them), capacity slots numbered by a
    cumsum over all first choices, then all second choices, tokens in
    row-major (B, S) order, and the gates. At k = 1 the gate is the raw
    router probability, the router's only gradient path besides the aux;
    at k > 1 the kept gates are renormalized in f32 with a 1e-9 floor."""
    E, k = cfg.moe_experts, cfg.moe_top_k
    probs = torch.softmax(tok.float() @ router, dim=-1)  # (T, E) f32
    remaining = probs.detach()  # argmax has no gradient
    experts, onehots, gates = [], [], []
    for _ in range(k):
        choice = torch.argmax(remaining, dim=-1)  # (T,)
        oh = F.one_hot(choice, E)
        experts.append(choice)
        onehots.append(oh)
        gates.append(probs.gather(1, choice[:, None])[:, 0])
        remaining = remaining.masked_fill(oh.bool(), 0.0)
    # switch load-balance aux on the first choices: E * sum_e f_e * p_e
    aux = E * torch.sum(onehots[0].float().mean(dim=0) * probs.mean(dim=0))
    expert = torch.cat(experts)  # (k*T,)
    # each choice's rank among its expert's choices: one 1-D scan over the
    # experts' runs of one-hots laid end to end (on CUDA a scan down the
    # (k*T, E) columns runs each column serially: 1.4 ms a layer at T 8192)
    seen = torch.cumsum(torch.cat(onehots).t().reshape(-1), dim=0).view(E, -1)
    before = torch.cat([seen.new_zeros(1), seen[:-1, -1]])  # choices of earlier experts
    slot = (seen - before[:, None]).gather(0, expert[None, :])[0] - 1
    keep = slot < capacity
    gate = torch.stack(gates) * keep.view(k, -1).float()  # (k, T)
    if k > 1:
        gate = gate / torch.clamp(gate.sum(dim=0, keepdim=True), min=1e-9)
    return MoERouting(probs, expert, slot, keep, gate, aux)


def _moe_experts(slots: torch.Tensor, blk: Block) -> torch.Tensor:
    """The E expert FFNs over their (E, C, D) bf16 slots, bf16 throughout:
    (slots @ w_up + b_up), tanh GELU, @ w_down + b_down."""
    up = torch.bmm(slots, _bf16(blk.w_up)) + _bf16(blk.b_up)[:, None, :]
    return torch.bmm(_gelu(up), _bf16(blk.w_down)) + _bf16(blk.b_down)[:, None, :]


def _moe_ffn(cfg: TransformerConfig, h: torch.Tensor, blk: Block):
    """The MoE FFN at one expert shard, index form: h (B, S, D) bf16 ->
    (out (B, S, D) f32 holding bf16 values, aux f32 scalar).

    Dispatch copies each kept choice's token row into its row of a zeroed
    (E*C, D) slot buffer (a dropped choice writes a spare row that is cut
    off); combine gathers each choice's slot row, scales it by the choice's
    bf16 gate and sums a token's k rows in f32, rounded once to bf16.
    Autograd gives the einsums' transposes: each slot's cotangent added
    into its token, a bf16-rounded cotangent for each gate, and nothing to
    an empty slot or a dropped choice. No (k*T, E, C) tensor is made, and
    nothing waits on the device."""
    B, S, D = h.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    T = B * S
    C = _moe_capacity(cfg, T)
    tok = h.reshape(T, D)
    r = _moe_route(cfg, tok, blk.router, C)
    dest = torch.where(r.keep, r.expert * C + r.slot, E * C)  # (k*T,)
    slots = tok.new_zeros(E * C + 1, D).index_copy(
        0, dest, tok.expand(k, T, D).reshape(k * T, D))[:E * C]
    down = _moe_experts(slots.view(E, C, D), blk).reshape(E * C, D)
    rows = down.index_select(0, torch.where(r.keep, dest, 0)).view(k, T, D)
    out = (rows.float() * r.gate.to(torch.bfloat16).float()[..., None]).sum(dim=0)
    return out.to(torch.bfloat16).float().reshape(B, S, D), r.aux


def _moe_ffn_reference(cfg: TransformerConfig, h: torch.Tensor, blk: Block):
    """The plain version of `_moe_ffn`: the JAX package's one-hot dispatch
    and combine einsums (`edl_tpu/models/transformer.py:357-397`) over the
    same routing. The combine's bf16 operands are multiplied and summed in
    f32 and rounded once, as the JAX package's bf16 einsum accumulates; the
    f32 einsum says so on any backend. It makes (k*T, E, C) tensors: a
    test and diagnostic path, not the model's."""
    B, S, D = h.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    T = B * S
    C = _moe_capacity(cfg, T)
    tok = h.reshape(T, D)
    r = _moe_route(cfg, tok, blk.router, C)
    pos = torch.where(F.one_hot(r.expert, E).bool(), r.slot[:, None], -1)  # (k*T, E)
    keep = (pos >= 0) & (pos < C)
    dispatch_all = (F.one_hot(torch.clamp(pos, 0, C - 1), C).to(torch.bfloat16)
                    * keep[..., None].to(torch.bfloat16))  # (k*T, E, C)
    dispatch = dispatch_all.view(k, T, E, C).sum(dim=0)  # (T, E, C)
    combine = (dispatch_all.view(k, T, E, C)
               * r.gate.to(torch.bfloat16)[:, :, None, None]).sum(dim=0)
    slots = torch.einsum("tec,td->ecd", dispatch, tok)  # (E, C, D)
    down = _moe_experts(slots, blk)
    out = torch.einsum("ecd,tec->td", down.float(), combine.float())
    return out.to(torch.bfloat16).float().reshape(B, S, D), r.aux


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
        aux_sum = None  # the MoE layers' aux, summed in layer order in f32
        for block in self.blocks:
            # blocks draw no randomness, so there is no RNG state to replay
            x, aux = (checkpoint(block, x, use_reentrant=False, preserve_rng_state=False)
                      if self.cfg.remat else block(x))
            if aux is not None:
                aux_sum = aux if aux_sum is None else aux_sum + aux
        # tail: final norm, f32 LM head, mean token cross-entropy (f32)
        h = _rmsnorm(x, self.lnf).float()
        logits = h @ self.head
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))
        if aux_sum is not None and self.cfg.moe_aux_weight > 0:
            # a per-layer mean: the weight over n_layers times the sum
            loss = loss + self.cfg.moe_aux_weight / self.cfg.n_layers * aux_sum
        return loss


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


# -- LM serving: prefill / single-token decode --------------------------------
#
# The JAX package's serving functions (`edl_tpu/models/transformer.py:
# 625-760`), as plain functions of a `TransformerLM` and int32 tensors:
#
# - **prefill** — the prompt's full causal forward, shaped (batch bucket,
#   seq bucket). It returns the per-layer K/V it computed, so decode never
#   re-touches prompt tokens, plus the prompt's next token.
# - **decode** — one token per step: each call reads the whole K/V cache
#   once and returns the new position's K/V, shaped (L, B, H, Dh), for the
#   caller to write at ``lengths``; the serving engine owns the cache.
#
# They do not reuse `Block.forward`: its attention rounds P to bf16 before
# P·V (the flash kernel or `dense_attention`), where the JAX prefill keeps
# scores, softmax and P·V in f32 with a -inf mask, and decode puts the
# self-score after the masked cache scores. Greedy tokens flip on such
# differences, so these follow the JAX lines exactly — matmuls in bf16,
# norms, softmax and logits in f32 — and round where XLA rounds them on the
# JAX package's CPU reference: the GELU op by op (`_gelu_ops`), and the
# second norm of a block on the unrounded residual sum (`_ffn_residual`).
# Dense FFN only, as in the JAX package.


def lm_cache_shape(cfg: TransformerConfig) -> Tuple[int, int, int]:
    """(n_layers, n_heads, head_dim): the per-token K/V geometry."""
    return (cfg.n_layers, cfg.n_heads, cfg.head_dim)


def lm_cache_bytes_per_token(cfg: TransformerConfig) -> int:
    """Device bytes one token slot of K+V occupies (bf16 cache)."""
    L, H, Dh = lm_cache_shape(cfg)
    return 2 * L * H * Dh * 2  # K and V, 2 bytes each (bfloat16)


def _check_lm_servable(cfg: TransformerConfig) -> None:
    if cfg.moe_experts > 0:
        raise NotImplementedError(
            "LM serving path covers dense FFN configs only (MoE decode "
            "needs the expert all_to_all plumbed through the cache path)")


def _gelu_ops(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s tanh form as XLA evaluates it on the JAX package's
    CPU reference: op by op in the input dtype, each op rounded to it, with
    its two constants rounded to it too. In bf16 it is bit for bit the JAX
    package's, where the fused `_gelu` (one rounding) differs in about 40 %
    of the elements by one unit, enough to flip near-tied greedy tokens."""
    # the constants as Python floats holding their rounded values: no
    # host-to-device copy a call
    c1 = torch.tensor(0.044715, dtype=x.dtype).item()
    c2 = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype).item()
    inner = c2 * (x + c1 * (x * x * x))
    return x * (0.5 * (1 + torch.tanh(inner)))


def _attn_residual(x: torch.Tensor, attn: torch.Tensor, blk: Block) -> torch.Tensor:
    """x + the attention output projected by ``wo``, as the f32 sum of the
    two bf16 terms: attn (..., H, Dh) bf16, x (..., D) bf16."""
    H, Dh, D = blk.wo.shape
    out = attn.reshape(*attn.shape[:-2], H * Dh) @ _bf16(blk.wo).reshape(H * Dh, D)
    return x.float() + (out.float() + blk.bo).to(torch.bfloat16).float()


def _ffn_residual(xf: torch.Tensor, blk: Block) -> torch.Tensor:
    """The block's second half on the f32 sum ``xf`` of the first: the
    residual stream is ``xf`` rounded to bf16, but the RMSNorm reads ``xf``
    itself, as XLA evaluates the JAX package's block (its excess-precision
    rewrite drops the bf16 round trip between the sum and the norm's f32
    cast). Returns the block's output, bf16."""
    h = _rmsnorm(xf, blk.ln2).to(torch.bfloat16)
    f = _gelu_ops(h @ _bf16(blk.win) + _bf16(blk.bin))
    o = f @ _bf16(blk.wout)
    return xf.to(torch.bfloat16) + (o.float() + blk.bout).to(torch.bfloat16)


def _qkv(h: torch.Tensor, blk: Block) -> torch.Tensor:
    """(..., D) bf16 -> (..., 3, H, Dh) bf16."""
    D, _, H, Dh = blk.wqkv.shape
    qkv = (h @ _bf16(blk.wqkv).reshape(D, 3 * H * Dh)).reshape(*h.shape[:-1], 3, H, Dh)
    return qkv + _bf16(blk.bqkv)


def _decode_attention(q, k_cache, v_cache, k_new, v_new, lengths, scale):
    """One token's attention over its cache plus itself.

    q/k_new/v_new: (B, H, Dh) bf16; caches (B, C, H, Dh) bf16; lengths
    (B,) = tokens already IN the cache (the new token's position). Cache
    positions >= length are dead slots and are masked out; the new token
    always attends to itself."""
    C = k_cache.shape[1]
    qf = q.float()
    scores = torch.einsum("bhe,bche->bhc", qf, k_cache.float()) * scale
    valid = torch.arange(C, device=q.device)[None, :] < lengths[:, None]  # (B, C)
    scores = torch.where(valid[:, None, :], scores, -math.inf)
    self_score = torch.sum(qf * k_new.float(), dim=-1)[..., None] * scale  # (B, H, 1)
    w = torch.softmax(torch.cat([scores, self_score], dim=-1), dim=-1)
    out = (torch.einsum("bhc,bche->bhe", w[..., :C], v_cache.float())
           + w[..., C:] * v_new.float())
    return out.to(torch.bfloat16)


def make_decode_step(cfg: TransformerConfig):
    """Single-token decode: (module, k_cache, v_cache, tokens, lengths) ->
    (next_tokens, k_new, v_new).

    Shapes: caches (L, B, C, H, Dh) bf16 — C is the stream's seq-bucket
    capacity; ``tokens`` (B,) the last emitted token ids; ``lengths`` (B,)
    the token count already cached (== the new token's position). Returns
    greedy-argmax next tokens (B,) int32 and the new position's per-layer
    K/V (L, B, H, Dh) bf16 for the caller to write at index ``lengths``.
    """
    _check_lm_servable(cfg)
    scale = 1.0 / math.sqrt(cfg.head_dim)

    @torch.no_grad()
    def step(module: "TransformerLM", k_cache, v_cache, tokens, lengths):
        lengths = lengths.long()
        x = (module.embed[tokens.long()] + module.pos[lengths]).to(torch.bfloat16)  # (B, D)
        k_out, v_out = [], []
        for i, blk in enumerate(module.blocks):
            qkv = _qkv(_rmsnorm(x, blk.ln1), blk)  # (B, 3, H, Dh)
            q, k_new, v_new = qkv[:, 0], qkv[:, 1], qkv[:, 2]
            attn = _decode_attention(q, k_cache[i], v_cache[i], k_new, v_new,
                                     lengths, scale)
            x = _ffn_residual(_attn_residual(x, attn, blk), blk)
            k_out.append(k_new)
            v_out.append(v_new)
        logits = _rmsnorm(x, module.lnf).float() @ module.head
        return (torch.argmax(logits, dim=-1).int(), torch.stack(k_out),
                torch.stack(v_out))

    return step


def _prefill_forward(module: "TransformerLM", tokens: torch.Tensor):
    """The prefill's causal forward over (B, S) tokens: the final residual
    stream (B, S, D) bf16 and the per-layer K and V, each (L, B, S, H, Dh)
    bf16. Scores, softmax and P·V in f32 with a -inf causal mask."""
    B, S = tokens.shape
    Dh = module.cfg.head_dim
    scale = 1.0 / math.sqrt(Dh)
    pos = torch.arange(S, device=tokens.device)
    x = (module.embed[tokens.long()] + module.pos[pos]).to(torch.bfloat16)
    causal = pos[None, :] <= pos[:, None]  # (S, S) keys <= queries
    ks, vs = [], []
    for blk in module.blocks:
        qkv = _qkv(_rmsnorm(x, blk.ln1), blk)  # (B, S, 3, H, Dh)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        scores = torch.einsum("bshe,bthe->bhst", q.float(), k.float()) * scale
        scores = torch.where(causal, scores, -math.inf)
        w = torch.softmax(scores, dim=-1)
        attn = torch.einsum("bhst,bthe->bshe", w, v.float()).to(torch.bfloat16)
        x = _ffn_residual(_attn_residual(x, attn, blk), blk)
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs)


def prefill_logits(module: "TransformerLM", tokens: torch.Tensor) -> torch.Tensor:
    """f32 next-token logits (B, S, V) at every position of the prefill's
    forward: teacher-forced scoring of a whole sequence in one call."""
    with torch.no_grad():
        x, _, _ = _prefill_forward(module, tokens)
        return _rmsnorm(x, module.lnf).float() @ module.head


def make_prefill_step(cfg: TransformerConfig):
    """Prompt prefill: (module, tokens, lengths) -> (next_tokens, k_cache,
    v_cache).

    ``tokens`` (B, S) right-padded int32 prompts, ``lengths`` (B,) real
    token counts. Full causal attention over the padded bucket (pad
    positions compute dead K/V the decode mask never reads); returns the
    per-layer K/V for all S positions as (L, B, S, H, Dh) bf16 and the
    greedy next token read at position ``clip(lengths - 1, 0, S - 1)``.
    """
    _check_lm_servable(cfg)

    @torch.no_grad()
    def step(module: "TransformerLM", tokens, lengths):
        B, S = tokens.shape
        x, k_cache, v_cache = _prefill_forward(module, tokens)
        last = torch.clamp(lengths.long() - 1, 0, S - 1)
        h_last = x[torch.arange(B, device=x.device), last]  # (B, D)
        logits = _rmsnorm(h_last, module.lnf).float() @ module.head
        return torch.argmax(logits, dim=-1).int(), k_cache, v_cache

    return step


def make_model(cfg: Optional[TransformerConfig] = None, **overrides) -> Model:
    cfg = cfg or TransformerConfig(**overrides)
    _check(cfg, None)
    return Model(
        name="transformer",
        build=lambda device=None, generator=None, mesh=None: TransformerLM(
            cfg, device=device, generator=generator,
            axes=None if mesh is None else mesh.shape),
        synthetic_batch=lambda rng, bs: synthetic_batch(cfg, rng, bs),
        label_keys=("targets",),
        config=cfg,
        flops_per_step=lambda bs: _flops_per_step(cfg, bs),
    )


#: default zoo instance, the JAX package's default config
MODEL = make_model()
