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

On a `parallel.mesh.Mesh` (``make_model(cfg).build(mesh=mesh)``, as the
Trainer builds it) every mesh axis of the JAX package runs, alone or
composed, as its ``shard_map`` kernel does on local shards:

- ``data`` (``batch_axis``): each rank's batch rows;
- ``seq``: each rank's sequence chunk (global positions for the position
  embedding) and ring attention over the axis
  (`parallel.ring_attention`), the flash kernels as its per-hop engine;
- ``model``: Megatron tensor parallelism, local heads ``H/tp`` and local
  ``d_ff/tp``, a `parallel.collective.psum` after ``wo`` and after
  ``wout``;
- ``pipe``: the rank builds only its stage's layers (contiguous, or
  chunk-major under `parallel.pipeline.interleaved_layout`) and runs GPipe,
  1F1B or interleaved 1F1B (`parallel.pipeline`), the MoE aux riding
  every schedule;
- ``expert``: each rank's experts, the (E, C, D) slot buffer's expert dim
  split over the axis by `parallel.collective.all_to_all` after the
  dispatch and put back before the combine (capacity per device group).

Blocks are named by their logical layer (``blocks.{i}``) on every rank,
so a stage's params carry their one-device names. `param_spec` gives
each param's shards (`models.base.Shard`), and `grad_axes` is every mesh
axis: the module returns its chunk's loss, the Trainer backpropagates it
over the world size and sums each gradient over the axes its param is not
sharded on, which is the JAX Trainer's gradient (the boundary rule of
``shard_map``'s transpose for a ``P()`` loss, with ``psum`` transposed to
``psum``).
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
from edl_tpu_torch.models.base import Shard
from edl_tpu_torch.parallel.collective import all_to_all, psum
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
    #: "gpipe", "1f1b" or "1f1b-interleaved" (`parallel.pipeline`)
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
    #: the mesh axis the experts are split over
    expert_axis: str = "expert"
    #: weight of the switch load-balance aux (E * sum_e f_e * p_e a layer,
    #: averaged over the layers); 0 = off
    moe_aux_weight: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _check(cfg: TransformerConfig, axes: Optional[Mapping[str, int]]) -> None:
    """The JAX package's config validation (``_init``), with its messages,
    against the mesh's axis sizes ``axes`` (None: one device)."""
    axes = axes or {}
    size = lambda name: int(axes.get(name, 1))  # noqa: E731
    tp = size(cfg.tp_axis)
    if cfg.n_heads % tp or cfg.d_ff % tp:
        raise ValueError(
            f"n_heads={cfg.n_heads} and d_ff={cfg.d_ff} must be divisible by tp={tp}")
    if cfg.seq_len % size(cfg.seq_axis):
        raise ValueError(f"seq_len={cfg.seq_len} must be divisible by "
                         f"sp={size(cfg.seq_axis)}")
    n_pp = size(cfg.pp_axis)
    if cfg.n_layers % n_pp:
        raise ValueError(f"n_layers={cfg.n_layers} must be divisible by pp={n_pp}")
    if cfg.pipeline_schedule not in ("gpipe", "1f1b", "1f1b-interleaved"):
        raise ValueError(
            f"unknown pipeline_schedule {cfg.pipeline_schedule!r}; "
            "expected 'gpipe', '1f1b' or '1f1b-interleaved'")
    v = cfg.virtual_stages
    if v < 1:
        raise ValueError(f"virtual_stages={v} must be >= 1")
    if v > 1 and cfg.pipeline_schedule != "1f1b-interleaved":
        raise ValueError(
            f"virtual_stages={v} requires pipeline_schedule="
            f"'1f1b-interleaved', got {cfg.pipeline_schedule!r}")
    if cfg.pipeline_schedule == "1f1b-interleaved" and n_pp > 1:
        if cfg.n_layers % (n_pp * v):
            raise ValueError(
                f"n_layers={cfg.n_layers} must be divisible by "
                f"pp*virtual_stages={n_pp * v} for the interleaved schedule")
        if v > 1 and (cfg.microbatches or n_pp) % n_pp:
            raise ValueError(
                f"microbatches={cfg.microbatches} must be divisible by "
                f"pp={n_pp} for the interleaved schedule (microbatches are "
                f"injected in groups of pp)")
    E, ep = cfg.moe_experts, size(cfg.expert_axis)
    if E > 0 and E % ep:
        raise ValueError(f"moe_experts={E} must be divisible by ep={ep}")
    if E > 0 and not 1 <= cfg.moe_top_k <= E:
        raise ValueError(f"moe_top_k={cfg.moe_top_k} must be in [1, moe_experts={E}]")


#: per-layer block params split over the tensor axis, and their dim (the
#: JAX package's ``_block_spec`` less its leading layer dim)
_TP_DIMS = {"wqkv": 2, "bqkv": 1, "wo": 0, "win": 1, "bin": 0, "wout": 0}
#: the experts' params, split over the expert axis on their expert dim
_EP_DIMS = {"w_up": 0, "b_up": 0, "w_down": 0, "b_down": 0}


class _Place:
    """Where this rank sits on the mesh for the LM: each parallel axis's
    size, this rank's index on it and its process group (None at size 1)."""

    def __init__(self, cfg: TransformerConfig, mesh):
        self.mesh = mesh

        def axis(name):
            n = int(mesh.shape.get(name, 1))
            return n, (mesh.axis_index(name) if n > 1 else 0), \
                (mesh.group(name) if n > 1 else None)

        self.tp, self.tp_index, self.tp_group = axis(cfg.tp_axis)
        self.sp, self.sp_index, _ = axis(cfg.seq_axis)
        self.pp, self.pp_index, _ = axis(cfg.pp_axis)
        self.ep, self.ep_index, self.ep_group = axis(cfg.expert_axis)
        if max(self.tp, self.sp, self.pp, self.ep) > 1 and not mesh.distributed:
            raise ValueError(f"{mesh}: tensor, sequence, pipeline and expert axes above "
                             "1 need a mesh over a process group (build_mesh)")
        v = cfg.virtual_stages if cfg.pipeline_schedule == "1f1b-interleaved" else 1
        #: chunks a rank holds, and the stacked storage order of the layers
        self.v = v if self.pp > 1 else 1
        self.layout = _layer_layout(cfg, self.pp)

    def cut(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of a per-layer block param drawn whole."""
        for dims, n, i in ((_TP_DIMS, self.tp, self.tp_index),
                           (_EP_DIMS, self.ep, self.ep_index)):
            if name in dims and n > 1:
                d = dims[name]
                size = t.shape[d] // n
                t = t.narrow(d, i * size, size)
        return t.contiguous()

    def layers(self) -> list:
        """The logical layers this rank holds, in its execution order."""
        L = len(self.layout)
        per = L // self.pp
        return [int(i) for i in self.layout[self.pp_index * per:(self.pp_index + 1) * per]]


def _layer_layout(cfg: TransformerConfig, pp: int) -> np.ndarray:
    """The stacked storage order of the layers: row p holds logical layer
    ``layout[p]`` (`interleaved_layout` for the interleaved schedule over
    a pipe axis, else the identity); pipe rank r holds rows ``[r*L/pp,
    (r+1)*L/pp)``."""
    from edl_tpu_torch.parallel.pipeline import interleaved_layout

    v = cfg.virtual_stages
    if cfg.pipeline_schedule == "1f1b-interleaved" and v > 1 and pp > 1:
        return interleaved_layout(cfg.n_layers, pp, v)
    return np.arange(cfg.n_layers)


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
                 device: torch.device, place: Optional[_Place] = None):
        super().__init__()
        D, H, Dh, Fd, E = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.moe_experts
        self.cfg = cfg
        self.place = place

        def param(name, shape, std=None):
            # drawn whole on the generator's device (the generator's
            # sequence is the one-device module's), then cut to this rank's
            # part
            t = (torch.randn(shape, generator=generator, device=generator.device) * std
                 if std is not None else torch.zeros(shape))
            if place is not None:
                t = place.cut(name, t)
            setattr(self, name, nn.Parameter(t.to(device)))

        self.ln1 = nn.Parameter(torch.ones(D, device=device))
        param("wqkv", (D, 3, H, Dh), math.sqrt(1.0 / D))
        param("bqkv", (3, H, Dh))
        param("wo", (H, Dh, D), math.sqrt(1.0 / D))
        param("bo", (D,))
        self.ln2 = nn.Parameter(torch.ones(D, device=device))
        if E > 0:
            param("router", (D, E), 0.02)
            param("w_up", (E, D, Fd), math.sqrt(2.0 / D))
            param("b_up", (E, Fd))
            param("w_down", (E, Fd, D), math.sqrt(1.0 / Fd))
            param("b_down", (E, D))
        else:
            param("win", (D, Fd), math.sqrt(2.0 / D))
            param("bin", (Fd,))
            param("wout", (Fd, D), math.sqrt(1.0 / Fd))
            param("bout", (D,))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x: (B, S, D) bf16 -> (the block's output (B, S, D) bf16, the MoE
        layer's load-balance aux as an f32 scalar, or None for a dense FFN).
        On a mesh: this rank's rows and sequence chunk, its heads and d_ff
        columns (summed over the tensor axis after ``wo`` and ``wout``), its
        experts."""
        cfg, place = self.cfg, self.place
        B, S, D = x.shape
        _, _, H, Dh = self.wqkv.shape  # this rank's heads
        tp_group = place.tp_group if place is not None else None
        h = _rmsnorm(x, self.ln1)
        qkv = (h @ _bf16(self.wqkv).reshape(D, 3 * H * Dh)).reshape(B, S, 3, H, Dh) \
            + _bf16(self.bqkv)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attn = _ring_attention_local(
            q, k, v, seq_axis=cfg.seq_axis, n_shards=place.sp if place else 1,
            causal=True, scale=1.0 / math.sqrt(Dh), flash=cfg.flash,
            mesh=place.mesh if place else None)  # (B, S, H, Dh)
        out = attn.reshape(B, S, H * Dh) @ _bf16(self.wo).reshape(H * Dh, D)
        x = x + (psum(out.float(), tp_group) + self.bo).to(torch.bfloat16)
        h = _rmsnorm(x, self.ln2)
        if cfg.moe_experts > 0:
            o, aux = _moe_ffn(cfg, h, self)  # o: f32 holding bf16 values; no bias
            return x + o.to(torch.bfloat16), aux
        f = _gelu(h @ _bf16(self.win) + _bf16(self.bin))
        o = f @ _bf16(self.wout)
        return x + (psum(o.float(), tp_group) + self.bout).to(torch.bfloat16), None


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
    """The MoE FFN, index form: h (B, S, D) bf16 -> (out (B, S, D) f32
    holding bf16 values, aux f32 scalar). Over an expert axis the slot
    buffer goes to the experts' ranks and back by `all_to_all` (the JAX
    package's two ``all_to_all``s), the capacity that of this rank's T
    tokens.

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
        0, dest, tok.expand(k, T, D).reshape(k * T, D))[:E * C].view(E, C, D)
    group = blk.place.ep_group if blk.place is not None else None
    if group is not None:
        # expert-major -> device-major: this rank keeps its E/ep experts'
        # slots from every rank, side by side on the slot dim
        slots = all_to_all(slots, group, 0, 1)  # (E/ep, ep*C, D)
    down = _moe_experts(slots, blk)
    if group is not None:
        down = all_to_all(down, group, 1, 0)  # back to (E, C, D)
    down = down.reshape(E * C, D)
    rows = down.index_select(0, torch.where(r.keep, dest, 0)).view(k, T, D)
    out = (rows.float() * r.gate.to(torch.bfloat16).float()[..., None]).sum(dim=0)
    return out.to(torch.bfloat16).float().reshape(B, S, D), r.aux


def _moe_ffn_reference(cfg: TransformerConfig, h: torch.Tensor, blk: Block):
    """The plain version of `_moe_ffn`: the JAX package's one-hot dispatch
    and combine einsums (`edl_tpu/models/transformer.py:357-397`) over the
    same routing. The combine's bf16 operands are multiplied and summed in
    f32 and rounded once, as the JAX package's bf16 einsum accumulates; the
    f32 einsum says so on any backend. It makes (k*T, E, C) tensors: a
    test and diagnostic path at one expert shard, not the model's."""
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
    returns the mean next-token cross-entropy, f32.

    ``mesh`` (a `parallel.mesh.Mesh`): this rank's part of the model (see
    the module docstring); its loss is the mean over its own rows and
    sequence chunk. Given the whole sequence, a rank cuts its chunk itself.
    The params are drawn from ``generator`` on its own device (default: a
    CPU generator seeded with 0): a CUDA generator draws them on the card,
    in a fraction of the host's time at billions of params, as other
    numbers than a CPU generator's."""

    def __init__(self, cfg: TransformerConfig, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__()
        _check(cfg, None if mesh is None else mesh.shape)
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        D, V = cfg.d_model, cfg.vocab_size
        self.cfg = cfg
        self.place = _Place(cfg, mesh) if mesh is not None else None
        #: ``max_stash`` of the last 1F1B schedule run (`parallel.pipeline`)
        self.pipeline_stats: dict = {}
        self.embed = nn.Parameter(
            (torch.randn((V, D), generator=g, device=g.device) * 0.02).to(device))
        self.pos = nn.Parameter(
            (torch.randn((cfg.seq_len, D), generator=g, device=g.device) * 0.02).to(device))
        if self.place is None:
            self.blocks = nn.ModuleList(Block(cfg, g, device) for _ in range(cfg.n_layers))
        else:
            # every layer is drawn, in order, so the generator gives each the
            # one-device module's params; a rank keeps its stage's, named by
            # their logical layer, in its execution order
            mine = set(self.place.layers())
            drawn = {}
            for i in range(cfg.n_layers):
                blk = Block(cfg, g, device if i in mine else torch.device("cpu"),
                            self.place)
                if i in mine:
                    drawn[i] = blk
            self.blocks = nn.ModuleList()
            for i in self.place.layers():
                self.blocks.add_module(str(i), drawn[i])
        self.lnf = nn.Parameter(torch.ones(D, device=device))
        self.head = nn.Parameter(
            (torch.randn((D, V), generator=g, device=g.device) * 0.02).to(device))

    def full_param_names(self) -> list:
        """The one-device module's param names, in its ``named_parameters``
        order (its own params first, then the blocks'): the order a whole
        optimizer state numbers them in."""
        leaves = MOE_LEAVES if self.cfg.moe_experts > 0 else DENSE_LEAVES
        return (["embed", "pos", "lnf", "head"]
                + [f"blocks.{i}.{n}" for i in range(self.cfg.n_layers) for n in leaves])

    def _run_blocks(self, blocks, x: torch.Tensor):
        """``blocks`` in order on x: (output, the MoE layers' aux summed in
        f32, or None)."""
        aux_sum = None
        for block in blocks:
            # blocks draw no randomness, so there is no RNG state to replay
            x, aux = (checkpoint(block, x, use_reentrant=False, preserve_rng_state=False)
                      if self.cfg.remat else block(x))
            if aux is not None:
                aux_sum = aux if aux_sum is None else aux_sum + aux
        return x, aux_sum

    def _tail(self, x: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """Final norm, f32 LM head, mean token cross-entropy (f32)."""
        h = _rmsnorm(x, self.lnf).float()
        logits = h @ self.head
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        cfg, place = self.cfg, self.place
        tokens, targets = batch["tokens"].long(), batch["targets"].long()
        sp_index = 0
        if place is not None and place.sp > 1:
            sp_index = place.sp_index
            if tokens.shape[1] == cfg.seq_len:  # the whole sequence: cut the chunk
                S = cfg.seq_len // place.sp
                tokens = tokens[:, sp_index * S:(sp_index + 1) * S]
                targets = targets[:, sp_index * S:(sp_index + 1) * S]
        S = tokens.shape[1]
        pos = sp_index * S + torch.arange(S, device=tokens.device)  # global positions
        x = (self.embed[tokens] + self.pos[pos]).to(torch.bfloat16)
        use_aux = cfg.moe_experts > 0 and cfg.moe_aux_weight > 0
        # a per-layer mean: the weight over n_layers times the sum
        aux_w = cfg.moe_aux_weight / cfg.n_layers if use_aux else 0.0
        if place is not None and place.pp > 1:
            return self._pipelined(x, targets, use_aux, aux_w)
        x, aux_sum = self._run_blocks(self.blocks, x)
        loss = self._tail(x, targets)
        if use_aux and aux_sum is not None:
            loss = loss + aux_w * aux_sum
        return loss

    def _pipelined(self, x, targets, use_aux: bool, aux_w: float) -> torch.Tensor:
        """The pipe path (the JAX ``_kernel``'s): 1F1B, plain or interleaved,
        with the tail inside the schedule; or GPipe, its output broadcast to
        every stage and the tail after it."""
        from edl_tpu_torch.parallel import pipeline

        cfg, place = self.cfg, self.place
        M = cfg.microbatches or place.pp
        blocks = list(self.blocks)

        def staged(bs, h):
            h, aux = self._run_blocks(bs, h)
            if not use_aux:
                return h
            return h, aux if aux is not None else torch.zeros((), device=h.device)

        if cfg.pipeline_schedule in ("1f1b", "1f1b-interleaved"):
            lc = len(blocks) // place.v
            chunks = [blocks[k * lc:(k + 1) * lc] for k in range(place.v)]
            return pipeline.pipeline_train_1f1b(
                lambda k, h: staged(chunks[k], h), self._tail, place.mesh, cfg.pp_axis,
                M, place.v, aux_w, [[p for b in c for p in b.parameters()] for c in chunks],
                [self.lnf, self.head], x, targets, stats=self.pipeline_stats)
        out = pipeline._pipeline_local(lambda h: staged(blocks, h), x, mesh=place.mesh,
                                       pipe_axis=cfg.pp_axis, n_stages=place.pp,
                                       microbatches=M, stage_aux=use_aux)
        x, aux = out if use_aux else (out, None)
        loss = self._tail(x, targets)
        return loss + aux_w * aux if use_aux else loss


def param_spec(cfg: TransformerConfig, mesh) -> Dict[str, Tuple[Shard, ...]]:
    """{param name: its shards} on ``mesh`` (JAX ``_block_spec`` per layer):
    every block param over the pipe axis is held by the stage that runs its
    layer; ``wqkv``, ``bqkv``, ``wo``, ``win``, ``bin``, ``wout`` split over
    the tensor axis; the experts over the expert axis. The embeddings, the
    final norm and the head are replicated."""
    size = lambda name: int(mesh.shape.get(name, 1))  # noqa: E731
    pp, tp, ep = size(cfg.pp_axis), size(cfg.tp_axis), size(cfg.expert_axis)
    names = MOE_LEAVES if cfg.moe_experts > 0 else DENSE_LEAVES
    layout = _layer_layout(cfg, pp)
    per = cfg.n_layers // pp
    spec: Dict[str, Tuple[Shard, ...]] = {}
    for row, layer in enumerate(layout):
        for name in names:
            shards = []
            if pp > 1:
                shards.append(Shard(cfg.pp_axis, None, row // per))
            if tp > 1 and name in _TP_DIMS:
                shards.append(Shard(cfg.tp_axis, _TP_DIMS[name]))
            if ep > 1 and name in _EP_DIMS:
                shards.append(Shard(cfg.expert_axis, _EP_DIMS[name]))
            if shards:
                spec[f"blocks.{int(layer)}.{name}"] = tuple(shards)
    return spec


#: a block's params, in module order: dense FFN and mixture of experts
DENSE_LEAVES = ("ln1", "wqkv", "bqkv", "wo", "bo", "ln2", "win", "bin", "wout", "bout")
MOE_LEAVES = ("ln1", "wqkv", "bqkv", "wo", "bo", "ln2", "router", "w_up", "b_up",
              "w_down", "b_down")


def batch_spec(cfg: TransformerConfig, mesh) -> Dict[str, tuple]:
    """JAX ``_batch_specs``: tokens and targets split over the batch axes on
    dim 0 and the sequence axis on dim 1."""
    sp = cfg.seq_axis if cfg.seq_axis in mesh.axis_names else None
    return {"tokens": (cfg.batch_axis, sp), "targets": (cfg.batch_axis, sp)}


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
            cfg, device=device, generator=generator, mesh=mesh),
        param_spec=lambda mesh: param_spec(cfg, mesh),
        # the JAX loss is P() out of its shard_map: every axis
        grad_axes=lambda mesh: tuple(mesh.axis_names),
        batch_spec=lambda mesh: batch_spec(cfg, mesh),
        synthetic_batch=lambda rng, bs: synthetic_batch(cfg, rng, bs),
        label_keys=("targets",),
        config=cfg,
        flops_per_step=lambda bs: _flops_per_step(cfg, bs),
    )


#: default zoo instance, the JAX package's default config
MODEL = make_model()
