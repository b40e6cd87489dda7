"""Flash attention: hand-written CUDA kernels for Hopper and their plain versions.

The port of `edl_tpu.ops.flash_attention`. The three Pallas TPU kernels (the
online-softmax forward and the two backward kernels) are CUDA C++ kernels in
``csrc/flash_attention.cu``, built for ``sm_90a`` at first use by `_build` and
called through ``ctypes``. Beside each kernel sits a plain PyTorch version of
the same function (`_fwd_reference`, `_bwd_reference`), with the same
global-position masking, the same ragged-edge masking and the same ``-1e30``
sentinel for rows that see no key.

Dispatch is by the tensors' device and nothing else: CPU tensors go through the
plain versions, CUDA tensors through the kernels, and a CUDA request the
kernels cannot serve raises. Nothing falls back.

The backward is the standard two-kernel flash recipe: the forward also emits
the per-row ``lse = m + log(l)``; the backward recomputes ``P = exp(S - lse)``
blockwise with ``delta = rowsum(dO * O) - dlse`` (plain PyTorch, as in the
JAX package, with dO in q's dtype: see `_backward_inputs`),
``dS = P * (dP - delta) * scale``, ``dQ = dS K``,
``dK = dSᵀ Q`` and ``dV = Pᵀ dO``. The lse cotangent ``dlse`` is what lets
the ring merge per-hop (out, lse) pairs and differentiate through both.

Layout at the boundary is the models' (B, S, H, D). The kernels read q, k and
v through their strides, so the slices of a fused (B, S, 3, H, D) projection
are not copied; outputs are contiguous (B, S, H, D), lse is (B, H, Sq) f32.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

__all__ = ["flash_attention"]

#: finite "masked" score: exp() of it is exactly 0.0 without nan risk
_NEG_INF = -1e30

#: the kernels' tile: query rows and key rows per thread block, fixed when
#: the CUDA source is compiled
TILE = 64

#: head dims the kernels are compiled for (even, at most 64)
MAX_HEAD_DIM = 64

#: kernel launches since the counts were last set to 0, one per kernel; each
#: wrapper adds one where it launches its kernel and nowhere else
LAUNCHES = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- plain PyTorch versions ----------------------------------------------------


def _valid(Sq: int, Sk: int, q_offset: int, k_offset: int, causal: bool,
           device) -> torch.Tensor:
    """(Sq, Sk) bool: key j visible to query i, in global positions."""
    if not causal:
        return torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    qpos = q_offset + torch.arange(Sq, device=device)
    kpos = k_offset + torch.arange(Sk, device=device)
    return kpos[None, :] <= qpos[:, None]


def _fwd_reference(q, k, v, *, scale: float, causal: bool, q_offset: int,
                   k_offset: int, out_dtype: torch.dtype
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in f32: (B, Sq, H, D) x 2 (B, Sk, H, D)
    -> o (B, Sq, H, D) in ``out_dtype``, lse (B, H, Sq) f32. A row that sees
    no key gets o = 0 and lse = ``_NEG_INF`` exactly."""
    valid = _valid(q.shape[1], k.shape[1], q_offset, k_offset, causal, q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where(valid, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)  # mask exp through valid
    l = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l > 0, l, 1.0)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / safe.permute(0, 2, 1, 3)
    lse = torch.where(l[..., 0] > 0, m[..., 0] + torch.log(safe[..., 0]), _NEG_INF)
    return o.to(out_dtype), lse


def _bwd_probs(q, k, v, do, lse, delta, *, scale, causal, q_offset, k_offset):
    """P and dS (B, H, Sq, Sk) f32, recomputed from lse as both backward
    kernels recompute them."""
    valid = _valid(q.shape[1], k.shape[1], q_offset, k_offset, causal, q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def _bwd_dq_reference(q, k, v, do, lse, delta, **opts) -> torch.Tensor:
    """The dq kernel's function in f32: dq in q's dtype. ``lse`` and
    ``delta`` are (B, H, Sq) f32."""
    _, ds = _bwd_probs(q, k, v, do, lse, delta, **opts)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def _bwd_dkv_reference(q, k, v, do, lse, delta, **opts
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dkv kernel's function in f32: (dk, dv) in the dtypes of k, v."""
    p, ds = _bwd_probs(q, k, v, do, lse, delta, **opts)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _bwd_reference(q, k, v, do, lse, delta, *, scale: float, causal: bool,
                   q_offset: int, k_offset: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both backward kernels' functions: (dq, dk, dv)."""
    opts = dict(scale=scale, causal=causal, q_offset=q_offset,
                k_offset=k_offset)
    dk, dv = _bwd_dkv_reference(q, k, v, do, lse, delta, **opts)
    return _bwd_dq_reference(q, k, v, do, lse, delta, **opts), dk, dv


# -- CUDA kernels ----------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_STRIDES = [_L] * 9  # batch, sequence and head strides of q, k and v
_SIGNATURES = {
    "edl_flash_fwd": [_P] * 5 + [_I] * 5 + _STRIDES
    + [_I, _I, ctypes.c_float, _I, _I, _P],
    "edl_flash_bwd_dq": [_P] * 7 + [_I] * 5 + _STRIDES
    + [_I, _I, ctypes.c_float, _I, _P],
    "edl_flash_bwd_dkv": [_P] * 8 + [_I] * 5 + _STRIDES
    + [_I, _I, ctypes.c_float, _I, _P],
}
_lib: Optional[ctypes.CDLL] = None


def _kernels() -> ctypes.CDLL:
    """The kernel library (built at first use) with its C signatures set."""
    global _lib
    if _lib is None:
        from edl_tpu_torch.ops import _build

        lib = _build.load()
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I
        lib.edl_cuda_error_string.argtypes = [_I]
        lib.edl_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(rc: int, kernel: str) -> None:
    if rc != 0:
        msg = _kernels().edl_cuda_error_string(rc).decode()
        raise RuntimeError(f"flash attention {kernel} kernel launch failed: "
                           f"CUDA error {rc} ({msg})")


def _check_kernel_inputs(q, k, v) -> None:
    """Raise on any request the kernels do not take."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name} is on {x.device}; the kernels need q, k "
                             f"and v on one CUDA device")
        if x.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"{name} is {x.dtype}; the CUDA kernels take bfloat16 only")
        if x.stride(3) != 1 or any(s % 2 for s in x.stride()[:3]) \
                or x.data_ptr() % 4:
            raise ValueError(
                f"{name} has strides {x.stride()}: the kernels read pairs of "
                f"bf16, so D needs unit stride and the other strides and the "
                f"start must be even")
    D = q.shape[3]
    if D % 2 or D > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"head_dim {D}: the kernels take even head dims up to "
            f"{MAX_HEAD_DIM}")
    B, H = q.shape[0], q.shape[2]
    tiles = -(-max(q.shape[1], k.shape[1]) // TILE)
    if B * H * tiles >= 2**31:
        raise ValueError("too many (batch, head, tile) blocks for one launch")


def _strides(*xs) -> list:
    return [s for x in xs for s in x.stride()[:3]]


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _fwd_kernel(q, k, v, *, scale, causal, q_offset, k_offset, out_dtype):
    _check_kernel_inputs(q, k, v)
    B, Sq, H, D = q.shape
    o = torch.empty((B, Sq, H, D), dtype=out_dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    rc = _kernels().edl_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, H, Sq, k.shape[1], D, *_strides(q, k, v), q_offset, k_offset,
        scale, int(causal), int(out_dtype == torch.float32), _stream(q))
    _check(rc, "fwd")
    LAUNCHES["fwd"] += 1
    return o, lse


def _bwd_args(q, k, v, do, lse, delta):
    _check_kernel_inputs(q, k, v)
    if do.dtype != torch.bfloat16 or do.shape != q.shape:
        raise NotImplementedError(
            f"dO is {do.dtype} {tuple(do.shape)}; the kernels take a bf16 dO "
            f"of q's shape {tuple(q.shape)}")
    return do.contiguous(), lse.contiguous(), delta.contiguous()


def _bwd_dq_kernel(q, k, v, do, lse, delta, *, scale, causal, q_offset,
                   k_offset):
    do, lse, delta = _bwd_args(q, k, v, do, lse, delta)
    B, Sq, H, D = q.shape
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    rc = _kernels().edl_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        B, H, Sq, k.shape[1], D, *_strides(q, k, v), q_offset, k_offset,
        scale, int(causal), _stream(q))
    _check(rc, "bwd_dq")
    LAUNCHES["bwd_dq"] += 1
    return dq


def _bwd_dkv_kernel(q, k, v, do, lse, delta, *, scale, causal, q_offset,
                    k_offset):
    do, lse, delta = _bwd_args(q, k, v, do, lse, delta)
    B, Sq, H, D = q.shape
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    rc = _kernels().edl_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, H, Sq, k.shape[1], D, *_strides(q, k, v), q_offset, k_offset,
        scale, int(causal), _stream(q))
    _check(rc, "bwd_dkv")
    LAUNCHES["bwd_dkv"] += 1
    return dk, dv


def _bwd_kernel(q, k, v, do, lse, delta, **opts):
    dq = _bwd_dq_kernel(q, k, v, do, lse, delta, **opts)
    return (dq, *_bwd_dkv_kernel(q, k, v, do, lse, delta, **opts))


def _route(x: torch.Tensor, plain, kernel):
    if x.device.type == "cuda":
        return kernel
    if x.device.type == "cpu":
        return plain
    raise ValueError(f"flash attention runs on CUDA or the CPU, not {x.device}")


# -- autograd ------------------------------------------------------------------


def _backward_inputs(q, o, do, dlse) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dO, delta) for both backward versions, from the cotangents of o and lse.

    dL/ds_ij = p_ij (dp_ij - delta_i) for the out path PLUS p_ij dlse_i for
    the lse path: the lse cotangent folds into delta = rowsum(dO * O) - dlse
    with a sign flip. dO is taken in q's dtype on either device: the kernels
    read bf16, so the f32 dO of the lse path is rounded, and delta is formed
    from that same dO. dP - delta then cancels as in exact arithmetic (to
    dlse for a row that sees one key), where a delta from the unrounded dO
    would leave dP's rounding error in dS.
    """
    do = do.to(q.dtype)
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2) - dlse.float()
    return do, delta  # delta: (B, H, Sq) f32



class _Flash(torch.autograd.Function):
    """Counterpart of the JAX package's ``_flash`` custom VJP: outputs
    (o, lse), differentiable through both."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, q_offset, k_offset, out_dtype):
        opts = dict(scale=scale, causal=causal, q_offset=q_offset,
                    k_offset=k_offset)
        fwd = _route(q, _fwd_reference, _fwd_kernel)
        o, lse = fwd(q, k, v, out_dtype=out_dtype, **opts)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = opts
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do, delta = _backward_inputs(q, o, do, dlse)
        bwd = _route(q, _bwd_reference, _bwd_kernel)
        dq, dk, dv = bwd(q, k, v, do, lse, delta, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
    k_offset: int = 0,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    return_lse: bool = False,
):
    """Blockwise-online attention. q: (B, Sq, H, D); k/v: (B, Sk, H, D).

    ``q_offset``/``k_offset`` are the GLOBAL positions of row 0: causality is
    evaluated in global coordinates, as the ring layer needs. With
    ``return_lse=True`` returns ``(out, lse)``: out stays f32 so ring hops
    merge at accumulator precision, lse is (B, H, Sq) f32 with rows that see
    no key at the finite ``_NEG_INF`` sentinel; gradients flow through both.

    ``block_q``/``block_k`` may name the kernels' tile (`TILE`) or be left
    out; the CUDA tiles are compile-time constants, so any other value raises
    ``NotImplementedError``.
    """
    for name, blk in (("block_q", block_q), ("block_k", block_k)):
        if blk is not None and blk != TILE:
            raise NotImplementedError(
                f"{name}={blk}: the kernels' tile is fixed at {TILE}")
    B, Sq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if Sq == 0 or k.shape[1] == 0:
        raise ValueError("flash attention needs at least one query and key")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    out_dtype = torch.float32 if return_lse else q.dtype
    o, lse = _Flash.apply(q, k, v, scale, bool(causal), int(q_offset),
                          int(k_offset), out_dtype)
    return (o, lse) if return_lse else o
