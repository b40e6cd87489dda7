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
kernels cannot serve raises. Nothing falls back. The kernels take bf16, f16
and f32 at any head dim: bf16 and f16 through the wgmma kernels
(``flash_kernels.cuh`` up to 256; past 256 the sliced kernels of
``flash_sliced.cuh``, whose blocks each own a slice of the output's columns
and sum the scores over 64-column chunks of the head dim), f32 through the
f32 kernels, all three on the tensor cores in 3xTF32 (``flash_*_f32.cu`` up
to 256, a block owning all D columns of its output; ``flash_*_f32_sliced.cu``
past it, a block owning a slice of them). What their loads cannot
read, the wrapper first makes readable, on either device: a head dim that
is not a multiple of 8 is zero-padded (zero columns change no score; the
outputs are sliced back), and a view that TMA cannot read is copied to a
contiguous one.

The forward's tile (``block_q`` query rows a block, ``block_k`` keys a stage)
comes from the tile table (`flash_tuning.lookup`) unless the caller pins it;
a pinned tile must be one the kernels were compiled for (`compiled_blocks`).

The backward is the standard two-kernel flash recipe: the forward also emits
the per-row ``lse = m + log(l)``; the backward recomputes ``P = exp(S - lse)``
blockwise with ``delta = rowsum(dO * O) - dlse`` (plain PyTorch, as in the
JAX package, with dO in q's dtype: see `_backward_inputs`),
``dS = P * (dP - delta) * scale``, ``dQ = dS K``,
``dK = dSᵀ Q`` and ``dV = Pᵀ dO``. The lse cotangent ``dlse`` is what lets
the ring merge per-hop (out, lse) pairs and differentiate through both.
The ring's hops have an f32 out, so their dO is f32, where the kernels read
q's dtype: for 16-bit q the backward then runs twice, on dO's part in q's
dtype and on the rounding of what that part leaves out (each pass with its
own delta, the function being linear in (dO, delta)), and adds the two: the
JAX kernels' f32 dO to within a rounding of the remainder.

Layout at the boundary is the models' (B, S, H, D). The kernels read q, k and
v through their strides, so the slices of a fused (B, S, 3, H, D) projection
are not copied; outputs are contiguous (B, S, H, D), lse is (B, H, Sq) f32.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from edl_tpu_torch.ops import flash_tuning

__all__ = ["flash_attention"]

#: finite "masked" score: exp() of it is exactly 0.0 without nan risk
_NEG_INF = -1e30

#: the rows one warpgroup owns in every 16-bit kernel (wgmma's 64-row M),
#: the keys a dkv block owns and the query tile it streams, and the sliced
#: dq's rows a block past a padded head dim of 256; the f32 kernels' forward
#: tile is TILE x TILE
TILE = 64

#: the padded head dims the 16-bit kernels are compiled for up to 256; past
#: it the sliced kernels take any multiple of 8, padded to one of `CHUNK`
_PADDED = (16, 32, 64, 128, 192, 256)

#: past a padded head dim of 256 (the sliced kernels, every dtype): the
#: head-dim columns of a chunk of the scores' sum in 16 bits, and the output
#: columns one block owns, by kernel (dkv: of dK and of dV), in bf16 and f16
#: (``csrc/flash_sliced.cuh``: dq's and dkv's two consumer warpgroups sum
#: 256 columns each, dq's of dQ, dkv's one of dK and dV; the forward's
#: consumers split the block's 128 rows) and in f32
#: (``csrc/flash_*_f32_sliced.cu``, whose consumer warpgroups split the
#: columns as the 16-bit dq and dkv do: the forward's and dq's 256 each, so
#: one block sums a row's scores once up to D 512; up to 256,
#: ``csrc/flash_*_f32.cu``, a block owns all D columns)
CHUNK = 64
SLICE_COLUMNS = {"fwd": 256, "bwd_dq": 512, "bwd_dkv": 256}
SLICE_COLUMNS_F32 = {"fwd": 512, "bwd_dq": 512, "bwd_dkv": 256}

#: the element types the kernels take, with the C interface's codes
_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}

#: kernel launches since the counts were last set to 0, one per kernel, every
#: variant under its kernel's name; each wrapper adds one where it launches
#: its kernel and nowhere else
LAUNCHES = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}

#: the same launches by variant: (kernel, dtype name, padded head dim, how
#: the call was cut) -> launches. The fourth field is the forward's keys a
#: stage, or None for the backward, up to a padded head dim of 256; past it,
#: the column slices of the call's one launch (`column_slices`, such as
#: ``"2x256"``). Every call is one CUDA launch
VARIANT_LAUNCHES: Dict[Tuple[str, str, int, object], int] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    VARIANT_LAUNCHES.clear()


def _count(kernel: str, dtype: torch.dtype, head_dim: int, block_k: Optional[int] = None) -> None:
    LAUNCHES[kernel] += 1
    key = (kernel, flash_tuning.dtype_name(dtype), padded_head_dim(head_dim),
           column_slices(kernel, head_dim, dtype) or block_k)
    VARIANT_LAUNCHES[key] = VARIANT_LAUNCHES.get(key, 0) + 1


def padded_head_dim(head_dim: int) -> int:
    """The head dim the kernels are compiled for that serves ``head_dim`` (a
    multiple of 8): 16, 32, 64, 128, 192 or 256; past 256, ``head_dim``
    rounded up to a multiple of `CHUNK` (264 -> 320, 520 -> 576), which the
    sliced kernels read at run time."""
    if head_dim > _PADDED[-1]:
        return -(-head_dim // CHUNK) * CHUNK
    return next(dp for dp in _PADDED if head_dim <= dp)


def slice_columns(kernel: str, dtype: torch.dtype) -> int:
    """The output columns one block of ``kernel``'s sliced form owns in
    ``dtype`` (`SLICE_COLUMNS`, `SLICE_COLUMNS_F32`)."""
    return (SLICE_COLUMNS_F32 if dtype == torch.float32 else SLICE_COLUMNS)[kernel]


def column_slices(kernel: str, head_dim: int,
                  dtype: torch.dtype = torch.bfloat16) -> Optional[str]:
    """How one launch of ``kernel`` in ``dtype`` cuts the output's columns,
    as `VARIANT_LAUNCHES` names it: past a padded head dim of 256,
    ``"NxW"``, N blocks a row tile each owning W columns (`slice_columns`;
    the last slice short where W does not divide the padded head dim:
    ``csrc/flash_sliced.cuh``, ``csrc/flash_*_f32_sliced.cu``); else
    None."""
    dp = padded_head_dim(head_dim)
    if dp <= _PADDED[-1]:
        return None
    width = slice_columns(kernel, dtype)
    return f"{-(-dp // width)}x{width}"


def compiled_blocks(head_dim: int, dtype: torch.dtype) -> Tuple[Tuple[int, int], ...]:
    """The forward tiles (block_q, block_k) compiled for this head dim and
    dtype, the default first (``csrc/flash_attention.cu`` has the table):
    bf16 and f16 at 128 query rows a block (two consumer warpgroups) and 64
    keys a stage at every head dim (past 256 the sliced forward), bf16 also
    at 128 keys at padded head dims 64 and 128; f32 at 64 x 64. None for a
    dtype the kernels do not take."""
    dp = padded_head_dim(head_dim)
    if dtype == torch.float32:
        return ((TILE, TILE),)
    if dtype in (torch.bfloat16, torch.float16) and dp > 128:
        return (flash_tuning.DEFAULT_BLOCKS,)
    if dtype == torch.bfloat16 and head_dim > 32:
        return (flash_tuning.DEFAULT_BLOCKS, (128, 128))
    if dtype in (torch.bfloat16, torch.float16):
        return (flash_tuning.DEFAULT_BLOCKS,)
    return ()


def resolve_blocks(seq_len: int, head_dim: int, dtype: torch.dtype,
                   block_q: Optional[int] = None, block_k: Optional[int] = None
                   ) -> Tuple[int, int]:
    """The forward's tile for a request: what the caller pinned, the rest
    from the tile table (`flash_tuning.lookup`, by key length, head dim and
    dtype), or this variant's default where the table names a tile that is
    not compiled for it. Raises ``NotImplementedError`` for a tile outside
    the compiled set, on either device."""
    compiled = compiled_blocks(head_dim, dtype)
    pinned = (block_q, block_k)
    if block_q is None or block_k is None:
        tuned = flash_tuning.lookup(seq_len, head_dim, dtype)
        if compiled and tuned not in compiled:
            tuned = compiled[0]
        block_q = tuned[0] if block_q is None else block_q
        block_k = tuned[1] if block_k is None else block_k
    if (block_q, block_k) in compiled or (not compiled and pinned == (None, None)):
        return block_q, block_k
    raise NotImplementedError(
        f"(block_q, block_k) = ({block_q}, {block_k}): the kernels for head dim "
        f"{head_dim} in {flash_tuning.dtype_name(dtype)} are compiled for "
        f"{list(compiled)}")


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
_SIGNATURES = {  # ... offsets, scale, causal, [out_f32,] dtype, [block_k,] stream
    "edl_flash_fwd": [_P] * 5 + [_I] * 5 + _STRIDES
    + [_I, _I, ctypes.c_float, _I, _I, _I, _I, _P],
    "edl_flash_bwd_dq": [_P] * 7 + [_I] * 5 + _STRIDES
    + [_I, _I, ctypes.c_float, _I, _I, _P],
    "edl_flash_bwd_dkv": [_P] * 8 + [_I] * 5 + _STRIDES
    + [_I, _I, ctypes.c_float, _I, _I, _P],
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


def _view_problem(shape, strides, itemsize: int, ptr: int) -> Optional[str]:
    """Why the kernels cannot read a (B, S, H, D) view of this layout, or
    None if they can. The 16-bit kernels load q, k and v by TMA: unit stride
    along D, a start aligned to 16 bytes, byte strides that are multiples of
    16, and a head dim that is a multiple of 8 (rows of 16-byte multiples);
    the f32 kernels are held to the same. The wrapper pads or copies
    whatever this refuses (`_kernel_layout`)."""
    D = shape[3]
    if D % 8 or D <= 0:
        return f"head_dim {D}: the kernels take head dims that are multiples of 8"
    return _layout_problem(strides, itemsize, ptr)


def _layout_problem(strides, itemsize: int, ptr: int) -> Optional[str]:
    """`_view_problem`'s layout part: why TMA cannot read a view with these
    strides from this start, or None."""
    if strides[3] != 1:
        return f"strides {tuple(strides)}: D needs unit stride"
    if any(s * itemsize % 16 for s in strides[:3]):
        return (f"strides {tuple(strides)} (elements of {itemsize} bytes): "
                f"TMA needs byte strides that are multiples of 16")
    if ptr % 16:
        return f"start address {ptr:#x}: TMA needs a 16-byte aligned start"
    return None


def _kernel_layout(q, k, v):
    """q, k and v as the kernels read them: a head dim that is not a multiple
    of 8 zero-padded up to one (zero columns change no score; the caller
    slices the outputs back), and a view whose layout TMA cannot read (a
    start not aligned to 16 bytes, byte strides that are not multiples of 16,
    a head-dim stride other than 1) copied to a contiguous one. Done on
    either device, outside the autograd function, so autograd carries the
    pad and the copy."""
    pad = -q.shape[3] % 8
    out = []
    for x in (q, k, v):
        if pad:
            x = F.pad(x, (0, pad))
        elif _layout_problem(x.stride(), x.element_size(), x.data_ptr()):
            x = x.clone(memory_format=torch.contiguous_format)
        out.append(x)
    return out


def _check_kernel_inputs(q, k, v) -> None:
    """Raise on any request the kernels do not take."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name} is on {x.device}; the kernels need q, k "
                             f"and v on one CUDA device")
        if x.dtype not in _DTYPES or x.dtype != q.dtype:
            raise NotImplementedError(
                f"{name} is {x.dtype} (q {q.dtype}); the CUDA kernels take q, k "
                f"and v of one dtype of {[str(t) for t in _DTYPES]}")
        problem = _view_problem(x.shape, x.stride(), x.element_size(),
                                x.data_ptr())
        if problem is not None:
            raise NotImplementedError(f"{name}: {problem}")
    B, H = q.shape[0], q.shape[2]
    tiles = -(-max(q.shape[1], k.shape[1]) // TILE)
    # past a padded head dim of 256 a row tile is a block for each column
    # slice, most in the narrowest slices
    dp = padded_head_dim(q.shape[3])
    width = min(slice_columns(name, q.dtype) for name in LAUNCHES)
    slices = -(-dp // width) if dp > _PADDED[-1] else 1
    if B * H * tiles * slices >= 2**31:
        raise ValueError("too many (batch, head, tile, column slice) blocks for one launch")


def _strides(*xs) -> list:
    return [s for x in xs for s in x.stride()[:3]]


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _fwd_kernel(q, k, v, *, scale, causal, q_offset, k_offset, out_dtype,
                block_k=flash_tuning.DEFAULT_BLOCKS[1]):
    """The forward kernel; ``block_k`` names its keys a stage (the f32
    kernel's tile is `TILE`)."""
    _check_kernel_inputs(q, k, v)
    B, Sq, H, D = q.shape
    o = torch.empty((B, Sq, H, D), dtype=out_dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    rc = _kernels().edl_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, H, Sq, k.shape[1], D, *_strides(q, k, v), q_offset, k_offset,
        scale, int(causal), int(out_dtype == torch.float32), _DTYPES[q.dtype],
        block_k, _stream(q))
    _check(rc, "fwd")
    _count("fwd", q.dtype, D, block_k)
    return o, lse


def _bwd_args(q, k, v, do, lse, delta):
    """The backward kernels' inputs, checked: (q, k, v, dO, lse, delta)
    with dO, lse and delta contiguous."""
    _check_kernel_inputs(q, k, v)
    if do.dtype != q.dtype or do.shape != q.shape:
        raise NotImplementedError(
            f"dO is {do.dtype} {tuple(do.shape)}; the kernels take a dO in q's "
            f"dtype ({q.dtype}) and of q's shape {tuple(q.shape)}")
    return q, k, v, do.contiguous(), lse.contiguous(), delta.contiguous()


def _launch_bwd_dq(q, k, v, do, lse, delta, *, scale, causal, q_offset,
                   k_offset):
    B, Sq, H, D = q.shape
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    rc = _kernels().edl_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        B, H, Sq, k.shape[1], D, *_strides(q, k, v), q_offset, k_offset,
        scale, int(causal), _DTYPES[q.dtype], _stream(q))
    _check(rc, "bwd_dq")
    _count("bwd_dq", q.dtype, D)
    return dq


def _launch_bwd_dkv(q, k, v, do, lse, delta, *, scale, causal, q_offset,
                    k_offset):
    B, Sq, H, D = q.shape
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    rc = _kernels().edl_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, H, Sq, k.shape[1], D, *_strides(q, k, v), q_offset, k_offset,
        scale, int(causal), _DTYPES[q.dtype], _stream(q))
    _check(rc, "bwd_dkv")
    _count("bwd_dkv", q.dtype, D)
    return dk, dv


def _bwd_dq_kernel(q, k, v, do, lse, delta, **opts):
    return _launch_bwd_dq(*_bwd_args(q, k, v, do, lse, delta), **opts)


def _bwd_dkv_kernel(q, k, v, do, lse, delta, **opts):
    return _launch_bwd_dkv(*_bwd_args(q, k, v, do, lse, delta), **opts)


def _bwd_kernel(q, k, v, do, lse, delta, **opts):
    """Both backward kernels, on inputs checked once."""
    args = _bwd_args(q, k, v, do, lse, delta)
    return (_launch_bwd_dq(*args, **opts), *_launch_bwd_dkv(*args, **opts))


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
    would leave dP's rounding error in dS. What the rounding leaves out goes
    through a second pass (`_Flash.backward`); an f32 q needs none.
    """
    do = do.to(q.dtype)
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2) - dlse.float()
    return do, delta  # delta: (B, H, Sq) f32


class _Flash(torch.autograd.Function):
    """Counterpart of the JAX package's ``_flash`` custom VJP: outputs
    (o, lse), differentiable through both."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, q_offset, k_offset, out_dtype, block_k):
        opts = dict(scale=scale, causal=causal, q_offset=q_offset,
                    k_offset=k_offset)
        fwd = _route(q, _fwd_reference, functools.partial(_fwd_kernel, block_k=block_k))
        o, lse = fwd(q, k, v, out_dtype=out_dtype, **opts)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = opts
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = _route(q, _bwd_reference, _bwd_kernel)
        hi, delta = _backward_inputs(q, o, do, dlse)
        grads = bwd(q, k, v, hi, lse, delta, **ctx.opts)
        if do.dtype != q.dtype:
            # an f32 dO for a 16-bit q (the ring's hops): the backward of its
            # remainder too, whose delta has no lse term (that went with the
            # first part)
            lo, delta_lo = _backward_inputs(q, o, do.float() - hi.float(),
                                            torch.zeros_like(delta))
            grads = tuple((a.float() + b.float()).to(a.dtype) for a, b in
                          zip(grads, bwd(q, k, v, lo, lse, delta_lo, **ctx.opts)))
        return (*grads, None, None, None, None, None, None)


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

    ``block_q``/``block_k`` name the forward kernel's tile (query rows a
    block, keys a stage). Left out, they come from the tile table
    (`resolve_blocks`); pinned, they must name a tile the kernels were
    compiled for (`compiled_blocks`), or ``NotImplementedError`` is raised.
    q, k and v take any float dtype on the CPU and bf16, f16 or f32 at any
    head dim on CUDA.
    """
    B, Sq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if Sq == 0 or k.shape[1] == 0:
        raise ValueError("flash attention needs at least one query and key")
    _, block_k = resolve_blocks(k.shape[1], D, q.dtype, block_q, block_k)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    out_dtype = torch.float32 if return_lse else q.dtype
    o, lse = _Flash.apply(*_kernel_layout(q, k, v), scale, bool(causal),
                          int(q_offset), int(k_offset), out_dtype, block_k)
    o = o[..., :D]
    return (o, lse) if return_lse else o
