"""Ring attention over the ``seq`` mesh axis: the port of
`edl_tpu.parallel.ring_attention`.

Q/K/V are sharded on the sequence dimension over the ``seq`` axis; each
rank computes attention for its local query block while the K/V blocks
travel the ring (`parallel.collective.ppermute`, one hop a step), so the
full (S, S) score matrix never exists. Causality comes from GLOBAL
positions: the block that arrives at step i started on the rank ``(my - i)
mod n``, so its key positions are known without communication.

Two engines, as in the JAX package:

- the einsum engine (`_ring_attention_local`): f32 online softmax, a
  running max, numerator and denominator folded over the visiting blocks;
- the flash engine (`_ring_flash_local`, ``flash=True``): each hop is one
  call of the flash kernels (`edl_tpu_torch.ops.flash_attention`) with the
  hop's global offsets and ``return_lse=True``, and the hops merge in f32
  ``(out, lse)`` form. A row that sees no key of a hop reports the finite
  ``_NEG_INF`` sentinel, which the merge weights to exactly 0. Gradients
  flow through both outputs of every hop.

`_ring_attention_local` is the per-rank form the model calls, given the
`parallel.mesh.Mesh` (the counterpart of being inside a ``shard_map``);
`ring_attention` takes the global q/k/v that every rank holds and returns
this rank's block of the output. With one sequence shard the local form is
the flash kernels themselves (``flash=True``) or the dense oracle.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

#: scores below this are "masked"; finite so exp() is exactly 0 without nans.
_NEG_INF = -1e30


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """Reference O(S^2)-memory attention. q/k/v: (B, S, H, D).

    f32 scores and softmax whatever the input dtype; the probabilities are
    cast to v's dtype for the value product, as in the JAX package."""
    B, S, H, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        pos = torch.arange(S, device=q.device)
        s = torch.where(pos[None, :] <= pos[:, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return out.to(q.dtype)


def _ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, seq_axis: str = "seq", n_shards: int = 1,
                          causal: bool = True, scale: Optional[float] = None,
                          flash: bool = False, mesh=None) -> torch.Tensor:
    """Attention over this rank's q/k/v: (B, S_local, H_local, D).

    With ``n_shards > 1`` the K/V blocks travel the ring over ``seq_axis``
    of ``mesh``, the rank's index on that axis giving the block's global
    positions. ``flash``: every block through the flash kernels instead of
    the einsum engine (the unsharded case directly, the ring case as
    per-hop (out, lse) pairs merged in f32)."""
    B, S, H, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if n_shards == 1:
        if flash:
            from edl_tpu_torch.ops import flash_attention

            return flash_attention(q, k, v, causal=causal, scale=scale)
        return dense_attention(q, k, v, causal=causal, scale=scale)
    if mesh is None or mesh.shape.get(seq_axis, 1) != n_shards:
        raise ValueError(f"ring attention over {n_shards} {seq_axis!r} shards needs "
                         f"the mesh whose {seq_axis!r} axis has that size, got {mesh}")
    if flash:
        return _ring_flash_local(q, k, v, seq_axis=seq_axis, n_shards=n_shards,
                                 causal=causal, scale=scale, mesh=mesh)
    from edl_tpu_torch.parallel.collective import ppermute

    my = mesh.axis_index(seq_axis)
    q_pos = my * S + torch.arange(S, device=q.device)  # global positions of local queries
    qf = q.float()

    def accumulate(acc, k_blk, v_blk, src):
        """Fold one visiting K/V block into the online-softmax accumulator."""
        m, num, den = acc
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.float()) * scale
        if causal:
            k_pos = src * S + torch.arange(S, device=q.device)
            mask = k_pos[None, :] <= q_pos[:, None]  # (S_q, S_k)
            s = torch.where(mask, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))  # (B, H, S_q)
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])  # (B, H, S_q, S_k)
        num = num * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_blk.float())
        den = den * alpha + p.sum(dim=-1)
        return m_new, num, den

    acc = (torch.full((B, H, S), _NEG_INF, device=q.device),
           torch.zeros((B, H, S, D), device=q.device),
           torch.zeros((B, H, S), device=q.device))
    acc = accumulate(acc, k, v, my)  # the local block, hop 0
    k_blk, v_blk = k, v
    for i in range(1, n_shards):
        # rotate first: n_shards - 1 hops carry every block round the ring
        k_blk, v_blk = ppermute([k_blk, v_blk], mesh, seq_axis, 1)
        acc = accumulate(acc, k_blk, v_blk, (my - i) % n_shards)
    _, num, den = acc
    out = num / den[..., None]  # (B, H, S_q, D)
    return out.transpose(1, 2).to(q.dtype)


def _ring_flash_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      seq_axis: str, n_shards: int, causal: bool, scale: float,
                      mesh) -> torch.Tensor:
    """The ring with the flash kernels as the per-hop block engine: each
    visiting block through ``flash_attention(return_lse=True)`` with global
    offsets, the hops merged as ``lse' = logaddexp(lse_a, lse_b)``, ``out'
    = out_a e^{lse_a - lse'} + out_b e^{lse_b - lse'}`` in f32."""
    from edl_tpu_torch.ops import flash_attention
    from edl_tpu_torch.parallel.collective import ppermute

    S = q.shape[1]
    my = mesh.axis_index(seq_axis)

    def block(k_blk, v_blk, src):
        return flash_attention(q, k_blk, v_blk, causal=causal, scale=scale,
                               q_offset=my * S, k_offset=src * S, return_lse=True)

    acc = block(k, v, my)  # the local block, hop 0; out is f32
    k_blk, v_blk = k, v
    for i in range(1, n_shards):
        k_blk, v_blk = ppermute([k_blk, v_blk], mesh, seq_axis, 1)
        acc = merge_hops(acc, block(k_blk, v_blk, (my - i) % n_shards))
    return acc[0].to(q.dtype)


def merge_hops(acc, blk):
    """Two hops' ``(out (B, S, H, D) f32, lse (B, H, S) f32)`` merged into
    one: ``lse = logaddexp(lse_a, lse_b)`` and each out weighted by
    ``exp(its lse - lse)``; a hop whose rows see no key (``_NEG_INF``)
    weighs exactly 0."""
    (oa, la), (ob, lb) = acc, blk
    lse = torch.logaddexp(la, lb)  # (B, H, S)
    wa = torch.exp(la - lse).transpose(1, 2)[..., None]  # (B, S, H, 1)
    wb = torch.exp(lb - lse).transpose(1, 2)[..., None]
    return oa * wa + ob * wb, lse


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *,
                   seq_axis: str = "seq", batch_axis: str = "data",
                   head_axis: str = "model", causal: bool = True,
                   scale: Optional[float] = None, flash: bool = False) -> torch.Tensor:
    """Sequence-parallel attention on ``mesh``. q/k/v: (B, S, H, D), the
    global tensors, the same on every rank.

    Each rank takes its block: batch over ``batch_axis``, sequence over
    ``seq_axis``, heads over ``head_axis`` (axes absent from the mesh do not
    split), runs `_ring_attention_local` and returns its block of the
    output, the shard the JAX package's out_spec gives the device at this
    rank's place. With no ``seq_axis`` on the mesh that is dense attention
    (``flash=False``, the whole output on every rank, as JAX's global
    call) or the flash kernels on the local batch and head block; a batch
    or head count the mesh does not divide takes the kernels on the whole
    tensors instead, as the JAX package does."""
    n_sp = mesh.shape.get(seq_axis, 1)
    if n_sp == 1:
        if not flash:
            return dense_attention(q, k, v, causal=causal, scale=scale)
        B, _, H, _ = q.shape
        if B % mesh.shape.get(batch_axis, 1) or H % mesh.shape.get(head_axis, 1):
            from edl_tpu_torch.ops import flash_attention

            return flash_attention(q, k, v, causal=causal, scale=scale)

    def local(x):
        for dim, axis in ((0, batch_axis), (1, seq_axis), (2, head_axis)):
            n = mesh.shape.get(axis, 1)
            if n > 1:
                if x.shape[dim] % n:
                    raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                                     f"over {n} {axis!r} shards")
                size = x.shape[dim] // n
                x = x.narrow(dim, mesh.axis_index(axis) * size, size)
        return x

    return _ring_attention_local(local(q), local(k), local(v), seq_axis=seq_axis,
                                 n_shards=n_sp, causal=causal, scale=scale, flash=flash,
                                 mesh=mesh)
