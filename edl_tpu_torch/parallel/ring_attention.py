"""Attention over the sequence axis: the port of `edl_tpu.parallel.ring_attention`.

This slice ports the single-shard case: `dense_attention`, the O(S^2)-memory
oracle, and `_ring_attention_local` with ``n_shards == 1``, which is the
flash kernel itself (``flash=True``) or the dense oracle. The ring across
sequence shards, where K/V blocks rotate device to device and per-hop
(out, lse) pairs merge, waits for a later slice and raises here.
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
                          flash: bool = False) -> torch.Tensor:
    """Attention over this shard's q/k/v: (B, S_local, H_local, D).

    ``flash``: run through the flash kernels (`edl_tpu_torch.ops.
    flash_attention`) instead of the dense oracle. Only ``n_shards == 1``
    is ported; the ring over ``seq_axis`` raises ``NotImplementedError``."""
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if n_shards != 1:
        raise NotImplementedError(
            f"ring attention over {n_shards} {seq_axis!r} shards is not "
            f"ported yet; only one sequence shard is")
    if flash:
        from edl_tpu_torch.ops import flash_attention

        return flash_attention(q, k, v, causal=causal, scale=scale)
    return dense_attention(q, k, v, causal=causal, scale=scale)
