"""Row-sharded embedding tables: the port of `edl_tpu.parallel.embedding`.

The JAX package keeps a large sparse table (CTR's 1e6+1 rows) as one array
row-sharded over a mesh axis, and a lookup is a `shard_map` collective. This
slice ports the one-shard case: the table is one tensor on one device and a
lookup is ``table[ids]``, whose backward is a scatter-add into a dense table
gradient, as XLA's is. The lookup is written ``F.embedding(ids, table)``:
the same gather, whose CUDA backward sorts the ids and adds up each row's
duplicates as one segment. The backward of ``table[ids]`` (index_put with
accumulate) walks every duplicate of a row in one thread, which CTR's
heavy-tailed ids make slow (`PERF.md` has the times). The padded vocab is
the JAX package's, so a table carries across whole (`models.convert`). The
two lookups across shards raise until ROADMAP queue A item 4 (data
parallelism over ``torch.distributed``) ports them.

`dedup_gather` is the JAX package's opt-in gather whose backward adds up
duplicate ids before it scatters: plain torch ops, as it is jnp there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F

from edl_tpu_torch.device import DeviceLike, resolve_device


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


class _DedupGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table: torch.Tensor, flat_ids: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(flat_ids)
        ctx.table_shape = table.shape
        return table[flat_ids]

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (flat_ids,) = ctx.saved_tensors
        dtable = g.new_zeros(ctx.table_shape)
        if flat_ids.numel() == 0:
            return dtable, None
        # sort the ids; each position's segment is its id's rank among them
        uniq, seg = torch.unique(flat_ids, sorted=True, return_inverse=True)
        uniq_grad = g.new_zeros((uniq.shape[0],) + g.shape[1:]).index_add_(0, seg, g)
        return dtable.index_add_(0, uniq, uniq_grad), None


def dedup_gather(table: torch.Tensor, flat_ids: torch.Tensor) -> torch.Tensor:
    """``table[flat_ids]`` whose backward adds up the gradients of duplicate
    ids (sorted, segment-summed) and then adds each unique row into the
    table gradient once. ``flat_ids``: 1-D non-negative integer tensor,
    possibly empty."""
    return _DedupGather.apply(table, flat_ids)


@dataclass(frozen=True)
class ShardedEmbedding:
    """Config, init and lookup for one row-sharded table.

    vocab is padded so every shard holds the same row count. The JAX
    package reads the shard count off a mesh axis (``shard_axis``); the port
    takes the count itself, 1 by default. ``batch_axis`` names the axis the
    ids are sharded on (may be the same)."""

    vocab_size: int
    features: int
    shard_axis: str = "data"
    #: one mesh axis or a hierarchy tuple the ids/batches are sharded over
    batch_axis: Any = "data"
    dtype: torch.dtype = torch.float32

    #: vocab is padded to a multiple of this whatever the shard count, so
    #: the table's shape is stable across elastic rescale; 256 divides
    #: evenly for every power-of-two shard count up to 256
    PAD_MULTIPLE = 256

    def padded_vocab(self, n_shards: int = 1) -> int:
        if self.PAD_MULTIPLE % n_shards == 0:
            return _round_up(self.vocab_size, self.PAD_MULTIPLE)
        # shard counts that do not divide 256 (3, 12) fall back to the LCM
        # so rows still split evenly, at the cost of rescale-stable shapes
        return _round_up(self.vocab_size, n_shards * self.PAD_MULTIPLE)

    def init(self, generator: Optional[torch.Generator] = None,
             device: DeviceLike = None, scale: float = 0.01,
             n_shards: int = 1) -> torch.Tensor:
        """The padded table, normal * ``scale``, drawn from ``generator`` on
        the host and placed on ``device``."""
        device = resolve_device(device)
        table = torch.randn((self.padded_vocab(n_shards), self.features),
                            generator=generator, dtype=self.dtype) * scale
        return table.to(device)

    def apply(self, table: torch.Tensor, ids: torch.Tensor,
              n_shards: int = 1) -> torch.Tensor:
        """Lookup: ids (...,) integer -> embeddings (..., features).

        Out-of-range ids must be clipped by the caller; padded rows hold real
        values that no id reaches, so their gradient is 0."""
        if n_shards == 1:
            return F.embedding(ids, table)  # table[ids]
        flat = ids.reshape(-1)
        if self.shard_axis == self.batch_axis:
            out = self._lookup_same_axis(table, flat, n_shards)
        else:
            out = self._lookup_cross_axis(table, flat, n_shards)
        return out.reshape(ids.shape + (self.features,))

    def _lookup_same_axis(self, table, flat_ids, n_shards):
        raise NotImplementedError(
            f"a lookup into a table over {n_shards} shards, ids sharded on the "
            "same axis, is not ported yet (ROADMAP queue A item 4)")

    def _lookup_cross_axis(self, table, flat_ids, n_shards):
        raise NotImplementedError(
            f"a lookup into a table over {n_shards} shards, ids sharded on "
            "another axis, is not ported yet (ROADMAP queue A item 4)")
