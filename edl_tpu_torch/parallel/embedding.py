"""Row-sharded embedding tables: the port of `edl_tpu.parallel.embedding`.

The JAX package keeps a large sparse table (CTR's 1e6+1 rows) as one array
row-sharded over a mesh axis, and a lookup is a `shard_map` collective.
Here each rank of a `parallel.mesh.Mesh` holds its ``padded_vocab / n``
rows as one tensor, and a lookup runs the same collectives over the
axis's process group (`parallel.collective`):

- ids sharded on the same axis as the table (CTR's production path, on a
  data-parallel mesh): all-gather the ids, look up the rows this rank owns
  (offset ``index * local_rows``), zero the rest, then reduce-scatter so
  each rank keeps its own batch slice. Backward: all-gather of the
  cotangent, then the scatter-add into the local rows, so a row's
  gradient is the sum over every rank's ids.
- ids sharded on another axis (the table over ``expert``, say): each rank
  looks up its own ids in its rows, zeroes the rest, and all-reduces over
  the table's axis. The output is replicated over that axis, so the
  cotangent passes back unchanged (the JAX transpose of that ``psum``).

With one shard (no mesh, or a mesh whose table axis has size 1) a lookup
is ``F.embedding(ids, table)``: the same gather as ``table[ids]``, whose
CUDA backward sorts the ids and adds up each row's duplicates as one
segment. The backward of ``table[ids]`` (index_put with accumulate) walks
every duplicate of a row in one thread, which CTR's heavy-tailed ids make
slow (`PERF.md` has the times). The padded vocab is the JAX package's,
so a table carries across whole or in shards (`models.convert`).

`dedup_gather` is the JAX package's opt-in gather whose backward adds up
duplicate ids before it scatters: plain torch ops, as it is jnp there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F

from edl_tpu_torch.device import DeviceLike, resolve_device
from edl_tpu_torch.parallel import collective


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

    vocab is padded so every shard holds the same row count. The shard
    count is the size of ``shard_axis`` on the mesh a call is given (1
    without one). ``batch_axis`` names the axis the ids are sharded on (may
    be the same)."""

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

    def n_shards(self, mesh=None) -> int:
        """The table's shard count on ``mesh``: its ``shard_axis``'s size."""
        return 1 if mesh is None else mesh.axis_size(self.shard_axis)

    def init(self, generator: Optional[torch.Generator] = None,
             device: DeviceLike = None, scale: float = 0.01,
             n_shards: int = 1, mesh=None) -> torch.Tensor:
        """The padded table, normal * ``scale``, drawn whole from
        ``generator`` on the host; on a ``mesh`` this rank keeps its rows
        ``[i*L, (i+1)*L)`` (``i`` its index on ``shard_axis``), so every
        world size draws the same table and leaves the generator in the
        same state. Placed on ``device``."""
        device = resolve_device(device)
        n = self.n_shards(mesh) if mesh is not None else n_shards
        table = torch.randn((self.padded_vocab(n), self.features),
                            generator=generator, dtype=self.dtype) * scale
        if mesh is not None and n > 1:
            rows = table.shape[0] // n
            i = mesh.axis_index(self.shard_axis)
            table = table[i * rows:(i + 1) * rows].clone()
        return table.to(device)

    def apply(self, table: torch.Tensor, ids: torch.Tensor, mesh=None) -> torch.Tensor:
        """Lookup: ids (...,) integer -> embeddings (..., features); on a
        ``mesh``, ``table`` is this rank's shard and ``ids`` its batch slice.

        Out-of-range ids must be clipped by the caller; padded rows hold real
        values that no id reaches, so their gradient is 0. More than one
        shard needs the ``mesh``'s process groups to carry the lookup."""
        n = self.n_shards(mesh)
        if n == 1:
            return F.embedding(ids, table)  # table[ids]
        if not mesh.distributed:
            raise ValueError(f"a lookup into a table over {n} shards needs the "
                             "Mesh whose process groups carry its collectives")
        flat = ids.reshape(-1)
        if self.shard_axis == self.batch_axis:
            out = self._lookup_same_axis(mesh, table, flat)
        else:
            out = self._lookup_cross_axis(mesh, table, flat)
        return out.reshape(ids.shape + (self.features,))

    def _local_rows(self, mesh, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """The rows of ``ids`` this rank owns, zeros for the others."""
        local_rows = table.shape[0]
        local = ids.long() - mesh.axis_index(self.shard_axis) * local_rows
        hit = (local >= 0) & (local < local_rows)
        rows = F.embedding(local.clamp(0, local_rows - 1), table)
        return torch.where(hit[:, None], rows, rows.new_zeros(()))

    def _lookup_same_axis(self, mesh, table, flat_ids):
        group = mesh.group(self.shard_axis)
        # (B/n,) -> (B,): every rank answers every rank's queries
        ids_all = collective.gather_dim(flat_ids.contiguous(), group)
        contrib = self._local_rows(mesh, table, ids_all)
        # each rank keeps its own batch slice, summed over the owners
        return collective.reduce_scatter(contrib, group)

    def _lookup_cross_axis(self, mesh, table, flat_ids):
        contrib = self._local_rows(mesh, table, flat_ids)
        return collective.all_reduce(contrib, mesh.group(self.shard_axis))
