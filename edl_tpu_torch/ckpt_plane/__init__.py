"""Memory-resident checkpoint plane: peer-replicated ZeRO-1 shards, the
port of `edl_tpu.ckpt_plane`.

The blob-store ``Checkpointer`` makes state durable; this plane makes the
common recovery *fast*. Each worker pushes its 1/N ZeRO shard of the train
state — chunked, epoch-stamped, ``put_id``-deduped — into the coordinator's
memory-resident shard store (``shard_put``/``shard_get``/``shard_meta``/
``shard_drop`` on the wire), with a ring replica-placement map published
through coordinator KV per membership epoch. On worker loss or rescale the
survivors assemble the full state from the plane in memory and load it
into the new world's state (`Trainer.load_full_state`) — zero blob reads.
Only a whole-replica-group death (or a coordinator restart: the store is
deliberately unjournaled) demotes recovery to the blob restore. The shard
blobs are the JAX package's byte for byte, so either package assembles the
other's.
"""

from edl_tpu_torch.ckpt_plane.placement import (
    PLACEMENT_KEY,
    placement_map,
    publish_placement,
    read_placement,
    replica_group,
)
from edl_tpu_torch.ckpt_plane.recovery import assemble_leaves, peer_restore
from edl_tpu_torch.ckpt_plane.replicator import (
    CHUNK_BYTES,
    CkptPlane,
    StateDef,
    chunk_blob,
    host_leaves,
    leaf_slice,
    owner_key,
    parse_shard,
    serialize_shard,
    state_def,
    state_template,
    unflatten,
)

__all__ = [
    "CkptPlane",
    "CHUNK_BYTES",
    "PLACEMENT_KEY",
    "StateDef",
    "assemble_leaves",
    "chunk_blob",
    "host_leaves",
    "leaf_slice",
    "owner_key",
    "parse_shard",
    "peer_restore",
    "placement_map",
    "publish_placement",
    "read_placement",
    "replica_group",
    "serialize_shard",
    "state_def",
    "state_template",
    "unflatten",
]
