"""Shard routing shared by the wire client and the in-process twin.

The control plane hash-partitions its keyspaces (KV keys, checkpoint-plane
owners, task names) across shard servers behind a thin membership root
(native ``--shards``). Both sides of the wire compute the same FNV-1a
64-bit hash — the constants here mirror ``Coordinator::key_shard`` in
``native/coordinator/coordinator.cc``; if they ever diverge the client
routes a key to one shard while the root redirects it to another.
"""

from __future__ import annotations

from typing import Dict, List, Optional

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK = 0xFFFFFFFFFFFFFFFF


def fnv1a64(key: str) -> int:
    h = _FNV_OFFSET
    for b in key.encode("utf-8"):
        h ^= b
        h = (h * _FNV_PRIME) & _MASK
    return h


def shard_of(key: str, nshards: int) -> int:
    """Owning shard slot for ``key`` — native ``key_shard`` parity."""
    if nshards <= 0:
        return 0
    return fnv1a64(key) % nshards


#: keyspace op -> request field whose value routes the op. Ops absent here
#: (membership, barriers, watch, status...) are served by the root itself.
ROUTED_OPS: Dict[str, str] = {
    "kv_put": "key",
    "kv_get": "key",
    "kv_del": "key",
    "kv_incr": "key",
    "shard_put": "owner",
    "shard_get": "owner",
    "shard_meta": "owner",
    "shard_drop": "owner",
    "complete_task": "task",
    "fail_task": "task",
    # acquire_task rotates over every shard (tasks are hashed by NAME, so a
    # worker's next task can live anywhere); the worker hash only picks the
    # stable starting slot. add_tasks is partitioned by the client before
    # sending. Both still appear here so redirect replies for them resolve.
    "acquire_task": "worker",
}


def route_key(op: str, fields: Dict) -> Optional[str]:
    """The routing key for a request, or None when the op is root-served."""
    field = ROUTED_OPS.get(op)
    if field is None:
        return None
    value = fields.get(field)
    return "" if value is None else str(value)


def partition_tasks(tasks: List[str], nshards: int) -> Dict[int, List[str]]:
    """Split an add_tasks batch by owning shard, preserving order."""
    out: Dict[int, List[str]] = {}
    for t in tasks:
        out.setdefault(shard_of(str(t), nshards), []).append(t)
    return out


class ShardMap:
    """A client's cached view of the partition: the root endpoint plus the
    ordered shard endpoints. Invalidated whenever a redirect reply or a
    reconnect proves it stale."""

    def __init__(self, shards: List[str]):
        self.shards = list(shards)

    @property
    def nshards(self) -> int:
        return len(self.shards)

    def endpoint_for(self, key: str) -> str:
        return self.shards[shard_of(key, self.nshards)]

    def slot_for(self, key: str) -> int:
        return shard_of(key, self.nshards)
