"""Replica placement for the memory-resident checkpoint plane: a copy of
`edl_tpu.ckpt_plane.placement`.

Placement is a ring over the membership ranks: the owner of shard ``r``
replicates to the ``k`` successors ``(r+1 .. r+k) mod world``. The map is
deterministic from ``(world, k)`` — every worker derives the same groups
with no coordination — but it is still *published* through the coordinator
KV under an epoch-scoped key, because the restorer after a rescale runs in
a NEW world and must know which layout the surviving shard data was written
under. A membership epoch change invalidates the previous epoch's key (the
ranks it names no longer exist); the shard *data* is deliberately NOT
dropped — serving a dead owner's bytes to its successor is the plane's
whole point.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional

#: coordinator KV key the placement map lives under, scoped by membership
#: epoch so a rescale's new map never aliases the old one.
PLACEMENT_KEY = "edl/ckpt_plane/placement/e{epoch}"


def replica_group(rank: int, world: int, k: int,
                  exclude: Optional[Iterable[int]] = None) -> List[int]:
    """Holder ranks for ``rank``'s shard: the ``k`` ring successors.

    ``k`` is clamped to ``world - 1`` (a peer cannot replicate to itself,
    and more holders than peers is meaningless). world=1 yields no holders:
    a lone worker's plane degenerates to the coordinator's own copy.

    ``exclude`` is the revocation override: ranks under an advance-notice
    drain are skipped when walking the ring — a doomed host may still OWN
    a shard (that data is exactly what must be copied off it) but never
    HOLDS a replica. The walk continues past excluded ranks so the group
    keeps ``k`` holders whenever enough survivors exist.
    """
    if world <= 1:
        return []
    banned = {int(x) % world for x in exclude} if exclude else set()
    k = max(0, min(k, world - 1 - len(banned - {rank % world})))
    out: List[int] = []
    for i in range(1, world):
        if len(out) >= k:
            break
        cand = (rank + i) % world
        if cand in banned:
            continue
        out.append(cand)
    return out


def placement_map(world: int, k: int,
                  exclude: Optional[Iterable[int]] = None
                  ) -> Dict[int, List[int]]:
    """owner rank -> holder ranks, for every rank in ``world``."""
    ex = list(exclude) if exclude else None
    return {r: replica_group(r, world, k, exclude=ex)
            for r in range(world)}


def publish_placement(client, epoch: int, world: int, k: int,
                      prev_epoch: Optional[int] = None,
                      exclude: Optional[Iterable[int]] = None) -> Dict:
    """Publish the epoch's placement map to coordinator KV and invalidate
    the previous epoch's (epoch change = rank renumbering = every group in
    the old map is stale). Idempotent: every member writes the identical
    JSON, so concurrent publishes are harmless. ``exclude`` (revoked ranks)
    is recorded in the doc so late readers reproduce the same override."""
    ex = sorted({int(x) for x in exclude}) if exclude else []
    doc = {
        "epoch": int(epoch),
        "world": int(world),
        "replicas": int(k),
        "excluded": ex,
        "groups": {str(r): g for r, g in
                   placement_map(world, k, exclude=ex).items()},
    }
    client.kv_put(PLACEMENT_KEY.format(epoch=int(epoch)), json.dumps(doc))
    if prev_epoch is not None and int(prev_epoch) != int(epoch):
        client.kv_del(PLACEMENT_KEY.format(epoch=int(prev_epoch)))
    return doc


def read_placement(client, epoch: int) -> Optional[Dict]:
    """The published map for ``epoch``, or None when absent/invalidated."""
    raw = client.kv_get(PLACEMENT_KEY.format(epoch=int(epoch)))
    if not raw:
        return None
    doc = json.loads(raw)
    doc["groups"] = {int(r): g for r, g in doc.get("groups", {}).items()}
    return doc
