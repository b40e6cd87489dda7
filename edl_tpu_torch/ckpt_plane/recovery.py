"""Zero-blob recovery: assemble a full state from peer-replicated shards,
the port of `edl_tpu.ckpt_plane.recovery`.

The restorer after a worker loss (or a rescale into a different world)
pulls every owner's latest shard from the coordinator's memory-resident
store, verifies they all belong to one step, and concatenates the ZeRO
slices back into full host leaves. The JAX package places them onto the
new mesh through its shardings; here they become a `Trainer.full_state`
dict (`replicator.unflatten`) and `Trainer.load_full_state` loads it into
the new state, each rank keeping its shards — the same code a blob restore
at another world size runs (including non-dividing changes like 6 -> 4).

Any gap — a missing owner, an incomplete chunk set, owners disagreeing on
the step, a stale step older than the blob store's — returns None, and the
caller falls back to the durable ``Checkpointer``. ``shard_meta``'s
``complete`` flag is the go/no-go: a replica-group death shows up as an
incomplete (or absent) owner and cleanly demotes recovery one rung down
the ladder.
"""

from __future__ import annotations

import base64
import logging
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from edl_tpu_torch.ckpt_plane.replicator import (OWNER_PREFIX, owner_key, parse_shard,
                                                 state_def, unflatten)

log = logging.getLogger("edl_tpu_torch.ckpt_plane")


def _pull_shard(client, owner: str) -> Optional[Tuple[Dict, bytes, int]]:
    """Fetch one owner's latest complete shard: (manifest, payload, bytes
    moved). None when absent or incomplete (group death / torn write)."""
    meta = client.shard_meta(owner)
    if not meta.get("ok") or not meta.get("found") or not meta.get("complete"):
        return None
    step = int(meta["step"])
    chunks = int(meta["chunks"])
    encoded: List[str] = []
    call_batch = getattr(client, "call_batch", None)
    if callable(call_batch) and chunks > 1:
        window = 8
        for base in range(0, chunks, window):
            ops = [{"op": "shard_get", "owner": owner, "step": step,
                    "chunk": c}
                   for c in range(base, min(base + window, chunks))]
            for sub in call_batch(ops):
                if not sub.get("ok") or not sub.get("found"):
                    return None
                encoded.append(sub.get("data", ""))
    else:
        for c in range(chunks):
            sub = client.shard_get(owner, step=step, chunk=c)
            if not sub.get("ok") or not sub.get("found"):
                return None
            encoded.append(sub.get("data", ""))
    blob = b"".join(base64.b64decode(e) for e in encoded)
    manifest, payload = parse_shard(blob)
    if int(manifest.get("step", -1)) != step:
        return None  # torn across a concurrent newer put
    return manifest, payload, len(blob)


def assemble_leaves(parts: Dict[int, Tuple[Dict, bytes]]) -> List[np.ndarray]:
    """Concatenate per-rank slices back into full host leaves.

    ``parts`` maps rank -> (manifest, payload) for EVERY rank of the world
    the shards were written under. Leaf layout comes from rank 0's manifest
    (all ranks derive the identical one); sliced leaves concatenate along
    their recorded dim in rank order, unsliced leaves are rank 0's whole
    copy.
    """
    world = len(parts)
    manifest0 = parts[0][0]
    offsets = {r: 0 for r in parts}
    leaves: List[np.ndarray] = []
    for i, meta in enumerate(manifest0["leaves"]):
        shape = tuple(meta["shape"])
        dtype = np.dtype(meta["dtype"])
        dim = meta["dim"]
        if dim is None:
            raw = _take(parts, offsets, 0, i)
            leaves.append(np.frombuffer(raw, dtype=dtype).reshape(shape))
            continue
        pieces = []
        per = shape[dim] // world
        piece_shape = list(shape)
        piece_shape[dim] = per
        for r in range(world):
            raw = _take(parts, offsets, r, i)
            pieces.append(np.frombuffer(raw, dtype=dtype).reshape(piece_shape))
        leaves.append(np.concatenate(pieces, axis=dim))
    return leaves


def _take(parts: Dict[int, Tuple[Dict, bytes]], offsets: Dict[int, int],
          rank: int, leaf_idx: int) -> bytes:
    """Rank ``rank``'s byte range for leaf ``leaf_idx`` (per its manifest)."""
    manifest, payload = parts[rank]
    want = int(manifest["leaves"][leaf_idx]["nbytes"])
    start = offsets[rank]
    offsets[rank] = start + want
    raw = payload[start:start + want]
    if len(raw) != want:
        raise ValueError(
            f"shard payload truncated: rank {rank} leaf {leaf_idx} wanted "
            f"{want} bytes, had {len(raw)}")
    return raw


def peer_restore(client, template: Dict, trainer=None, state=None,
                 min_step: Optional[int] = None,
                 owner_prefix: str = OWNER_PREFIX,
                 instruments=None, tracer=None) -> Optional[Tuple[Any, Dict]]:
    """Assemble the full state from the plane.

    ``template`` is a `Trainer.full_state` dict of the state being restored
    (a fresh one will do): it fixes the leaf order and the dtypes. With
    ``trainer`` and ``state`` the assembled state is loaded into ``state``
    (`Trainer.load_full_state`: each rank keeps its shards) and returned;
    without them the full-state dict is. ``min_step`` rejects a plane older
    than the blob store's best: recovery must never move training
    backwards past the durable copy. Returns ``(state or dict, {step,
    bytes, seconds, world_at_save, source, reshard_start, reshard_end})``
    or None.
    """
    t0 = time.perf_counter()
    t0_wall = time.time()
    try:
        first = _pull_shard(client, owner_key(0, owner_prefix))
        if first is None:
            return None
        manifest0, payload0, nbytes = first
        step = int(manifest0["step"])
        if min_step is not None and step < int(min_step):
            log.info("ckpt-plane step %d older than blob step %d; using blob",
                     step, int(min_step))
            return None
        world_at_save = int(manifest0["world"])
        parts: Dict[int, Tuple[Dict, bytes]] = {0: (manifest0, payload0)}
        total = nbytes
        for r in range(1, world_at_save):
            got = _pull_shard(client, owner_key(r, owner_prefix))
            if got is None or int(got[0]["step"]) != step:
                log.warning(
                    "ckpt-plane owner %s missing/incomplete/stale at step "
                    "%d — replica group lost; falling back to blob restore",
                    owner_key(r, owner_prefix), step)
                return None
            parts[r] = (got[0], got[1])
            total += got[2]
        host = assemble_leaves(parts)
        out: Any = unflatten(state_def(template), host)
        # The reshard window: host leaves -> this rank's shards on the
        # device, under the NEW world (which need not match the world the
        # shards were saved under). Timed separately so the rescale
        # timeline can attribute it as its own phase.
        reshard_start = reshard_end = time.time()
        if trainer is not None and state is not None:
            out = trainer.load_full_state(state, out)
            if trainer.device.type == "cuda":
                import torch

                torch.cuda.synchronize(trainer.device)  # the window covers the copies
            reshard_end = time.time()
    except Exception:  # edl: noqa[EDL005] the plane is the fast rung of the fallback ladder; any defect in it must demote to the blob restore, never fail recovery outright
        log.warning("ckpt-plane restore failed; falling back to blob restore",
                    exc_info=True)
        return None
    seconds = time.perf_counter() - t0
    if instruments is not None:
        instruments.restores.inc(source="peer")
        instruments.restore_bytes.inc(float(total), source="peer")
    if tracer is not None:
        tracer.record("peer_restore", t0_wall, time.time(),
                      component="worker", step=step, bytes=total,
                      world_at_save=world_at_save)
    return out, {"step": step, "bytes": total, "seconds": seconds,
                 "world_at_save": world_at_save, "source": "peer",
                 "reshard_start": reshard_start,
                 "reshard_end": reshard_end}
