"""Shard replication: host-level ZeRO-1 slices pushed through the wire, the
port of `edl_tpu.ckpt_plane.replicator`.

Each worker owns a 1/``world`` slice of every state leaf — the same
largest-divisible-dim layout ``parallel.collective.zero_shard_spec`` pins
on the ranks (``zero_shard_dim`` picks the dim here too, so the host slice
IS the ZeRO shard). Leaves no dim of which divides by ``world`` (scalars,
odd shapes) are owned whole by rank 0. The slices serialize into one blob:

    manifest JSON line  \\n  raw little-endian leaf-slice bytes, leaf order

and the blob rides the coordinator wire base64-encoded in ~256 KB chunks
(``shard_put`` — epoch-stamped, ``put_id``-deduped, batched through the
``batch`` frame when the transport supports it). The format is numpy-level
and the JAX package's byte for byte: the same leaves give the same blob
(bf16 leaves carry ml_dtypes' dtype string ``<V2``), so either package
assembles the other's shards. The coordinator's shard store is
memory-resident and deliberately unjournaled: losing the coordinator loses
the plane, and recovery falls back to the blob-store ``Checkpointer``.

The state a worker replicates is `Trainer.full_state`'s dict (every table
row and ZeRO moment gathered whole, on the host): `host_leaves` flattens
it in a fixed order — the step, the module's state_dict in its order, then
the optimizer's per-param state by param index and key — and `StateDef`
keeps what `unflatten` needs to rebuild it (keys, dtypes, the non-tensor
entries such as ``param_groups``). The blobs carry no names, so a restorer
takes the structure from a template of its own fresh state
(`state_template`).
"""

from __future__ import annotations

import base64
import json
import logging
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from edl_tpu_torch.ckpt_plane.placement import publish_placement, replica_group
from edl_tpu_torch.parallel.collective import zero_shard_dim

log = logging.getLogger("edl_tpu_torch.ckpt_plane")

#: wire chunk size BEFORE base64 (the encoded line grows 4/3): large enough
#: to amortize per-op framing, small enough that one chunk never stalls the
#: coordinator's single-threaded event loop noticeably.
CHUNK_BYTES = 256 * 1024

#: owner key prefix in the coordinator shard store; owners are named by the
#: membership rank that wrote them (``z0``, ``z1``, ...), which is exactly
#: the identity the manifest's ``world`` lets a restorer re-enumerate.
OWNER_PREFIX = "z"

#: numpy has no bfloat16: its bits travel as 2-byte void items, and the
#: manifest names them ``<V2``, the dtype string of ml_dtypes' bfloat16
#: (what a JAX bf16 leaf becomes in numpy)
BF16_DTYPE = np.dtype("V2")
BF16_DTYPE_STR = "<V2"


def _dtype_str(dtype: np.dtype) -> str:
    return BF16_DTYPE_STR if dtype.kind == "V" and dtype.itemsize == 2 else dtype.str


def owner_key(rank: int, prefix: str = OWNER_PREFIX) -> str:
    return f"{prefix}{int(rank)}"


def leaf_slice(arr: np.ndarray, rank: int, world: int
               ) -> Tuple[Optional[np.ndarray], Optional[int]]:
    """``rank``'s ZeRO slice of ``arr`` under ``world``, and the sliced dim.

    Mirrors ``zero_shard_spec``'s placement: the largest dim divisible by
    ``world`` is split evenly; when none divides (or world==1) the whole
    leaf belongs to rank 0 and every other rank contributes nothing.
    """
    dim = zero_shard_dim(arr.shape, world)
    if dim is None:
        return (arr if rank == 0 else None), None
    per = arr.shape[dim] // world
    index: List[Any] = [slice(None)] * arr.ndim
    index[dim] = slice(rank * per, (rank + 1) * per)
    return np.ascontiguousarray(arr[tuple(index)]), dim


def serialize_shard(leaves: List[np.ndarray], step: int, rank: int,
                    world: int) -> bytes:
    """One rank's shard blob: manifest line + concatenated slice bytes."""
    metas: List[Dict] = []
    payload: List[bytes] = []
    for arr in leaves:
        arr = np.asarray(arr)
        piece, dim = leaf_slice(arr, rank, world)
        raw = piece.tobytes() if piece is not None else b""
        metas.append({
            "shape": list(arr.shape),
            "dtype": _dtype_str(arr.dtype),
            "dim": dim,
            "nbytes": len(raw),
        })
        payload.append(raw)
    manifest = {
        "v": 1,
        "step": int(step),
        "rank": int(rank),
        "world": int(world),
        "leaves": metas,
    }
    return json.dumps(manifest).encode() + b"\n" + b"".join(payload)


def parse_shard(blob: bytes) -> Tuple[Dict, bytes]:
    """Split a shard blob back into (manifest, payload bytes)."""
    head, sep, payload = blob.partition(b"\n")
    if not sep:
        raise ValueError("shard blob has no manifest line")
    return json.loads(head.decode()), payload


def chunk_blob(blob: bytes, chunk_bytes: int = CHUNK_BYTES) -> List[str]:
    """Base64-encoded wire chunks (at least one, even for an empty blob)."""
    chunks = [
        base64.b64encode(blob[i:i + chunk_bytes]).decode("ascii")
        for i in range(0, len(blob), chunk_bytes)
    ] or [base64.b64encode(b"").decode("ascii")]
    return chunks


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's host value as numpy; bf16 as its bits in `BF16_DTYPE`."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_DTYPE)
    return t.numpy()


def from_numpy(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """`to_numpy`'s inverse, to a tensor of ``dtype`` (bf16 from its bits)."""
    if dtype == torch.bfloat16:
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(dtype)


@dataclass
class StateDef:
    """The structure of a `Trainer.full_state` dict without its tensors:
    each leaf's path and dtype in `host_leaves`' order, and the dict with
    every tensor replaced by None."""

    paths: List[Tuple]
    dtypes: List[torch.dtype]
    skeleton: Dict


def _leaf_paths(full: Dict) -> List[Tuple]:
    paths: List[Tuple] = [("step",)]
    paths += [("module", k) for k, v in full["module"].items()
              if isinstance(v, torch.Tensor)]
    opt = full["optimizer"]["state"]
    for i in sorted(opt):
        paths += [("optimizer", "state", i, k) for k in sorted(opt[i])
                  if isinstance(opt[i][k], torch.Tensor)]
    return paths


def _get(tree: Dict, path: Tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def _set(tree: Dict, path: Tuple, value: Any) -> None:
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def state_def(full: Dict) -> StateDef:
    """The `StateDef` of a `Trainer.full_state` dict (no tensor is copied)."""
    paths = _leaf_paths(full)
    skeleton = {"step": None,
                "module": dict(full["module"]),
                "optimizer": {"state": {i: dict(per) for i, per in
                                        full["optimizer"]["state"].items()},
                              "param_groups": full["optimizer"]["param_groups"]}}
    dtypes = [torch.int32]
    for path in paths[1:]:
        dtypes.append(_get(full, path).dtype)
        _set(skeleton, path, None)
    return StateDef(paths, dtypes, skeleton)


def host_leaves(full: Dict) -> Tuple[List[np.ndarray], StateDef]:
    """Flatten a `Trainer.full_state` dict to host numpy leaves + its
    `StateDef`. The step is leaf 0, an int32 scalar as the JAX package's
    ``TrainState.step`` is."""
    defn = state_def(full)
    leaves = [np.asarray(int(full["step"]), dtype=np.int32)]
    leaves += [to_numpy(_get(full, path)) for path in defn.paths[1:]]
    return leaves, defn


def _lazy_state_spec(opt: torch.optim.Optimizer) -> Dict[str, Tuple[bool, torch.dtype]]:
    """The per-param state ``opt``'s class creates at its first step, as
    ``{key: (shaped like the param, dtype)}``: read from a probe of the
    same class and hyper-parameters stepping a two-element CPU param."""
    p = torch.zeros(2, requires_grad=True)
    probe = type(opt)([p], **{k: v for k, v in opt.defaults.items()
                              if k not in ("capturable", "fused")})
    p.grad = torch.zeros_like(p)
    probe.step()
    return {k: (v.dim() > 0, v.dtype) for k, v in probe.state[p].items()
            if isinstance(v, torch.Tensor)}


def state_template(trainer, state) -> Dict:
    """A `Trainer.full_state` dict of ``state`` (collective on a mesh)
    whose optimizer entries are complete: ``torch.optim`` creates Adam's
    moments and step count at the first step, so a fresh state has none,
    while the blobs it must match carry them. Missing entries are zeros of
    the params' whole shapes, laid out as the optimizer's class lays them
    out — a template fixes the leaf order, not the values."""
    full = trainer.full_state(state)
    opt = state.opt_state
    module = state.params
    # numbered as the one-device module's params, whose whole shapes
    # `full_state` gathered: on a pipeline mesh a rank holds only its
    # stage's layers, so its own params do not cover them
    if trainer.mesh is None:
        names = [n for n, _ in module.named_parameters()]
    else:
        names = trainer.layout_for(module).full_names
    shapes = [tuple(full["module"][n].shape) for n in names]
    per = full["optimizer"]["state"]
    missing = [i for i in range(len(shapes)) if not per.get(i)]
    if missing:
        spec = _lazy_state_spec(opt)
        for i in missing:
            if spec:
                per[i] = {k: torch.zeros(shapes[i] if shaped else (), dtype=dtype)
                          for k, (shaped, dtype) in spec.items()}
    return full


def unflatten(defn: StateDef, leaves: List[np.ndarray]) -> Dict:
    """The full-state dict ``defn`` describes, with ``leaves`` (host numpy,
    `host_leaves`' order) as its tensors; the step as an int."""
    if len(leaves) != len(defn.paths):
        raise ValueError(f"{len(leaves)} leaves for a state of {len(defn.paths)}")
    out = {"step": int(np.asarray(leaves[0]).reshape(())),
           "module": dict(defn.skeleton["module"]),
           "optimizer": {"state": {i: dict(per) for i, per in
                                   defn.skeleton["optimizer"]["state"].items()},
                         "param_groups": defn.skeleton["optimizer"]["param_groups"]}}
    for path, dtype, arr in zip(defn.paths[1:], defn.dtypes[1:], leaves[1:]):
        _set(out, path, from_numpy(arr, dtype))
    return out


class CkptPlane:
    """One worker's handle on the memory-resident checkpoint plane.

    Everything here is best-effort by design: replication that fails (the
    coordinator is down, mid-restart, out of memory) logs and returns
    None — the blob-store checkpoint the caller just wrote is the durable
    copy; the plane only makes recovery *faster*, never *possible*.

    The state it takes is a `Trainer.full_state` dict (``full``): the JAX
    package's single-controller array gathers itself on the host, while a
    port worker gathers its shards with the Trainer first.
    """

    def __init__(self, client, replicas: int = 1,
                 owner_prefix: str = OWNER_PREFIX,
                 chunk_bytes: int = CHUNK_BYTES,
                 instruments=None, tracer=None):
        if replicas < 1:
            raise ValueError(f"CkptPlane needs replicas >= 1, got {replicas}")
        # Plane traffic goes to the RAW transport, not an OutboxClient
        # facade: buffering multi-MB shard chunks for outage replay would
        # turn the outbox into a second (worse) checkpoint store.
        self.client = getattr(client, "client", client)
        self.replicas = int(replicas)
        self.owner_prefix = owner_prefix
        self.chunk_bytes = int(chunk_bytes)
        if instruments is None:
            from edl_tpu_torch.obs.instruments import CkptPlaneInstruments

            instruments = CkptPlaneInstruments()
        self.obs = instruments
        self.tracer = tracer
        #: last epoch whose placement map this worker published (the key
        #: ``on_epoch`` invalidates when the epoch moves on).
        self._published_epoch: Optional[int] = None
        #: ranks under an advance-notice revocation: excluded from every
        #: replica ring this plane computes until the drain completes.
        self._revoked: set = set()

    # -- revocation override ---------------------------------------------------

    def set_revoked(self, ranks) -> None:
        """Install the revocation override: ``ranks`` are doomed hosts that
        must not HOLD replicas (they may still own shards — that data is
        what ``evacuate`` copies off). Pass an empty iterable to clear."""
        self._revoked = {int(r) for r in (ranks or ())}

    def evacuate(self, full: Dict, step: int, world: int) -> Optional[Dict]:
        """Re-push the revoked ranks' shards under the exclusion override,
        landing their ZeRO slices on surviving hosts specifically — the
        drain step of an advance-notice revocation. No-op (None) when no
        revoked rank is in range."""
        doomed = sorted(r for r in self._revoked if 0 <= r < world)
        if not doomed:
            return None
        return self._replicate_ranks(full, step, doomed, world)

    # -- placement lifecycle ---------------------------------------------------

    def on_epoch(self, epoch: int, world: int, rank: int) -> None:
        """Membership epoch adopted: publish the new placement map and
        invalidate the previous epoch's. Idempotent and best-effort."""
        try:
            publish_placement(self.client, epoch, world, self.replicas,
                              prev_epoch=self._published_epoch,
                              exclude=sorted(self._revoked))
            self._published_epoch = int(epoch)
        except Exception:  # edl: noqa[EDL005] placement publish is advisory metadata; losing it degrades to manifest-derived discovery, never to data loss
            log.debug("ckpt-plane placement publish failed", exc_info=True)

    # -- replication -----------------------------------------------------------

    def replicate(self, full: Dict, step: int, rank: int,
                  world: int) -> Optional[Dict]:
        """Push this rank's ZeRO slice of ``full`` at ``step`` to the plane
        (the multi-process path: each process owns one slice). Returns
        {bytes, chunks, seconds} or None on failure."""
        return self._replicate_ranks(full, step, [rank], world)

    def replicate_all(self, full: Dict, step: int,
                      world: int) -> Optional[Dict]:
        """Push EVERY rank's slice from one process — the `ElasticWorker`
        path, whose one process holds the whole state. The plane still
        stores them as ``world`` independent owners: recovery and the
        group-death fallback behave identically to the per-process
        layout."""
        return self._replicate_ranks(full, step, list(range(world)), world)

    def _replicate_ranks(self, full: Dict, step: int, ranks: List[int],
                         world: int) -> Optional[Dict]:
        t0 = time.perf_counter()
        t0_wall = time.time()  # spans stitch on the wall clock
        total = 0
        chunk_count = 0
        try:
            leaves, _ = host_leaves(full)
            for rank in ranks:
                blob = serialize_shard(leaves, step, rank, world)
                chunks = chunk_blob(blob, self.chunk_bytes)
                group = [owner_key(h, self.owner_prefix)
                         for h in replica_group(rank, world, self.replicas,
                                                exclude=self._revoked)]
                self._put_chunks(owner_key(rank, self.owner_prefix), step,
                                 chunks, len(blob), group)
                total += len(blob)
                chunk_count += len(chunks)
        except Exception:  # edl: noqa[EDL005] replication is the fast path on top of a durable blob save; any transport/serialization failure must degrade, not propagate
            log.warning("ckpt-plane replicate failed at step %s; blob "
                        "checkpoint remains the restore source", step,
                        exc_info=True)
            return None
        seconds = time.perf_counter() - t0
        self.obs.replicated_bytes.inc(float(total))
        self.obs.replications.inc()
        self.obs.replication_lag.set(seconds)
        if self.tracer is not None:
            self.tracer.record("peer_replicate", t0_wall, time.time(),
                               component="worker", step=int(step),
                               bytes=total, chunks=chunk_count)
        return {"bytes": total, "chunks": chunk_count, "seconds": seconds}

    def _put_chunks(self, owner: str, step: int, chunks: List[str],
                    nbytes: int, group: List[str]) -> None:
        """Wire the chunks, batched through one ``batch`` frame per window
        when the transport supports it (one round trip, positional
        replies), else one ``shard_put`` per chunk."""
        call_batch = getattr(self.client, "call_batch", None)
        total = len(chunks)
        if callable(call_batch):
            window = 8  # keep each batch frame's line well under a few MB
            for base in range(0, total, window):
                ops = []
                for i, data in enumerate(chunks[base:base + window]):
                    chunk = base + i
                    ops.append({
                        "op": "shard_put", "owner": owner, "step": int(step),
                        "chunk": chunk, "chunks": total, "nbytes": int(nbytes),
                        "data": data, "group": group,
                        "put_id": f"{owner}.s{step}.c{chunk}",
                    })
                for sub in call_batch(ops):
                    if not sub.get("ok"):
                        raise RuntimeError(f"shard_put rejected: {sub}")
        else:
            for chunk, data in enumerate(chunks):
                reply = self.client.shard_put(
                    owner, int(step), chunk, total, data,
                    nbytes=int(nbytes), group=group,
                    put_id=f"{owner}.s{step}.c{chunk}",
                )
                if not reply.get("ok"):
                    raise RuntimeError(f"shard_put rejected: {reply}")

    # -- recovery (delegates to ckpt_plane.recovery) ---------------------------

    def restore(self, template: Dict, trainer=None, state=None,
                min_step: Optional[int] = None) -> Optional[Tuple[Any, Dict]]:
        """Assemble the full state from the plane; see ``recovery.peer_restore``."""
        from edl_tpu_torch.ckpt_plane.recovery import peer_restore

        return peer_restore(self.client, template, trainer=trainer, state=state,
                            min_step=min_step, owner_prefix=self.owner_prefix,
                            instruments=self.obs, tracer=self.tracer)

    # -- admin / test surface --------------------------------------------------

    def drop_owner(self, rank: int, step: int = -1) -> None:
        """Forget one owner's shard (chaos harness: a replica-group death is
        every member's drop)."""
        self.client.shard_drop(owner_key(rank, self.owner_prefix), step)
