"""Request router: the serving tier's control-plane component. A copy of
`edl_tpu.serving.router`.

A :class:`Router` fronts a mutable pool of replicas — fixed-shape batch
replicas (:class:`ServingReplica`) and LM replicas
(:class:`LMServingReplica`) side by side — and owns two things:

- **Health/affinity routing fed from replica status.** Batch requests go
  to the started replica with the shallowest queue (failing over on
  overload); LM streams go to the started replica with the most free KV
  blocks that can admit the stream's full token budget — the same
  ``kv.free_blocks`` number the replicas publish to coordinator KV, read
  here directly from ``status()``.
- **Zero-drop rescale under decode.** Removing a replica mid-decode
  evicts its live streams (:meth:`LMServingReplica.evict_streams` —
  blocks released, futures unresolved), and the router resubmits each
  stream's remainder elsewhere: the accumulated tokens become a prefix,
  ``prompt + generated`` re-prefills on the target, and the caller's
  future resolves with the stitched token list and an exact accounting —
  ``len(tokens)`` is identical to the unmigrated run. ``dropped_streams``
  stays 0 unless the pool ends up with no replica that can admit.

The router is in-process control plane (it holds replica objects, not
URLs): the unit the autoscaler's desired-replica delta acts through.
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from edl_tpu_torch.serving.kvcache import KVCacheExhaustedError
from edl_tpu_torch.serving.worker import ServeOverloadError

__all__ = ["Router", "NoReplicaError"]

log = logging.getLogger("edl_tpu_torch.serving.router")


class NoReplicaError(RuntimeError):
    """The pool holds no started replica of the kind this request needs."""


@dataclass
class _RoutedStream:
    """One LM stream as the router sees it: the caller-facing future plus
    the prefix accumulated across migrations."""

    sid: str
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int]
    future: Future
    prefix: List[int] = field(default_factory=list)
    segment: int = 0
    migrations: int = 0
    replica: Optional[str] = None  # current owner (name)


class Router:
    """Health/affinity router over a mutable replica pool."""

    def __init__(self, replicas=(), name: str = "router"):
        self.name = name
        self._lock = threading.Lock()
        self._replicas: Dict[str, Any] = {}
        self._streams: Dict[str, _RoutedStream] = {}
        self._counter = 0
        self._rr = 0
        self._completed = 0
        self._dropped = 0
        self._migrations = 0
        self._migrated_tokens = 0
        for r in replicas:
            self.add(r)

    # -- pool membership -------------------------------------------------------

    def add(self, replica) -> None:
        with self._lock:
            name = replica.config.name
            if name in self._replicas:
                raise ValueError(f"replica {name!r} already in the pool")
            self._replicas[name] = replica

    def remove(self, name: str, migrate: bool = True):
        """Detach ``name`` from the pool; with ``migrate`` its live LM
        streams are evicted and resubmitted across the remaining pool
        (token lists stitched — the zero-drop contract). Returns the
        replica for the caller to ``stop()``; a batch replica's own
        ``stop(drain=True)`` already resolves everything it accepted."""
        with self._lock:
            replica = self._replicas.pop(name, None)
        if replica is None:
            raise KeyError(f"replica {name!r} not in the pool")
        if migrate and hasattr(replica, "evict_streams"):
            for snap in replica.evict_streams():
                self._remigrate(snap)
        return replica

    def replica_names(self) -> List[str]:
        with self._lock:
            return sorted(self._replicas)

    def _candidates(self, lm: bool) -> List[Any]:
        with self._lock:
            pool = list(self._replicas.values())
        return [r for r in pool
                if getattr(r, "started", False)
                and hasattr(r, "generate") == lm]

    # -- batch path ------------------------------------------------------------

    def submit(self, features: Dict[str, Any]) -> Future:
        """Route one fixed-shape request to the shallowest-queue started
        batch replica, failing over on overload."""
        candidates = self._candidates(lm=False)
        if not candidates:
            raise NoReplicaError("no started batch replica in the pool")
        candidates.sort(key=lambda r: r.status()["queue_depth"])
        last: Optional[Exception] = None
        for r in candidates:
            try:
                return r.submit(features)
            except ServeOverloadError as e:
                last = e
        raise last if last is not None else NoReplicaError("no capacity")

    # -- LM path ---------------------------------------------------------------

    def generate_async(self, prompt, max_new_tokens: Optional[int] = None,
                       eos_id: Optional[int] = None):
        """Admit one LM stream against the pool; returns a handle whose
        result carries the stitched token list (``migrations`` counts the
        rescues it survived). Admission rejections (`SeqTooLongError`,
        `KVCacheExhaustedError` when no replica can hold it) raise
        synchronously, same as a single replica."""
        from edl_tpu_torch.serving.lm import LMStreamHandle

        ids = np.asarray(prompt, dtype=np.int32).reshape(-1)
        with self._lock:
            self._counter += 1
            sid = f"{self.name}-r{self._counter}"
        rs = _RoutedStream(sid=sid, prompt=ids,
                           max_new_tokens=int(max_new_tokens or 0) or None,
                           eos_id=eos_id, future=Future())
        with self._lock:
            self._streams[sid] = rs
        try:
            self._dispatch(rs, ids, rs.max_new_tokens)
        except Exception:
            with self._lock:
                self._streams.pop(sid, None)
            raise
        return LMStreamHandle(stream_id=sid, future=rs.future)

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 timeout: Optional[float] = 60.0) -> Dict[str, Any]:
        return self.generate_async(prompt, max_new_tokens, eos_id).result(
            timeout=timeout
        )

    def _pick_lm_replica(self):
        """Affinity policy: started LM replicas ordered by free KV blocks
        (descending) — route to headroom, spill to the rest."""
        candidates = self._candidates(lm=True)
        if not candidates:
            raise NoReplicaError("no started LM replica in the pool")

        def free_blocks(r) -> int:
            try:
                return int(r.status().get("kv", {}).get("free_blocks", 0))
            except Exception:  # edl: noqa[EDL005] a replica failing status mid-rescale just sorts last; routing must not die on it
                return -1

        candidates.sort(key=free_blocks, reverse=True)
        return candidates

    def _dispatch(self, rs: _RoutedStream, prompt: np.ndarray,
                  budget: Optional[int]) -> None:
        """Submit one segment of ``rs`` to the best replica; tries the
        pool in affinity order, re-raising the last admission error when
        every replica is out of blocks."""
        last: Optional[Exception] = None
        for r in self._pick_lm_replica():
            rs.segment += 1
            inner_id = f"{rs.sid}/seg{rs.segment}"
            try:
                handle = r.submit(prompt, max_new_tokens=budget,
                                  eos_id=rs.eos_id, stream_id=inner_id)
            except KVCacheExhaustedError as e:
                last = e
                continue
            rs.replica = r.config.name
            handle.future.add_done_callback(
                lambda fut, sid=rs.sid: self._on_segment_done(sid, fut)
            )
            return
        raise last if last is not None else NoReplicaError("no capacity")

    def _on_segment_done(self, sid: str, fut: Future) -> None:
        with self._lock:
            rs = self._streams.pop(sid, None)
        if rs is None:
            return  # mid-migration: the resubmitted segment owns the finish
        error = fut.exception()
        if error is not None:
            with self._lock:
                self._dropped += 1
            rs.future.set_exception(error)
            return
        result = fut.result()
        with self._lock:
            self._completed += 1
        rs.future.set_result({
            "stream_id": rs.sid,
            "tokens": rs.prefix + list(result["tokens"]),
            "finish_reason": result["finish_reason"],
            "prompt_tokens": int(rs.prompt.size),
            "model_step": result.get("model_step"),
            "migrations": rs.migrations,
        })

    def _remigrate(self, snap: Dict[str, Any]) -> None:
        """Resubmit one evicted stream's remainder: generated-so-far joins
        the prefix, prompt+generated re-prefills elsewhere with the
        reduced budget. The eviction released the source replica's blocks;
        admission on the target is a fresh reservation for what is left."""
        sid = str(snap["stream_id"]).split("/", 1)[0]
        with self._lock:
            rs = self._streams.get(sid)
        if rs is None:
            return  # finished in the gap between evict and resubmit
        generated = list(snap["generated"])
        with self._lock:
            rs.prefix.extend(generated)
            rs.migrations += 1
            self._migrations += 1
            self._migrated_tokens += len(generated)
        new_prompt = np.concatenate(
            [snap["prompt"], np.asarray(generated, dtype=np.int32)]
        ) if generated else snap["prompt"]
        try:
            self._dispatch(rs, new_prompt, snap["max_new_tokens"])
        except Exception as e:  # resolved into the caller's future: a pool with no admitting replica left is the one case a stream drops, and it drops loudly
            with self._lock:
                self._streams.pop(sid, None)
                self._dropped += 1
            log.error("stream %s dropped during migration: %s", sid, e)
            rs.future.set_exception(e)

    # -- status ----------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "replicas": sorted(self._replicas),
                "streams_inflight": len(self._streams),
                "completed_streams": self._completed,
                "dropped_streams": self._dropped,
                "migrations": self._migrations,
                "migrated_tokens": self._migrated_tokens,
            }
