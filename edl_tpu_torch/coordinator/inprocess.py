"""Pure-Python twin of the C++ coordinator state machine.

Same semantics as `native/coordinator/coordinator.cc` (membership epochs,
dense re-ranking, 16s-style task leases with requeue, generation-counted
barriers, KV), behind the same client method surface — so tests and the
single-host launcher can run hermetically without the native binary, exactly
the role the reference's in-memory fake clientset plays
(`pkg/client/clientset/versioned/fake/`). Thread-safe; barriers block on a
Condition instead of a parked socket.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Dict, List, Optional, Set

from edl_tpu_torch.coordinator.sharding import shard_of


class InProcessCoordinator:
    def __init__(self, task_lease_sec: float = 16.0,
                 heartbeat_ttl_sec: float = 10.0,
                 auth_token: Optional[str] = None,
                 shard_endpoints: Optional[List[str]] = None,
                 state_file: Optional[str] = None,
                 run_id: Optional[str] = None,
                 compact_every: Optional[int] = None,
                 skip_tail_commit_scan: bool = False):
        self.task_lease_sec = task_lease_sec
        self.heartbeat_ttl_sec = heartbeat_ttl_sec
        #: per-job shared secret, same contract as the native binary's
        #: EDL_COORD_TOKEN: empty/None disables auth; set, every client op
        #: except ping must present it (CoordinatorAuthError otherwise).
        self.auth_token = auth_token or ""
        self._lock = threading.RLock()
        self._barrier_cv = threading.Condition(self._lock)
        self._boot_monotonic = time.monotonic()
        self._epoch = 0
        self._next_rank = 0
        self._members: Dict[str, Dict] = {}  # name -> {rank, last_heartbeat}
        self._todo: deque = deque()
        self._leased: Dict[str, Dict] = {}  # task -> {worker, deadline}
        # Last acquire per worker: worker -> (req_id, task), so a retried
        # acquire (lost reply) gets the same lease back (native parity).
        self._acquire_cache: Dict[str, tuple] = {}
        self._done: Set[str] = set()
        self._barriers: Dict[str, Dict] = {}  # name -> {arrived, generation}
        self._sync_arrived: Set[str] = set()
        self._sync_generation = 0
        self._kv: Dict[str, str] = {}
        # Memory-resident checkpoint plane (native parity: op_shard_*).
        # owner -> {step, chunks, nbytes, group, data: {chunk: payload}}.
        # Volatile by design (the native store is not journaled either):
        # the blob-store checkpoint stays the durable tier, and member drop
        # does NOT clear an owner's blob — surviving a dead owner is the
        # whole point of the plane.
        self._shards: Dict[str, Dict] = {}
        self._shard_put_seen: Set[str] = set()
        self._shard_put_order: deque = deque()
        # Sharded-root twin (native --shards): with endpoints configured,
        # every keyspace op answers a redirect instead of being served —
        # EDL009 drives redirect-during-watch schedules through this.
        self._shard_endpoints: List[str] = list(shard_endpoints or [])
        self._shard_index = -1
        self._num_shards = 0
        # Watch subscriptions (native parity, worker-keyed instead of
        # fd-keyed): pending notification frames per subscriber, drained by
        # the shim's watch take path the way the wire server pushes them.
        self._watch_queues: Dict[str, deque] = {}
        # Pending advance-notice revocations (native parity: preempts_),
        # worker -> {notice_s, reason, seq}. Volatile by design — a
        # restarted coordinator forgets notices and the scheduler re-issues
        # them; consumed when the worker actually departs (_drop_member).
        self._preempts: Dict[str, Dict] = {}
        self._preempt_seq = 0
        # Test-only mutation hook: EDL009's model checker flips this on a
        # deliberately-broken twin to prove a dedup regression is caught.
        # Never set outside tests.
        self._test_disable_dedup = False
        # Native-parity status counters. Without a state file the journal
        # trio stays zero, but the fields must exist so status replies are
        # field-identical across backends (EDL007).
        self._ops_count = 0
        self._batch_frames = 0
        self._batch_subops = 0
        # State-file persistence twin (EDL010): a JSONL group-commit journal
        # mirroring the native server's — same record vocabulary (meta /
        # todo / done / lease / kv / kvdel), one frame per event-loop turn,
        # each frame closed by a {"k":"c"} commit-marker line. Recovery
        # replays only the committed prefix (everything after the last
        # marker is a torn tail and is truncated away), restores leases
        # under their holders, rebuilds the acquire req_id cache from the
        # journaled lease records, and bumps the epoch.
        self._state_file = state_file
        self._run_id = run_id or ""
        self._compact_every = compact_every
        # Test-only mutant hook (EDL010 teeth): skip the tail-commit scan
        # during recovery, replaying partial frames the way the journal
        # format's silent-skip predecessor did. Never set outside tests.
        self._skip_tail_commit_scan = skip_tail_commit_scan
        # Test-only crash hook: the next frame commit is dropped on the
        # floor (the on-disk effect of dying inside a snapshot write,
        # after the tmp write and before the rename).
        self._test_crash_before_commit = False
        self._pending_records: List[str] = []
        self._turn_depth = 0  # >0: a batch frame is open; defer commits
        self._fsyncs = 0
        self._snapshots = 0
        self._records_since = 0  # journal lines since last snapshot
        if self._state_file:
            self._load_state()

    # -- state-file persistence (the EDL010 twin journal) ----------------------

    def _record(self, obj: Dict) -> None:
        if self._state_file:
            self._pending_records.append(json.dumps(obj, sort_keys=True))

    def _record_epoch(self) -> None:
        self._record({"k": "meta", "epoch": self._epoch,
                      "run_id": self._run_id})

    def _record_todo(self, tasks: List[str]) -> None:
        if tasks:  # native parity: the empty list is not journaled
            self._record({"k": "todo", "tasks": list(tasks)})

    def _record_done(self, task: str) -> None:
        self._record({"k": "done", "tasks": [task]})

    def _record_lease(self, task: str, worker: str,
                      req_id: str = "") -> None:
        self._record({"k": "lease", "task": task, "worker": worker,
                      "req_id": req_id})

    def _record_kv(self, key: str) -> None:
        self._record({"k": "kv", "key": key,
                      "value": self._kv.get(key, "")})

    def _record_kv_del(self, key: str) -> None:
        self._record({"k": "kvdel", "key": key})

    def _append_frame(self, lines: List[str]) -> None:
        with open(self._state_file, "a", encoding="utf-8") as f:
            for line in lines:
                f.write(line + "\n")
            f.write('{"k": "c"}\n')  # the frame's commit marker
            f.flush()
        self._fsyncs += 1
        self._records_since += len(lines) + 1

    def _commit(self) -> None:
        """Group-commit the turn's records: one append + one fsync per
        event-loop turn — or a snapshot when past the compaction threshold
        (checked BEFORE appending, the native ``maybe_save_state`` shape;
        the snapshot covers the pending effects because in-memory state
        already has them)."""
        if not self._state_file or not self._pending_records:
            return
        if self._turn_depth > 0:
            return  # a batch frame is open: sub-op records ride it
        if self._test_crash_before_commit:
            # dying inside the snapshot write, before the rename: the
            # journal is untouched and the frame never reaches disk.
            self._test_crash_before_commit = False
            self._pending_records = []
            return
        pending = self._pending_records
        self._pending_records = []
        if (self._compact_every is not None
                and self._records_since >= self._compact_every):
            self._save_snapshot()
        else:
            self._append_frame(pending)

    def _save_snapshot(self) -> None:
        """Native ``save_snapshot`` layout: meta, todo (live queue order),
        one lease line per held lease (carrying the holder's cached req_id
        when it names this task), done, kv — tmp write + rename."""
        recs: List[Dict] = [{"k": "meta", "epoch": self._epoch,
                             "run_id": self._run_id}]
        if self._todo:
            recs.append({"k": "todo", "tasks": list(self._todo)})
        req_of = {}
        for w, (req, task) in self._acquire_cache.items():
            req_of[(task, w)] = req
        for task in sorted(self._leased):
            w = self._leased[task]["worker"]
            recs.append({"k": "lease", "task": task, "worker": w,
                         "req_id": req_of.get((task, w), "")})
        for task in sorted(self._done):
            recs.append({"k": "done", "tasks": [task]})
        for key in sorted(self._kv):
            recs.append({"k": "kv", "key": key, "value": self._kv[key]})
        tmp = self._state_file + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for rec in recs:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
            f.write('{"k": "c"}\n')
            f.flush()
        os.replace(tmp, self._state_file)
        self._snapshots += 1
        self._records_since = 0

    def _load_state(self) -> None:
        """Recovery replay (native ``load_state`` semantics): replay the
        committed journal prefix, restore leases under their holders,
        rebuild the acquire req_id dedup cache from the journaled lease
        records, bump the epoch (a restart IS a membership event), and
        truncate any torn tail away on disk."""
        try:
            with open(self._state_file, "r", encoding="utf-8") as f:
                raw = [ln for ln in f.read().splitlines() if ln.strip()]
        except OSError:
            self._boot_frame()
            return
        # Tail-commit scan: only the prefix up to the last {"k":"c"} marker
        # is durable; everything after it is a torn frame and must be
        # dropped WHOLE (all-or-nothing is the frame contract). Files from
        # the pre-marker format (no "c" records at all) are taken whole.
        committed = raw
        if not self._skip_tail_commit_scan:
            last_c = -1
            for i, line in enumerate(raw):
                try:
                    if json.loads(line).get("k") == "c":
                        last_c = i
                except ValueError:
                    continue
            if last_c >= 0:
                committed = raw[: last_c + 1]
        epoch = 0
        todo_order: List[str] = []
        seen: Set[str] = set()
        lease_of: Dict[str, str] = {}
        cache: Dict[str, tuple] = {}
        done: Set[str] = set()
        kv: Dict[str, str] = {}
        for line in committed:
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # mutant/legacy lane: unparseable lines skipped
            kind = rec.get("k")
            if kind == "meta":
                if self._run_id and rec.get("run_id") \
                        and rec["run_id"] != self._run_id:
                    # another run's journal: discard it, start fresh
                    open(self._state_file, "w", encoding="utf-8").close()
                    self._records_since = 0
                    self._boot_frame()
                    return
                epoch = int(rec.get("epoch", 0))
            elif kind == "todo":
                for t in rec.get("tasks", []):
                    if t not in seen:
                        seen.add(t)
                        todo_order.append(t)
            elif kind == "done":
                for t in rec.get("tasks", []):
                    done.add(t)
            elif kind == "lease":
                t, w = rec.get("task", ""), rec.get("worker", "")
                if t and t not in seen:  # a lease implies the task exists
                    seen.add(t)
                    todo_order.append(t)
                lease_of[t] = w
                if w and rec.get("req_id"):
                    cache[w] = (rec["req_id"], t)
            elif kind == "kv":
                kv[rec.get("key", "")] = rec.get("value", "")
            elif kind == "kvdel":
                kv.pop(rec.get("key", ""), None)
        if len(committed) != len(raw):
            with open(self._state_file, "w", encoding="utf-8") as f:
                for line in committed:
                    f.write(line + "\n")
        self._epoch = epoch + 1
        now = time.monotonic()
        self._todo = deque(
            t for t in todo_order if t not in done and not lease_of.get(t))
        self._leased = {
            t: {"worker": w, "deadline": now + self.task_lease_sec}
            for t, w in lease_of.items() if w and t not in done
        }
        self._done = set(done)
        self._kv = dict(kv)
        self._acquire_cache = dict(cache)
        self._records_since = len(committed)
        self._boot_frame()

    def _boot_frame(self) -> None:
        """A fresh incarnation's first frame: the epoch meta record. The
        native server queues it in load_state and flushes on the next
        turn; the twin flushes synchronously so the file always names the
        live epoch. Bypasses compaction (matching the model's recovery)."""
        self._record_epoch()
        lines = self._pending_records
        self._pending_records = []
        if lines:
            self._append_frame(lines)

    # -- expiry ---------------------------------------------------------------

    def _tick(self) -> None:
        now = time.monotonic()
        dead = [
            n for n, m in self._members.items()
            if m["last_heartbeat"] + self.heartbeat_ttl_sec <= now
        ]
        for name in dead:
            self._drop_member(name)
        expired = [t for t, l in self._leased.items() if l["deadline"] <= now]
        for t in expired:
            del self._leased[t]
            self._todo.append(t)
            self._record_lease(t, "", "")
        if dead or expired:
            # expiry is its own event-loop turn (native: tick()), so its
            # records commit as their own frame, not the caller op's.
            self._commit()

    def _drop_member(self, name: str) -> None:
        if name not in self._members:
            return
        del self._members[name]
        by_rank = sorted(self._members.items(), key=lambda kv: kv[1]["rank"])
        for r, (n, m) in enumerate(by_rank):
            m["rank"] = r
        self._next_rank = len(self._members)
        self._epoch += 1
        self._record_epoch()
        self._notify_watchers()
        self._requeue_worker_leases(name)
        self._acquire_cache.pop(name, None)
        # The departure a notice predicted has happened: the revocation is
        # consumed (a re-registered successor under this name is fresh).
        self._preempts.pop(name, None)
        self._release_sync()

    def _release_sync(self) -> None:
        """Membership moved: wake parked sync waiters so they resync."""
        self._sync_arrived = set()
        self._barrier_cv.notify_all()

    def _membership_reply(self, worker: str) -> Dict:
        m = self._members.get(worker)
        return {
            "ok": True,
            "rank": m["rank"] if m else -1,
            "epoch": self._epoch,
            "world": len(self._members),
        }

    # -- ops (mirror the C++ op_* handlers) -----------------------------------

    def register(self, worker: str, takeover: bool = False) -> Dict:
        with self._lock:
            self._tick()
            if not worker:
                # Same refusal as the native op_register: an anonymous member
                # could never be ranked or dropped.
                return {"ok": False, "error": "worker required",
                        "epoch": self._epoch}
            if takeover:
                # Incarnation boundary: leases held under this name belong
                # to a dead predecessor (same pod name, warm-restarted);
                # requeue them for replay — the successor's heartbeats would
                # otherwise renew them forever and rank 0 would deadlock on
                # its own stale leases. A plain refresh (takeover=False)
                # renews instead: a live mid-run re-register must not
                # forfeit shards it is training.
                self._requeue_worker_leases(worker)
            if worker not in self._members:
                self._members[worker] = {
                    "rank": self._next_rank,
                    "last_heartbeat": time.monotonic(),
                }
                self._next_rank += 1
                self._epoch += 1
                self._record_epoch()
                self._notify_watchers()
                self._release_sync()
            else:
                self._members[worker]["last_heartbeat"] = time.monotonic()
                self._renew_leases(worker)
            self._commit()
            return self._membership_reply(worker)

    def _requeue_worker_leases(self, worker: str) -> None:
        stale = [t for t, l in self._leased.items() if l["worker"] == worker]
        for t in stale:
            del self._leased[t]
            self._todo.append(t)
            self._record_lease(t, "", "")

    def _renew_leases(self, worker: str) -> None:
        """A live worker keeps its leases (etcd-keepalive semantics): renewal
        rides heartbeats, so completion-lag holds can outlive task_lease_sec
        without healthy runs retraining shards; expiry fires only when the
        heartbeat ALSO stopped — a real failure. Mirrors the C++ service."""
        deadline = time.monotonic() + self.task_lease_sec
        for lease in self._leased.values():
            if lease["worker"] == worker:
                lease["deadline"] = deadline

    def heartbeat(self, worker: str) -> Dict:
        with self._lock:
            self._tick()
            if worker not in self._members:
                return {"ok": False, "error": "unknown worker", "epoch": self._epoch}
            self._members[worker]["last_heartbeat"] = time.monotonic()
            self._renew_leases(worker)
            return self._membership_reply(worker)

    def leave(self, worker: str) -> Dict:
        with self._lock:
            self._tick()
            self._drop_member(worker)
            self._commit()
            return {"ok": True, "epoch": self._epoch}

    def members(self) -> List[str]:
        with self._lock:
            self._tick()
            return [
                n for n, _ in sorted(
                    self._members.items(), key=lambda kv: kv[1]["rank"]
                )
            ]

    def epoch(self) -> int:
        with self._lock:
            self._tick()
            return self._epoch

    def add_tasks(self, tasks: List[str]) -> int:
        with self._lock:
            self._tick()
            added = 0
            fresh: List[str] = []
            for t in tasks:
                if t in self._done or t in self._leased or t in self._todo:
                    continue
                self._todo.append(t)
                fresh.append(t)
                added += 1
            self._record_todo(fresh)
            self._commit()
            return added

    def acquire(self, worker: str, req_id: Optional[str] = None) -> Dict:
        with self._lock:
            self._tick()
            # Dedup (native parity): a retried acquire with the same req_id
            # returns the existing lease instead of popping a second task.
            if req_id and not self._test_disable_dedup:
                cached = self._acquire_cache.get(worker)
                if cached and cached[0] == req_id:
                    lease = self._leased.get(cached[1])
                    if lease and lease["worker"] == worker:
                        lease["deadline"] = time.monotonic() + self.task_lease_sec
                        return {"ok": True, "task": cached[1],
                                "lease_sec": self.task_lease_sec,
                                "duplicate": True}
            if not self._todo:
                return {"ok": True, "task": None, "exhausted": not self._leased}
            task = self._todo.popleft()
            self._leased[task] = {
                "worker": worker,
                "deadline": time.monotonic() + self.task_lease_sec,
            }
            if req_id:
                self._acquire_cache[worker] = (req_id, task)
            # The req_id rides the lease record (the EDL010 durability fix:
            # an unjournaled dedup cache would hand a retried acquire a
            # SECOND task after restart — an exactly-once violation).
            self._record_lease(task, worker, req_id or "")
            self._commit()
            return {"ok": True, "task": task, "lease_sec": self.task_lease_sec}

    def acquire_task(self, worker: str) -> Optional[str]:
        return self.acquire(worker).get("task")

    def complete_task(self, worker: str, task: str) -> Dict:
        with self._lock:
            self._tick()
            # Idempotent (native parity): replayed completions are success.
            if task in self._done:
                return {"ok": True, "duplicate": True,
                        "done": len(self._done), "queued": len(self._todo)}
            if task not in self._leased:
                # Requeued-but-unleased after an outage: the completer holds
                # a durable covering checkpoint, so accept rather than
                # retrain. Unknown tasks stay an error.
                if task in self._todo:
                    self._todo.remove(task)
                    self._done.add(task)
                    self._record_done(task)
                    self._commit()
                    return {"ok": True, "requeued": True,
                            "done": len(self._done), "queued": len(self._todo)}
                return {"ok": False, "error": "not leased"}
            if self._leased[task]["worker"] != worker:
                return {"ok": False, "error": "lease not owned"}
            del self._leased[task]
            self._done.add(task)
            self._record_done(task)
            self._commit()
            return {"ok": True, "done": len(self._done), "queued": len(self._todo)}

    def fail_task(self, worker: str, task: str) -> Dict:
        with self._lock:
            self._tick()
            if task not in self._leased:
                return {"ok": False, "error": "not leased"}
            if self._leased[task]["worker"] != worker:
                return {"ok": False, "error": "lease not owned"}
            del self._leased[task]
            self._todo.append(task)
            self._record_lease(task, "", "")
            self._commit()
            return {"ok": True}

    def barrier(self, worker: str, name: str, count: int, timeout: float = 120.0) -> Dict:
        with self._barrier_cv:
            b = self._barriers.setdefault(
                name, {"arrived": set(), "generation": 0, "want": 0}
            )
            if not b["arrived"]:
                # First arrival of a cycle fixes the count; later arrivals
                # must agree (mirrors the native server — last-writer-wins
                # would let mismatched cohorts release each other).
                b["want"] = count
            elif count != b.get("want"):
                return {"ok": False, "error": "barrier count mismatch",
                        "want": b["want"]}
            gen = b["generation"]
            b["arrived"].add(worker)
            if len(b["arrived"]) >= b["want"]:
                b["generation"] += 1
                b["arrived"] = set()
                self._barrier_cv.notify_all()
                return {"ok": True, "barrier": name, "generation": gen}
            deadline = time.monotonic() + timeout
            while b["generation"] == gen:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    b["arrived"].discard(worker)
                    return {"ok": False, "error": "barrier timeout"}
                self._barrier_cv.wait(remaining)
            return {"ok": True, "barrier": name, "generation": gen}

    def sync(self, worker: str, epoch: int, timeout: float = 60.0) -> Dict:
        """Epoch-synchronized rendezvous: released when every current member
        arrives at ``epoch``; membership movement releases with resync=True."""
        with self._barrier_cv:
            self._tick()
            if worker not in self._members:
                return {"ok": False, "error": "unknown worker",
                        "epoch": self._epoch, "world": len(self._members)}
            self._members[worker]["last_heartbeat"] = time.monotonic()
            self._renew_leases(worker)
            if epoch != self._epoch:
                return {"ok": False, "resync": True,
                        "epoch": self._epoch, "world": len(self._members)}
            self._sync_arrived.add(worker)
            if self._sync_arrived >= set(self._members):
                self._sync_generation += 1
                self._sync_arrived = set()
                self._barrier_cv.notify_all()
                return {"ok": True, "epoch": self._epoch, "world": len(self._members)}
            gen = self._sync_generation
            deadline = time.monotonic() + timeout
            while gen == self._sync_generation and epoch == self._epoch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._sync_arrived.discard(worker)
                    return {"ok": False, "error": "timeout",
                            "epoch": self._epoch, "world": len(self._members)}
                self._barrier_cv.wait(remaining)
            if epoch != self._epoch:
                return {"ok": False, "resync": True,
                        "epoch": self._epoch, "world": len(self._members)}
            return {"ok": True, "epoch": self._epoch, "world": len(self._members)}

    def bump_epoch(self) -> Dict:
        """Control-plane membership nudge (matches the C++ op_bump_epoch):
        parked sync waiters resync so workers observe a rescale immediately."""
        with self._barrier_cv:
            self._epoch += 1
            self._record_epoch()
            self._notify_watchers()
            self._release_sync()
            self._commit()
            return {"ok": True, "epoch": self._epoch}

    def kv_put(self, key: str, value: str) -> None:
        with self._lock:
            self._kv[key] = value
            self._record_kv(key)
            self._commit()

    def kv_get(self, key: str) -> Optional[str]:
        with self._lock:
            return self._kv.get(key)

    def kv_del(self, key: str) -> None:
        with self._lock:
            if key in self._kv:  # native parity: a no-op del is not journaled
                del self._kv[key]
                self._record_kv_del(key)
                self._commit()

    def kv_incr(self, key: str, delta: int = 1,
                op_id: Optional[str] = None) -> int:
        reply = self.kv_incr_reply(key, delta, op_id=op_id)
        if not reply["ok"]:
            raise ValueError(reply["error"])
        return int(reply["value"])

    def kv_incr_reply(self, key: str, delta: int = 1,
                      op_id: Optional[str] = None) -> Dict:
        """Atomic counter with the full native op_kv_incr reply surface:
        read-modify-write under the lock, so concurrent failure-count bumps
        cannot be lost; ``op_id`` dedups replayed increments exactly-once
        (native parity: the marker lives in the KV namespace) and a replay
        reports ``duplicate`` alongside the previously-returned value."""
        with self._lock:
            if not key:
                return {"ok": False, "error": "key required"}
            marker = f"__edl_op/{op_id}" if op_id else None
            if marker and marker in self._kv and not self._test_disable_dedup:
                return {"ok": True, "value": int(self._kv[marker]),
                        "duplicate": True}
            try:
                cur = int(self._kv.get(key, "0") or "0") + int(delta)
            except ValueError:
                return {"ok": False, "error": "value not an integer"}
            self._kv[key] = str(cur)
            self._record_kv(key)
            if marker:
                self._kv[marker] = str(cur)
                self._record_kv(marker)
            # value + marker share one frame: both durable or neither —
            # a partially-replayed frame here is exactly the torn-tail
            # double-apply EDL010's torn schedule hunts.
            self._commit()
            return {"ok": True, "value": cur}

    #: put_id dedup markers kept (FIFO) before the oldest is forgotten —
    #: mirrors the native kShardPutSeenCap.
    SHARD_PUT_SEEN_CAP = 4096

    def shard_put(self, owner: str, step: int, chunk: int, chunks: int,
                  nbytes: int = 0, data: str = "",
                  put_id: Optional[str] = None,
                  group: Optional[List[str]] = None) -> Dict:
        """Checkpoint-plane replication (native op_shard_put): store one
        chunk of an owner's ZeRO-1 shard; latest step supersedes; ``put_id``
        dedups replayed puts exactly-once (marked seen only after a
        successful apply, so duplicate implies the original landed)."""
        with self._lock:
            if not owner or step < 0 or chunks < 1 or not 0 <= chunk < chunks:
                return {"ok": False,
                        "error": "shard_put requires owner, step>=0, "
                                 "0<=chunk<chunks"}
            if put_id and put_id in self._shard_put_seen \
                    and not self._test_disable_dedup:
                return {"ok": True, "duplicate": True, "stored": True}
            blob = self._shards.setdefault(
                owner, {"step": -1, "chunks": 0, "nbytes": 0,
                        "group": [], "data": {}})
            if step < blob["step"]:
                # Stale chunk racing a newer replication pass: not stored,
                # not an error.
                return {"ok": True, "duplicate": False, "stored": False}
            if step > blob["step"]:
                blob["step"] = step
                blob["data"] = {}
                blob["group"] = []
            blob["chunks"] = int(chunks)
            blob["nbytes"] = int(nbytes)
            if isinstance(group, list):
                blob["group"] = [str(g) for g in group]
            blob["data"][int(chunk)] = data
            if put_id:
                self._shard_put_seen.add(put_id)
                self._shard_put_order.append(put_id)
                if len(self._shard_put_order) > self.SHARD_PUT_SEEN_CAP:
                    self._shard_put_seen.discard(
                        self._shard_put_order.popleft())
            return {"ok": True, "duplicate": False, "stored": True}

    def shard_get(self, owner: str, step: int = -1, chunk: int = 0) -> Dict:
        """Recovery fetch (native op_shard_get): one chunk of a possibly-dead
        owner's replicated shard. step<0 means latest; a specific step must
        match exactly so a restorer never mixes replication passes."""
        with self._lock:
            blob = self._shards.get(owner)
            if blob is None or (step >= 0 and blob["step"] != step):
                return {"ok": True, "found": False, "data": "", "chunks": 0}
            payload = blob["data"].get(int(chunk))
            if payload is None:
                return {"ok": True, "found": False, "data": "",
                        "chunks": int(blob["chunks"])}
            return {"ok": True, "found": True, "data": payload,
                    "chunks": int(blob["chunks"])}

    def shard_meta(self, owner: str) -> Dict:
        """Plane inventory for one owner (native op_shard_meta):
        complete=True only when every chunk of the latest step is present —
        the restorer's go/no-go before pulling chunks."""
        with self._lock:
            blob = self._shards.get(owner)
            if blob is None or blob["step"] < 0:
                return {"ok": True, "found": False, "step": -1, "chunks": 0,
                        "nbytes": 0, "complete": False, "group": []}
            complete = blob["chunks"] > 0 \
                and len(blob["data"]) == blob["chunks"]
            return {"ok": True, "found": True, "step": int(blob["step"]),
                    "chunks": int(blob["chunks"]),
                    "nbytes": int(blob["nbytes"]), "complete": complete,
                    "group": list(blob["group"])}

    def shard_drop(self, owner: str, step: int = -1) -> Dict:
        """Epoch/placement invalidation (native op_shard_drop): step<0 drops
        unconditionally; step>=0 only if the plane holds exactly that step,
        so a drop racing a newer put cannot destroy the newer blob."""
        with self._lock:
            blob = self._shards.get(owner)
            dropped = False
            if blob is not None and (step < 0 or blob["step"] == step):
                del self._shards[owner]
                dropped = True
            return {"ok": True, "dropped": dropped}

    # -- push notifications (native parity: op_watch / push_notify) ------------

    def _notify_frame(self, e: int) -> Dict:
        return {"ok": True, "notify": "epoch", "epoch": int(e),
                "cursor": int(e), "world": len(self._members)}

    def _notify_watchers(self) -> None:
        """Epoch moved: queue one notification frame per subscription (the
        wire server pushes the same frame to every watcher fd)."""
        for q in self._watch_queues.values():
            q.append(self._notify_frame(self._epoch))

    def _preempt_frame(self, worker: str) -> Dict:
        """Targeted revocation frame (native push_preempt): no wall clock —
        the client anchors the drain deadline to its own monotonic arrival
        time plus notice_s, so clock skew never shortens the budget."""
        p = self._preempts[worker]
        return {"ok": True, "notify": "preempt", "worker": worker,
                "notice_s": p["notice_s"], "reason": p["reason"],
                "seq": p["seq"], "epoch": self._epoch,
                "cursor": self._epoch, "world": len(self._members)}

    def preempt_notice(self, targets: List[str], notice_s: float = 0.0,
                       reason: str = "") -> Dict:
        """Advance-notice revocation (native op_preempt_notice): record the
        pending notice per target and push a targeted frame to the target's
        subscription. No membership change here — the drain the notice
        triggers ends in leave/_drop_member like any departure."""
        with self._lock:
            self._tick()
            if not isinstance(targets, list) or not targets:
                return {"ok": False, "error": "targets array required"}
            revoked: List[str] = []
            for t in targets:
                t = str(t)
                self._preempt_seq += 1
                self._preempts[t] = {"notice_s": float(notice_s),
                                     "reason": reason or "preempt",
                                     "seq": self._preempt_seq}
                q = self._watch_queues.get(t)
                if q is not None:
                    q.append(self._preempt_frame(t))
                revoked.append(t)
            return {"ok": True, "revoked": revoked}

    def watch(self, worker: str, cursor: int = -1) -> Dict:
        """Subscribe ``worker`` to epoch-change notifications. cursor >= 0
        resumes after a reconnect: every epoch in (cursor, current] is
        queued exactly once, in order, before the ack — native parity with
        op_watch's deferred replay."""
        with self._lock:
            self._tick()
            q = self._watch_queues.setdefault(worker or "", deque())
            if cursor >= 0:
                for e in range(int(cursor) + 1, self._epoch + 1):
                    q.append(self._notify_frame(e))
            # A notice posted before this subscription is replayed (native
            # parity) — at-least-once delivery; clients dedup on seq.
            if worker in self._preempts:
                q.append(self._preempt_frame(worker))
            return {"ok": True, "watch": True, "cursor": self._epoch,
                    "epoch": self._epoch}

    def watch_take(self, worker: str) -> Dict:
        """Drain one pending notification frame — the in-process stand-in
        for the wire server's unsolicited push (a poll, because a hermetic
        twin has no socket to write to). Empty queue answers notify=None."""
        with self._lock:
            q = self._watch_queues.get(worker or "")
            if not q:
                return {"ok": True, "notify": None, "cursor": self._epoch,
                        "world": len(self._members)}
            frame = q.popleft()
            if frame.get("notify") == "preempt":
                # Rebuilt as a literal rather than aliased: takers must not
                # be able to mutate queued history, and the wire-parity
                # checker reads the reply vocabulary from this shape.
                return {"ok": True, "notify": "preempt",
                        "worker": frame["worker"],
                        "notice_s": frame["notice_s"],
                        "reason": frame["reason"], "seq": frame["seq"],
                        "epoch": frame["epoch"], "cursor": frame["cursor"],
                        "world": frame["world"]}
            return frame

    def watch_cancel(self, worker: str) -> Dict:
        with self._lock:
            cancelled = (worker or "") in self._watch_queues
            self._watch_queues.pop(worker or "", None)
            return {"ok": True, "cancelled": cancelled}

    # -- shard routing (native parity: redirect_reply / op_shard_map) ----------

    def redirect_for(self, key: str) -> Optional[Dict]:
        """Redirect reply when this twin plays a sharded ROOT (endpoints
        configured); None on a plain coordinator — so every keyspace shim
        branch can guard with ``redirect_for(key) or <serve>``."""
        with self._lock:
            if not self._shard_endpoints:
                return None
            s = shard_of(str(key), len(self._shard_endpoints))
            return {"ok": False, "error": "wrong shard",
                    "redirect": self._shard_endpoints[s], "shard": s}

    def shard_map(self) -> Dict:
        with self._lock:
            n = len(self._shard_endpoints) if self._shard_endpoints \
                else self._num_shards
            return {"ok": True, "root": bool(self._shard_endpoints),
                    "nshards": n, "shards": list(self._shard_endpoints),
                    "shard_index": self._shard_index}

    # -- reply-shaped helpers for the wire shim --------------------------------

    def kv_put_reply(self, key: str, value: str) -> Dict:
        with self._lock:
            if not key:
                return {"ok": False, "error": "key required"}
            self._kv[key] = value
            self._record_kv(key)
            self._commit()
            return {"ok": True}

    def kv_del_reply(self, key: str) -> Dict:
        with self._lock:
            if key in self._kv:
                del self._kv[key]
                self._record_kv_del(key)
                self._commit()
            return {"ok": True}

    def add_tasks_reply(self, tasks: List[str]) -> Dict:
        with self._lock:
            added = self.add_tasks(tasks)
            return {"ok": True, "added": added, "queued": len(self._todo)}

    def status(self) -> Dict:
        with self._lock:
            self._tick()
            holders: Dict[str, int] = {}
            for lease in self._leased.values():
                holders[lease["worker"]] = holders.get(lease["worker"], 0) + 1
            return {
                "ok": True,
                "epoch": self._epoch,
                "world": len(self._members),
                "queued": len(self._todo),
                "leased": len(self._leased),
                "done": len(self._done),
                # Wire-parity counters: ops/batch counts are real; the
                # journal trio is real when a state file is configured and
                # structurally zero otherwise (no disk in-process), and
                # "turns" mirrors ops — every op is its own event-loop turn.
                "ops": self._ops_count,
                "batch_frames": self._batch_frames,
                "batch_subops": self._batch_subops,
                "fsyncs": self._fsyncs,
                "snapshots": self._snapshots,
                "journal_records": self._records_since,
                "turns": self._ops_count,
                "uptime_seconds": time.monotonic() - self._boot_monotonic,
                # native-parity encoding: flat "worker=count" strings (the
                # wire writer has no nested objects, so neither do we).
                "lease_holders": sorted(
                    f"{w}={n}" for w, n in holders.items()
                ),
                # pending revocations, same flat encoding; notice_s is
                # integer-truncated to match the native formatting.
                "preempts": sorted(
                    f"{w}={int(p['notice_s'])}"
                    for w, p in self._preempts.items()
                ),
            }

    def ping(self) -> bool:
        return True

    def queued_count(self) -> int:
        with self._lock:
            return len(self._todo)

    def note_batch(self, subops: int) -> None:
        """Batch-frame accounting from the client shim (native parity: the
        server counts frames/sub-ops itself; in-process the framing lives in
        InProcessClient.call_batch, so it reports here)."""
        with self._lock:
            self._batch_frames += 1
            self._batch_subops += subops

    # -- client-compatible facade ---------------------------------------------

    def client(self, worker: str = "",
               token: Optional[str] = None) -> "InProcessClient":
        # None = "use the coordinator's own token": the common single-
        # process case (both ends in one pod share EDL_COORD_TOKEN).
        # Tests pass an explicit wrong/empty token for the negative path.
        return InProcessClient(
            self, worker, self.auth_token if token is None else token
        )

    def authorize(self, token: str) -> None:
        """The wire twin's auth gate (native: coordinator.cc handle())."""
        with self._lock:
            self._ops_count += 1
        if self.auth_token and token != self.auth_token:
            from edl_tpu_torch.coordinator.client import CoordinatorAuthError

            raise CoordinatorAuthError(
                "coordinator rejected call: bad or missing token"
            )


class InProcessClient:
    """Same method surface as CoordinatorClient, bound to one worker name.

    Auth mirrors the native wire: every op except ping passes through the
    coordinator's token gate before touching state.
    """

    def __init__(self, coord: InProcessCoordinator, worker: str,
                 token: str = ""):
        self._c = coord
        self.worker = worker
        self.token = token
        #: coalesced-epoch surface, mirroring CoordinatorClient: workers
        #: read these instead of issuing dedicated epoch polls. In-process
        #: there is no wire to save, but the attributes keep worker code
        #: backend-agnostic.
        self.observed_epoch: Optional[int] = None
        self.observed_epoch_at: float = 0.0
        self.last_membership: Optional[Dict] = None
        self.last_membership_at: float = 0.0
        self.piggyback_heartbeat: float = 0.0
        self.retry_count = 0
        #: per-client nonce for shard_put dedup ids (CoordinatorClient
        #: parity: a fresh client can never replay a predecessor's markers).
        self._nonce = uuid.uuid4().hex[:8]
        self._put_seq = 0

    def _auth(self) -> None:
        self._c.authorize(self.token)

    def _note_reply(self, reply):
        if isinstance(reply, dict) and "epoch" in reply:
            now = time.monotonic()
            self.observed_epoch = int(reply["epoch"])
            self.observed_epoch_at = now
            if reply.get("ok") and "rank" in reply and "world" in reply:
                self.last_membership = dict(reply)
                self.last_membership_at = now
        return reply

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def register(self, takeover: bool = False):
        self._auth()
        return self._note_reply(self._c.register(self.worker, takeover=takeover))

    def heartbeat(self):
        self._auth()
        return self._note_reply(self._c.heartbeat(self.worker))

    def leave(self):
        self._auth()
        return self._c.leave(self.worker)

    def members(self):
        self._auth()
        return self._c.members()

    def epoch(self):
        self._auth()
        return self._c.epoch()

    def add_tasks(self, tasks):
        self._auth()
        return self._c.add_tasks(tasks)

    def acquire_task(self):
        self._auth()
        return self._c.acquire_task(self.worker)

    def acquire(self, req_id=None):
        self._auth()
        return self._c.acquire(self.worker, req_id=req_id)

    def complete_task(self, task):
        self._auth()
        return self._c.complete_task(self.worker, task)

    def fail_task(self, task):
        self._auth()
        return self._c.fail_task(self.worker, task)

    def barrier(self, name, count, timeout=120.0):
        self._auth()
        return self._c.barrier(self.worker, name, count, timeout)

    def sync(self, epoch, timeout=60.0):
        self._auth()
        return self._c.sync(self.worker, epoch, timeout)

    def bump_epoch(self):
        self._auth()
        # int, matching CoordinatorClient.bump_epoch's unwrapped return.
        return int(self._c.bump_epoch()["epoch"])

    def preempt_notice(self, targets, notice_s=30.0, reason="preempt"):
        # list of revoked names, matching CoordinatorClient.preempt_notice's
        # unwrapped return (the straggler detector and chaos scenarios call
        # this surface generically across both transports).
        self._auth()
        return list(self.call("preempt_notice", targets=list(targets),
                              notice_s=float(notice_s),
                              reason=str(reason)).get("revoked", []))

    def kv_put(self, key, value):
        self._auth()
        return self._c.kv_put(key, value)

    def kv_get(self, key):
        self._auth()
        return self._c.kv_get(key)

    def kv_del(self, key):
        self._auth()
        return self._c.kv_del(key)

    def kv_incr(self, key, delta=1):
        self._auth()
        return self._c.kv_incr(key, delta)

    # -- checkpoint plane ------------------------------------------------------

    def shard_put(self, owner, step, chunk, chunks, data, nbytes=0,
                  group=None, put_id=None):
        """Convenience mirror of CoordinatorClient.shard_put: auto-generates
        a per-client put_id when none is given, so bare retries dedup."""
        self._auth()
        if put_id is None:
            put_id = self._next_put_id()
        return self._c.shard_put(owner, int(step), int(chunk), int(chunks),
                                 nbytes=int(nbytes), data=data,
                                 put_id=put_id, group=group)

    def shard_get(self, owner, step=-1, chunk=0):
        self._auth()
        return self._c.shard_get(owner, int(step), int(chunk))

    def shard_meta(self, owner):
        self._auth()
        return self._c.shard_meta(owner)

    def shard_drop(self, owner, step=-1):
        self._auth()
        return self._c.shard_drop(owner, int(step))

    def _next_put_id(self):
        self._put_seq += 1
        return f"{self._nonce}.p{self._put_seq}"

    def _stamp(self, reply):
        """Mirror of the native handle()'s stamp_epoch: every reply carries
        the membership epoch, so clients coalesce epoch observation off any
        traffic (wire parity: EDL007 checks both sides stamp)."""
        reply = dict(reply)
        reply.setdefault("epoch", self._c.epoch())
        return reply

    def call(self, op, timeout=None, **fields):
        """Wire-call shim covering the native dispatch table op-for-op (the
        outbox replays through this); replies are field-identical to the
        C++ server's, including the epoch stamp — EDL007 diffs them."""
        if op == "ping":  # native parity: ping bypasses the token gate
            return self._stamp({"ok": True, "pong": True})
        self._auth()
        if op == "register":
            return self._note_reply(self._c.register(
                self.worker, takeover=bool(fields.get("takeover"))))
        if op == "heartbeat":
            return self._note_reply(self._c.heartbeat(self.worker))
        if op == "leave":
            return self._c.leave(self.worker)
        if op == "members":
            return self._stamp({"ok": True, "members": self._c.members()})
        # Keyspace ops guard with ``redirect_for(key) or <serve>`` — exactly
        # the native handlers' shard-root redirect placement: None (plain
        # coordinator) falls through to serving; a configured root answers
        # the redirect before any validation, same as the C++ order.
        if op == "complete_task":
            return self._stamp(
                self._c.redirect_for(fields["task"])
                or self._c.complete_task(self.worker, fields["task"]))
        if op == "fail_task":
            return self._stamp(
                self._c.redirect_for(fields["task"])
                or self._c.fail_task(self.worker, fields["task"]))
        if op == "kv_put":
            return self._stamp(
                self._c.redirect_for(fields.get("key", ""))
                or self._c.kv_put_reply(fields.get("key", ""),
                                        fields.get("value", "")))
        if op == "kv_incr":
            return self._stamp(
                self._c.redirect_for(fields.get("key", ""))
                or self._c.kv_incr_reply(
                    fields.get("key", ""), fields.get("delta", 1),
                    op_id=fields.get("op_id")))
        if op == "shard_put":
            return self._stamp(
                self._c.redirect_for(fields.get("owner", ""))
                or self._c.shard_put(
                    fields.get("owner", ""), int(fields.get("step", -1)),
                    int(fields.get("chunk", -1)),
                    int(fields.get("chunks", 0)),
                    nbytes=int(fields.get("nbytes", 0)),
                    data=fields.get("data", ""),
                    put_id=fields.get("put_id"), group=fields.get("group")))
        if op == "shard_get":
            return self._stamp(
                self._c.redirect_for(fields.get("owner", ""))
                or self._c.shard_get(
                    fields.get("owner", ""), int(fields.get("step", -1)),
                    int(fields.get("chunk", 0))))
        if op == "shard_meta":
            return self._stamp(
                self._c.redirect_for(fields.get("owner", ""))
                or self._c.shard_meta(fields.get("owner", "")))
        if op == "shard_drop":
            return self._stamp(
                self._c.redirect_for(fields.get("owner", ""))
                or self._c.shard_drop(
                    fields.get("owner", ""), int(fields.get("step", -1))))
        if op == "kv_get":
            return self._stamp(
                self._c.redirect_for(fields.get("key", ""))
                or {"ok": True, "value": self._c.kv_get(fields["key"])})
        if op == "kv_del":
            return self._stamp(
                self._c.redirect_for(fields.get("key", ""))
                or self._c.kv_del_reply(fields.get("key", "")))
        if op == "acquire_task":
            return self._stamp(
                self._c.redirect_for(self.worker)
                or self._c.acquire(self.worker, req_id=fields.get("req_id")))
        if op == "add_tasks":
            tasks = fields.get("tasks")
            if not isinstance(tasks, list):
                return self._stamp(
                    self._c.redirect_for("")
                    or {"ok": False, "error": "tasks array required"})
            return self._stamp(
                self._c.redirect_for(str(tasks[0]) if tasks else "")
                or self._c.add_tasks_reply(tasks))
        if op == "barrier":
            return self._stamp(self._c.barrier(
                self.worker, fields["name"], int(fields["count"]),
                timeout if timeout is not None else 120.0))
        if op == "sync":
            return self._stamp(self._c.sync(
                self.worker, int(fields["epoch"]),
                timeout if timeout is not None else 60.0))
        if op == "bump_epoch":
            return self._c.bump_epoch()
        if op == "preempt_notice":
            return self._stamp(self._c.preempt_notice(
                fields.get("targets"),
                notice_s=float(fields.get("notice_s", 0) or 0),
                reason=fields.get("reason", "")))
        if op == "status":
            return self._c.status()
        if op == "watch":
            if fields.get("take"):
                # In-process delivery: drain one pushed frame — the wire
                # server writes these unsolicited to the subscriber's fd,
                # a hermetic twin has no socket so the model polls instead.
                return self._stamp(self._c.watch_take(self.worker))
            return self._stamp(self._c.watch(
                self.worker, int(fields.get("cursor", -1))))
        if op == "watch_cancel":
            return self._stamp(self._c.watch_cancel(self.worker))
        if op == "shard_map":
            return self._stamp(self._c.shard_map())
        if op == "batch":
            ops_arg = fields.get("ops")
            if not isinstance(ops_arg, list):
                return self._stamp({"ok": False, "error": "ops array required"})
            return self._stamp(
                {"ok": True, "replies": self.call_batch(ops_arg, timeout=timeout)})
        raise ValueError(f"unsupported in-process op {op!r}")

    def call_batch(self, ops, timeout=None):
        """Batched-frame parity with CoordinatorClient.call_batch: the same
        per-sub-op reply list, driven through the shim — so the outbox's
        batched replay and worker piggyback paths run identically against
        the hermetic twin. Sub-op semantics (dedup ids, idempotence) are
        the coordinator's own; framing adds nothing in-process. Accepts the
        wire encoding too (JSON strings with an "op" key)."""
        self._c.note_batch(len(ops))
        # One frame per batch (native parity: the whole batch is one
        # event-loop turn): sub-op records accumulate and group-commit
        # together when the frame closes.
        with self._c._lock:
            self._c._turn_depth += 1
        try:
            replies = self._call_batch_inner(ops, timeout)
        finally:
            with self._c._lock:
                self._c._turn_depth -= 1
                self._c._commit()
        return replies

    def _call_batch_inner(self, ops, timeout=None):
        replies = []
        for item in ops:
            if isinstance(item, str):
                try:
                    fields = json.loads(item)
                except (ValueError, TypeError):
                    replies.append({"ok": False, "error": "bad json"})
                    continue
                op = fields.pop("op", "")
            elif isinstance(item, dict):
                fields = dict(item)
                op = fields.pop("op", "")
            else:
                op, fields = item
                fields = dict(fields)
            if op in ("batch", "barrier", "sync", "watch"):
                replies.append(
                    {"ok": False, "error": f"op not batchable: {op}"})
                continue
            replies.append(self.call(op, timeout=timeout, **fields))
        return replies

    def status(self):
        self._auth()
        return self._c.status()

    def shard_map(self):
        """CoordinatorClient.shard_map parity: the twin's partition layout."""
        return self.call("shard_map")

    def ping(self):
        return True
