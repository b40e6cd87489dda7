"""Protocol state-machine model checker (the engine behind EDL009).

EDL007 proved the coordinator protocol's *shape* agrees across the C++
server, the wire client, and the in-process twin. This module checks its
*behavior*: the per-op ``state_effects`` block of ``protocol_schema.json``
declares how each op touches coordinator state (epoch bumps, lease
acquire/release, dedup keys, fd-parking), a small abstract interpreter
(`ProtocolModel`) executes those declarations, and a bounded explicit-state
explorer enumerates every interleaving of N scripted workers — including
crash/restart and duplicate-delivery faults — checking four invariants on
every trace:

- **epoch monotonicity**: the epoch observed on any worker's reply stream
  never decreases;
- **exactly-once**: a replayed ``req_id``/``op_id`` must return the original
  effect (same task, same counter value), never apply a second one;
- **lease exclusivity**: at most one live lease per task, transfers only
  through an explicit requeue event (complete/fail/takeover/drop);
- **progress**: every parked op (barrier/sync) is eventually released and
  every script drains — a schedule where all runnable workers are parked is
  a deadlock, reported without replay.

Every completed trace is then replayed op-for-op against a fresh
``InProcessCoordinator`` (the executable oracle): each model-predicted reply
must be a subset of the oracle's reply, with the epoch matching exactly. A
model/oracle divergence means either the schema's behavioral annotations or
the twin drifted — both are findings.

Exploration is exhaustive by default (DFS over all interleavings) and can
run as a seeded random walk (``fuzz_samples``/``fuzz_seed``), whose explored
trace set — and therefore violation set — is provably a subset of the
exhaustive run at equal depth: both draw schedules from the same runnable
sets, the walk just samples one branch per node.

**Durability lane (EDL010).** Schedules flagged ``durable`` additionally
split the model into volatile vs durable halves: every op's ``durability``
tag in ``state_effects`` declares which journal records it emits
(``journal:kv``, ``journal:meta,lease``, ``volatile``, ``none``), handlers
emit those records into a per-turn frame, and each frame group-commits
(one fsync per event-loop turn, a trailing commit-marker record closing
the frame — mirroring the native journal byte-for-byte in structure). A
``crash`` pseudo-op (modes ``clean`` / ``pre_ack`` / ``torn`` /
``during_compaction``) is a first-class schedule step: the DFS interleaves
it like any other op, so its position enumerates every crash point; its
semantics discard volatile state, replay the committed journal exactly the
way ``load_state`` does (epoch+1, leases restored under holders, req_id
dedup cache rebuilt, torn tail frames dropped whole), and its oracle
realization kills and restarts a REAL coordinator — the file-backed
``InProcessCoordinator`` persistence twin in the default lane, the native
binary with env-gated crash injection (``EDL_COORD_CRASH_AFTER_APPENDS``)
in ``edl_tpu_torch.analysis.native_oracle``. Invariants added on top of the
four above: acked-implies-durable, exactly-once across crash,
snapshot⊕journal-suffix equivalence at every compaction, epoch
monotonicity across restart, and ladder honesty for the deliberately
unjournaled shard store (loss may cost a recovery rung, never contradict
a durable ack). A sleep-set partial-order reduction over commuting ops
(disjoint static footprints; any epoch-writing op conflicts with
everything) keeps crash-point exploration inside EDL009's budget.

``python -m edl_tpu_torch.analysis.modelcheck`` runs the default bounded
configuration — the 2-worker faulty base (13 ops including ``batch``, one
crash+restart, two duplicate deliveries), the checkpoint-plane ops, a
watch/notify schedule, a redirect-during-watch schedule against a sharded
root, and the durability schedules (post-fsync survival, pre-fsync loss,
torn tail, crash-during-compaction, shard-store-across-crash) — and exits
1 on any violation: the ``make modelcheck`` gate. ``--schedules`` filters
by name, ``--dump-trace`` writes the first violating interleaving as a
JSON spec, ``--replay-trace`` re-executes such a spec in isolation.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
import weakref
from dataclasses import dataclass, field, replace as _dc_replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from edl_tpu_torch.coordinator.sharding import shard_of

#: ops a ``call_batch`` frame refuses (they park, nest framing, or bind an
#: out-of-band push stream to the connection — ``watch``); mirrored from the
#: wire protocol, used by the composite handler.
_NON_BATCHABLE = ("batch", "barrier", "sync", "watch")

#: sentinel request-field value: resolved at issue time to the task named in
#: the issuing worker's most recent acquire reply (each side — model and
#: oracle — resolves from its OWN reply stream, so a grant divergence is
#: reported once at the acquire, not echoed by every downstream op).
LAST_TASK = "__edl_modelcheck_last_task__"

#: the crash pseudo-op (not a wire op): kills the coordinator at this point
#: in the interleaving and replays recovery. Scheduled like any other
#: ScriptOp, so DFS position = crash point.
CRASH_OP = "crash"

#: crash modes. ``clean``: nothing in flight, recover to the committed
#: journal. ``pre_ack``: the inflight op's frame is appended AND fsynced but
#: the reply never flushes — its effects must survive (post-fsync survival).
#: ``torn``: the inflight frame is appended but torn mid-write (no commit
#: marker reaches disk) — the WHOLE frame must be absent after recovery
#: (pre-fsync loss; all-or-nothing is the frame contract). #:
#: ``during_compaction``: the inflight op triggers a snapshot that dies
#: after the tmp write, before the rename — the journal is untouched and
#: the inflight effects are lost, unacked.
CRASH_MODES = ("clean", "pre_ack", "torn", "during_compaction")

#: journal record kinds, mirroring the native journal line vocabulary.
_JOURNAL_KINDS = ("meta", "todo", "done", "lease", "kv", "kvdel")


class ModelCheckError(Exception):
    """The schema's state_effects block cannot drive the model (missing op,
    unknown effect tag): a behavioral-spec error, not a trace violation."""


class _SnapshotDivergence(Exception):
    """The model's own snapshot⊕journal-suffix self-check failed: replaying
    the compacted journal did not reconstruct the live durable state. The
    explorer converts this into a ``snapshot-divergence`` violation on the
    trace that triggered the compaction."""


#: sentinel distinguishing "no durability tag at all" from an empty kind set.
_MISSING_TAG = object()


def _durability_kinds(effects: Dict[str, Dict[str, Any]], op: str):
    """Parse an op's ``durability`` tag into its declared journal-record
    kind set. ``none``/``volatile`` -> empty set (the op must emit no
    journal records), ``journal:<k1,k2>`` -> {k1, k2}, ``composite`` ->
    None (batch: checked against the union of its sub-ops), missing ->
    ``_MISSING_TAG``."""
    tag = effects.get(op, {}).get("durability")
    if tag is None:
        return _MISSING_TAG
    if tag in ("none", "volatile"):
        return set()
    if tag == "composite":
        return None
    if isinstance(tag, str) and tag.startswith("journal:"):
        kinds = {k.strip() for k in tag[len("journal:"):].split(",") if k.strip()}
        bad = kinds - set(_JOURNAL_KINDS)
        if bad:
            raise ModelCheckError(
                f"state_effects[{op!r}] durability tag names unknown "
                f"journal kind(s) {sorted(bad)} — known: {_JOURNAL_KINDS}"
            )
        return kinds
    raise ModelCheckError(
        f"state_effects[{op!r}] durability tag {tag!r} is malformed — "
        "expected journal:<kinds>, volatile, none, or composite"
    )


@dataclass(frozen=True)
class ScriptOp:
    """One scripted client op. ``note`` tags fault injections ("dup",
    "restart") for trace rendering; semantics live entirely in op+fields."""

    op: str
    fields: Tuple[Tuple[str, Any], ...] = ()
    note: str = ""

    @staticmethod
    def make(op: str, note: str = "", **fields: Any) -> "ScriptOp":
        frozen = []
        for k in sorted(fields):
            v = fields[k]
            if isinstance(v, list):
                v = tuple(
                    tuple(sorted(d.items())) if isinstance(d, dict) else d
                    for v_ in [v] for d in v_
                )
            frozen.append((k, v))
        return ScriptOp(op=op, fields=tuple(frozen), note=note)

    def field_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self.fields:
            if isinstance(v, tuple) and v and isinstance(v[0], tuple):
                # list-of-dicts (batch sub-ops) round-trips through tuples
                out[k] = [dict(item) for item in v]
            elif isinstance(v, tuple):
                out[k] = list(v)
            else:
                out[k] = v
        return out

    def render(self) -> str:
        parts = ", ".join(
            f"{k}={v!r}" for k, v in self.fields if k != "ops"
        )
        tag = f" [{self.note}]" if self.note else ""
        return f"{self.op}({parts}){tag}"


@dataclass
class Violation:
    kind: str  # epoch-monotonicity | exactly-once | lease-exclusivity |
    #            progress | oracle-divergence | conservation |
    #            acked-durability | snapshot-divergence
    message: str
    trace: str  # stable rendering of the schedule that produced it
    schedule: str = ""  # named schedule that produced it ("" for ad-hoc)
    order: Tuple[str, ...] = ()  # worker step order, for --dump-trace

    def key(self) -> Tuple[str, str]:
        return (self.kind, self.trace)


@dataclass
class ModelCheckResult:
    traces: int = 0
    replays: int = 0
    violations: List[Violation] = field(default_factory=list)
    #: per-schedule (name, traces, seconds) rows — the --timings split.
    timings: List[Tuple[str, int, float]] = field(default_factory=list)

    def ok(self) -> bool:
        return not self.violations

    def violation_keys(self) -> set:
        return {v.key() for v in self.violations}


# -- the abstract model --------------------------------------------------------


class ProtocolModel:
    """Explicit-state interpreter for the coordinator protocol, driven by the
    ``state_effects`` declarations. Predicts, for every (worker, op, fields)
    event, the reply the real coordinator must produce; the oracle replay
    checks the prediction. Time never passes: leases and heartbeats cannot
    expire, which matches the replay coordinator's near-infinite TTLs."""

    _KNOWN_TAGS = {
        "epoch", "lease", "dedup", "kv", "queue", "membership", "parks",
        "composite", "shard", "watch", "routing", "durability", "preempt",
    }

    def __init__(self, effects: Dict[str, Dict[str, Any]],
                 shard_endpoints: Optional[Sequence[str]] = None,
                 durable: bool = False,
                 compact_every: Optional[int] = None):
        for op, tags in effects.items():
            unknown = set(tags) - self._KNOWN_TAGS
            if unknown:
                raise ModelCheckError(
                    f"state_effects[{op!r}] has unknown tag(s): "
                    f"{sorted(unknown)}"
                )
        self.effects = effects
        # Durable half (EDL010): the journal as committed frames. Volatile
        # state is everything below; the journal is what a crash preserves.
        self.durable = durable
        self.compact_every = compact_every
        if durable:
            for op in effects:
                if _durability_kinds(effects, op) is _MISSING_TAG:
                    raise ModelCheckError(
                        f"state_effects[{op!r}] has no durability tag — "
                        "every op needs one before the durability model "
                        "can run (journal:<kinds>, volatile, none, or "
                        "composite)"
                    )
        #: committed frames, each a tuple of journal records. The first
        #: frame at boot is the meta record load_state queues on a missing
        #: state file. A snapshot replaces the whole list with one frame.
        self.journal: List[Tuple[Tuple[Any, ...], ...]] = []
        self.frames = 0  # append batches (group commits), incl. boot frame
        self.records_since = 0  # journal lines since last snapshot
        self.snapshots = 0
        self._pending: List[Tuple[Any, ...]] = []  # current turn's records
        self._apply_depth = 0
        self.last_crash_info: Optional[Dict[str, Any]] = None
        if durable:
            self._append_frame((("meta", 0),))  # boot: record_epoch()
        # Sharded-ROOT mode (native --shards): with endpoints configured,
        # every keyspace op answers a redirect instead of being served.
        self.shard_endpoints: List[str] = list(shard_endpoints or [])
        self.epoch = 0
        self.members: Dict[str, int] = {}  # name -> rank
        self.next_rank = 0
        self.todo: List[str] = []
        self.leased: Dict[str, str] = {}  # task -> worker (insertion-ordered)
        self.done: set = set()
        self.acquire_cache: Dict[str, Tuple[str, str]] = {}
        self.kv: Dict[str, str] = {}
        self.barriers: Dict[str, Dict[str, Any]] = {}
        self.sync_arrived: set = set()
        self.sync_generation = 0
        # Checkpoint plane: owner -> {step, chunks, nbytes, group, data}.
        self.shards: Dict[str, Dict[str, Any]] = {}
        self.shard_put_seen: set = set()
        # Watch subscriptions: worker -> pending notification frames.
        self.watch_queues: Dict[str, List[Dict[str, Any]]] = {}
        # Pending advance-notice revocations: worker -> {notice_s, reason,
        # seq}. Volatile (native preempts_ is never journaled).
        self.preempts: Dict[str, Dict[str, Any]] = {}
        self.preempt_seq = 0

    def copy(self) -> "ProtocolModel":
        m = ProtocolModel.__new__(ProtocolModel)
        m.effects = self.effects
        m.durable = self.durable
        m.compact_every = self.compact_every
        m.journal = list(self.journal)  # frames are immutable tuples
        m.frames = self.frames
        m.records_since = self.records_since
        m.snapshots = self.snapshots
        m._pending = list(self._pending)
        m._apply_depth = self._apply_depth
        m.last_crash_info = self.last_crash_info
        m.shard_endpoints = list(self.shard_endpoints)
        m.epoch = self.epoch
        m.members = dict(self.members)
        m.next_rank = self.next_rank
        m.todo = list(self.todo)
        m.leased = dict(self.leased)
        m.done = set(self.done)
        m.acquire_cache = dict(self.acquire_cache)
        m.kv = dict(self.kv)
        m.barriers = {
            k: {"arrived": set(v["arrived"]), "generation": v["generation"],
                "want": v["want"]}
            for k, v in self.barriers.items()
        }
        m.sync_arrived = set(self.sync_arrived)
        m.sync_generation = self.sync_generation
        m.shards = {
            owner: {"step": b["step"], "chunks": b["chunks"],
                    "nbytes": b["nbytes"], "group": list(b["group"]),
                    "data": dict(b["data"])}
            for owner, b in self.shards.items()
        }
        m.shard_put_seen = set(self.shard_put_seen)
        m.watch_queues = {
            w: [dict(f) for f in q] for w, q in self.watch_queues.items()
        }
        m.preempts = {w: dict(p) for w, p in self.preempts.items()}
        m.preempt_seq = self.preempt_seq
        return m

    # Every handler returns (reply_prediction | None-if-parked, released)
    # where released is [(worker, reply_prediction), ...] for parked ops
    # this event unblocked.

    def apply(self, worker: str, op: str, fields: Dict[str, Any]):
        if op == CRASH_OP:
            if self._apply_depth:
                raise ModelCheckError("crash cannot nest inside batch")
            return self._op_crash(worker, fields)
        if op not in self.effects:
            raise ModelCheckError(
                f"op {op!r} has no state_effects entry in the schema"
            )
        handler = getattr(self, f"_op_{op}", None)
        if handler is None:
            raise ModelCheckError(f"model has no handler for op {op!r}")
        self._apply_depth += 1
        try:
            out = handler(worker, fields)
        finally:
            self._apply_depth -= 1
        if self.durable and self._apply_depth == 0:
            self._check_durability_tag(op, fields)
            self._commit_frame()
        return out

    # -- durable plane: journal frames, commit, snapshot, recovery replay ------

    def _rec(self, *record: Any) -> None:
        """Emit one journal record into the current turn's frame. Handlers
        call this exactly where the native server calls its ``record_*``
        helpers; a no-op outside durable mode."""
        if self.durable:
            self._pending.append(tuple(record))

    def _check_durability_tag(self, op: str, fields: Dict[str, Any]) -> None:
        """Dynamic half of the durability ratchet: the records an op's
        handler actually emitted must be covered by its declared tag (batch
        checks against the union of its sub-ops' tags)."""
        emitted = {r[0] for r in self._pending}
        if not emitted:
            return
        allowed = _durability_kinds(self.effects, op)
        if allowed is None:  # composite: union over sub-ops
            allowed = set()
            for sub in fields.get("ops", []) or []:
                sub_kinds = _durability_kinds(self.effects,
                                              sub.get("op", ""))
                if isinstance(sub_kinds, set):
                    allowed |= sub_kinds
        if allowed is _MISSING_TAG or emitted - allowed:
            raise ModelCheckError(
                f"durability tag drift: op {op!r} emitted journal "
                f"record kind(s) {sorted(emitted)} but its durability tag "
                f"declares {sorted(allowed) if isinstance(allowed, set) else 'nothing'}"
            )

    def _append_frame(self, frame: Tuple[Tuple[Any, ...], ...]) -> None:
        """Group-commit one frame: append + trailing commit marker + fsync
        (the marker is implicit here — `len(frame) + 1` records — and a
        literal ``{"k":"c"}`` line on disk in both real journals)."""
        self.journal.append(frame)
        self.frames += 1
        self.records_since += len(frame) + 1

    def _commit_frame(self) -> None:
        """End of an event-loop turn: group-commit the pending records —
        or, past the compaction threshold, fold everything into a snapshot
        (the native ``maybe_save_state`` shape: the threshold is checked
        BEFORE appending, and the snapshot covers the pending effects
        because in-memory state already has them)."""
        if not self._pending:
            return
        frame = tuple(self._pending)
        self._pending = []
        if (self.compact_every is not None
                and self.records_since >= self.compact_every):
            self._compact()
        else:
            self._append_frame(frame)

    def _compact(self) -> None:
        """Snapshot the durable projection of current state into a single
        frame, replacing the journal — with the snapshot⊕journal-suffix
        self-check: replaying the new journal must reconstruct exactly the
        state replaying the old one did (plus anything the pending frame
        just folded in, i.e. current state)."""
        snap = self._snapshot_frame()
        self.journal = [snap]
        self.snapshots += 1
        self.records_since = 0
        replayed = self._replay_journal(self.journal)
        now = self._durable_projection()
        if replayed != now:
            raise _SnapshotDivergence(
                f"snapshot replay diverges from live durable state: "
                f"{replayed!r} != {now!r}"
            )

    def _snapshot_frame(self) -> Tuple[Tuple[Any, ...], ...]:
        """The native ``save_snapshot`` layout: meta, todo (live queue
        order), one lease line per held lease (sorted by task, carrying the
        holder's cached req_id when it names this task), done, kv lines
        (sorted)."""
        records: List[Tuple[Any, ...]] = [("meta", self.epoch)]
        if self.todo:
            records.append(("todo", tuple(self.todo)))
        req_of = {}
        for w, (req, task) in self.acquire_cache.items():
            req_of[(task, w)] = req
        for task in sorted(self.leased):
            w = self.leased[task]
            records.append(("lease", task, w, req_of.get((task, w), "")))
        for task in sorted(self.done):
            records.append(("done", task))
        for key in sorted(self.kv):
            records.append(("kv", key, self.kv[key]))
        return tuple(records)

    def _durable_projection(self) -> Tuple[Any, ...]:
        """The journaled slice of live state, in recovery-normal form —
        what a crash right now must reconstruct. Note the todo ORDER is the
        live queue order only until records replay through first-mention
        order; the projection therefore compares sets for todo except
        after a snapshot, where the snapshot pins live order."""
        return (
            self.epoch,
            tuple(sorted(self.todo)),
            tuple(sorted(self.leased.items())),
            tuple(sorted(self.done)),
            tuple(sorted(self.kv.items())),
        )

    def _replay_journal(self, frames: Sequence[Tuple[Tuple[Any, ...], ...]]):
        """Mirror of the native ``load_state`` two-phase replay, in
        recovery-normal form (matching ``_durable_projection``)."""
        epoch = 0
        todo_order: List[str] = []
        seen: Set[str] = set()
        lease_of: Dict[str, str] = {}
        done: Set[str] = set()
        kv: Dict[str, Any] = {}
        for frame in frames:
            for rec in frame:
                kind = rec[0]
                if kind == "meta":
                    epoch = int(rec[1])
                elif kind == "todo":
                    for t in rec[1]:
                        if t not in seen:
                            seen.add(t)
                            todo_order.append(t)
                elif kind == "lease":
                    t = rec[1]
                    if t not in seen:  # lease implies the task exists
                        seen.add(t)
                        todo_order.append(t)
                    lease_of[t] = rec[2]
                elif kind == "done":
                    done.add(rec[1])
                elif kind == "kv":
                    kv[rec[1]] = rec[2]
                elif kind == "kvdel":
                    kv.pop(rec[1], None)
        todo = [t for t in todo_order
                if t not in done and not lease_of.get(t)]
        leased = {t: w for t, w in lease_of.items()
                  if w and t not in done}
        return (
            epoch,
            tuple(sorted(todo)),
            tuple(sorted(leased.items())),
            tuple(sorted(done)),
            tuple(sorted(kv.items())),
        )

    def _recover(self) -> None:
        """``load_state`` semantics on the committed journal: durable state
        replayed, epoch bumped (a restart IS a membership event), every
        volatile table wiped — members, barriers, sync parks, the shard
        store and its put_id dedup (ladder honesty: gone, not lied about),
        watch subscriptions — and the acquire req_id cache REBUILT from the
        journaled lease records (dedup tables are durable state)."""
        epoch = 0
        todo_order: List[str] = []
        seen: Set[str] = set()
        lease_of: Dict[str, str] = {}
        done: Set[str] = set()
        kv: Dict[str, Any] = {}
        cache: Dict[str, Tuple[str, str]] = {}
        for frame in self.journal:
            for rec in frame:
                kind = rec[0]
                if kind == "meta":
                    epoch = int(rec[1])
                elif kind == "todo":
                    for t in rec[1]:
                        if t not in seen:
                            seen.add(t)
                            todo_order.append(t)
                elif kind == "lease":
                    t, w = rec[1], rec[2]
                    req = rec[3] if len(rec) > 3 else ""
                    if t not in seen:
                        seen.add(t)
                        todo_order.append(t)
                    lease_of[t] = w
                    if w and req:
                        cache[w] = (req, t)
                elif kind == "done":
                    done.add(rec[1])
                elif kind == "kv":
                    kv[rec[1]] = rec[2]
                elif kind == "kvdel":
                    kv.pop(rec[1], None)
        self.epoch = epoch + 1
        self.todo = [t for t in todo_order
                     if t not in done and not lease_of.get(t)]
        self.leased = {t: w for t, w in lease_of.items()
                       if w and t not in done}
        self.done = done
        self.kv = kv
        self.acquire_cache = cache
        self.members = {}
        self.next_rank = 0
        self.barriers = {}
        self.sync_arrived = set()
        self.sync_generation = 0
        self.shards = {}
        self.shard_put_seen = set()
        self.watch_queues = {}
        # preempt notices are volatile: a restarted coordinator forgets
        # them and the scheduler re-issues (ladder honesty, like shards).
        self.preempts = {}
        self.preempt_seq = 0
        # boot of the new incarnation: load_state queues record_epoch();
        # crash-injection env does not survive the restart, so compaction
        # reverts to the (never-reached) native default threshold.
        self.compact_every = None
        self.records_since = sum(len(f) + 1 for f in self.journal)
        self._append_frame((("meta", self.epoch),))

    def durability_counters(self) -> Dict[str, int]:
        return {"frames": self.frames, "records": self.records_since,
                "snapshots": self.snapshots}

    def _op_crash(self, worker: str, fields: Dict[str, Any]):
        if not self.durable:
            raise ModelCheckError(
                "crash op scheduled outside a durable schedule"
            )
        mode = fields.get("mode", "clean")
        if mode not in CRASH_MODES:
            raise ModelCheckError(
                f"crash mode {mode!r} — expected one of {CRASH_MODES}"
            )
        inflight = fields.get("inflight") or []
        if mode == "clean" and inflight:
            raise ModelCheckError("crash(clean) takes no inflight ops")
        if mode != "clean" and len(inflight) != 1:
            raise ModelCheckError(
                f"crash({mode}) needs exactly one inflight op (one frame)"
            )
        if mode != "clean" and self.compact_every is not None:
            raise ModelCheckError(
                f"crash({mode}) cannot combine with a compact_every "
                "schedule — the inflight frame's append/snapshot fate "
                "would depend on the interleaving"
            )
        info: Dict[str, Any] = {
            "mode": mode,
            "inflight": [dict(s) for s in inflight],
            "frames_before": self.frames,
            "records_before": self.records_since,
            "snapshots_before": self.snapshots,
        }
        # Hold the apply depth up while applying the inflight op, so the
        # nested apply() does NOT auto-commit its frame — the whole point
        # is that this frame's fate (append / discard) is the crash mode's
        # to decide.
        self._apply_depth += 1
        try:
            for spec in inflight:
                sub = dict(spec)
                sub_op = sub.pop("op", "")
                sub_worker = sub.pop("worker", worker)
                if any(v == LAST_TASK for v in sub.values()):
                    raise ModelCheckError(
                        "inflight crash ops cannot use LAST_TASK"
                    )
                reply, released = self.apply(sub_worker, sub_op, sub)
                if reply is None or released:
                    raise ModelCheckError(
                        f"inflight crash op {sub_op!r} parked or released — "
                        "only plain request/reply ops can ride a crash frame"
                    )
        finally:
            self._apply_depth -= 1
        frame = tuple(self._pending)
        self._pending = []
        info["inflight_records"] = len(frame)
        if mode == "pre_ack" and frame:
            # appended + fsynced, reply never flushed: effects are durable.
            # (Schedules never combine pre_ack with compact_every, so this
            # is always an append, never a snapshot.)
            self._append_frame(frame)
        # torn / during_compaction: the frame never commits — recovery
        # must show NONE of its effects. An empty frame (the inflight op
        # deduplicated, journaling nothing) degrades every mode to clean.
        self._recover()
        info["epoch_after"] = self.epoch
        self.last_crash_info = info
        return {"ok": True, "crash": mode, "epoch": self.epoch}, []

    def _membership_reply(self, worker: str) -> Dict[str, Any]:
        rank = self.members.get(worker, -1)
        return {"ok": True, "rank": rank, "epoch": self.epoch,
                "world": len(self.members)}

    def _redirect(self, key: Any) -> Optional[Dict[str, Any]]:
        """Redirect prediction for a keyspace op on a sharded ROOT; None on
        a plain coordinator. Mirrors the twin's ``redirect_for`` (which
        mirrors the native ``redirect_reply``), including the epoch stamp
        and the answer-before-validation placement."""
        if not self.shard_endpoints:
            return None
        s = shard_of(str(key), len(self.shard_endpoints))
        return {"ok": False, "error": "wrong shard",
                "redirect": self.shard_endpoints[s], "shard": s,
                "epoch": self.epoch}

    def _notify_frame(self, e: int) -> Dict[str, Any]:
        return {"ok": True, "notify": "epoch", "epoch": int(e),
                "cursor": int(e), "world": len(self.members)}

    def _notify_watchers(self) -> None:
        """Epoch moved: one notification frame per live subscription."""
        for q in self.watch_queues.values():
            q.append(self._notify_frame(self.epoch))

    def _preempt_frame(self, worker: str) -> Dict[str, Any]:
        p = self.preempts[worker]
        return {"ok": True, "notify": "preempt", "worker": worker,
                "notice_s": p["notice_s"], "reason": p["reason"],
                "seq": p["seq"], "epoch": self.epoch,
                "cursor": self.epoch, "world": len(self.members)}

    def _requeue_worker_leases(self, worker: str) -> None:
        stale = [t for t, w in self.leased.items() if w == worker]
        for t in stale:
            del self.leased[t]
            self.todo.append(t)
            self._rec("lease", t, "", "")  # native: record_lease(task, "")

    def _release_sync_on_epoch_change(self) -> List[Tuple[str, Dict]]:
        """Membership moved (epoch already bumped): every parked sync wakes
        and observes the epoch mismatch — resync replies."""
        released = [
            (w, {"ok": False, "resync": True, "epoch": self.epoch,
                 "world": len(self.members)})
            for w in sorted(self.sync_arrived)
        ]
        self.sync_arrived = set()
        return released

    def _op_register(self, worker: str, fields: Dict[str, Any]):
        released: List[Tuple[str, Dict]] = []
        tags = self.effects["register"]
        if fields.get("takeover") and tags.get("lease") == "requeue_on_takeover":
            self._requeue_worker_leases(worker)
        if worker not in self.members:
            self.members[worker] = self.next_rank
            self.next_rank += 1
            if tags.get("epoch") == "bump_on_join":
                self.epoch += 1
                self._rec("meta", self.epoch)  # native: bump_epoch() records
                self._notify_watchers()
                released = self._release_sync_on_epoch_change()
        return self._membership_reply(worker), released

    def _op_heartbeat(self, worker: str, fields: Dict[str, Any]):
        if worker not in self.members:
            return ({"ok": False, "error": "unknown worker",
                     "epoch": self.epoch}, [])
        return self._membership_reply(worker), []

    def _op_leave(self, worker: str, fields: Dict[str, Any]):
        # The shim binds leave to the calling client's own worker name; the
        # "worker" request field is envelope, not a target selector.
        target = worker
        released: List[Tuple[str, Dict]] = []
        if target in self.members:
            del self.members[target]
            ranked = sorted(self.members.items(), key=lambda kv: kv[1])
            for r, (name, _) in enumerate(ranked):
                self.members[name] = r
            self.next_rank = len(self.members)
            if self.effects["leave"].get("epoch") == "bump_on_drop":
                self.epoch += 1
                self._rec("meta", self.epoch)
                self._notify_watchers()
            self._requeue_worker_leases(target)
            self.acquire_cache.pop(target, None)
            self.preempts.pop(target, None)  # departure consumes the notice
            released = self._release_sync_on_epoch_change()
        return {"ok": True, "epoch": self.epoch}, released

    def _op_members(self, worker: str, fields: Dict[str, Any]):
        names = [n for n, _ in sorted(self.members.items(),
                                      key=lambda kv: kv[1])]
        return {"ok": True, "members": names, "epoch": self.epoch}, []

    def _op_ping(self, worker: str, fields: Dict[str, Any]):
        return {"ok": True, "pong": True, "epoch": self.epoch}, []

    def _op_add_tasks(self, worker: str, fields: Dict[str, Any]):
        tasks = fields.get("tasks") or []
        r = self._redirect(str(tasks[0]) if tasks else "")
        if r:
            return r, []
        fresh = []
        for t in fields.get("tasks", []):
            if t in self.done or t in self.leased or t in self.todo:
                continue
            self.todo.append(t)
            fresh.append(t)
        if fresh:  # native record_todo skips the empty list
            self._rec("todo", tuple(fresh))
        added = len(fresh)
        return ({"ok": True, "added": added, "queued": len(self.todo),
                 "epoch": self.epoch}, [])

    def _op_acquire_task(self, worker: str, fields: Dict[str, Any]):
        r = self._redirect(worker)
        if r:
            return r, []
        req_id = fields.get("req_id")
        if req_id and self.effects["acquire_task"].get("dedup") == "req_id":
            cached = self.acquire_cache.get(worker)
            if cached and cached[0] == req_id:
                task = cached[1]
                if self.leased.get(task) == worker:
                    return ({"ok": True, "task": task, "duplicate": True,
                             "epoch": self.epoch}, [])
        if not self.todo:
            return ({"ok": True, "task": None,
                     "exhausted": not self.leased, "epoch": self.epoch}, [])
        task = self.todo.pop(0)
        self.leased[task] = worker
        # journaling the req_id with the lease is THE durability fix for
        # exactly-once across crash: the cache rebuilds from this record.
        self._rec("lease", task, worker, req_id or "")
        if req_id:
            self.acquire_cache[worker] = (req_id, task)
        return {"ok": True, "task": task, "epoch": self.epoch}, []

    def _op_complete_task(self, worker: str, fields: Dict[str, Any]):
        task = fields.get("task")
        r = self._redirect(task)
        if r:
            return r, []
        if task in self.done:
            return ({"ok": True, "duplicate": True, "done": len(self.done),
                     "queued": len(self.todo), "epoch": self.epoch}, [])
        if task not in self.leased:
            if task in self.todo:
                self.todo.remove(task)
                self.done.add(task)
                self._rec("done", task)
                return ({"ok": True, "requeued": True,
                         "done": len(self.done), "queued": len(self.todo),
                         "epoch": self.epoch}, [])
            return ({"ok": False, "error": "not leased",
                     "epoch": self.epoch}, [])
        if self.leased[task] != worker:
            return ({"ok": False, "error": "lease not owned",
                     "epoch": self.epoch}, [])
        del self.leased[task]
        self.done.add(task)
        self._rec("done", task)
        return ({"ok": True, "done": len(self.done),
                 "queued": len(self.todo), "epoch": self.epoch}, [])

    def _op_fail_task(self, worker: str, fields: Dict[str, Any]):
        task = fields.get("task")
        r = self._redirect(task)
        if r:
            return r, []
        if task not in self.leased:
            return ({"ok": False, "error": "not leased",
                     "epoch": self.epoch}, [])
        if self.leased[task] != worker:
            return ({"ok": False, "error": "lease not owned",
                     "epoch": self.epoch}, [])
        del self.leased[task]
        self.todo.append(task)
        self._rec("lease", task, "", "")
        return {"ok": True, "epoch": self.epoch}, []

    def _op_kv_put(self, worker: str, fields: Dict[str, Any]):
        key = fields.get("key")
        r = self._redirect(key or "")
        if r:
            return r, []
        if not key:
            return ({"ok": False, "error": "key required",
                     "epoch": self.epoch}, [])
        self.kv[key] = fields.get("value")
        self._rec("kv", key, self.kv[key])
        return {"ok": True, "epoch": self.epoch}, []

    def _op_kv_get(self, worker: str, fields: Dict[str, Any]):
        r = self._redirect(fields.get("key") or "")
        if r:
            return r, []
        return ({"ok": True, "value": self.kv.get(fields.get("key")),
                 "epoch": self.epoch}, [])

    def _op_kv_del(self, worker: str, fields: Dict[str, Any]):
        r = self._redirect(fields.get("key") or "")
        if r:
            return r, []
        key = fields.get("key")
        if key in self.kv:  # native records only when the erase took
            del self.kv[key]
            self._rec("kvdel", key)
        return {"ok": True, "epoch": self.epoch}, []

    def _op_kv_incr(self, worker: str, fields: Dict[str, Any]):
        key = fields.get("key", "")
        r = self._redirect(key)
        if r:
            return r, []
        if not key:
            return ({"ok": False, "error": "key required",
                     "epoch": self.epoch}, [])
        op_id = fields.get("op_id")
        marker = f"__edl_op/{op_id}" if op_id else None
        if (marker and marker in self.kv
                and self.effects["kv_incr"].get("dedup") == "op_id"):
            return ({"ok": True, "value": int(self.kv[marker]),
                     "duplicate": True, "epoch": self.epoch}, [])
        cur = int(self.kv.get(key, "0") or "0") + int(fields.get("delta", 1))
        self.kv[key] = str(cur)
        # value record + marker record ride ONE frame: the torn-tail
        # schedule exists to prove they live or die together.
        self._rec("kv", key, str(cur))
        if marker:
            self.kv[marker] = str(cur)
            self._rec("kv", marker, str(cur))
        return {"ok": True, "value": cur, "epoch": self.epoch}, []

    # Checkpoint-plane ops (memory-resident shard replication). Mirror the
    # twin's shard_* methods exactly: step supersedes, put_id dedups
    # exactly-once, drop with a step only removes that exact step. None of
    # them touch the epoch or park.

    def _op_shard_put(self, worker: str, fields: Dict[str, Any]):
        owner = fields.get("owner", "")
        r = self._redirect(owner)
        if r:
            return r, []
        step = int(fields.get("step", -1))
        chunk = int(fields.get("chunk", -1))
        chunks = int(fields.get("chunks", 0))
        if not owner or step < 0 or chunks < 1 or not 0 <= chunk < chunks:
            return ({"ok": False,
                     "error": "shard_put requires owner, step>=0, "
                              "0<=chunk<chunks",
                     "epoch": self.epoch}, [])
        put_id = fields.get("put_id")
        if (put_id and put_id in self.shard_put_seen
                and self.effects["shard_put"].get("dedup") == "put_id"):
            return ({"ok": True, "duplicate": True, "stored": True,
                     "epoch": self.epoch}, [])
        blob = self.shards.setdefault(
            owner, {"step": -1, "chunks": 0, "nbytes": 0,
                    "group": [], "data": {}})
        if step < blob["step"]:
            return ({"ok": True, "duplicate": False, "stored": False,
                     "epoch": self.epoch}, [])
        if step > blob["step"]:
            blob["step"] = step
            blob["data"] = {}
            blob["group"] = []
        blob["chunks"] = chunks
        blob["nbytes"] = int(fields.get("nbytes", 0))
        group = fields.get("group")
        if isinstance(group, list):
            blob["group"] = [str(g) for g in group]
        blob["data"][chunk] = fields.get("data", "")
        if put_id:
            self.shard_put_seen.add(put_id)
        return ({"ok": True, "duplicate": False, "stored": True,
                 "epoch": self.epoch}, [])

    def _op_shard_get(self, worker: str, fields: Dict[str, Any]):
        owner = fields.get("owner", "")
        r = self._redirect(owner)
        if r:
            return r, []
        step = int(fields.get("step", -1))
        chunk = int(fields.get("chunk", 0))
        blob = self.shards.get(owner)
        if blob is None or (step >= 0 and blob["step"] != step):
            return ({"ok": True, "found": False, "data": "", "chunks": 0,
                     "epoch": self.epoch}, [])
        payload = blob["data"].get(chunk)
        if payload is None:
            return ({"ok": True, "found": False, "data": "",
                     "chunks": blob["chunks"], "epoch": self.epoch}, [])
        return ({"ok": True, "found": True, "data": payload,
                 "chunks": blob["chunks"], "epoch": self.epoch}, [])

    def _op_shard_meta(self, worker: str, fields: Dict[str, Any]):
        r = self._redirect(fields.get("owner", ""))
        if r:
            return r, []
        blob = self.shards.get(fields.get("owner", ""))
        if blob is None or blob["step"] < 0:
            return ({"ok": True, "found": False, "step": -1, "chunks": 0,
                     "nbytes": 0, "complete": False, "group": [],
                     "epoch": self.epoch}, [])
        complete = blob["chunks"] > 0 and len(blob["data"]) == blob["chunks"]
        return ({"ok": True, "found": True, "step": blob["step"],
                 "chunks": blob["chunks"], "nbytes": blob["nbytes"],
                 "complete": complete, "group": list(blob["group"]),
                 "epoch": self.epoch}, [])

    def _op_shard_drop(self, worker: str, fields: Dict[str, Any]):
        owner = fields.get("owner", "")
        r = self._redirect(owner)
        if r:
            return r, []
        step = int(fields.get("step", -1))
        blob = self.shards.get(owner)
        dropped = False
        if blob is not None and (step < 0 or blob["step"] == step):
            del self.shards[owner]
            dropped = True
        return {"ok": True, "dropped": dropped, "epoch": self.epoch}, []

    def _op_bump_epoch(self, worker: str, fields: Dict[str, Any]):
        self.epoch += 1
        self._rec("meta", self.epoch)
        self._notify_watchers()
        released = self._release_sync_on_epoch_change()
        return {"ok": True, "epoch": self.epoch}, released

    def _op_status(self, worker: str, fields: Dict[str, Any]):
        return ({"ok": True, "epoch": self.epoch,
                 "world": len(self.members), "queued": len(self.todo),
                 "leased": len(self.leased), "done": len(self.done),
                 "preempts": sorted(
                     f"{w}={int(p['notice_s'])}"
                     for w, p in self.preempts.items())}, [])

    def _op_preempt_notice(self, worker: str, fields: Dict[str, Any]):
        targets = fields.get("targets")
        if not isinstance(targets, list) or not targets:
            return ({"ok": False, "error": "targets array required",
                     "epoch": self.epoch}, [])
        notice_s = float(fields.get("notice_s", 0) or 0)
        reason = fields.get("reason") or "preempt"
        revoked: List[str] = []
        for t in targets:
            t = str(t)
            self.preempt_seq += 1
            self.preempts[t] = {"notice_s": notice_s, "reason": reason,
                                "seq": self.preempt_seq}
            q = self.watch_queues.get(t)
            if q is not None:
                q.append(self._preempt_frame(t))
            revoked.append(t)
        return {"ok": True, "revoked": revoked, "epoch": self.epoch}, []

    # Watch/notify ops (push-based epoch discovery). The twin has no socket
    # to push to, so delivery is modeled the way the shim serves it: a
    # subscribe queues replayed frames for every epoch in (cursor, current],
    # epoch bumps append live frames, and ``watch`` with take=True drains
    # one frame (the in-process stand-in for the wire server's unsolicited
    # push). Frames carry the epoch being ANNOUNCED, which may be historical.

    def _op_watch(self, worker: str, fields: Dict[str, Any]):
        if fields.get("take"):
            q = self.watch_queues.get(worker)
            if not q:
                return ({"ok": True, "notify": None, "cursor": self.epoch,
                         "world": len(self.members),
                         "epoch": self.epoch}, [])
            return dict(q.pop(0)), []
        q = self.watch_queues.setdefault(worker, [])
        cursor = int(fields.get("cursor", -1))
        if cursor >= 0:
            for e in range(cursor + 1, self.epoch + 1):
                q.append(self._notify_frame(e))
        if worker in self.preempts:  # late subscriber: replay the notice
            q.append(self._preempt_frame(worker))
        return ({"ok": True, "watch": True, "cursor": self.epoch,
                 "epoch": self.epoch}, [])

    def _op_watch_cancel(self, worker: str, fields: Dict[str, Any]):
        cancelled = worker in self.watch_queues
        self.watch_queues.pop(worker, None)
        return {"ok": True, "cancelled": cancelled, "epoch": self.epoch}, []

    def _op_shard_map(self, worker: str, fields: Dict[str, Any]):
        return ({"ok": True, "root": bool(self.shard_endpoints),
                 "nshards": len(self.shard_endpoints),
                 "shards": list(self.shard_endpoints), "shard_index": -1,
                 "epoch": self.epoch}, [])

    def _op_batch(self, worker: str, fields: Dict[str, Any]):
        if not self.effects["batch"].get("composite"):
            raise ModelCheckError(
                "state_effects['batch'] lost its composite tag"
            )
        replies = []
        released: List[Tuple[str, Dict]] = []
        for sub in fields.get("ops", []):
            sub = dict(sub)
            sub_op = sub.pop("op", "")
            if sub_op in _NON_BATCHABLE:
                replies.append(
                    {"ok": False, "error": f"op not batchable: {sub_op}"})
                continue
            reply, rel = self.apply(worker, sub_op, sub)
            replies.append(reply)
            released.extend(rel)
        return ({"ok": True, "replies": replies, "epoch": self.epoch},
                released)

    # Parked ops return (None, released): the caller must park the worker.

    def _op_barrier(self, worker: str, fields: Dict[str, Any]):
        name = fields["name"]
        count = int(fields["count"])
        b = self.barriers.setdefault(
            name, {"arrived": set(), "generation": 0, "want": 0})
        if not b["arrived"]:
            b["want"] = count
        elif count != b["want"]:
            return ({"ok": False, "error": "barrier count mismatch",
                     "want": b["want"], "epoch": self.epoch}, [])
        gen = b["generation"]
        b["arrived"].add(worker)
        if len(b["arrived"]) >= b["want"]:
            b["generation"] += 1
            parked = sorted(b["arrived"] - {worker})
            b["arrived"] = set()
            released = [
                (w, {"ok": True, "barrier": name, "generation": gen,
                     "epoch": self.epoch})
                for w in parked
            ]
            return ({"ok": True, "barrier": name, "generation": gen,
                     "epoch": self.epoch}, released)
        return None, []  # parked

    def _op_sync(self, worker: str, fields: Dict[str, Any]):
        if worker not in self.members:
            return ({"ok": False, "error": "unknown worker",
                     "epoch": self.epoch, "world": len(self.members)}, [])
        if int(fields["epoch"]) != self.epoch:
            return ({"ok": False, "resync": True, "epoch": self.epoch,
                     "world": len(self.members)}, [])
        self.sync_arrived.add(worker)
        if self.sync_arrived >= set(self.members):
            parked = sorted(self.sync_arrived - {worker})
            self.sync_arrived = set()
            self.sync_generation += 1
            reply = {"ok": True, "epoch": self.epoch,
                     "world": len(self.members)}
            return reply, [(w, dict(reply)) for w in parked]
        return None, []  # parked


# -- explorer ------------------------------------------------------------------


@dataclass
class _Event:
    """One scheduled op in a concrete trace, with the model's prediction."""

    worker: str
    op: ScriptOp
    fields: Dict[str, Any]  # LAST_TASK already resolved (model view)
    predicted: Optional[Dict[str, Any]]  # None while parked
    parked: bool = False
    released_at: Optional[int] = None  # index of the releasing event
    #: for CRASH_OP events: the model's crash bookkeeping (mode, inflight
    #: specs, pre-crash frame/record counters) — the oracle adapter arms
    #: its crash injection from this.
    crash_info: Optional[Dict[str, Any]] = None


def _resolve_last_task(fields: Dict[str, Any], last_task: Any):
    out = {}
    for k, v in fields.items():
        if v == LAST_TASK:
            out[k] = last_task
        elif k == "ops" and isinstance(v, list):
            out[k] = [_resolve_last_task(dict(sub), last_task) for sub in v]
        else:
            out[k] = v
    return out


def _grants_from_reply(op: str, fields: Dict[str, Any], reply: Any):
    """(task, duplicate) grant observations in a reply (incl. batch subs)."""
    if not isinstance(reply, dict):
        return
    if op == "acquire_task" and reply.get("ok") and reply.get("task"):
        yield reply["task"], bool(reply.get("duplicate")), fields.get("req_id")
    if op == "batch":
        subs = fields.get("ops", [])
        for sub, sub_reply in zip(subs, reply.get("replies", []) or []):
            sub_op = sub.get("op", "")
            yield from _grants_from_reply(sub_op, sub, sub_reply)


class _TraceState:
    """One DFS node: per-worker program counters + parked set + model."""

    def __init__(self, scripts: Dict[str, Sequence[ScriptOp]],
                 model: ProtocolModel):
        self.scripts = scripts
        self.pcs = {w: 0 for w in scripts}
        self.parked: Dict[str, int] = {}  # worker -> event index in trace
        self.last_task: Dict[str, Any] = {w: None for w in scripts}
        self.model = model
        self.trace: List[_Event] = []

    def runnable(self) -> List[str]:
        return sorted(
            w for w, pc in self.pcs.items()
            if pc < len(self.scripts[w]) and w not in self.parked
        )

    def done(self) -> bool:
        return not self.parked and all(
            pc >= len(self.scripts[w]) for w, pc in self.pcs.items()
        )

    def copy(self) -> "_TraceState":
        st = _TraceState.__new__(_TraceState)
        st.scripts = self.scripts
        st.pcs = dict(self.pcs)
        st.parked = dict(self.parked)
        st.last_task = dict(self.last_task)
        st.model = self.model.copy()
        st.trace = [
            _Event(e.worker, e.op, e.fields, e.predicted, e.parked,
                   e.released_at, e.crash_info)
            for e in self.trace
        ]
        return st

    def step(self, worker: str) -> None:
        """Advance ``worker`` one op through the model."""
        sop = self.scripts[worker][self.pcs[worker]]
        self.pcs[worker] += 1
        if sop.op == CRASH_OP and self.parked:
            raise ModelCheckError(
                "crash scheduled while a worker is parked — durable "
                "schedules must not mix crash with barrier/sync ops"
            )
        fields = _resolve_last_task(sop.field_dict(), self.last_task[worker])
        predicted, released = self.model.apply(worker, sop.op, fields)
        ev = _Event(worker=worker, op=sop, fields=fields,
                    predicted=predicted, parked=predicted is None)
        if sop.op == CRASH_OP:
            ev.crash_info = self.model.last_crash_info
        self.trace.append(ev)
        idx = len(self.trace) - 1
        if ev.parked:
            self.parked[worker] = idx
        else:
            self._note_grants(worker, sop.op, fields, predicted)
        for released_worker, reply in released:
            parked_idx = self.parked.pop(released_worker, None)
            if parked_idx is not None:
                parked_ev = self.trace[parked_idx]
                parked_ev.predicted = reply
                parked_ev.parked = False
                parked_ev.released_at = idx
                self._note_grants(released_worker, parked_ev.op.op,
                                  parked_ev.fields, reply)

    def _note_grants(self, worker, op, fields, reply):
        for task, _dup, _req in _grants_from_reply(op, fields, reply):
            self.last_task[worker] = task

    def render(self) -> str:
        return " ; ".join(f"{e.worker}:{e.op.render()}" for e in self.trace)


CoordinatorFactory = Callable[[], Any]


def _default_coordinator_factory():
    from edl_tpu_torch.coordinator.inprocess import InProcessCoordinator

    # Time must not pass for the model: near-infinite lease/TTL windows.
    return InProcessCoordinator(task_lease_sec=1e9, heartbeat_ttl_sec=1e9)


def _replay_trace(trace: List[_Event], factory: CoordinatorFactory,
                  rendered: str, violations: List[Violation],
                  join_timeout: float = 30.0) -> None:
    """Execute the scheduled trace against a fresh coordinator and check
    model predictions + runtime invariants on the oracle's replies."""
    coord = factory()
    # Oracles that must know the crash point BEFORE the first op (the
    # native coordinator reads its crash-injection env at boot) get the
    # whole trace up front; the in-process twin has no such hook.
    begin = getattr(coord, "begin_trace", None)
    if begin is not None:
        begin(trace)
    clients = {}
    last_task: Dict[str, Any] = {}
    last_epoch: Dict[str, int] = {}
    live_grants: Dict[str, str] = {}  # task -> worker (oracle view)
    grants_by_req: Dict[Tuple[str, str], set] = {}
    pending: Dict[int, Tuple[threading.Thread, List]] = {}
    added_total = 0
    crashed = [False]  # flips at the first crash event in the trace

    def client(worker: str):
        if worker not in clients:
            clients[worker] = coord.client(worker)
        return clients[worker]

    def div_kind() -> str:
        """Model/oracle reply divergences BEFORE any crash are plain
        spec/twin drift; AFTER a crash they mean recovery reconstructed
        different durable state than a correct journal replay would — the
        acked-durability invariant."""
        return "acked-durability" if crashed[0] else "oracle-divergence"

    def requeue_events(worker: str, op: str, fields: Dict[str, Any]):
        """Lease-release points: a grant after one is a transfer, not a
        violation. Mirrors the coordinator's requeue semantics."""
        if op == "register" and fields.get("takeover"):
            for t, w in list(live_grants.items()):
                if w == worker:
                    del live_grants[t]
        if op == "leave":
            for t, w in list(live_grants.items()):
                if w == worker:
                    del live_grants[t]
        if op in ("fail_task", "complete_task"):
            live_grants.pop(fields.get("task"), None)

    def check_reply(idx: int, ev: _Event, fields: Dict[str, Any],
                    reply: Any) -> None:
        """``fields`` is the ORACLE-side resolution of the scripted op
        (LAST_TASK bound from the oracle's own reply stream)."""
        nonlocal added_total
        where = f"step {idx} ({ev.worker}:{ev.op.render()})"
        if not isinstance(reply, dict):
            violations.append(Violation(
                div_kind(),
                f"{where}: oracle returned non-dict reply {reply!r}",
                rendered))
            return
        # model prediction must be a subset of the oracle reply, epoch exact
        for key, want in (ev.predicted or {}).items():
            have = reply.get(key, "<absent>")
            if key == "replies":
                continue  # batch sub-replies compared below
            if have != want:
                violations.append(Violation(
                    div_kind(),
                    f"{where}: model predicts {key}={want!r}, oracle "
                    f"replied {key}={have!r}",
                    rendered))
        if ev.op.op == "batch":
            want_subs = (ev.predicted or {}).get("replies", [])
            have_subs = reply.get("replies", [])
            if len(want_subs) != len(have_subs):
                violations.append(Violation(
                    div_kind(),
                    f"{where}: batch sub-reply count mismatch "
                    f"(model {len(want_subs)}, oracle {len(have_subs)})",
                    rendered))
            for j, (ws, hs) in enumerate(zip(want_subs, have_subs)):
                for key, want in ws.items():
                    if not isinstance(hs, dict) or hs.get(key, "<absent>") != want:
                        violations.append(Violation(
                            div_kind(),
                            f"{where} sub-op {j}: model predicts "
                            f"{key}={want!r}, oracle replied "
                            f"{(hs or {}).get(key, '<absent>')!r}",
                            rendered))
        # invariant: per-stream epoch monotonicity. Notification frames are
        # exempt: their "epoch" names the (possibly historical) epoch being
        # announced — on the wire they ride a dedicated watch connection,
        # not the request/reply stream the invariant is defined over.
        if "epoch" in reply and not reply.get("notify"):
            ep = int(reply["epoch"])
            if ep < last_epoch.get(ev.worker, 0):
                violations.append(Violation(
                    "epoch-monotonicity",
                    f"{where}: epoch went backwards "
                    f"({last_epoch[ev.worker]} -> {ep}) on "
                    f"{ev.worker}'s reply stream",
                    rendered))
            last_epoch[ev.worker] = max(last_epoch.get(ev.worker, 0), ep)
        # invariants: exactly-once + lease exclusivity on oracle grants
        requeue_events(ev.worker, ev.op.op, fields)
        if ev.op.op == "batch":
            for sub in fields.get("ops", []):
                requeue_events(ev.worker, sub.get("op", ""), sub)
        for task, dup, req_id in _grants_from_reply(
                ev.op.op, fields, reply):
            last_task[ev.worker] = task
            if req_id:
                seen = grants_by_req.setdefault((ev.worker, req_id), set())
                seen.add(task)
                if len(seen) > 1:
                    violations.append(Violation(
                        "exactly-once",
                        f"{where}: req_id {req_id!r} was granted "
                        f"{sorted(seen)} — a replayed acquire popped a "
                        "second task instead of returning the original "
                        "lease",
                        rendered))
            if not dup:
                holder = live_grants.get(task)
                if holder is not None and holder != ev.worker:
                    violations.append(Violation(
                        "lease-exclusivity",
                        f"{where}: task {task!r} granted to {ev.worker} "
                        f"while {holder} still holds the lease",
                        rendered))
                live_grants[task] = ev.worker
        if ev.op.op == "add_tasks" and reply.get("ok"):
            added_total += int(reply.get("added", 0))
        if ev.op.op == "batch":
            for sub, sub_reply in zip(fields.get("ops", []),
                                      reply.get("replies", []) or []):
                if (sub.get("op") == "add_tasks"
                        and isinstance(sub_reply, dict)
                        and sub_reply.get("ok")):
                    added_total += int(sub_reply.get("added", 0))
        if ev.op.op == "status" and reply.get("ok"):
            # invariant: task conservation — at this point in the schedule
            # every task added so far is queued, leased, or done.
            total = (int(reply.get("queued", 0))
                     + int(reply.get("leased", 0))
                     + int(reply.get("done", 0)))
            if total != added_total:
                violations.append(Violation(
                    "conservation",
                    f"{where}: status queued+leased+done={total} != "
                    f"tasks added so far={added_total}",
                    rendered))

    oracle_fields: Dict[int, Dict[str, Any]] = {}
    for idx, ev in enumerate(trace):
        # Resolve LAST_TASK from the ORACLE's own reply stream (ev.fields is
        # the model-side resolution; the two views stay independent so a
        # grant divergence is reported once, at the acquire).
        fields = _resolve_last_task(ev.op.field_dict(),
                                    last_task.get(ev.worker))
        oracle_fields[idx] = fields
        if ev.op.op == CRASH_OP:
            if not hasattr(coord, "model_crash"):
                raise ModelCheckError(
                    "schedule contains a crash op but the oracle factory "
                    "built a coordinator without model_crash() — durable "
                    "schedules need a crash-capable oracle adapter"
                )
            reply = coord.model_crash(ev.crash_info or {})
            crashed[0] = True
            clients.clear()  # old incarnation's clients are dead
            check_reply(idx, ev, fields, reply)
            continue
        if ev.parked or ev.released_at is not None:
            holder: List = []

            def run(c=client(ev.worker), op=ev.op.op, f=fields, h=holder):
                try:
                    h.append(c.call(op, timeout=join_timeout, **f))
                except Exception as e:  # edl: noqa[EDL005] stashed in holder; join() turns it into a violation
                    h.append(e)

            th = threading.Thread(target=run, daemon=True)
            th.start()
            pending[idx] = (th, holder)
        else:
            reply = client(ev.worker).call(ev.op.op, **fields)
            check_reply(idx, ev, fields, reply)
        # join any parked ops this event released
        for pidx in [p for p in list(pending)
                     if trace[p].released_at == idx]:
            th, holder = pending.pop(pidx)
            th.join(join_timeout)
            if th.is_alive() or not holder:
                violations.append(Violation(
                    "progress",
                    f"step {pidx} ({trace[pidx].worker}:"
                    f"{trace[pidx].op.render()}): oracle did not release "
                    "the parked op the model says this event releases",
                    rendered))
                continue
            reply = holder[0]
            if isinstance(reply, Exception):
                violations.append(Violation(
                    "oracle-divergence",
                    f"step {pidx}: parked op raised {reply!r}", rendered))
                continue
            check_reply(pidx, trace[pidx], oracle_fields[pidx], reply)

    if pending:
        violations.append(Violation(
            "progress",
            f"{len(pending)} parked op(s) never released by trace end",
            rendered))

    close = getattr(coord, "close", None)
    if close is not None:
        close()  # durable oracles hold a temp state dir per replay


def _footprint(sop: ScriptOp):
    """Static footprint of a scripted op for the sleep-set POR. ``None``
    means global (conflicts with every other op): epoch writers, crash,
    batch, parked ops, the watch plane. Non-global ops commute iff their
    footprints are disjoint — replies (epoch included: nobody here bumps
    it) and the reached state are then identical in either order, so the
    pruned interleaving is trace-equivalent to an explored one."""
    op = sop.op
    f = dict(sop.fields)
    if op in ("ping", "members", "shard_map"):
        return frozenset()
    if op in ("kv_put", "kv_get", "kv_del"):
        return frozenset({("kv", f.get("key"))})
    if op == "kv_incr":
        keys = {("kv", f.get("key"))}
        if f.get("op_id"):
            keys.add(("kv", f"__edl_op/{f.get('op_id')}"))
        return frozenset(keys)
    if op in ("shard_put", "shard_get", "shard_meta", "shard_drop"):
        return frozenset({("shard", f.get("owner"))})
    if op in ("acquire_task", "add_tasks", "complete_task", "fail_task",
              "status"):
        return frozenset({("queue",)})
    return None


def _independent(a: ScriptOp, b: ScriptOp) -> bool:
    fa, fb = _footprint(a), _footprint(b)
    return fa is not None and fb is not None and not (fa & fb)


def explore(
    scripts: Dict[str, Sequence[ScriptOp]],
    effects: Dict[str, Dict[str, Any]],
    coordinator_factory: Optional[CoordinatorFactory] = None,
    max_traces: int = 20000,
    max_violations: int = 25,
    fuzz_samples: int = 0,
    fuzz_seed: int = 0,
    replay: bool = True,
    shard_endpoints: Optional[Sequence[str]] = None,
    durable: bool = False,
    compact_every: Optional[int] = None,
    por: bool = False,
    name: str = "",
) -> ModelCheckResult:
    """Enumerate interleavings of ``scripts`` (exhaustive DFS, or a seeded
    random walk when ``fuzz_samples > 0``), model-check each, and replay
    completed traces against the oracle coordinator. ``shard_endpoints``
    puts the MODEL in sharded-root mode — pair it with a factory that
    builds the oracle with the same endpoints. ``durable`` runs the
    journaled model (crash ops allowed; factory must build a crash-capable
    oracle adapter). ``por`` turns on the sleep-set partial-order
    reduction (exhaustive mode only; off under fuzz and compaction, where
    frame counting makes commutation journal-visible)."""
    factory = coordinator_factory or _default_coordinator_factory
    result = ModelCheckResult()

    def model() -> ProtocolModel:
        return ProtocolModel(effects, shard_endpoints,
                             durable=durable, compact_every=compact_every)

    def annotate(start: int, state: _TraceState) -> None:
        order = tuple(e.worker for e in state.trace)
        for v in result.violations[start:]:
            v.schedule = name
            v.order = order

    def finish(state: _TraceState) -> None:
        result.traces += 1
        rendered = state.render()
        start = len(result.violations)
        if not state.done():
            # all runnable workers parked / drained with parked remainder
            stuck = sorted(state.parked)
            result.violations.append(Violation(
                "progress",
                f"deadlock: worker(s) {stuck} parked with no releasing op "
                "left in any script",
                rendered))
            annotate(start, state)
            return  # replay would hang on the parked ops
        if replay:
            result.replays += 1
            _replay_trace(state.trace, factory, rendered, result.violations)
            annotate(start, state)

    def budget_left() -> bool:
        return (result.traces < max_traces
                and len(result.violations) < max_violations)

    def snapshot_diverged(state: _TraceState, exc: _SnapshotDivergence):
        result.traces += 1
        start = len(result.violations)
        result.violations.append(Violation(
            "snapshot-divergence", str(exc), state.render()))
        annotate(start, state)

    if fuzz_samples > 0:
        import random

        rng = random.Random(fuzz_seed)
        seen = set()
        for _ in range(fuzz_samples):
            if not budget_left():
                break
            state = _TraceState(scripts, model())
            diverged = False
            while True:
                workers = state.runnable()
                if not workers:
                    break
                try:
                    state.step(rng.choice(workers))
                except _SnapshotDivergence as exc:
                    snapshot_diverged(state, exc)
                    diverged = True
                    break
            if diverged:
                continue
            key = state.render()
            if key in seen:
                continue
            seen.add(key)
            finish(state)
        return result

    use_por = por and compact_every is None

    def next_op(state: _TraceState, worker: str) -> ScriptOp:
        return state.scripts[worker][state.pcs[worker]]

    def dfs(state: _TraceState, sleep: frozenset) -> None:
        if not budget_left():
            return
        workers = state.runnable()
        if not workers:
            finish(state)
            return
        active = [w for w in workers if w not in sleep]
        if not active:
            return  # every continuation is covered by an explored sibling
        explored: List[str] = []
        for i, worker in enumerate(active):
            branch = state if i == len(active) - 1 else state.copy()
            if use_por:
                here = next_op(state, worker)
                child_sleep = frozenset(
                    v for v in (set(sleep) | set(explored))
                    if v != worker and v in workers
                    and _independent(next_op(state, v), here)
                )
            else:
                child_sleep = frozenset()
            try:
                branch.step(worker)
            except _SnapshotDivergence as exc:
                snapshot_diverged(branch, exc)
            else:
                dfs(branch, child_sleep)
            explored.append(worker)
            if not budget_left():
                return

    dfs(_TraceState(scripts, model()), frozenset())
    return result


# -- default bounded configuration ---------------------------------------------


def default_scripts() -> Dict[str, List[ScriptOp]]:
    """The acceptance configuration: 2 workers, 13 ops including ``batch``,
    one crash+restart (register takeover), and two duplicate deliveries
    (an acquire req_id replay and a kv_incr op_id replay)."""
    mk = ScriptOp.make
    w0 = [
        mk("register", worker="w0"),
        mk("add_tasks", tasks=["t0", "t1", "t2", "t3"]),
        mk("acquire_task", req_id="w0-a1", worker="w0"),
        mk("acquire_task", note="dup", req_id="w0-a1", worker="w0"),
        mk("register", note="restart", takeover=True, worker="w0"),
        mk("batch", ops=[
            {"op": "acquire_task", "req_id": "w0-a2"},
            {"op": "kv_incr", "key": "steps", "delta": 1,
             "op_id": "w0-i1"},
        ]),
        mk("complete_task", task=LAST_TASK, worker="w0"),
    ]
    w1 = [
        mk("register", worker="w1"),
        mk("acquire_task", req_id="w1-a1", worker="w1"),
        mk("kv_incr", key="steps", delta=1, op_id="w1-i1"),
        mk("kv_incr", note="dup", key="steps", delta=1, op_id="w1-i1"),
        mk("complete_task", task=LAST_TASK, worker="w1"),
        mk("status"),
    ]
    return {"w0": w0, "w1": w1}


def ckpt_plane_scripts() -> Dict[str, List[ScriptOp]]:
    """Checkpoint-plane schedule: 2 workers exercising the shard_* ops —
    a batched two-chunk replication pass, a duplicate shard_put replay
    (exactly-once under put_id dedup), a stale put racing a newer pass, a
    chunk fetch, and a step-conditional drop. Kept separate from
    ``default_scripts`` so the combined interleaving count stays inside the
    exploration budget (adding 5 ops to the default schedule would blow it)."""
    mk = ScriptOp.make
    w0 = [
        mk("register", worker="w0"),
        mk("batch", ops=[
            {"op": "shard_put", "owner": "w0", "step": 1, "chunk": 0,
             "chunks": 2, "nbytes": 8, "data": "AAAA", "put_id": "w0-p1",
             "group": ["w1"]},
            {"op": "shard_put", "owner": "w0", "step": 1, "chunk": 1,
             "chunks": 2, "nbytes": 8, "data": "BBBB", "put_id": "w0-p2",
             "group": ["w1"]},
        ]),
        mk("shard_put", note="dup", owner="w0", step=1, chunk=0, chunks=2,
           nbytes=8, data="AAAA", put_id="w0-p1", group=["w1"]),
        mk("shard_meta", owner="w0"),
    ]
    w1 = [
        mk("register", worker="w1"),
        mk("shard_put", note="stale", owner="w0", step=0, chunk=0, chunks=1,
           nbytes=4, data="OLD", put_id="w1-p1"),
        mk("shard_get", owner="w0", step=-1, chunk=0),
        mk("shard_drop", owner="w0", step=1),
    ]
    return {"w0": w0, "w1": w1}


#: fake shard endpoints driving the redirect schedules — never dialed; the
#: sharded root (model AND twin) only hashes keys against them (FNV-1a).
SHARD_ENDPOINTS = ["10.0.0.1:7164", "10.0.0.2:7164"]


def watch_scripts() -> Dict[str, List[ScriptOp]]:
    """Watch/notify schedule: subscribe with a resume cursor, epoch bumps
    from joins and an explicit bump, frame drains interleaved with the
    bumps, a duplicate re-subscribe at a stale cursor (at-least-once
    delivery replays already-announced epochs — the model must predict the
    duplicates exactly), and a cancel. Runs against the plain twin."""
    mk = ScriptOp.make
    w0 = [
        mk("register", worker="w0"),
        mk("watch", cursor=0, worker="w0"),
        mk("watch", take=True, worker="w0"),
        mk("bump_epoch"),
        mk("watch", take=True, worker="w0"),
        mk("watch", note="dup", cursor=0, worker="w0"),
        mk("watch", take=True, worker="w0"),
        mk("watch_cancel", worker="w0"),
    ]
    w1 = [
        mk("register", worker="w1"),
        mk("shard_map"),
        mk("status"),
    ]
    return {"w0": w0, "w1": w1}


def preempt_scripts() -> Dict[str, List[ScriptOp]]:
    """Advance-notice revocation schedule: w1 issues a ``preempt_notice``
    targeting w0 while w0 subscribes/drains its watch stream — the
    interleavings cover both the live-push order (subscribe first) and the
    late-subscriber replay order (notice first), plus the malformed
    empty-targets reply, status rendering of pending revocations, and the
    departure-consumes-notice rule on leave. Runs against the plain twin
    (``take`` is the in-process drain verb, absent from the wire)."""
    mk = ScriptOp.make
    w0 = [
        mk("register", worker="w0"),
        mk("watch", cursor=0, worker="w0"),
        mk("watch", take=True, worker="w0"),
        mk("watch", take=True, worker="w0"),
        mk("status"),
        mk("leave", worker="w0"),
    ]
    w1 = [
        mk("register", worker="w1"),
        mk("preempt_notice", targets=["w0"], notice_s=30, reason="spot"),
        mk("preempt_notice", note="empty", targets=[]),
        mk("status"),
    ]
    return {"w0": w0, "w1": w1}


def watch_redirect_scripts() -> Dict[str, List[ScriptOp]]:
    """Redirect-during-watch schedule against a sharded ROOT
    (``SHARD_ENDPOINTS``): every keyspace op answers a redirect computed by
    key hash (never served), while membership, epoch bumps, and the watch
    stream stay root-local — notifications keep flowing to a subscriber
    whose data ops are being bounced to shard servers."""
    mk = ScriptOp.make
    w0 = [
        mk("register", worker="w0"),
        mk("watch", cursor=0, worker="w0"),
        mk("kv_put", key="alpha", value="1"),
        mk("bump_epoch"),
        mk("watch", take=True, worker="w0"),
        mk("shard_map"),
    ]
    w1 = [
        mk("register", worker="w1"),
        mk("acquire_task", req_id="w1-a1", worker="w1"),
        mk("add_tasks", tasks=["t0"]),
        mk("kv_get", key="beta"),
    ]
    return {"w0": w0, "w1": w1}


def _sharded_root_factory():
    from edl_tpu_torch.coordinator.inprocess import InProcessCoordinator

    return InProcessCoordinator(task_lease_sec=1e9, heartbeat_ttl_sec=1e9,
                                shard_endpoints=list(SHARD_ENDPOINTS))


# -- durable oracle adapter ------------------------------------------------------


def _truncate_torn_tail(path: str) -> None:
    """Tear the journal's final frame: drop its commit-marker line (it
    never reached disk) and cut the last data record in half, leaving an
    unparseable tail — the on-disk shape of a crash mid-``fwrite``."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            lines = f.read().splitlines()
    except OSError:
        return
    while lines and not lines[-1].strip():
        lines.pop()
    if not lines:
        return
    last = lines.pop()
    try:
        is_marker = json.loads(last).get("k") == "c"
    except ValueError:
        is_marker = False
    if not is_marker:
        lines.append(last)  # already torn; just halve the data record
    if lines:
        lines[-1] = lines[-1][: max(1, len(lines[-1]) // 2)]
    with open(path, "w", encoding="utf-8") as f:
        for ln in lines:
            f.write(ln + "\n")


class DurableTwinOracle:
    """Crash-capable oracle adapter for durable schedules: an
    ``InProcessCoordinator`` with its state-file persistence twin enabled,
    plus ``model_crash()`` — the oracle realization of the model's crash
    pseudo-op. ``clean`` reboots from the state file; ``pre_ack`` applies
    the inflight op (its frame commits) and discards the reply; ``torn``
    applies the inflight op then tears the journal tail; and
    ``during_compaction`` arms the crash-before-commit hook so the inflight
    frame never reaches disk. ``skip_tail_scan`` is the EDL010 mutant
    knob: recovery skips torn-tail detection, replaying partial frames —
    which the acked-durability invariant must catch."""

    def __init__(self, compact_every: Optional[int] = None,
                 skip_tail_scan: bool = False,
                 disable_dedup: bool = False):
        self._dir = tempfile.mkdtemp(prefix="edl-modelcheck-")
        self._finalizer = weakref.finalize(
            self, shutil.rmtree, self._dir, True)
        self._path = os.path.join(self._dir, "coordinator_state.jsonl")
        self._skip_tail_scan = skip_tail_scan
        self._disable_dedup = disable_dedup
        self._coord = self._boot(compact_every)

    def _boot(self, compact_every: Optional[int]):
        from edl_tpu_torch.coordinator.inprocess import InProcessCoordinator

        c = InProcessCoordinator(
            task_lease_sec=1e9, heartbeat_ttl_sec=1e9,
            state_file=self._path, run_id="modelcheck",
            compact_every=compact_every,
            skip_tail_commit_scan=self._skip_tail_scan,
        )
        if self._disable_dedup:
            c._test_disable_dedup = True
        return c

    def client(self, worker: str):
        return self._coord.client(worker)

    def model_crash(self, info: Dict[str, Any]) -> Dict[str, Any]:
        mode = info.get("mode", "clean")
        for spec in info.get("inflight", []):
            sub = dict(spec)
            sub_op = sub.pop("op", "")
            sub_worker = sub.pop("worker", "__crash__")
            if mode == "during_compaction":
                self._coord._test_crash_before_commit = True
            self._coord.client(sub_worker).call(sub_op, **sub)  # reply lost
        if mode == "torn" and info.get("inflight_records", 0) > 0:
            _truncate_torn_tail(self._path)
        # reboot: a fresh incarnation recovering from the state file. The
        # crash-injection env never survives a restart, so neither does a
        # compaction override.
        self._coord = self._boot(compact_every=None)
        status = self._coord.client("__crash__").call("status")
        return {"ok": True, "crash": mode, "epoch": status.get("epoch")}

    def close(self) -> None:
        self._finalizer()


def _durable_twin_factory():
    return DurableTwinOracle()


#: compaction threshold (journal lines incl. commit markers) for the
#: durability-compact schedule — low enough that most interleavings snapshot
#: mid-trace. The model and the twin count records identically.
_COMPACT_EVERY = 6


def _durable_compact_twin_factory():
    return DurableTwinOracle(compact_every=_COMPACT_EVERY)


def _native_oracle_factory():
    from edl_tpu_torch.analysis.native_oracle import NativeCrashOracle

    return NativeCrashOracle()


def _native_compact_oracle_factory():
    from edl_tpu_torch.analysis.native_oracle import NativeCrashOracle

    return NativeCrashOracle(compact_every=_COMPACT_EVERY)


def durability_base_scripts() -> Dict[str, List[ScriptOp]]:
    """Durability base schedule: a clean crash interleaved through the
    journaled op set — the DFS position of the crash op enumerates every
    crash point. Post-crash: the duplicate acquire must return the
    original lease (req_id dedup cache rebuilt from journaled lease
    records) and the completed task must conserve."""
    mk = ScriptOp.make
    w0 = [
        mk("register", worker="w0"),
        mk("add_tasks", tasks=["d0", "d1"]),
        mk("acquire_task", req_id="w0-a1", worker="w0"),
        mk("crash", mode="clean", worker="w0"),
        mk("acquire_task", note="dup", req_id="w0-a1", worker="w0"),
        mk("complete_task", task=LAST_TASK, worker="w0"),
    ]
    w1 = [
        mk("register", worker="w1"),
        mk("kv_put", key="alpha", value="1"),
        mk("kv_incr", key="steps", delta=1, op_id="w1-i1"),
        mk("kv_get", key="alpha"),
        mk("kv_del", key="alpha"),
        mk("status"),
    ]
    return {"w0": w0, "w1": w1}


def durability_dedup_scripts() -> Dict[str, List[ScriptOp]]:
    """Post-fsync survival (``pre_ack``): the inflight kv_put's frame is
    fsynced but its reply never flushes — recovery must show the value.
    The duplicate acquire and duplicate kv_incr straddle the crash point
    in some interleavings: exactly-once across crash."""
    mk = ScriptOp.make
    w0 = [
        mk("register", worker="w0"),
        mk("add_tasks", tasks=["d0", "d1"]),
        mk("acquire_task", req_id="w0-a1", worker="w0"),
        mk("crash", mode="pre_ack", worker="w0",
           inflight=[{"op": "kv_put", "key": "ck", "value": "committed"}]),
        mk("acquire_task", note="dup", req_id="w0-a1", worker="w0"),
        mk("kv_get", key="ck"),
    ]
    w1 = [
        mk("register", worker="w1"),
        mk("kv_incr", key="steps", delta=1, op_id="w1-i1"),
        mk("kv_incr", note="dup", key="steps", delta=1, op_id="w1-i1"),
        mk("status"),
    ]
    return {"w0": w0, "w1": w1}


def durability_torn_scripts() -> Dict[str, List[ScriptOp]]:
    """Pre-fsync loss (``torn``): the inflight kv_incr writes its value
    record and its op_id marker record into ONE frame, and the tail is
    torn mid-write — recovery must drop the whole frame (all-or-nothing),
    so the post-crash retry applies exactly once. A twin that skips
    torn-tail detection replays the value without the marker and
    double-applies: the mutant-teeth scenario."""
    mk = ScriptOp.make
    w0 = [
        mk("register", worker="w0"),
        mk("kv_incr", key="steps", delta=1, op_id="w0-i1"),
        mk("crash", mode="torn", worker="w0",
           inflight=[{"op": "kv_incr", "key": "steps", "delta": 1,
                      "op_id": "w0-i2"}]),
        mk("kv_incr", note="retry", key="steps", delta=1, op_id="w0-i2"),
        mk("kv_get", key="steps"),
    ]
    w1 = [
        mk("register", worker="w1"),
        mk("kv_put", key="alpha", value="1"),
        mk("kv_get", key="alpha"),
        mk("kv_del", key="alpha"),
        mk("status"),
    ]
    return {"w0": w0, "w1": w1}


def durability_compact_scripts() -> Dict[str, List[ScriptOp]]:
    """Snapshot/compaction schedule (``compact_every=_COMPACT_EVERY``):
    most interleavings cross the threshold mid-trace, so the model's
    snapshot⊕journal-suffix self-check runs at a different point per
    interleaving, and the clean crash recovers from snapshot + suffix.
    POR is off here: frame counting makes commutation journal-visible."""
    mk = ScriptOp.make
    w0 = [
        mk("register", worker="w0"),
        mk("add_tasks", tasks=["c0", "c1"]),
        mk("acquire_task", req_id="w0-a1", worker="w0"),
        mk("complete_task", task=LAST_TASK, worker="w0"),
        mk("crash", mode="clean", worker="w0"),
        mk("kv_get", key="a"),
        mk("kv_incr", key="steps", delta=1, op_id="w0-i1"),
    ]
    w1 = [
        mk("register", worker="w1"),
        mk("kv_put", key="a", value="1"),
        mk("kv_incr", key="steps", delta=1, op_id="w1-i1"),
        mk("kv_put", key="b", value="2"),
        mk("kv_del", key="b"),
        mk("status"),
    ]
    return {"w0": w0, "w1": w1}


def durability_crash_compact_scripts() -> Dict[str, List[ScriptOp]]:
    """Crash during compaction: the inflight kv_put triggers a snapshot
    that dies after the tmp write, before the rename — the journal is
    untouched and the inflight effects are lost, unacked. Recovery must
    show the pre-crash journal state exactly."""
    mk = ScriptOp.make
    w0 = [
        mk("register", worker="w0"),
        mk("kv_put", key="s1", value="v1"),
        mk("crash", mode="during_compaction", worker="w0",
           inflight=[{"op": "kv_put", "key": "s2", "value": "v2"}]),
        mk("kv_get", key="s2"),
        mk("kv_get", key="s1"),
    ]
    w1 = [
        mk("register", worker="w1"),
        mk("add_tasks", tasks=["x0"]),
        mk("acquire_task", req_id="w1-a1", worker="w1"),
        mk("status"),
    ]
    return {"w0": w0, "w1": w1}


def durability_shard_scripts() -> Dict[str, List[ScriptOp]]:
    """Ladder honesty for the deliberately-unjournaled shard store: a
    crash loses the blobs AND the put_id dedup table, so a replayed
    shard_put re-stores (duplicate=False) instead of lying about
    durability — its loss costs a recovery rung, never contradicts an
    ack."""
    mk = ScriptOp.make
    w0 = [
        mk("register", worker="w0"),
        mk("shard_put", owner="w0", step=1, chunk=0, chunks=1, nbytes=4,
           data="AAAA", put_id="w0-p1", group=["w1"]),
        mk("crash", mode="clean", worker="w0"),
        mk("shard_put", note="dup", owner="w0", step=1, chunk=0, chunks=1,
           nbytes=4, data="AAAA", put_id="w0-p1", group=["w1"]),
        mk("shard_meta", owner="w0"),
    ]
    w1 = [
        mk("register", worker="w1"),
        mk("shard_get", owner="w0", step=-1, chunk=0),
        mk("kv_put", key="k", value="v1"),
        mk("shard_meta", owner="w0"),
        mk("shard_get", owner="w0", step=-1, chunk=0),
        mk("status"),
    ]
    return {"w0": w0, "w1": w1}


def durability_preempt_scripts() -> Dict[str, List[ScriptOp]]:
    """Ladder honesty for the deliberately-unjournaled preempt table: a
    pending revocation notice is scheduler state, so a crashed coordinator
    forgets it (the scheduler re-issues) — ``status`` must show the
    pending notice before the crash and an empty table after, never a
    journal-resurrected ghost. No ``take`` frames here: this row replays
    against the native crash oracle, whose wire has no drain verb."""
    mk = ScriptOp.make
    w0 = [
        mk("register", worker="w0"),
        mk("kv_put", key="pk", value="v1"),
        mk("crash", mode="clean", worker="w0"),
        mk("status"),
        mk("kv_get", key="pk"),
    ]
    w1 = [
        mk("register", worker="w1"),
        mk("preempt_notice", targets=["w1"], notice_s=45, reason="maint"),
        mk("status"),
    ]
    return {"w0": w0, "w1": w1}


@dataclass
class Schedule:
    """One named row of the acceptance configuration: scripts + the oracle
    factory + the model knobs. ``default_schedules`` returns these;
    ``run_default`` explores each and merges results."""

    name: str
    scripts: Dict[str, List[ScriptOp]]
    factory: Optional[CoordinatorFactory] = None
    shard_endpoints: Optional[List[str]] = None
    durable: bool = False
    compact_every: Optional[int] = None
    por: bool = False


def durability_schedules() -> List[Schedule]:
    """The EDL010 rows: every journaled op crossed with enumerated crash
    points, plus the shard-store (unjournaled) schedule — all replayed
    against the file-backed persistence twin."""
    return [
        Schedule("durability-base", durability_base_scripts(),
                 _durable_twin_factory, durable=True, por=True),
        Schedule("durability-dedup", durability_dedup_scripts(),
                 _durable_twin_factory, durable=True, por=True),
        Schedule("durability-torn", durability_torn_scripts(),
                 _durable_twin_factory, durable=True, por=True),
        Schedule("durability-compact", durability_compact_scripts(),
                 _durable_compact_twin_factory, durable=True,
                 compact_every=_COMPACT_EVERY, por=False),
        Schedule("durability-crash-compact",
                 durability_crash_compact_scripts(),
                 _durable_twin_factory, durable=True, por=True),
        Schedule("durability-shard", durability_shard_scripts(),
                 _durable_twin_factory, durable=True, por=True),
        Schedule("durability-preempt", durability_preempt_scripts(),
                 _durable_twin_factory, durable=True, por=True),
    ]


def default_schedules(
    coordinator_factory: Optional[CoordinatorFactory] = None,
) -> List[Schedule]:
    """The acceptance schedules — explored separately so each stays inside
    the interleaving budget; results merge. With a caller-supplied
    ``coordinator_factory`` (the broken-twin tests) the redirect schedule
    runs UNSHARDED against that factory, and the durability rows are
    dropped entirely: a caller's factory has neither the persistence twin
    nor ``model_crash`` (durable mutants use ``explore`` directly with a
    ``DurableTwinOracle`` variant)."""
    rows = [
        Schedule("default", default_scripts(), coordinator_factory),
        Schedule("ckpt-plane", ckpt_plane_scripts(), coordinator_factory),
        Schedule("watch", watch_scripts(), coordinator_factory),
        Schedule("preempt", preempt_scripts(), coordinator_factory),
    ]
    if coordinator_factory is None:
        rows.append(Schedule("watch-redirect", watch_redirect_scripts(),
                             _sharded_root_factory,
                             shard_endpoints=list(SHARD_ENDPOINTS)))
        rows.extend(durability_schedules())
    else:
        rows.append(Schedule("watch-redirect", watch_redirect_scripts(),
                             coordinator_factory))
    return rows


def load_state_effects(root: str, schema_rel: str = "protocol_schema.json"):
    """(state_effects dict or None, declared op set or None, error string)."""
    path = os.path.join(root, schema_rel)
    try:
        with open(path, "r", encoding="utf-8") as f:
            schema = json.load(f)
    except OSError:
        return None, None, f"{schema_rel} is missing"
    except json.JSONDecodeError as e:
        return None, None, f"{schema_rel} is not valid JSON: {e}"
    effects = schema.get("state_effects")
    ops = set(schema.get("ops", {}))
    if effects is None:
        return None, ops, (
            f"{schema_rel} has no state_effects block — the behavioral "
            "spec EDL009 model-checks against"
        )
    return effects, ops, None


def run_default(
    coordinator_factory: Optional[CoordinatorFactory] = None,
    effects: Optional[Dict[str, Dict[str, Any]]] = None,
    fuzz_samples: int = 0,
    fuzz_seed: int = 0,
    max_traces: int = 20000,
    max_violations: int = 25,
    schedules: Optional[Sequence[str]] = None,
    native: bool = False,
) -> ModelCheckResult:
    """Explore the default schedule set (optionally filtered to the named
    ``schedules``) and merge results. ``result.timings`` carries one
    (name, traces, seconds) row per schedule.

    ``native=True`` swaps the durability rows' oracle for the crash-armed
    ``edl-coordinator`` subprocess (``NativeCrashOracle``) and drops the
    non-durable rows: each trace then boots/kills/restarts a real server,
    so only the crash-recovery lanes are worth the wall-clock."""
    if effects is None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        effects, _ops, err = load_state_effects(root)
        if err:
            raise ModelCheckError(err)
    rows = default_schedules(coordinator_factory)
    if native:
        rows = [
            _dc_replace(
                s, factory=(_native_compact_oracle_factory
                            if s.compact_every else _native_oracle_factory))
            for s in rows if s.durable
        ]
    if schedules is not None:
        known = {s.name for s in rows}
        unknown = set(schedules) - known
        if unknown:
            raise ModelCheckError(
                f"unknown schedule(s) {sorted(unknown)} — "
                f"known: {sorted(known)}"
            )
        rows = [s for s in rows if s.name in set(schedules)]
    result = ModelCheckResult()
    for sched in rows:
        t0 = time.monotonic()
        extra = explore(
            sched.scripts, effects,
            coordinator_factory=sched.factory,
            fuzz_samples=fuzz_samples, fuzz_seed=fuzz_seed,
            max_traces=max_traces, max_violations=max_violations,
            shard_endpoints=sched.shard_endpoints,
            durable=sched.durable, compact_every=sched.compact_every,
            por=sched.por, name=sched.name,
        )
        result.traces += extra.traces
        result.replays += extra.replays
        result.violations.extend(extra.violations)
        result.timings.append(
            (sched.name, extra.traces, time.monotonic() - t0))
    return result


# -- trace spec round-trip (--dump-trace / --replay-trace) -----------------------


def dump_trace_spec(v: Violation,
                    schedules: Optional[List[Schedule]] = None
                    ) -> Dict[str, Any]:
    """Serialize a violating interleaving as a self-contained JSON spec
    (same round-trip discipline as ChaosScenario): the schedule's scripts,
    the exact worker step order, and the model knobs needed to re-create
    the run in isolation."""
    rows = schedules if schedules is not None else default_schedules()
    sched = next((s for s in rows if s.name == v.schedule), None)
    if sched is None:
        raise ModelCheckError(
            f"violation carries no known schedule name ({v.schedule!r}) — "
            "only violations from named schedules can be dumped"
        )
    return {
        "schedule": sched.name,
        "kind": v.kind,
        "message": v.message,
        "order": list(v.order),
        "scripts": {
            w: [{"op": s.op, "note": s.note, "fields": s.field_dict()}
                for s in ops]
            for w, ops in sched.scripts.items()
        },
        "durable": sched.durable,
        "compact_every": sched.compact_every,
        "shard_endpoints": sched.shard_endpoints,
    }


def _factory_for_spec(spec: Dict[str, Any]) -> CoordinatorFactory:
    if spec.get("durable"):
        compact = spec.get("compact_every")
        return lambda: DurableTwinOracle(compact_every=compact)
    endpoints = spec.get("shard_endpoints")
    if endpoints:
        from edl_tpu_torch.coordinator.inprocess import InProcessCoordinator

        return lambda: InProcessCoordinator(
            task_lease_sec=1e9, heartbeat_ttl_sec=1e9,
            shard_endpoints=list(endpoints))
    return _default_coordinator_factory


def replay_trace_spec(
    spec: Dict[str, Any],
    effects: Dict[str, Dict[str, Any]],
    coordinator_factory: Optional[CoordinatorFactory] = None,
) -> List[Violation]:
    """Re-execute one dumped interleaving — the exact step order, no
    exploration — through the model and against the oracle; returns the
    violations it reproduces."""
    scripts = {
        w: [ScriptOp.make(e["op"], e.get("note", ""),
                          **(e.get("fields") or {}))
            for e in ops]
        for w, ops in spec.get("scripts", {}).items()
    }
    model = ProtocolModel(
        effects, spec.get("shard_endpoints"),
        durable=bool(spec.get("durable")),
        compact_every=spec.get("compact_every"))
    state = _TraceState(scripts, model)
    violations: List[Violation] = []
    for w in spec.get("order", []):
        try:
            state.step(w)
        except _SnapshotDivergence as exc:
            violations.append(Violation(
                "snapshot-divergence", str(exc), state.render(),
                schedule=spec.get("schedule", ""),
                order=tuple(spec.get("order", []))))
            return violations
    rendered = state.render()
    if not state.done():
        violations.append(Violation(
            "progress",
            f"deadlock: worker(s) {sorted(state.parked)} parked at spec "
            "end",
            rendered, schedule=spec.get("schedule", ""),
            order=tuple(spec.get("order", []))))
        return violations
    factory = coordinator_factory or _factory_for_spec(spec)
    _replay_trace(state.trace, factory, rendered, violations)
    for v in violations:
        v.schedule = spec.get("schedule", "")
        v.order = tuple(spec.get("order", []))
    return violations


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m edl_tpu_torch.analysis.modelcheck",
        description=(
            "Bounded explicit-state model check of the coordinator "
            "protocol's behavioral spec (protocol_schema.json "
            "state_effects) against the in-process oracle."
        ),
    )
    parser.add_argument(
        "--fuzz", type=int, default=0, metavar="N",
        help="seeded random-walk mode: sample N schedules instead of "
             "exhaustive DFS (findings are a subset of the exhaustive run)")
    parser.add_argument(
        "--seed", type=int, default=0, help="fuzz-mode RNG seed")
    parser.add_argument(
        "--max-traces", type=int, default=20000,
        help="exploration budget (default: 20000)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable result")
    parser.add_argument(
        "--schedules", default=None, metavar="NAME,...",
        help="comma-separated schedule filter (e.g. "
             "durability-base,durability-torn); default: all")
    parser.add_argument(
        "--dump-trace", default=None, metavar="PATH",
        help="on the first violation, write the interleaving as a JSON "
             "spec replayable with --replay-trace")
    parser.add_argument(
        "--replay-trace", default=None, metavar="PATH",
        help="re-execute one dumped trace spec in isolation instead of "
             "exploring")
    parser.add_argument(
        "--timings", action="store_true",
        help="print a per-schedule (traces, seconds) split")
    parser.add_argument(
        "--native", action="store_true",
        help="replay the durability schedules against the crash-armed "
             "native edl-coordinator binary instead of the in-process "
             "persistence twin (drops the non-durable schedules; exits 0 "
             "with a notice when no C++ toolchain is on PATH)")
    args = parser.parse_args(argv)

    if args.replay_trace:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        effects, _ops, err = load_state_effects(root)
        if err:
            print(f"modelcheck: {err}")
            return 2
        with open(args.replay_trace, "r", encoding="utf-8") as f:
            spec = json.load(f)
        violations = replay_trace_spec(spec, effects)
        print(
            f"modelcheck [replay {spec.get('schedule', '?')}]: 1 trace, "
            f"{len(violations)} violation(s)"
        )
        for v in violations:
            print(f"  [{v.kind}] {v.message}")
            print(f"    trace: {v.trace}")
        return 0 if not violations else 1

    schedules = None
    if args.schedules:
        schedules = [s.strip() for s in args.schedules.split(",")
                     if s.strip()]
    if args.native:
        from edl_tpu_torch.analysis.native_oracle import native_toolchain_available

        if not native_toolchain_available():
            print("modelcheck [native]: no C++ toolchain on PATH — "
                  "native-oracle lane skipped")
            return 0
        from edl_tpu_torch.coordinator.server import CoordinatorError, ensure_built

        try:
            ensure_built()
        except CoordinatorError as e:
            print(f"modelcheck [native]: coordinator build failed: {e}")
            return 2
    result = run_default(
        fuzz_samples=args.fuzz, fuzz_seed=args.seed,
        max_traces=args.max_traces,
        schedules=schedules,
        native=args.native,
    )
    if args.dump_trace and result.violations:
        spec = dump_trace_spec(result.violations[0])
        with open(args.dump_trace, "w", encoding="utf-8") as f:
            json.dump(spec, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"modelcheck: first violating trace dumped to "
              f"{args.dump_trace}")
    if args.json:
        print(json.dumps({
            "traces": result.traces,
            "replays": result.replays,
            "timings": [
                {"schedule": n, "traces": t, "seconds": round(s, 3)}
                for n, t, s in result.timings
            ],
            "violations": [
                {"kind": v.kind, "message": v.message, "trace": v.trace,
                 "schedule": v.schedule}
                for v in result.violations
            ],
        }, indent=2))
    else:
        mode = f"fuzz({args.fuzz}, seed={args.seed})" if args.fuzz else "exhaustive"
        if args.native:
            mode += ", native"
        oracle = ("crash-armed edl-coordinator" if args.native
                  else "InProcessCoordinator")
        print(
            f"modelcheck [{mode}]: {result.traces} trace(s) explored, "
            f"{result.replays} replayed against {oracle}, "
            f"{len(result.violations)} violation(s)"
        )
        if args.timings:
            for n, t, s in result.timings:
                print(f"  {n}: {t} trace(s) in {s:.2f}s")
        for v in result.violations:
            print(f"  [{v.kind}] {v.message}")
            print(f"    trace: {v.trace}")
    return 0 if result.ok() else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
