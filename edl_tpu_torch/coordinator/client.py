"""Blocking TCP client for the coordinator's newline-JSON protocol.

The trainer-side embed: replaces the reference's etcd client + master RPC in
`train_ft.py` (`SGD(pserver_spec=etcd_endpoint, use_etcd=True)`,
`cloud_reader` task pulls, `example/fit_a_line/train_ft.py:105-114`) and the
pod launcher's poll-and-sleep discovery (`docker/k8s_tools.py:70-78`).
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
import uuid
from typing import Dict, List, Optional

from edl_tpu_torch.coordinator.retry import DEFAULT_RETRY, RetryPolicy
from edl_tpu_torch.coordinator.sharding import ShardMap, partition_tasks, route_key
from edl_tpu_torch.obs.metrics import get_registry

# Process-wide client telemetry (all CoordinatorClient instances in this
# process feed the same families — per-connection split isn't worth a label).
_REG = get_registry()
_M_CALLS = _REG.counter(
    "edl_client_calls_total",
    "coordinator RPC transactions completed, by op",
    labelnames=("op",),
)
_M_RETRIES = _REG.counter(
    "edl_client_retries_total",
    "transport-level re-dial attempts (coordinator unreachable)",
)
_M_RECONNECTS = _REG.counter(
    "edl_client_reconnects_total",
    "fresh TCP connections established after a poisoned/closed socket",
)
_M_BATCH_FRAMES = _REG.counter(
    "edl_client_batch_frames_total",
    "batched frames sent (each carries many sub-ops in one round-trip)",
)
_M_CALL_LATENCY = _REG.histogram(
    "edl_client_call_latency_seconds",
    "coordinator RPC round-trip latency (excludes ops parked server-side: "
    "barrier/sync wait time is rendezvous, not transport)",
)
_M_SHARD_REDIRECTS = _REG.counter(
    "edl_client_shard_redirects_total",
    "redirect replies observed (root routing a keyspace op, or a stale "
    "shard map sending an op to the wrong shard)",
)
_M_SHARD_MAP_REFRESHES = _REG.counter(
    "edl_client_shard_map_refreshes_total",
    "shard_map re-resolutions (first redirect, stale-map invalidation, or "
    "reconnect after a shard endpoint became unreachable)",
)
#: parked ops: their round-trip time measures rendezvous latency, which
#: would swamp the transport histogram with multi-second waits.
_PARKED_OPS = frozenset({"barrier", "sync"})


class CoordinatorError(RuntimeError):
    pass


class CoordinatorAuthError(CoordinatorError):
    """The coordinator rejected the call's token (job secret mismatch).

    Typed separately because the right reaction differs from transport
    errors: retrying cannot help — the pod's EDL_COORD_TOKEN disagrees
    with the job's, which is a deployment bug (or an unauthorized peer).
    """


class CoordinatorTimeout(CoordinatorError):
    """The reply did not arrive within the caller's timeout.

    Not retried by the client: the request may have been processed (a
    barrier arrival whose release is still pending, a lease grant with a
    slow reply), so a blind re-send is not safe at this layer. Callers
    with idempotent semantics re-issue at their own layer.
    """


class CoordinatorUnreachable(CoordinatorError):
    """Connection-level failure: refused, reset, or closed mid-call.

    The retryable class — ``call()`` re-dials with backoff until the
    retry policy's deadline, and raises this only once that budget is
    spent. Degraded-mode callers (outbox buffering, checkpoint-and-park)
    key off this type.
    """


class CoordinatorClient:
    """One persistent connection; requests are serialized (1 req -> 1 reply),
    except ``barrier`` which blocks until the coordinator releases it.

    Thread-safe at request granularity: a lock serializes each call's full
    send→recv transaction, so the pipelined data path (`DevicePrefetcher`
    running `LeaseReader` RPCs on a pump thread) can share the client with
    the main loop's heartbeats. Requests from different threads queue
    behind each other — a thread parked in ``barrier``/``sync`` blocks
    other callers, so long rendezvous belong on a dedicated client.

    ``token`` is the per-job shared secret (default: the pod env's
    EDL_COORD_TOKEN, stamped by the controller — jobparser.make_env); it
    rides every request. Auth-rejected calls raise CoordinatorAuthError.

    ``retry`` is the outage policy baked into every ``call()``: connection
    failures re-dial with jittered exponential backoff until the policy
    deadline, then raise CoordinatorUnreachable. Pass ``retry=None`` for
    the legacy crash-on-first-error behavior (some tests want it). Auth
    errors and reply timeouts are never retried — see retry.py's taxonomy.

    Control-plane batching (BENCH_COORD.json): ``call_batch()`` sends many
    sub-ops in ONE frame with positional per-sub-op replies, and
    ``piggyback_heartbeat > 0`` transparently rides a due heartbeat on
    whatever call is going out anyway — one round-trip instead of two, and
    the membership observation lands in ``last_membership`` for workers to
    coalesce on. Every reply's epoch (the server stamps all of them) is
    tracked in ``observed_epoch``, so epoch discovery no longer needs
    dedicated ``status`` polls.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 7164,
                 worker: str = "", connect_timeout: float = 10.0,
                 token: Optional[str] = None,
                 retry: Optional[RetryPolicy] = DEFAULT_RETRY,
                 piggyback_heartbeat: float = 0.0):
        self.host = host
        self.port = port
        self.worker = worker
        self.connect_timeout = connect_timeout
        self.token = token if token is not None \
            else os.environ.get("EDL_COORD_TOKEN", "")
        self.retry = retry
        #: seconds between piggybacked heartbeats; 0 disables. When due, an
        #: eligible call() is wrapped in a batch frame with a leading
        #: heartbeat — the worker stays live without a dedicated RPC.
        self.piggyback_heartbeat = piggyback_heartbeat
        #: transport-level retry attempts performed over this client's
        #: lifetime (outage telemetry; workers surface it in summaries).
        self.retry_count = 0
        #: latest epoch seen on ANY reply (every server reply carries it),
        #: and the monotonic instant it was observed. Workers use this to
        #: skip dedicated epoch polls (coalesced watch-style notification).
        self.observed_epoch: Optional[int] = None
        self.observed_epoch_at: float = 0.0
        #: latest ok membership reply (rank/world/epoch) from a heartbeat /
        #: register / piggybacked heartbeat, with its observation instant.
        self.last_membership: Optional[Dict] = None
        self.last_membership_at: float = 0.0
        self._last_piggyback = 0.0
        self._sock: Optional[socket.socket] = None
        self._buf = b""
        #: sharded-plane routing state, learned lazily from the first
        #: redirect reply — a plain single-process coordinator never sends
        #: one, so unsharded deployments never pay a shard_map round-trip.
        self._shard_map: Optional[ShardMap] = None
        self._shard_clients: Dict[int, "CoordinatorClient"] = {}
        #: per-client nonce namespaces dedup ids (req_id/op_id) so a fresh
        #: process reusing a worker name can never hit a predecessor's
        #: cached replies or persisted kv_incr markers.
        self._nonce = uuid.uuid4().hex[:8]
        self._acquire_seq = 0
        self._op_seq = 0
        self._put_seq = 0
        #: serializes one full request/reply transaction per call() — the
        #: socket and _buf pair replies to requests by ordering, so
        #: interleaved sends from two threads would cross-deliver replies.
        #: RLock: call()'s error paths close() while already holding it.
        self._lock = threading.RLock()
        self._connect(connect_timeout)

    def _connect(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        last_err: Optional[Exception] = None
        sleeps = (self.retry or DEFAULT_RETRY).sleeps()
        while time.monotonic() < deadline:
            try:
                sock = socket.create_connection((self.host, self.port), timeout=5.0)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                sock.settimeout(None)
                self._sock = sock
                return
            except OSError as e:
                last_err = e
                time.sleep(min(next(sleeps), max(0.0, deadline - time.monotonic())))
        raise CoordinatorUnreachable(
            f"cannot connect to coordinator at {self.host}:{self.port}: {last_err}"
        )

    def close(self) -> None:
        self._drop_shard_clients()
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                finally:
                    self._sock = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- protocol --------------------------------------------------------------

    def call(self, op: str, timeout: Optional[float] = None, **fields) -> Dict:
        """One request/reply transaction, with the retry policy applied.

        Retries cover only ``CoordinatorUnreachable`` (refused / reset /
        closed): the request was not answered, so re-sending is safe for
        every op — mutating ops carry dedup ids (``req_id``/``op_id``) or
        are idempotent server-side (``complete_task``). Auth rejections
        and reply timeouts propagate immediately.

        Against a sharded control plane, keyspace ops are routed to their
        owning shard via the cached shard map (learned from the root on the
        first redirect reply; see ``sharding.route_key``). Single-process
        coordinators never redirect, so the unsharded path is unchanged.
        """
        smap = self._shard_map
        if smap is not None and smap.nshards > 0:
            if op == "add_tasks":
                return self._sharded_add_tasks(timeout, fields)
            if op == "acquire_task":
                return self._sharded_acquire(timeout, fields)
            key = route_key(op, fields)
            if key is not None:
                return self._shard_call(op, timeout, fields, key)
        reply = self._direct_call(op, timeout, fields)
        if self._is_redirect(reply):
            # First contact with a sharded root: learn the map, re-route.
            _M_SHARD_REDIRECTS.inc()
            self._refresh_shard_map()
            if self._shard_map is not None and self._shard_map.nshards > 0:
                return self.call(op, timeout=timeout, **fields)
        return reply

    def _direct_call(self, op: str, timeout: Optional[float],
                     fields: Dict) -> Dict:
        """The pre-sharding call body: piggyback check + retry loop over one
        request/reply transaction on THIS client's own connection."""
        if self._piggyback_due(op, fields):
            return self._call_with_piggyback(op, timeout, fields)
        if self.retry is None:
            return self._call_once(op, timeout, fields)
        deadline = time.monotonic() + self.retry.deadline
        sleeps = self.retry.sleeps()
        while True:
            try:
                return self._call_once(op, timeout, fields,
                                       connect_deadline=deadline)
            except (CoordinatorAuthError, CoordinatorTimeout):
                raise
            except CoordinatorUnreachable:
                delay = next(sleeps)
                if time.monotonic() + delay >= deadline:
                    raise
                self.retry_count += 1  # edl: noqa[EDL001] telemetry counter; a torn increment under-counts a metric, never corrupts protocol state
                _M_RETRIES.inc()
                time.sleep(delay)

    # -- shard routing ---------------------------------------------------------

    @staticmethod
    def _is_redirect(reply) -> bool:
        return (isinstance(reply, dict) and not reply.get("ok")
                and "redirect" in reply)

    def _shard_call(self, op: str, timeout: Optional[float], fields: Dict,
                    key: str) -> Dict:
        """Route one keyspace op to the shard owning ``key``.

        A redirect reply or an unreachable shard endpoint invalidates the
        cached map and re-resolves it from the root (bounded, with the
        retry policy's backoff) instead of hammering the stale address to
        deadline exhaustion; the op is then re-routed against the fresh
        map. Redirect ping-pong (a genuinely disagreeing root) is capped —
        the last redirect reply is returned rather than looping forever.
        """
        redirects = 0
        refreshes = 0
        while True:
            smap = self._shard_map
            if smap is None or smap.nshards == 0:
                # Routing got disabled mid-flight (root says unsharded).
                return self._direct_call(op, timeout, fields)
            slot = smap.slot_for(key)
            try:
                reply = self._shard_client(slot)._direct_call(
                    op, timeout, fields)
            except (CoordinatorAuthError, CoordinatorTimeout):
                raise
            except CoordinatorUnreachable:
                # Stale endpoint (shard moved or restarting): re-resolve
                # the map rather than retrying the dead address.
                if refreshes >= 3:
                    raise
                refreshes += 1
                self._drop_shard_clients()
                self._refresh_shard_map()
                continue
            if self._is_redirect(reply):
                _M_SHARD_REDIRECTS.inc()
                redirects += 1
                if redirects > 4:
                    return reply
                self._refresh_shard_map()
                continue
            return reply

    def _shard_client(self, slot: int) -> "CoordinatorClient":
        with self._lock:
            sub = self._shard_clients.get(slot)
            if sub is not None:
                return sub
        endpoint = self._shard_map.shards[slot]
        host, _, port = endpoint.rpartition(":")
        # Fail fast on a dead shard (the slot loop's refresh path is the
        # retry mechanism) — no per-sub-client retry policy, short dial.
        sub = CoordinatorClient(
            host=host or "127.0.0.1", port=int(port), worker=self.worker,
            connect_timeout=min(2.0, self.connect_timeout),
            token=self.token, retry=None, piggyback_heartbeat=0.0)
        with self._lock:
            existing = self._shard_clients.get(slot)
            if existing is not None:
                sub.close()
                return existing
            self._shard_clients[slot] = sub
        return sub

    def _drop_shard_clients(self) -> None:
        with self._lock:
            subs, self._shard_clients = self._shard_clients, {}
        for sub in subs.values():
            try:
                sub.close()
            except OSError:
                pass

    def _refresh_shard_map(self) -> None:
        """Bounded shard-map re-resolution against the root.

        Called on the first redirect, on a redirect proving the cached map
        stale, and when a cached shard endpoint stops answering. At most a
        few attempts with the retry policy's backoff between them — the
        root being down is a full control-plane outage and surfaces as
        CoordinatorUnreachable like any other root call.
        """
        _M_SHARD_MAP_REFRESHES.inc()
        sleeps = (self.retry or DEFAULT_RETRY).sleeps()
        last_err: Optional[Exception] = None
        for _attempt in range(4):
            try:
                reply = self._direct_call("shard_map", None, {})
            except CoordinatorUnreachable as e:
                last_err = e
                time.sleep(next(sleeps))
                continue
            if reply.get("ok") and reply.get("root") and reply.get("shards"):
                new = ShardMap([str(s) for s in reply["shards"]])
                with self._lock:
                    old = self._shard_map
                    self._shard_map = new
                if old is None or old.shards != new.shards:
                    self._drop_shard_clients()
                return
            # The endpoint answers but is not a sharded root: disable
            # routing (covers a root replaced by a plain coordinator).
            with self._lock:
                self._shard_map = None
            self._drop_shard_clients()
            return
        raise CoordinatorUnreachable(
            f"shard_map refresh failed against root "
            f"{self.host}:{self.port}: {last_err}")

    def _sharded_add_tasks(self, timeout: Optional[float],
                           fields: Dict) -> Dict:
        """Partition an add_tasks batch by owning shard client-side (tasks
        are hashed by name) and merge the per-shard replies."""
        tasks = fields.get("tasks")
        if not isinstance(tasks, list) or not tasks:
            # Let one shard produce the canonical error/empty reply.
            return self._shard_call("add_tasks", timeout, fields, "")
        parts = partition_tasks([str(t) for t in tasks],
                                self._shard_map.nshards)
        added = 0
        queued = 0
        last: Dict = {}
        for _slot, chunk in sorted(parts.items()):
            sub_fields = dict(fields)
            sub_fields["tasks"] = chunk
            reply = self._shard_call("add_tasks", timeout, sub_fields,
                                     chunk[0])
            if not reply.get("ok"):
                return reply
            last = reply
            added += int(reply.get("added", 0))
            queued += int(reply.get("queued", 0))
        merged = dict(last)
        merged["added"] = added
        merged["queued"] = queued
        return merged

    def _sharded_acquire(self, timeout: Optional[float],
                         fields: Dict) -> Dict:
        """Acquire from the sharded task space: rotate over every shard
        starting at the worker's stable home slot, returning the first
        grant. Drained only when EVERY shard reports exhausted."""
        smap = self._shard_map
        n = smap.nshards
        start = smap.slot_for(str(fields.get("worker") or self.worker or ""))
        exhausted = True
        last: Dict = {}
        for i in range(n):
            slot = (start + i) % n
            reply = self._shard_call_slot("acquire_task", timeout, fields,
                                          slot)
            if not reply.get("ok"):
                return reply
            if reply.get("task") is not None:
                return reply
            last = reply
            exhausted = exhausted and bool(reply.get("exhausted"))
        merged = dict(last) if last else {"ok": True, "task": None}
        merged["task"] = None
        merged["exhausted"] = exhausted
        return merged

    def _shard_call_slot(self, op: str, timeout: Optional[float],
                         fields: Dict, slot: int) -> Dict:
        """Like _shard_call but targeting an explicit slot (acquire's
        rotation) — same refresh-on-unreachable behavior."""
        refreshes = 0
        while True:
            smap = self._shard_map
            if smap is None or smap.nshards == 0:
                return self._direct_call(op, timeout, fields)
            try:
                return self._shard_client(slot % smap.nshards)._direct_call(
                    op, timeout, fields)
            except (CoordinatorAuthError, CoordinatorTimeout):
                raise
            except CoordinatorUnreachable:
                if refreshes >= 3:
                    raise
                refreshes += 1
                self._drop_shard_clients()
                self._refresh_shard_map()

    def call_batch(self, ops: List, timeout: Optional[float] = None) -> List[Dict]:
        """Send many sub-ops in ONE frame; returns per-sub-op replies.

        ``ops`` is a list of ``(op, fields)`` pairs (or dicts carrying an
        ``"op"`` key). The frame's worker identity and token cover every
        sub-op; per-sub-op dedup (``req_id``/``op_id``) and idempotence
        hold exactly as they do for single-op calls, so whole-frame retry
        after a transport failure is as safe as retrying each op — which
        is why the frame rides the same retry policy as ``call()``.
        ``barrier``/``sync`` are not batchable (their replies are parked
        server-side and cannot be threaded into a positional reply array).
        """
        reqs = []
        for item in ops:
            if isinstance(item, dict):
                req = dict(item)
            else:
                op, fields = item
                req = {"op": op, **fields}
            reqs.append(req)
        smap = self._shard_map
        if smap is not None and smap.nshards > 0:
            return self._call_batch_sharded(reqs, timeout)
        encoded = [json.dumps(r, ensure_ascii=False) for r in reqs]
        _M_BATCH_FRAMES.inc()
        reply = self._direct_call("batch", timeout, {"ops": encoded})
        if not reply.get("ok"):
            raise CoordinatorError(f"batch frame rejected: {reply.get('error')}")
        subs = [json.loads(line) for line in reply.get("replies", [])]
        if any(self._is_redirect(s) for s in subs):
            # The root redirected keyspace sub-ops: learn the shard map and
            # re-dispatch the whole frame split by destination.
            _M_SHARD_REDIRECTS.inc()
            self._refresh_shard_map()
            if self._shard_map is not None and self._shard_map.nshards > 0:
                return self._call_batch_sharded(reqs, timeout)
        for sub in subs:
            self._note_reply(sub)
        return subs

    def _call_batch_sharded(self, reqs: List[Dict],
                            timeout: Optional[float]) -> List[Dict]:
        """Split one logical batch by destination (root vs owning shard),
        send one frame per destination, and reassemble replies positionally.
        An add_tasks sub-op whose tasks span shards is executed via the
        routed single-op path and spliced back into its position."""
        smap = self._shard_map
        groups: Dict[int, List] = {}  # dest slot (-1 = root) -> [(pos, req)]
        singles: List = []  # (pos, req) for multi-shard add_tasks
        for pos, req in enumerate(reqs):
            op = req.get("op", "")
            if op == "add_tasks" and isinstance(req.get("tasks"), list):
                parts = partition_tasks([str(t) for t in req["tasks"]],
                                        smap.nshards)
                if len(parts) > 1:
                    singles.append((pos, req))
                    continue
                slot = next(iter(parts)) if parts else 0
                groups.setdefault(slot, []).append((pos, req))
                continue
            key = route_key(op, req)
            dest = -1 if key is None else smap.slot_for(key)
            groups.setdefault(dest, []).append((pos, req))
        out: List[Optional[Dict]] = [None] * len(reqs)
        for dest, items in sorted(groups.items()):
            encoded = [json.dumps(r, ensure_ascii=False) for _, r in items]
            _M_BATCH_FRAMES.inc()
            if dest < 0:
                frame = self._direct_call("batch", timeout, {"ops": encoded})
            else:
                frame = self._shard_call_slot("batch", timeout,
                                              {"ops": encoded}, dest)
            if not frame.get("ok"):
                raise CoordinatorError(
                    f"batch frame rejected: {frame.get('error')}")
            sub_replies = [json.loads(line)
                           for line in frame.get("replies", [])]
            for (pos, req), sub in zip(items, sub_replies):
                if self._is_redirect(sub):
                    # Stale map for this sub-op: refresh and re-route it
                    # individually (keeps the frame's positional contract).
                    _M_SHARD_REDIRECTS.inc()
                    self._refresh_shard_map()
                    fields = {k: v for k, v in req.items() if k != "op"}
                    sub = self.call(req.get("op", ""), timeout=timeout,
                                    **fields)
                out[pos] = sub
                if dest < 0:
                    # Only root replies feed epoch/membership observation:
                    # shard processes don't see membership, so their epoch
                    # stamps (always 0) must not clobber the real one.
                    self._note_reply(sub)
        for pos, req in singles:
            fields = {k: v for k, v in req.items() if k != "op"}
            out[pos] = self.call(req.get("op", ""), timeout=timeout, **fields)
        return out  # type: ignore[return-value]

    #: ops a due heartbeat may NOT ride on: frames/parked ops (reply shape),
    #: and membership ops whose own semantics a heartbeat would perturb.
    _NO_PIGGYBACK = frozenset({"batch", "barrier", "sync",
                               "register", "leave", "heartbeat"})

    def _piggyback_due(self, op: str, fields: Dict) -> bool:
        return (self.piggyback_heartbeat > 0
                and bool(self.worker)
                and op not in self._NO_PIGGYBACK
                and "worker" not in fields
                and time.monotonic() - self._last_piggyback
                >= self.piggyback_heartbeat)

    def _call_with_piggyback(self, op: str, timeout: Optional[float],
                             fields: Dict) -> Dict:
        # Ride the due heartbeat on this call's frame: one round-trip keeps
        # the worker live AND performs the op. The heartbeat sub-reply is
        # absorbed into last_membership by call_batch's _note_reply; the
        # caller sees only its own op's reply, same contract as call().
        hb_reply, main = self.call_batch(
            [("heartbeat", {}), (op, fields)], timeout=timeout)
        if hb_reply.get("ok"):
            self._last_piggyback = time.monotonic()  # edl: noqa[EDL001] telemetry timestamp; a torn write only re-piggybacks early
        return main

    def _note_reply(self, reply: Dict) -> None:
        # Epoch observations are monotonic telemetry: GIL-atomic attribute
        # writes, read opportunistically by workers — no lock needed.
        if not isinstance(reply, dict):
            return
        ep = reply.get("epoch")
        if ep is None:
            return
        try:
            ep = int(ep)
        except (TypeError, ValueError):
            return
        now = time.monotonic()
        self.observed_epoch = ep  # edl: noqa[EDL001] coalesced-epoch telemetry; stale reads only cost one extra heartbeat RPC
        self.observed_epoch_at = now  # edl: noqa[EDL001] coalesced-epoch telemetry; stale reads only cost one extra heartbeat RPC
        if reply.get("ok") and "rank" in reply and "world" in reply:
            self.last_membership = dict(reply)  # edl: noqa[EDL001] coalesced-epoch telemetry; stale reads only cost one extra heartbeat RPC
            self.last_membership_at = now  # edl: noqa[EDL001] coalesced-epoch telemetry; stale reads only cost one extra heartbeat RPC

    def _call_once(self, op: str, timeout: Optional[float],
                   fields: Dict,
                   connect_deadline: Optional[float] = None) -> Dict:
        # The lock intentionally spans the socket round-trip: this is a
        # CLIENT connection whose replies pair to requests by ordering, so
        # the transaction must be atomic per thread — unlike the
        # coordinator's service lock, nothing latency-critical serializes
        # behind it except other requests on this same connection.
        t0 = time.perf_counter()
        with self._lock:
            if self._sock is None:
                _M_RECONNECTS.inc()
                # A previous timeout/error poisoned the connection (a late
                # reply may still be in flight, which would desync
                # request/reply pairing) — start a fresh one. The re-dial
                # budget honors the CONFIGURED connect_timeout, clipped to
                # what remains of the retry policy's deadline when call()
                # is driving retries (a hard-coded 5.0 here used to both
                # overshoot tight deadlines and undershoot generous ones).
                self._buf = b""
                budget = self.connect_timeout
                if connect_deadline is not None:
                    budget = min(budget,
                                 max(0.1, connect_deadline - time.monotonic()))
                self._connect(budget)
            req = {"op": op, **fields}
            if self.worker and "worker" not in req:
                req["worker"] = self.worker
            if self.token and "token" not in req:
                req["token"] = self.token
            payload = (json.dumps(req, ensure_ascii=False) + "\n").encode()
            self._sock.settimeout(timeout)
            try:
                self._sock.sendall(payload)  # edl: noqa[EDL004] client request/reply transaction — the lock exists to make exactly this atomic
                while b"\n" not in self._buf:
                    chunk = self._sock.recv(65536)  # edl: noqa[EDL004] client request/reply transaction — the lock exists to make exactly this atomic
                    if not chunk:
                        # EOF: close now so a retry re-dials instead of
                        # re-sending into the half-closed socket.
                        self.close()
                        raise CoordinatorUnreachable("coordinator closed connection")
                    self._buf += chunk
            except socket.timeout as e:
                self.close()  # poison: the reply may arrive later on this socket
                raise CoordinatorTimeout(f"coordinator call {op!r} timed out") from e
            except OSError as e:
                self.close()
                raise CoordinatorUnreachable(
                    f"coordinator call {op!r} failed: {e}") from e
            finally:
                if self._sock is not None:
                    self._sock.settimeout(None)
            line, self._buf = self._buf.split(b"\n", 1)
        _M_CALLS.inc(op=op)
        if op not in _PARKED_OPS:
            _M_CALL_LATENCY.observe(time.perf_counter() - t0)
        reply = json.loads(line)
        if isinstance(reply, dict) and reply.get("unauthorized"):
            raise CoordinatorAuthError(
                f"coordinator rejected {op!r}: {reply.get('error', 'unauthorized')}"
            )
        self._note_reply(reply)
        return reply

    # -- membership ------------------------------------------------------------

    def register(self, takeover: bool = False) -> Dict:
        """Join (or refresh) membership. ``takeover=True`` marks an
        incarnation boundary — a fresh process claiming this worker name —
        and requeues any leases a dead predecessor still holds; a plain
        refresh renews them instead (a live worker re-registering mid-run
        must not forfeit shards it is training)."""
        return self.call("register", **({"takeover": 1} if takeover else {}))

    def heartbeat(self) -> Dict:
        return self.call("heartbeat")

    def leave(self) -> Dict:
        return self.call("leave")

    def members(self) -> List[str]:
        return self.call("members")["members"]

    def epoch(self) -> int:
        """Fresh epoch via a status round-trip. Hot paths should prefer
        ``observed_epoch`` (stamped on every reply) and let epoch discovery
        coalesce onto traffic that is happening anyway."""
        return int(self.call("status")["epoch"])

    def bump_epoch(self) -> int:
        """Force an epoch bump + sync release (the control plane's rescale
        nudge): live workers parked in sync() resync immediately instead of
        waiting for a membership event. Returns the new epoch."""
        return int(self.call("bump_epoch")["epoch"])

    def preempt_notice(self, targets: List[str], notice_s: float = 30.0,
                       reason: str = "preempt") -> List[str]:
        """Schedule an advance-notice revocation: each target worker gets a
        ``{"notify": "preempt", ...}`` frame pushed on its watch stream (or
        replayed when it next subscribes) and ``notice_s`` seconds to drain.
        The notice is volatile scheduler state — a coordinator restart
        forgets it and the scheduler re-issues. Returns the revoked names."""
        return list(self.call("preempt_notice", targets=list(targets),
                              notice_s=float(notice_s),
                              reason=reason).get("revoked", []))

    # -- task queue ------------------------------------------------------------

    def add_tasks(self, tasks: List[str]) -> int:
        return int(self.call("add_tasks", tasks=list(tasks))["added"])

    def acquire_task(self) -> Optional[str]:
        return self.acquire().get("task")

    def acquire(self) -> Dict:
        """Full acquire reply: {task: str|None, exhausted: bool when drained}.

        Each acquire carries a per-connection ``req_id`` so a retry after a
        lost reply returns the *same* lease instead of popping a second
        task (which would pin a zombie lease renewed by every heartbeat).
        The server answers a repeated (worker, req_id) from its dedup
        cache while the cached task is still leased to this worker.
        """
        with self._lock:
            self._acquire_seq += 1
            req_id = f"{self._nonce}.{self._acquire_seq}"
        return self.call("acquire_task", req_id=req_id)

    def complete_task(self, task: str) -> Dict:
        return self.call("complete_task", task=task)

    def fail_task(self, task: str) -> Dict:
        return self.call("fail_task", task=task)

    # -- synchronization -------------------------------------------------------

    def barrier(self, name: str, count: int, timeout: float = 120.0) -> Dict:
        """Block until ``count`` distinct workers arrive at ``name``.

        Replaces the launcher's sleep-and-poll barriers
        (docker/paddle_k8s:128-130,178) with a real rendezvous. On timeout
        returns {"ok": False, "error": "timeout"} (matching the in-process
        twin) rather than raising; the connection is re-established. A
        transport failure is *not* a timeout — it returns {"ok": False,
        "error": "unreachable"} so callers retry the rendezvous instead of
        proceeding as if peers were merely late on a dead coordinator.
        """
        try:
            return self.call("barrier", timeout=timeout, name=name, count=count)
        except CoordinatorAuthError:
            raise  # deployment bug, not a timeout — never mask it
        except CoordinatorTimeout:
            return {"ok": False, "error": "timeout"}
        except CoordinatorError:
            return {"ok": False, "error": "unreachable"}

    def sync(self, epoch: int, timeout: float = 60.0) -> Dict:
        """Epoch-synchronized rendezvous (the rescale sync point): blocks
        until every current member arrives at ``epoch``. Replies:
        {"ok": True} released; {"ok": False, "resync": True, epoch, world}
        when membership moved (retry with the new epoch); {"ok": False,
        "error": "timeout"} on client-side timeout; {"ok": False,
        "error": "unreachable"} when the coordinator cannot be reached —
        distinct so rendezvous loops re-enter instead of giving up.
        """
        try:
            return self.call("sync", timeout=timeout, epoch=int(epoch))
        except CoordinatorAuthError:
            raise  # deployment bug, not a timeout — never mask it
        except CoordinatorTimeout:
            return {"ok": False, "error": "timeout"}
        except CoordinatorError:
            return {"ok": False, "error": "unreachable"}

    # -- KV (etcd-role subset) -------------------------------------------------

    def kv_put(self, key: str, value: str) -> None:
        self.call("kv_put", key=key, value=value)

    def kv_get(self, key: str) -> Optional[str]:
        return self.call("kv_get", key=key).get("value")

    def kv_del(self, key: str) -> None:
        self.call("kv_del", key=key)

    def kv_incr(self, key: str, delta: int = 1) -> int:
        """Server-side atomic add; returns the new value.

        Carries an ``op_id`` so a retried increment (lost reply, or a
        replay across a coordinator restart) applies exactly once: the
        server persists applied op_ids alongside the KV namespace and
        answers duplicates with the value recorded at first application.
        Failure budgets counted this way cannot double-count an outage.
        """
        with self._lock:
            self._op_seq += 1
            op_id = f"{self._nonce}.{self._op_seq}"
        reply = self.call("kv_incr", key=key, delta=int(delta), op_id=op_id)
        if not reply.get("ok"):
            raise CoordinatorError(f"kv_incr failed: {reply.get('error')}")
        return int(reply["value"])

    # -- checkpoint plane (memory-resident shard replication) ------------------

    def shard_put(self, owner: str, step: int, chunk: int, chunks: int,
                  data: str, nbytes: int = 0,
                  group: Optional[List[str]] = None,
                  put_id: Optional[str] = None) -> Dict:
        """Replicate one chunk of ``owner``'s ZeRO-1 shard into the plane.

        Each put carries a per-connection ``put_id`` so a retried put (lost
        reply, outbox replay) applies exactly once — the server acks the
        replay with ``duplicate`` instead of re-storing. The plane keeps
        only the latest ``step`` per owner; a stale put acks with
        ``stored: False`` and the replicator moves on.
        """
        if put_id is None:
            put_id = self._next_put_id()
        fields: Dict = {"owner": owner, "step": int(step),
                        "chunk": int(chunk), "chunks": int(chunks),
                        "nbytes": int(nbytes), "data": data,
                        "put_id": put_id}
        if group is not None:
            fields["group"] = list(group)
        return self.call("shard_put", **fields)

    def shard_get(self, owner: str, step: int = -1, chunk: int = 0) -> Dict:
        """Fetch one chunk of a (possibly dead) owner's replicated shard;
        ``step < 0`` means latest, a specific step must match exactly."""
        return self.call("shard_get", owner=owner, step=int(step),
                         chunk=int(chunk))

    def shard_meta(self, owner: str) -> Dict:
        """What the plane holds for ``owner``: {found, step, chunks, nbytes,
        complete, group} — ``complete`` is the restorer's go/no-go."""
        return self.call("shard_meta", owner=owner)

    def shard_drop(self, owner: str, step: int = -1) -> Dict:
        """Invalidate ``owner``'s replicated shard (``step < 0``:
        unconditionally; else only that exact step)."""
        return self.call("shard_drop", owner=owner, step=int(step))

    def _next_put_id(self) -> str:
        with self._lock:
            self._put_seq += 1
            return f"{self._nonce}.p{self._put_seq}"

    def status(self) -> Dict:
        return self.call("status")

    def shard_map(self) -> Dict:
        """The control plane's partition layout as the root reports it:
        {root: bool, nshards, shards: [host:port...], shard_index}. A plain
        single-process coordinator answers root=False, nshards=0."""
        return self.call("shard_map")

    def ping(self) -> bool:
        try:
            return bool(self.call("ping", timeout=5.0).get("pong"))
        except (CoordinatorError, OSError):
            return False
