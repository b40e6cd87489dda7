"""Degraded-mode client: buffer side effects during a coordinator outage.

The worker's compute does not depend on the coordinator — batches already
leased and placed keep stepping. What the outage blocks is *bookkeeping*:
``complete_task`` after a covering checkpoint, ``fail_task`` on a bad
shard, KV publishes. This module buffers exactly those, then replays them
in order once the coordinator answers again. Replay is safe because the
server treats every buffered op idempotently:

- ``complete_task``: already-done replies ok+duplicate; requeued-but-
  unleased tasks are accepted (the worker only completes after a durable
  covering checkpoint).
- ``fail_task``: a task whose lease already expired is simply back in the
  queue; the error reply is ignored on replay.
- ``kv_put``: last-writer-wins by design.
- ``kv_incr``: carries an ``op_id`` marker persisted server-side, so a
  replay across even a coordinator *restart* applies exactly once.

:class:`OutboxClient` wraps any client with the ``CoordinatorClient``
method surface (wire or in-process) and adds outage accounting: reads
fail soft (``acquire`` returns ``{"task": None, "unreachable": True}``),
mutations buffer, and ``outage_seconds()`` feeds the worker's park budget.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from edl_tpu_torch.coordinator.client import (
    CoordinatorAuthError,
    CoordinatorError,
    CoordinatorUnreachable,
)

__all__ = ["Outbox", "OutboxClient"]


class Outbox:
    """Ordered buffer of coordinator mutations awaiting replay.

    Thread-safe: with a pipelined input path the lease RPCs run on the pump
    thread while heartbeats/commits stay on the worker's main thread, so
    two threads can observe recovery — and call :meth:`replay` — at once.
    """

    def __init__(self) -> None:
        self._entries: List[Tuple[str, Dict]] = []
        self._lock = threading.Lock()
        #: held by the (single) thread currently draining; a concurrent
        #: replay returns 0 instead of racing the pops.
        self._replaying = threading.Lock()

    def add(self, op: str, **fields) -> None:
        with self._lock:
            self._entries.append((op, fields))

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def pending(self) -> List[Tuple[str, Dict]]:
        with self._lock:
            return list(self._entries)

    #: sub-ops per replay frame: bounds frame size (a 10k-op outage backlog
    #: must not serialize into one multi-megabyte line) while amortizing
    #: the round-trip ~64x versus per-op replay.
    BATCH = 64

    def replay(self, client) -> int:
        """Replay buffered ops in order through the client.

        Uses ``client.call_batch`` when the client has one — ordered frames
        of up to :data:`BATCH` sub-ops, one round-trip each — and falls
        back to per-op ``client.call``. Returns the number of ops drained.
        Stops (keeping the tail) on the first transport failure so a
        mid-replay outage loses nothing: a frame that failed in transit is
        retried whole later, which is safe for the same reason replay is
        safe at all — every buffered op is idempotent or deduped server-
        side (op_id markers), even if the lost frame was partially applied.
        A rejected sub-op ({"ok": False}) is dropped — the server has
        already resolved it (e.g. a fail_task whose lease expired and
        requeued). One replayer at a time: a thread that finds a drain
        already in flight returns 0 (its guarded call proceeds; ops are
        idempotent).
        """
        if not self._replaying.acquire(blocking=False):
            return 0
        try:
            call_batch = getattr(client, "call_batch", None)
            if call_batch is not None:
                return self._replay_batched(call_batch)
            drained = 0
            while True:
                with self._lock:
                    if not self._entries:
                        break
                    op, fields = self._entries[0]
                try:
                    client.call(op, **fields)
                except CoordinatorAuthError:
                    raise
                except CoordinatorError:
                    break
                with self._lock:
                    self._entries.pop(0)
                drained += 1
            return drained
        finally:
            self._replaying.release()

    def _replay_batched(self, call_batch) -> int:
        drained = 0
        while True:
            with self._lock:
                frame = list(self._entries[:self.BATCH])
            if not frame:
                break
            try:
                call_batch(frame)
            except CoordinatorAuthError:
                raise
            except CoordinatorError:
                break
            with self._lock:
                del self._entries[:len(frame)]
            drained += len(frame)
        return drained


class OutboxClient:
    """CoordinatorClient facade that degrades instead of raising.

    Wraps the underlying ``client`` (CoordinatorClient or InProcessClient):

    - **mutations** (``complete_task``/``fail_task``/``kv_put``) land in
      the outbox when the coordinator is unreachable and report
      ``{"ok": True, "buffered": True}``;
    - **acquire** fails soft with ``{"task": None, "unreachable": True}``
      — the lease loop's existing empty-queue poll path absorbs it;
    - **reachability** is tracked across all guarded calls:
      ``outage_seconds()`` is the worker's park-budget input, and any
      successful guarded call replays the outbox first so buffered
      completions land before new ones.

    Auth errors always propagate — a bad token is a deployment bug the
    outage machinery must never absorb.
    """

    def __init__(self, client, outbox: Optional[Outbox] = None) -> None:
        self.client = client
        self.outbox = outbox if outbox is not None else Outbox()
        #: monotonic timestamp of the first failure of the current outage,
        #: None while reachable.
        self.unreachable_since: Optional[float] = None
        self.buffered_ops = 0
        self.replayed_ops = 0
        self.outages = 0
        self.outage_total_seconds = 0.0
        #: called with the incident's duration (seconds) each time an
        #: outage closes — the running total above aggregates per-incident
        #: lengths away, and both the outage-duration histogram and the
        #: adaptive fault-tolerance policy need the distribution. Invoked
        #: from whichever thread's guarded call observed recovery; keep
        #: the callback cheap and thread-safe.
        self.on_outage_close: Optional[Callable[[float], None]] = None

    # -- outage accounting -----------------------------------------------------

    @property
    def worker(self) -> str:
        return self.client.worker

    def outage_seconds(self) -> float:
        if self.unreachable_since is None:
            return 0.0
        return time.monotonic() - self.unreachable_since

    @property
    def unreachable(self) -> bool:
        return self.unreachable_since is not None

    def _mark_down(self) -> None:
        if self.unreachable_since is None:
            self.unreachable_since = time.monotonic()
            self.outages += 1

    def _mark_up(self) -> None:
        if self.unreachable_since is not None:
            duration = time.monotonic() - self.unreachable_since
            self.outage_total_seconds += duration
            self.unreachable_since = None
            if self.on_outage_close is not None:
                self.on_outage_close(duration)

    def replay(self) -> int:
        """Drain the outbox through the underlying client (idempotent)."""
        drained = self.outbox.replay(self.client)
        self.replayed_ops += drained
        return drained

    def _recovered(self) -> None:
        self._mark_up()
        if len(self.outbox):
            self.replay()

    # -- guarded mutations (buffer on outage) ----------------------------------

    def _mutate(self, op: str, **fields) -> Dict:
        try:
            reply = self.client.call(op, **fields)
        except CoordinatorAuthError:
            raise
        except CoordinatorError:
            self._mark_down()
            self.outbox.add(op, **fields)
            self.buffered_ops += 1
            return {"ok": True, "buffered": True}
        self._recovered()
        return reply

    def complete_task(self, task: str) -> Dict:
        # Buffered-first ordering: a completion buffered during the outage
        # must not be reordered behind this one.
        if len(self.outbox) and not self.unreachable:
            self.replay()
        return self._mutate("complete_task", task=task)

    def fail_task(self, task: str) -> Dict:
        return self._mutate("fail_task", task=task)

    def kv_put(self, key: str, value: str) -> None:
        self._mutate("kv_put", key=key, value=value)

    # -- guarded reads (fail soft) ---------------------------------------------

    def acquire(self) -> Dict:
        try:
            reply = self.client.acquire()
        except CoordinatorAuthError:
            raise
        except CoordinatorError:
            self._mark_down()
            # Shape-compatible with the empty-queue reply: the lease loop
            # polls instead of dying, which *is* degraded mode.
            return {"ok": False, "task": None, "exhausted": False,
                    "unreachable": True}
        self._recovered()
        return reply

    def acquire_task(self) -> Optional[str]:
        return self.acquire().get("task")

    def heartbeat(self) -> Dict:
        try:
            reply = self.client.heartbeat()
        except CoordinatorAuthError:
            raise
        except CoordinatorError:
            self._mark_down()
            return {"ok": False, "error": "unreachable", "unreachable": True}
        self._recovered()
        return reply

    def register(self, takeover: bool = False) -> Dict:
        try:
            reply = self.client.register(takeover=takeover)
        except CoordinatorAuthError:
            raise
        except CoordinatorError:
            self._mark_down()
            return {"ok": False, "error": "unreachable", "unreachable": True}
        self._recovered()
        return reply

    # -- transparent passthroughs ----------------------------------------------

    def __getattr__(self, name: str):
        # Everything not explicitly guarded (sync, barrier, kv_get, members,
        # status, ping, leave, add_tasks, bump_epoch, kv_incr, close, ...)
        # keeps the underlying client's semantics, including its retry
        # policy and its error types.
        return getattr(self.client, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.client.close()

    def summary(self) -> Dict[str, float]:
        """Outage telemetry for worker run summaries / the collector."""
        out = {
            "outages": float(self.outages),
            "outage_total_seconds": self.outage_total_seconds
            + self.outage_seconds(),
            "buffered_ops": float(self.buffered_ops),
            "replayed_ops": float(self.replayed_ops),
            "outbox_pending": float(len(self.outbox)),
        }
        retries = getattr(self.client, "retry_count", 0)
        out["transport_retries"] = float(retries)
        return out
