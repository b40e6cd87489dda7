"""Bridge the coordinator's ``status`` counters into the metrics registry:
a copy of `edl_tpu.obs.bridge`.

The native coordinator (`native/coordinator/coordinator.cc`) keeps its
control-plane telemetry — ops handled, batch frames/sub-ops, fsyncs,
snapshots, journal records, event-loop turns, queue/lease/done depths,
per-worker lease counts — inside its ``status`` reply. This bridge is a
registry *collector*: every `/metrics` scrape performs one status
round-trip and republishes those counters as ``edl_coordinator_*`` gauges,
so one scrape of a worker (or the controller) sees the control plane and
the data plane on the same page. The in-process twin
(`coordinator/inprocess.py`) exposes the subset it tracks; missing fields
are simply absent, never zero-faked.

Counters are exported as gauges on purpose: the bridge re-reads absolute
server-side values, it does not own increments — re-publishing a
monotonic reading through a gauge is the textbook pattern for proxied
counters (resetting on coordinator restart is itself signal: the
supervisor's restart is visible as the sawtooth).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from edl_tpu_torch.obs.metrics import MetricsRegistry, get_registry

__all__ = ["CoordinatorStatusBridge"]

#: status fields bridged 1:1 when numeric (native names on the left).
_NUMERIC_FIELDS = (
    "epoch", "world", "queued", "leased", "done",
    "ops", "batch_frames", "batch_subops",
    "fsyncs", "snapshots", "journal_records", "turns",
    "uptime_seconds",
)


class CoordinatorStatusBridge:
    """Scrape-time status poll -> ``edl_coordinator_*`` gauge family.

    ``client`` is anything with the CoordinatorClient surface (wire,
    in-process, or outbox-wrapped). The poll is bounded by ``timeout`` and
    guarded: an unreachable coordinator sets ``edl_coordinator_up`` to 0
    and leaves the last-known values in place (staleness is visible via
    ``up``, absence would read as data loss).
    """

    def __init__(self, client, registry: Optional[MetricsRegistry] = None,
                 timeout: float = 2.0):
        self.client = client
        self.timeout = timeout
        registry = registry if registry is not None else get_registry()
        self._up = registry.gauge(
            "edl_coordinator_up",
            "1 when the last scrape-time status poll succeeded",
        )
        self._gauges = {
            name: registry.gauge(
                f"edl_coordinator_{name}",
                f"coordinator status field {name!r} (absolute server-side value)",
            )
            for name in _NUMERIC_FIELDS
        }
        self._leases = registry.gauge(
            "edl_coordinator_worker_leases",
            "tasks currently leased, per worker",
            labelnames=("worker",),
        )
        self._registry = registry
        #: one poll at a time: concurrent scrapes must not interleave
        #: request/reply pairs on a shared single-connection client.
        self._poll_lock = threading.Lock()
        self._registered = False

    def register(self) -> "CoordinatorStatusBridge":
        if not self._registered:
            self._registry.register_collector(self.collect)
            self._registered = True  # edl: noqa[EDL001] registration happens once at wiring time, before any scrape thread exists
        return self

    def unregister(self) -> None:
        self._registry.unregister_collector(self.collect)
        self._registered = False  # edl: noqa[EDL001] teardown-path flag, owner-thread-only by contract

    def _status(self) -> Dict:
        # Prefer a bounded call when the client speaks the wire protocol: an
        # unbounded status() against a hung coordinator would park the scrape.
        call = getattr(self.client, "call", None)
        if call is not None:
            return call("status", timeout=self.timeout)
        return self.client.status()

    def collect(self) -> None:
        try:
            with self._poll_lock:
                status = self._status()
        except Exception:  # edl: noqa[EDL005] an unreachable coordinator is expected telemetry, reported as up=0 — the scrape itself must survive
            self._up.set(0.0)
            return
        if not isinstance(status, dict) or not status.get("ok", True):
            self._up.set(0.0)
            return
        self._up.set(1.0)
        for name, gauge in self._gauges.items():
            v = status.get(name)
            if isinstance(v, (int, float)):
                gauge.set(float(v))
        holders = status.get("lease_holders")
        if isinstance(holders, list):
            # native encoding: ["worker=count", ...] (flat string array — the
            # wire writer has no nested objects). Reset-by-rewrite: publish
            # current holders; a worker that dropped to zero is set to 0 so
            # its stale series doesn't dangle.
            seen = {}
            for item in holders:
                name, _, count = str(item).rpartition("=")
                if not name:
                    continue
                try:
                    seen[name] = float(count)
                except ValueError:
                    continue
            for worker, count in seen.items():
                self._leases.set(count, worker=worker)
            with self._leases._lock:
                stale = [k for k in self._leases._cells
                         if dict(k).get("worker") not in seen]
            for key in stale:
                self._leases.set(0.0, worker=dict(key)["worker"])
