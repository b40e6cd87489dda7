"""Cluster metrics collector.

Equivalent of the reference's measurement harness
(`example/fit_a_line/collector.py:27-226`), which defined the published
experiment's metrics plane: submitted/pending job counts, running trainers per
job, and cluster utilization, sampled on a fixed period (10 s print loop,
`collector.py:215-226`). Ours reads the JobStore + ClusterProvider instead of
the K8s API, adds TPU-chip utilization (the resource that matters here), and
keeps samples as structured records so tests and benches can assert on them.

A copy of the JAX package's ``edl_tpu/tools/collector.py`` with the imports
pointing at this package; ``tpu_utilization`` keeps its name and here is the
share of the H100 cards requested.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, TextIO

from edl_tpu_torch.api.types import JobPhase
from edl_tpu_torch.controller.cluster import ClusterProvider
from edl_tpu_torch.controller.jobparser import ROLE_TRAINER
from edl_tpu_torch.controller.store import JobStore
from edl_tpu_torch.obs.metrics import get_registry

log = logging.getLogger("edl_tpu_torch.tools.collector")

# Every sample mirrors onto the controller's /metrics endpoint: the JSONL
# stream keeps history, the gauges carry the live values a scraper wants.
_REG = get_registry()
_M_SUBMITTED = _REG.gauge("edl_cluster_submitted_jobs", "jobs in the store")
_M_PENDING = _REG.gauge(
    "edl_cluster_pending_jobs", "submitted jobs with no running pods yet")
_M_RUNNING = _REG.gauge("edl_cluster_running_jobs", "jobs in RUNNING phase")
_M_UTIL = _REG.gauge(
    "edl_cluster_utilization",
    "cluster resource utilization fraction, by resource",
    labelnames=("resource",),
)
_M_SUP_RESTARTS = _REG.gauge(
    "edl_coordinator_supervisor_restarts",
    "times the supervised coordinator was restarted",
)
_M_SUP_DOWNTIME = _REG.gauge(
    "edl_coordinator_supervisor_downtime_seconds",
    "cumulative seconds the supervised coordinator was down",
)


@dataclass
class ClusterSample:
    """One observation (ref: the per-tick print block, collector.py:137-213)."""

    timestamp: float
    submitted_jobs: int
    pending_jobs: int
    running_jobs: int
    #: job -> running trainer count (ref: RUNNING-TRAINERS per job).
    running_trainers: Dict[str, int] = field(default_factory=dict)
    #: job -> phase string.
    phases: Dict[str, str] = field(default_factory=dict)
    cpu_utilization: float = 0.0
    tpu_utilization: float = 0.0
    memory_utilization: float = 0.0
    #: coordinator-supervision health (restarts, downtime_seconds,
    #: last_restart_rc) when a supervisor is attached — the control plane's
    #: own availability belongs on the same metrics plane as the jobs it
    #: schedules.
    coordinator: Dict[str, float] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "timestamp": self.timestamp,
            "submitted_jobs": self.submitted_jobs,
            "pending_jobs": self.pending_jobs,
            "running_jobs": self.running_jobs,
            "running_trainers": dict(self.running_trainers),
            "phases": dict(self.phases),
            "cpu_utilization": round(self.cpu_utilization, 4),
            "tpu_utilization": round(self.tpu_utilization, 4),
            "memory_utilization": round(self.memory_utilization, 4),
            "coordinator": {k: round(v, 4) for k, v in self.coordinator.items()},
        }


class Collector:
    """Sample the control plane on a period; optionally stream JSON lines.

    The reference printed CSV-ish lines every 10 s (`collector.py:215-226`);
    we default to the same period and emit one JSON object per line.
    """

    def __init__(
        self,
        store: JobStore,
        cluster: ClusterProvider,
        period_seconds: float = 10.0,
        sink: Optional[TextIO] = None,
        max_samples: int = 100_000,
        supervisor=None,
    ):
        self.store = store
        self.cluster = cluster
        self.period_seconds = period_seconds
        self.sink = sink
        #: optional CoordinatorSupervisor (or anything with ``summary() ->
        #: Dict[str, float]``): its restart/downtime counters ride along in
        #: every sample.
        self.supervisor = supervisor
        self.samples: List[ClusterSample] = []
        self._max = max_samples
        #: guards the samples ring: sample() runs on the collector thread,
        #: but tests and report code call it (and the readers) directly.
        self._samples_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- one observation (ref: collector.py:95-213) ----------------------------

    def sample(self) -> ClusterSample:
        jobs = self.store.list()
        snap = self.cluster.inquire()
        running_trainers: Dict[str, int] = {}
        phases: Dict[str, str] = {}
        pending = running = 0
        for job in jobs:
            phases[job.name] = job.status.phase.value
            pods = self.cluster.job_pods(job.name, ROLE_TRAINER)
            running_trainers[job.name] = sum(1 for p in pods if p.phase == "Running")
            if job.status.phase == JobPhase.RUNNING:
                running += 1
            # "Pending" in the reference: submitted but with no running pods yet
            # (collector.py:95-118) — creation still in flight counts too.
            elif job.status.phase in (JobPhase.NONE, JobPhase.CREATING):
                pending += 1
        s = ClusterSample(
            timestamp=time.time(),
            submitted_jobs=len(jobs),
            pending_jobs=pending,
            running_jobs=running,
            running_trainers=running_trainers,
            phases=phases,
            cpu_utilization=snap.util("cpu"),
            tpu_utilization=snap.util("tpu"),
            memory_utilization=snap.util("memory"),
            coordinator=(
                dict(self.supervisor.summary())
                if self.supervisor is not None else {}
            ),
        )
        _M_SUBMITTED.set(float(s.submitted_jobs))
        _M_PENDING.set(float(s.pending_jobs))
        _M_RUNNING.set(float(s.running_jobs))
        _M_UTIL.set(s.cpu_utilization, resource="cpu")
        _M_UTIL.set(s.tpu_utilization, resource="tpu")
        _M_UTIL.set(s.memory_utilization, resource="memory")
        if "restarts" in s.coordinator:
            _M_SUP_RESTARTS.set(float(s.coordinator["restarts"]))
        if "downtime_seconds" in s.coordinator:
            _M_SUP_DOWNTIME.set(float(s.coordinator["downtime_seconds"]))
        with self._samples_lock:
            self.samples.append(s)
            if len(self.samples) > self._max:
                del self.samples[: len(self.samples) - self._max]
        if self.sink is not None:
            self.sink.write(json.dumps(s.to_dict()) + "\n")
            self.sink.flush()
        return s

    # -- loop ------------------------------------------------------------------

    def start(self) -> "Collector":
        self._thread = threading.Thread(target=self._run, name="edl-collector", daemon=True)  # edl: noqa[EDL001] started exactly once before the collector is shared; _samples_lock guards the ring, not lifecycle

        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.sample()
            except Exception:  # keep observing through transient provider errors
                log.exception("collector sample failed")
            self._stop.wait(self.period_seconds)

    # -- summaries the experiment report needs ---------------------------------

    def peak_tpu_utilization(self) -> float:
        with self._samples_lock:
            return max((s.tpu_utilization for s in self.samples), default=0.0)

    def latest(self) -> Optional[ClusterSample]:
        with self._samples_lock:
            return self.samples[-1] if self.samples else None
