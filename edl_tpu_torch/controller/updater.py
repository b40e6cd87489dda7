"""Per-job lifecycle actor.

Re-design of the reference's per-job updater
(`pkg/updater/trainingJobUpdater.go:44-481`): one thread per TrainingJob owns
all of that job's control-plane state (the actor pattern the reference uses to
avoid locking its job map, `:74-75`), driven by a bounded event queue with a
high-water warning (`:19-26,80-86`), and a periodic status conversion tick
(10 s in the reference, `:22`).

Lifecycle: create coordinator, poll until ready, create trainers
(`:209-293` creation order master→pserver→trainer), then run the phase machine
None→Creating→Running→Succeeded/Failed (`:384-449`) with the reference's
fault-tolerance rules (`:359-380`): a strict job fails on ANY trainer failure;
a fault-tolerant job fails only when ALL trainers have failed. On completion
the coordinator role is released while trainer history is kept (`:343-382`);
deletion tears down both roles (`:99-207`).

A copy of the JAX package's ``edl_tpu/controller/updater.py`` with the
imports pointing at this package.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

from edl_tpu_torch.api.types import JobPhase, TrainerStatus, TrainingJob
from edl_tpu_torch.api.validation import normalize
from edl_tpu_torch.controller.cluster import ClusterProvider
from edl_tpu_torch.controller.jobparser import (
    ROLE_COORDINATOR,
    ROLE_TRAINER,
    parse_to_coordinator,
    parse_to_trainer,
)
from edl_tpu_torch.controller.store import JobStore

log = logging.getLogger("edl_tpu_torch.controller.updater")

#: event-queue capacity + warning threshold (ref: trainingJobUpdater.go:19-26).
EVENT_QUEUE_CAP = 1000
EVENT_QUEUE_HIGH_WATER = 800


@dataclass
class UpdaterConfig:
    #: status conversion period (ref: 10 s, trainingJobUpdater.go:22).
    convert_seconds: float = 10.0
    #: readiness poll period while creating roles (ref: 5 s, :209-257).
    poll_seconds: float = 5.0
    #: give up on role creation after this long and fail the job.
    create_timeout: float = 600.0


class JobUpdater:
    """Actor owning one job's materialization, status, and teardown."""

    def __init__(
        self,
        job: TrainingJob,
        cluster: ClusterProvider,
        store: JobStore,
        config: Optional[UpdaterConfig] = None,
    ):
        self.job = normalize(job)
        self.cluster = cluster
        self.store = store
        self.config = config or UpdaterConfig()
        self._events: "queue.Queue[str]" = queue.Queue(maxsize=EVENT_QUEUE_CAP)
        self._stop = threading.Event()
        self._deleted = threading.Event()  # deletion requested
        self._gc_done = threading.Event()  # resources torn down
        self._gc_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._last_written_status: Optional[tuple] = None
        self.done = threading.Event()  # set once the actor exits

    # -- external surface (ref: Notify/Modify/Delete, :88-97) ------------------

    def start(self) -> "JobUpdater":
        self._thread = threading.Thread(  # edl: noqa[EDL001] started exactly once by the controller before the updater is shared
            target=self._run, name=f"edl-updater-{self.job.name}", daemon=True
        )
        self._thread.start()
        return self

    def notify_update(self, job: TrainingJob) -> None:
        self.job.spec = job.spec  # edl: noqa[EDL001,EDL006] atomic reference swap under the GIL; the actor thread reads it on its next tick
        self._enqueue("update")

    def record_scale(self, record) -> None:
        """Append an autoscaler actuation to status history. List append is
        atomic under the GIL; the actor persists it on its next status write."""
        self.job.status.scale_history.append(record)
        self._enqueue("update")

    def notify_delete(self) -> None:
        """Request teardown. The actor GCs in its exit path; if it already
        exited (terminal phase), GC runs on the caller's thread instead."""
        self._deleted.set()
        self._enqueue("delete")
        if self.done.is_set():
            self._gc_resources()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._enqueue("stop")
        deadline = time.monotonic() + timeout
        if self._thread:
            self._thread.join(timeout=timeout)
        # A delete requested but never processed (actor raced past the event)
        # must still tear down — but within stop()'s remaining time budget:
        # if the actor thread is wedged inside _gc_resources holding the
        # lock, we return without waiting unboundedly for it.
        if self._deleted.is_set():
            self._gc_resources(lock_timeout=max(0.0, deadline - time.monotonic()))

    def _enqueue(self, kind: str) -> None:
        if self._events.qsize() >= EVENT_QUEUE_HIGH_WATER:
            log.warning(
                "updater %s event queue high water (%d)", self.job.name, self._events.qsize()
            )
        try:
            self._events.put_nowait(kind)
        except queue.Full:  # drop like the reference's full channel would block
            log.error("updater %s event queue full; dropping %s", self.job.name, kind)

    # -- status writeback (ref: updateCRDStatus, :295-307) ---------------------

    def _status_fingerprint(self) -> tuple:
        st = self.job.status
        return (
            st.phase,
            st.reason,
            st.parallelism,
            tuple(sorted((k, v.value) for k, v in st.replica_statuses.items())),
            len(st.scale_history),
        )

    def _set_phase(self, phase: JobPhase, reason: str = "") -> None:
        """Write status to the store only when it actually changed. The store
        echoes every write back as a watch event (informer semantics), so an
        unconditional write per tick would turn the convert loop into a
        busy loop: write -> echo -> event -> convert -> write ..."""
        self.job.status.phase = phase
        self.job.status.reason = reason
        fp = self._status_fingerprint()
        if fp == self._last_written_status:
            return
        try:
            self.store.update_status(self.job.name, self.job.status, self.job.namespace)
            self._last_written_status = fp
        except KeyError:
            pass  # job deleted from the store mid-flight
        except Exception as e:  # noqa: BLE001 — e.g. ApiError after the
            # store's conflict retries ran dry. The fingerprint stays
            # unrecorded, so the next convert tick rewrites; an actor crash
            # here would take the whole job down over a status blip.
            log.warning("status writeback for %s failed (will retry): %s",
                        self.job.name, e)

    # -- materialization (ref: createTrainingJob, :282-293) --------------------

    def _create_resources(self) -> bool:
        """Coordinator first, poll ready, then trainers. Returns success.

        Roles that already exist are adopted, not re-created — a controller
        restart replays running jobs through on_add, and duplicating pods of
        a live job would double its resource footprint.
        """
        self._set_phase(JobPhase.CREATING)
        self._ensure_auth_token()
        if not self.cluster.job_pods(self.job.name, ROLE_COORDINATOR):
            coord = parse_to_coordinator(self.job)
            self.cluster.create_role(
                self.job.name, ROLE_COORDINATOR, coord.replicas,
                coord.requests, coord.limits, workload=coord,
            )
        deadline = time.monotonic() + self.config.create_timeout
        while not self._coordinator_ready():
            if self._stop.is_set():
                return False
            if time.monotonic() > deadline:
                self._set_phase(JobPhase.FAILED, "coordinator never became ready")
                return False
            time.sleep(max(0.01, min(self.config.poll_seconds, deadline - time.monotonic())))
        existing = self.cluster.job_pods(self.job.name, ROLE_TRAINER)
        if existing:
            self.job.status.parallelism = self.cluster.get_trainer_parallelism(self.job.name)
        else:
            trainer = parse_to_trainer(self.job)
            self.cluster.create_role(
                self.job.name, ROLE_TRAINER, trainer.replicas,
                trainer.requests, trainer.limits, workload=trainer,
            )
            self.job.status.parallelism = trainer.replicas
        self._set_phase(JobPhase.RUNNING)
        return True

    def _ensure_auth_token(self) -> None:
        """Stamp a per-job coordinator secret into the spec at admission.

        Persisted through the store BEFORE any pod materializes, so a
        controller restart replays the same token instead of minting a new
        one under running pods (which would lock every trainer out of its
        own coordinator). Pods receive it as EDL_COORD_TOKEN (make_env).
        """
        if self.job.spec.auth_token:
            return
        import secrets

        self.job.spec.auth_token = secrets.token_hex(16)  # edl: noqa[EDL001] actor-thread-owned state; only the updater's own loop reaches admission
        try:
            self.job = normalize(self.store.update(self.job))  # edl: noqa[EDL001] atomic reference swap under the GIL, same as notify_update
        except KeyError:
            pass  # job deleted from the store mid-flight; actor will exit

    def _coordinator_ready(self) -> bool:
        pods = self.cluster.job_pods(self.job.name, ROLE_COORDINATOR)
        return bool(pods) and all(p.phase == "Running" for p in pods)

    # -- status conversion (ref: GetStatus/Convert, :343-414) ------------------

    def _convert(self) -> None:
        """Fold pod phases into job status; apply terminal-phase rules."""
        if self.job.status.phase.terminal():
            return
        pods = self.cluster.job_pods(self.job.name, ROLE_TRAINER)
        statuses: Dict[str, TrainerStatus] = {}
        counts = {"Pending": 0, "Running": 0, "Succeeded": 0, "Failed": 0}
        for p in pods:
            counts[p.phase] = counts.get(p.phase, 0) + 1
            statuses[p.name] = TrainerStatus(p.phase)
        self.job.status.replica_statuses = statuses
        self.job.status.parallelism = self.cluster.get_trainer_parallelism(self.job.name)

        total = len(pods)
        fault_tolerant = self.job.spec.fault_tolerant
        if total == 0:
            self._set_phase(self.job.status.phase)  # just refresh statuses
            return
        if not fault_tolerant and counts["Failed"] > 0:
            # Strict job: any failure fails the job (ref: :369-380).
            self._finish(JobPhase.FAILED, f"{counts['Failed']}/{total} trainers failed")
        elif fault_tolerant and counts["Failed"] == total:
            # FT job: dead only when everyone is (ref: :359-367).
            self._finish(JobPhase.FAILED, "all trainers failed")
        elif counts["Succeeded"] > 0 and counts["Running"] + counts["Pending"] == 0:
            # Work exhausted: remaining pods all terminal, at least one trainer
            # completed the task queue (FT) / all did (strict, no failures).
            self._finish(JobPhase.SUCCEEDED, "")
        else:
            self._set_phase(self.job.status.phase)

    def _finish(self, phase: JobPhase, reason: str) -> None:
        """Terminal transition: release the coordinator, keep trainer history
        (ref: releaseMaster/releasePserver on completion, :343-382)."""
        self._set_phase(phase, reason)
        try:
            self.cluster.delete_role(self.job.name, ROLE_COORDINATOR)
        except Exception:
            log.exception("releasing coordinator of %s failed", self.job.name)

    # -- teardown (ref: deleteTrainingJob + pod GC, :99-207) -------------------

    def _gc_resources(self, lock_timeout: Optional[float] = None) -> None:
        # Lock held through the teardown itself, not just the flag: a caller
        # returning from notify_delete must observe resources GONE, not
        # in-flight (the loser of the race blocks until the winner finishes).
        # ``lock_timeout`` bounds that wait for callers with their own
        # deadline (stop()); None preserves the block-until-done contract.
        acquired = self._gc_lock.acquire(
            timeout=lock_timeout if lock_timeout is not None else -1
        )
        if not acquired:
            log.warning(
                "gc of %s still in flight elsewhere; not waiting", self.job.name
            )
            return
        try:
            if self._gc_done.is_set():
                return
            for role in (ROLE_TRAINER, ROLE_COORDINATOR):
                try:
                    self.cluster.delete_role(self.job.name, role)
                except Exception:
                    log.exception(
                        "deleting role %s of %s failed", role, self.job.name
                    )
            self._gc_done.set()
        finally:
            self._gc_lock.release()

    # -- actor loop (ref: start, :453-481) -------------------------------------

    def _run(self) -> None:
        try:
            if not self._create_resources():
                if self._stop.is_set():
                    return
                # creation failed: leave resources for debugging, like the
                # reference leaves the failed RS; deletion GCs them.
            while not self._stop.is_set():
                try:
                    evt = self._events.get(timeout=self.config.convert_seconds)
                except queue.Empty:
                    evt = "tick"
                if evt in ("delete", "stop"):
                    return
                try:
                    self._convert()
                except Exception:
                    log.exception("convert failed for %s", self.job.name)
                if self.job.status.phase.terminal():
                    return
        finally:
            # Set done BEFORE checking _deleted, mirroring notify_delete's
            # set-_deleted-then-check-done: whichever thread writes second is
            # guaranteed to see the other's flag, so GC cannot be skipped when
            # notify_delete races the actor's exit. (_gc_resources is
            # lock-idempotent, so both seeing it is fine.)
            self.done.set()
            if self._deleted.is_set():
                self._gc_resources()
