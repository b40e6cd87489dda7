"""Role launcher: the `paddle_k8s` equivalent.

Dispatches the roles a pod can play (ref: `docker/paddle_k8s:238-263`):

- ``start_coordinator`` — run the native coordinator service and seed its
  task queue (ref: start_master + etcd sidecar, `docker/paddle_k8s:26-32`).
- ``start_trainer`` — gate on the job-wide failure budget, wait for the
  coordinator, then exec the user entrypoint, mapping crash exit codes to a
  termination log (ref: start_new_trainer + check_trainer_ret,
  `docker/paddle_k8s:121-143,44-60`).

Configuration arrives via the ``EDL_*`` env protocol the controller stamps on
pods (`edl_tpu.controller.jobparser.make_env`), mirroring how `paddle_k8s`
consumed `PADDLE_*` (`pkg/jobparser.go:263-311`).

A copy of the JAX package's ``edl_tpu/launcher/launch.py``: the imports
point at this package, the coordinator is the same ``native/coordinator``
binary, and the env protocol is read letter for letter. One difference: the
entry gets no ``JAX_COMPILATION_CACHE_DIR``, since the port's entries run
no XLA compiler and the port has no compilation cache (ROADMAP).
"""

from __future__ import annotations

import json
import logging
import os
import shlex
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from edl_tpu_torch.coordinator.client import CoordinatorError
from edl_tpu_torch.launcher.discovery import wait_coordinator

log = logging.getLogger("edl_tpu_torch.launcher.launch")

#: coordinator KV key counting trainer process failures job-wide.
FAILED_COUNT_KEY = "edl/trainer_failed_count"

#: fatal signals -> human reason (ref: docker/paddle_k8s:44-60 maps the
#: shell's 128+N encoding; subprocess reports signal death as -N).
_SIGNAL_REASONS = {
    6: "Aborted (SIGABRT)",
    8: "Floating point exception (SIGFPE)",
    9: "Killed (SIGKILL / OOM)",
    11: "Segmentation fault (SIGSEGV)",
}


def map_exit_code(code: int) -> str:
    """Human-readable trainer exit reason for the termination log.

    Accepts both encodings of a signal death: negative (``subprocess``
    returncode for direct exec) and 128+N (shell-wrapped entrypoints).
    """
    if code == 0:
        return "Succeeded"
    sig = -code if code < 0 else code - 128 if code > 128 else None
    if sig in _SIGNAL_REASONS:
        return _SIGNAL_REASONS[sig]
    return f"Exited with code {code}"


@dataclass
class LaunchContext:
    """The EDL_* env protocol, parsed (ref consumption side of
    `pkg/jobparser.go:263-311`)."""

    job_name: str = "job"
    namespace: str = "default"
    role: str = "trainer"
    coordinator_endpoint: str = "127.0.0.1:7164"
    port: int = 7164
    num_trainers: int = 1
    max_trainers: int = 1
    fault_tolerant: bool = False
    passes: int = 1
    entry: str = ""
    workspace: str = ""
    mesh_axes: Dict[str, int] = field(default_factory=dict)
    tpu_chips: int = 0
    data_shards: List[str] = field(default_factory=list)
    checkpoint_dir: str = ""
    checkpoint_interval: int = 1000
    termination_log: str = "/dev/termination-log"
    #: coordinator durability snapshot (queue/done/kv/epoch). Empty -> a
    #: default under the workspace, so a restarted coordinator pod with any
    #: persistent volume resumes instead of replaying the dataset.
    state_file: str = ""
    #: identity of this job RUN (the K8s object UID when deployed). Stamped
    #: into the coordinator state file so a fresh run in a reused workspace
    #: discards the previous run's done-set instead of silently "completing".
    run_id: str = ""

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None) -> "LaunchContext":
        e = env if env is not None else os.environ
        return cls(
            job_name=e.get("EDL_JOB_NAME", "job"),
            namespace=e.get("EDL_NAMESPACE", "default"),
            role=e.get("EDL_ROLE", "trainer"),
            coordinator_endpoint=e.get("EDL_COORDINATOR_ENDPOINT", "127.0.0.1:7164"),
            port=int(e.get("EDL_PORT", "7164")),
            num_trainers=int(e.get("EDL_NUM_TRAINERS", "1")),
            max_trainers=int(e.get("EDL_MAX_TRAINERS", "1")),
            fault_tolerant=e.get("EDL_FAULT_TOLERANT", "0") == "1",
            passes=int(e.get("EDL_PASSES", "1")),
            entry=e.get("EDL_ENTRY", ""),
            workspace=e.get("EDL_WORKSPACE", ""),
            mesh_axes=json.loads(e.get("EDL_MESH_AXES", "{}")),
            tpu_chips=int(e.get("EDL_TPU_CHIPS", "0")),
            data_shards=json.loads(e.get("EDL_DATA_SHARDS", "[]")),
            checkpoint_dir=e.get("EDL_CHECKPOINT_DIR", ""),
            checkpoint_interval=int(e.get("EDL_CHECKPOINT_INTERVAL", "1000")),
            termination_log=e.get("EDL_TERMINATION_LOG", "/dev/termination-log"),
            state_file=e.get("EDL_STATE_FILE", ""),
            run_id=e.get("EDL_RUN_ID", ""),
        )

    @property
    def failure_threshold(self) -> int:
        """Lifetime failed-trainer budget before new trainers refuse to start:
        0 for strict jobs; for fault-tolerant jobs the job's LARGEST trainer
        count (ref: docker/paddle_k8s:123,147 uses $TRAINERS — but an elastic
        job scales past min_instance, and gating replacements on the smallest
        size would wedge a mostly-healthy scaled-up job)."""
        if not self.fault_tolerant:
            return 0
        return max(self.num_trainers, self.max_trainers)


def _write_termination_log(ctx: LaunchContext, reason: str) -> None:
    try:
        with open(ctx.termination_log, "w") as f:
            f.write(reason)
    except OSError:
        log.warning("cannot write termination log %s", ctx.termination_log)


def check_failed_count(client, threshold: int) -> int:
    """Read the job-wide failure counter; raise if over budget
    (ref: check_failed_cnt, `docker/paddle_k8s:34-42`)."""
    raw = client.kv_get(FAILED_COUNT_KEY)
    failed = int(raw) if raw else 0
    if failed > threshold:
        raise RuntimeError(
            f"job failure budget exhausted: {failed} trainer failures > {threshold}"
        )
    return failed


def _bump_failed_count(client) -> None:
    client.kv_incr(FAILED_COUNT_KEY)  # server-side atomic: no lost increments


# -- roles --------------------------------------------------------------------


def start_coordinator(ctx: LaunchContext, block: bool = True):
    """Run the native coordinator on ctx.port and seed the shard queue.

    The reference's master pod runs `/usr/bin/master` with an etcd sidecar
    (`docker/paddle_k8s:26-32`, `pkg/jobparser.go:167-227`); our native
    service holds its own state, so there is no sidecar to babysit.
    """
    from edl_tpu_torch.coordinator.server import CoordinatorServer, CoordinatorSupervisor

    state_file = ctx.state_file or os.path.join(
        ctx.workspace or ".", f"{ctx.job_name}-coordinator-state.jsonl"
    )
    # host="0.0.0.0" is deliberate and launcher-only: trainer pods on other
    # hosts dial the coordinator service, so the pod role must expose the
    # port; the binary itself defaults to loopback (unauthenticated protocol).
    # run_id keeps a reused workspace's stale state file from being resumed.
    server = CoordinatorServer(
        port=ctx.port,
        host="0.0.0.0",
        state_file=state_file,
        run_id=ctx.run_id or f"{ctx.namespace}/{ctx.job_name}",
    )
    server.start()
    if ctx.data_shards:
        from edl_tpu_torch.runtime.data import pass_tasks

        # Multi-pass (spec.passes; ref --num_passes, docker/paddle_k8s:205-216):
        # every pass's visit of every shard is its own lease, seeded upfront
        # pass-major so pass 0 drains first. Idempotent across restarts: the
        # server dedups against its restored todo/leased/done sets, so
        # re-seeding never replays completed visits.
        with server.client("launcher-seed") as c:
            added = c.add_tasks(pass_tasks(ctx.data_shards, ctx.passes))
        log.info("seeded %d shard visits (%d shards x %d passes)",
                 added, len(ctx.data_shards), max(1, ctx.passes))
    if not block:
        return server
    # Supervised: a crashed coordinator process is restarted in place (same
    # port, same state_file, same run_id), so it resumes its journal and
    # bumps the epoch — the master-ReplicaSet role the reference delegated
    # to Kubernetes (`pkg/controller.go:119-134`). Only a crash LOOP past
    # the supervisor's budget fails the pod.
    supervisor = CoordinatorSupervisor(server)
    supervisor.start()
    try:
        while True:
            rc = server.poll()
            if rc is not None and supervisor.restarts >= supervisor.max_restarts:
                raise RuntimeError(
                    f"coordinator crash-looped (rc={rc}) after "
                    f"{supervisor.restarts} restarts; giving up"
                )
            time.sleep(0.5)
    finally:
        supervisor.stop()


#: entry exit code meaning "world size changed: relaunch me at the new one".
#: A multi-host worker cannot rebuild its distributed world in-process
#: (world size is fixed at initialize), so it checkpoints and exits with this
#: code; the launcher restarts the entry, which re-initializes at the new
#: world and restores. 75 = EX_TEMPFAIL ("temporary failure, retry").
RESCALE_EXIT_CODE = 75


def start_trainer(
    ctx: LaunchContext,
    extra_env: Optional[Dict[str, str]] = None,
    max_rescale_restarts: int = 64,
) -> int:
    """Gate, wait, exec ENTRY; account failures. Returns the child's exit code
    (ref: start_new_trainer, `docker/paddle_k8s:121-143`).

    An entry exiting with RESCALE_EXIT_CODE is relaunched in place (warm
    restart: the pod, its cached compilation state, and its data stay put —
    only the distributed runtime re-initializes), without touching the job-wide
    failure budget."""
    if not ctx.entry:
        raise ValueError("EDL_ENTRY is required for start_trainer")
    client = wait_coordinator(ctx.coordinator_endpoint)
    try:
        check_failed_count(client, ctx.failure_threshold)
    except RuntimeError as e:
        _write_termination_log(ctx, str(e))
        client.close()
        return 1

    env = dict(os.environ)
    env.update(extra_env or {})
    cwd = ctx.workspace or None
    # Forward pod termination to the entry: K8s (and ProcessCluster)
    # SIGTERM the launcher — pod PID 1. Without forwarding, the training
    # child outlives its pod as an orphan, holding gang membership and
    # shard leases until TTL expiry (the slow path a graceful drain
    # exists to avoid).
    import signal as _signal

    from edl_tpu_torch.runtime.signals import main_thread_signal

    state = {"proc": None, "terminating": False}

    def _forward(signum, frame):
        state["terminating"] = True
        p = state["proc"]
        if p is not None and p.poll() is None:
            p.send_signal(_signal.SIGTERM)

    proc = None
    with main_thread_signal(_signal.SIGTERM, _forward):
        for restart in range(max_rescale_restarts + 1):
            if state["terminating"]:
                break  # signal landed between restarts: nothing to relaunch
            log.info("exec: %s (cwd=%s, restart=%d)",
                     ctx.entry, cwd or ".", restart)
            proc = subprocess.Popen(shlex.split(ctx.entry), env=env, cwd=cwd)
            state["proc"] = proc
            if state["terminating"] and proc.poll() is None:
                # Signal landed after the spawn but before the handler could
                # see this proc: forward by hand so the fresh child drains.
                proc.send_signal(_signal.SIGTERM)
            proc.wait()
            if proc.returncode != RESCALE_EXIT_CODE or state["terminating"]:
                break
            log.info("entry requested rescale restart (exit %d)",
                     RESCALE_EXIT_CODE)
    if proc is None:  # terminated before the first spawn
        _write_termination_log(ctx, "terminated before entry launch")
        client.close()
        return 0
    if state["terminating"] and proc.returncode in (RESCALE_EXIT_CODE,
                                                    -_signal.SIGTERM):
        # Pod deletion, not a crash: the entry either drained (rescale
        # exit) or died to the forwarded SIGTERM before its drain handler
        # was up (interpreter startup / first jit). Neither may burn the
        # job-wide failure budget — repeated clean scale-downs would brick
        # the job against check_failed_count.
        reason = "terminated by pod deletion"
        _write_termination_log(ctx, reason)
        client.close()
        return 0
    reason = map_exit_code(proc.returncode)
    _write_termination_log(ctx, reason)
    if proc.returncode != 0:
        log.error("trainer entry failed: %s", reason)
        try:
            _bump_failed_count(client)
        except CoordinatorError:
            pass
    client.close()
    return proc.returncode


# -- CLI (ref: the case dispatch, docker/paddle_k8s:238-263) -------------------


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="edl-launch", description="EDL-TPU pod role launcher"
    )
    parser.add_argument("role", choices=["start_coordinator", "start_trainer"])
    parser.add_argument("--port", type=int, default=None,
                        help="override EDL_PORT (coordinator role)")
    parser.add_argument("--entry", default=None, help="override EDL_ENTRY")
    parser.add_argument("--log-level", default="info",
                        choices=["debug", "info", "warning", "error"])
    parser.add_argument("--log-format", default=os.environ.get(
                            "EDL_LOG_FORMAT", "text"),
                        choices=["text", "json"],
                        help="json = one JSON object per log line; also "
                             "settable via EDL_LOG_FORMAT (pod manifests)")
    args = parser.parse_args(argv)

    from edl_tpu_torch.obs.logs import configure_logging

    configure_logging(level=args.log_level, fmt=args.log_format)
    ctx = LaunchContext.from_env()
    if args.port is not None:
        ctx.port = args.port
    if args.entry is not None:
        ctx.entry = args.entry

    if args.role == "start_coordinator":
        start_coordinator(ctx)
        return 0
    return start_trainer(ctx)


if __name__ == "__main__":
    sys.exit(main())
