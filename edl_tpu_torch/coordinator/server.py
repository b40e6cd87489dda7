"""Lifecycle manager for the native coordinator binary.

Builds `native/coordinator` on first use (make), spawns it as a subprocess on
a free port, and tears it down — the role the controller's master-ReplicaSet
materialization plays in the reference (`pkg/controller.go:119-134`,
`pkg/jobparser.go:167-227`), minus Kubernetes.
"""

from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import threading
import time
from typing import Dict, List, Optional

from edl_tpu_torch.coordinator.client import CoordinatorClient, CoordinatorError

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO_ROOT, "native", "coordinator")
BINARY = os.path.join(NATIVE_DIR, "edl-coordinator")

#: EDL_COORD_SANITIZER -> (make target, binary name). The sanitizer pytest
#: lane sets the env var so every CoordinatorServer in the process — chaos
#: proxies, supervisors, batch tests — runs against the instrumented binary.
SANITIZER_VARIANTS: Dict[str, str] = {
    "": "edl-coordinator",
    "tsan": "edl-coordinator-tsan",
    "asan": "edl-coordinator-asan",
}


def sanitizer_variant() -> str:
    """Active sanitizer variant ('' when none) from EDL_COORD_SANITIZER."""
    variant = os.environ.get("EDL_COORD_SANITIZER", "").strip().lower()
    if variant not in SANITIZER_VARIANTS:
        raise CoordinatorError(
            f"EDL_COORD_SANITIZER={variant!r} — expected one of "
            f"{sorted(SANITIZER_VARIANTS)}"
        )
    return variant


def ensure_built(timeout: float = 120.0, variant: Optional[str] = None) -> str:
    """Build the coordinator binary (the ``variant``'s, default from
    EDL_COORD_SANITIZER); returns its path.

    Always invokes make — it no-ops in milliseconds when the binary is fresh,
    and rebuilds after source edits (a stale-binary check by existence alone
    would silently keep old protocol semantics live).
    """
    if variant is None:
        variant = sanitizer_variant()
    name = SANITIZER_VARIANTS[variant]
    binary = os.path.join(NATIVE_DIR, name)
    proc = subprocess.run(
        ["make", "-C", NATIVE_DIR, name],
        capture_output=True,
        text=True,
        timeout=timeout,
    )
    if proc.returncode != 0 or not os.path.exists(binary):
        raise CoordinatorError(
            f"failed to build coordinator ({name}): "
            f"{proc.stdout}\n{proc.stderr}"
        )
    return binary


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class CoordinatorServer:
    """Spawn/own one coordinator process."""

    def __init__(
        self,
        port: Optional[int] = None,
        task_lease_sec: float = 16.0,  # ref: -task-timout-dur 16s
        heartbeat_ttl_sec: float = 10.0,
        host: str = "127.0.0.1",
        state_file: Optional[str] = None,
        run_id: Optional[str] = None,
        auth_token: Optional[str] = None,
        shards: Optional[List[str]] = None,
        shard_index: int = -1,
        num_shards: int = 0,
        extra_env: Optional[Dict[str, str]] = None,
    ):
        self.port = port or free_port()
        self.task_lease_sec = task_lease_sec
        self.heartbeat_ttl_sec = heartbeat_ttl_sec
        #: loopback by default — the protocol is unauthenticated, so binding
        #: beyond loopback is an explicit deployment decision (the pod
        #: launcher passes host="0.0.0.0": cross-host trainers must dial in).
        self.host = host
        #: durability log path for queue/done/kv/epoch; a restarted server
        #: with the same state_file (and run_id) resumes instead of replaying
        #: the whole dataset (the reference's etcd-sidecar role).
        self.state_file = state_file
        #: identity stamped into the state file; a mismatched file (another
        #: run's leftovers in the same workspace) is discarded, not resumed.
        self.run_id = run_id
        #: per-job shared secret (EDL_COORD_TOKEN). None inherits whatever
        #: the launching pod's env carries (the controller stamps it into
        #: every pod); "" explicitly disables auth.
        self.auth_token = auth_token if auth_token is not None \
            else os.environ.get("EDL_COORD_TOKEN", "")
        #: sharded-root mode (--shards): host:port per shard server; the
        #: process serves only membership/epoch/watch and redirects every
        #: keyspace op by key hash.
        self.shards = list(shards or [])
        #: shard-server mode (--shard-index/--num-shards): serves its slice
        #: of the keyspace; membership lives on the root.
        self.shard_index = shard_index
        self.num_shards = num_shards
        #: extra environment stamped into the child on every start() —
        #: the EDL010 native-oracle lane injects its crash hooks
        #: (EDL_COORD_CRASH_AFTER_APPENDS, ...) here, and clears them
        #: before the post-crash restart. Mutable between restarts.
        self.extra_env: Dict[str, str] = dict(extra_env or {})
        self._proc: Optional[subprocess.Popen] = None
        self._stderr_path: Optional[str] = None
        #: stderr of the last exited/stopped process (sanitizer reports live
        #: here after stop()) — capped, never None.
        self.last_stderr: str = ""

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"

    def start(self, wait: float = 10.0) -> "CoordinatorServer":
        binary = ensure_built()
        argv = [
            binary,
            "--port", str(self.port),
            "--host", self.host,
            "--task-lease-sec", str(self.task_lease_sec),
            "--heartbeat-ttl-sec", str(self.heartbeat_ttl_sec),
        ]
        if self.state_file:
            argv += ["--state-file", self.state_file]
        if self.run_id:
            argv += ["--run-id", self.run_id]
        if self.shards:
            argv += ["--shards", ",".join(self.shards)]
        if self.shard_index >= 0 and self.num_shards > 0:
            argv += ["--shard-index", str(self.shard_index),
                     "--num-shards", str(self.num_shards)]
        env = dict(os.environ)
        # Token travels by env, never argv (/proc/<pid>/cmdline is world-
        # readable); an empty token scrubs any inherited one so a
        # no-auth server can't accidentally enforce the pod's secret.
        if self.auth_token:
            env["EDL_COORD_TOKEN"] = self.auth_token
        else:
            env.pop("EDL_COORD_TOKEN", None)
        # Sanitizer runs must fail loudly: a distinct exit code separates
        # "TSan/ASan found something" from crashes the chaos tests inject.
        env.setdefault("TSAN_OPTIONS", "exitcode=66")
        env.setdefault("ASAN_OPTIONS", "exitcode=66")
        env.setdefault("UBSAN_OPTIONS", "print_stacktrace=1")
        env.update(self.extra_env)
        # stderr goes to a file, not DEVNULL: sanitizer reports (and crash
        # diagnostics) must survive the process; sanitizer_report() reads it.
        fd, self._stderr_path = tempfile.mkstemp(
            prefix="edl-coordinator-", suffix=".stderr"
        )
        try:
            self._proc = subprocess.Popen(
                argv,
                stdout=subprocess.DEVNULL,
                stderr=fd,
                env=env,
            )
        finally:
            os.close(fd)
        deadline = time.monotonic() + wait
        while time.monotonic() < deadline:
            try:
                with CoordinatorClient(port=self.port, connect_timeout=0.5) as c:
                    if c.ping():
                        return self
            except CoordinatorError:
                pass
            if self._proc.poll() is not None:
                rc = self._proc.returncode
                self._proc = None
                self._harvest_stderr()
                raise CoordinatorError(
                    f"coordinator exited at startup (rc={rc}): "
                    f"{self.last_stderr[-500:]}"
                )
            time.sleep(0.05)
        self.stop()  # don't leak the subprocess (and its port) on timeout
        raise CoordinatorError("coordinator did not become ready")

    def _harvest_stderr(self) -> None:
        """Fold the child's stderr file into ``last_stderr`` (capped) and
        remove it — no temp-file leaks across chaos restarts."""
        if self._stderr_path is None:
            return
        try:
            with open(self._stderr_path, "r", errors="replace") as f:
                # Accumulate across restarts: a sanitizer report from an
                # earlier incarnation must survive a supervisor's respawn.
                self.last_stderr = (self.last_stderr + f.read())[-65536:]
        except OSError:
            pass
        try:
            os.unlink(self._stderr_path)
        except OSError:
            pass
        self._stderr_path = None

    def sanitizer_report(self) -> str:
        """Stderr of the running process (or of the last one after stop) —
        where TSan/ASan write their reports. Empty string when clean."""
        if self._stderr_path is not None:
            try:
                with open(self._stderr_path, "r", errors="replace") as f:
                    return (self.last_stderr + f.read())[-65536:]
            except OSError:
                return self.last_stderr
        return self.last_stderr

    def poll(self) -> Optional[int]:
        """None while the coordinator process runs; its exit code otherwise."""
        if self._proc is None:
            return -1
        return self._proc.poll()

    def wait(self) -> int:
        """Block until the coordinator process exits; returns its exit code."""
        if self._proc is None:
            return -1
        return self._proc.wait()

    def kill(self) -> None:
        """Hard-kill (SIGKILL) without graceful shutdown — for crash tests
        exercising --state-file durability."""
        if self._proc is not None:
            self._proc.kill()
            self._proc.wait()
            self._proc = None
        self._harvest_stderr()

    def stop(self) -> None:
        if self._proc is not None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
            self._proc = None
        self._harvest_stderr()

    def restart(self, wait: float = 10.0) -> "CoordinatorServer":
        """Bring a dead (or killed) coordinator back on the SAME port with
        the same state_file + run_id, so it resumes its queue/done/kv and
        reconnecting clients need no re-discovery. Stops any still-running
        process first (idempotent under supervision races)."""
        self.stop()
        return self.start(wait=wait)

    def client(self, worker: str = "") -> CoordinatorClient:
        return CoordinatorClient(port=self.port, worker=worker,
                                 token=self.auth_token)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class ShardedCoordinator:
    """One partitioned control plane: a thin ROOT plus K shard servers.

    The root owns membership, epochs, and watch subscriptions; every
    keyspace op (KV, task leases, checkpoint shards) is redirected by FNV-1a
    key hash to one of the shard servers, which each journal their own
    slice. Clients learn the layout from the root's redirect/``shard_map``
    replies (`CoordinatorClient` caches it and routes directly after the
    first bounce), so the root's per-op work stops growing with keyspace
    traffic — only membership scales on it.

    Start order matters: shard servers come up first so the root never
    advertises an endpoint that refuses connections.
    """

    def __init__(self, num_shards: int = 2,
                 task_lease_sec: float = 16.0,
                 heartbeat_ttl_sec: float = 10.0,
                 auth_token: Optional[str] = None,
                 state_dir: Optional[str] = None,
                 run_id: Optional[str] = None):
        def state(name: str) -> Optional[str]:
            return os.path.join(state_dir, f"{name}.state") \
                if state_dir else None

        self.shards = [
            CoordinatorServer(
                task_lease_sec=task_lease_sec,
                heartbeat_ttl_sec=heartbeat_ttl_sec,
                auth_token=auth_token, run_id=run_id,
                state_file=state(f"shard{i}"),
                shard_index=i, num_shards=num_shards,
            )
            for i in range(num_shards)
        ]
        self.root = CoordinatorServer(
            task_lease_sec=task_lease_sec,
            heartbeat_ttl_sec=heartbeat_ttl_sec,
            auth_token=auth_token, run_id=run_id,
            state_file=state("root"),
            shards=[s.address for s in self.shards],
        )

    @property
    def port(self) -> int:
        return self.root.port

    @property
    def address(self) -> str:
        return self.root.address

    def start(self, wait: float = 10.0) -> "ShardedCoordinator":
        started = []
        try:
            for s in self.shards:
                s.start(wait=wait)
                started.append(s)
            self.root.start(wait=wait)
        except CoordinatorError:
            for s in started:
                s.stop()
            raise
        return self

    def stop(self) -> None:
        self.root.stop()
        for s in self.shards:
            s.stop()

    def client(self, worker: str = "") -> CoordinatorClient:
        return self.root.client(worker)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class CoordinatorSupervisor:
    """Keep one coordinator process alive — the master-ReplicaSet role.

    The reference delegates this to Kubernetes: the master Deployment's
    ReplicaSet re-creates a dead master pod, and etcd preserves its state
    (`pkg/controller.go:119-134`). Here a watch thread polls the child and
    restarts it through :meth:`CoordinatorServer.restart` — same port, same
    ``state_file``, same ``run_id`` — so the resurrected process resumes
    the journal, bumps the epoch, and requeues live leases exactly as a
    planned restart would. Workers ride the outage on their retry policy.

    Metrics (``restarts``, ``downtime_seconds``, ``last_restart_rc``) feed
    the collector's cluster samples.
    """

    def __init__(self, server: CoordinatorServer, poll_interval: float = 0.2,
                 max_restarts: int = 100):
        self.server = server
        self.poll_interval = poll_interval
        #: crash-loop bound: a coordinator that cannot stay up (bad state
        #: path, port stolen) should fail the job, not flap forever.
        self.max_restarts = max_restarts
        self.restarts = 0
        self.downtime_seconds = 0.0
        self.last_restart_rc: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def start(self) -> "CoordinatorSupervisor":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(  # edl: noqa[EDL001] lifecycle field; start/stop are owner-thread-only by contract
            target=self._watch, name="edl-coordinator-supervisor", daemon=True
        )
        self._thread.start()
        return self

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_interval):
            rc = self.server.poll()
            if rc is None:
                continue
            if self.restarts >= self.max_restarts:
                return
            down_at = time.monotonic()
            try:
                self.server.restart()
            except CoordinatorError:
                # Startup failed (port race with the dying process, transient
                # fs error): loop and retry until max_restarts — supervision
                # must outlive one bad attempt.
                continue
            finally:
                with self._lock:
                    self.last_restart_rc = rc
                    self.restarts += 1
                    self.downtime_seconds += time.monotonic() - down_at

    def stop(self) -> None:
        """Stop supervising, then stop the coordinator itself."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None  # edl: noqa[EDL001] lifecycle field; start/stop are owner-thread-only by contract
        self.server.stop()

    def summary(self) -> Dict[str, float]:
        with self._lock:
            return {
                "restarts": float(self.restarts),
                "downtime_seconds": self.downtime_seconds,
                "last_restart_rc": float(self.last_restart_rc)
                if self.last_restart_rc is not None else -1.0,
            }

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
