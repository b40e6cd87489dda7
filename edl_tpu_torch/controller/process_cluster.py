"""ProcessCluster: a ClusterProvider that runs roles as local subprocesses.

The third backend next to ``FakeCluster`` (accounting only) and ``K8sCluster``
(real cluster): role workloads become real OS processes on this machine, with
node-granular TPU-chip accounting kept like the fake's. This is the
single-host "minikube mode" the reference demos its elasticity tutorial on
(`doc/boss_tutorial.md:163-301`) — the control plane's scale
decisions spawn and reap actual trainer processes, so autoscaler → coordinator
→ warm-restart is exercisable end-to-end with no Kubernetes.

Mapping (ref: pkg/cluster.go:91-113,245-291):

- ``create_role``            — spawn ``replicas`` processes from the
  workload's entrypoint + env (each gets ``EDL_POD_NAME``).
- ``set_trainer_parallelism``— reconcile the live process count: spawn more,
  or SIGTERM the newest extras (K8s Job parallelism-reduction order).
- ``job_pods``               — phase from the process state: Running while
  alive, Succeeded/Failed from the exit code, Pending when unplaceable.
- ``delete_role``            — terminate everything carrying the label.

A copy of the JAX package's ``edl_tpu/controller/process_cluster.py``. Pods
inherit this process's environment, as the JAX package's do: a pod names no
card of its own, so the trainers of one host share its cards. Two
departures: a pod's teardown kills what is left of its process group once
its leader has exited (the JAX package's leaves a coordinator pod's native
server running), and ``shutdown`` takes the grace a pod gets before its
group is killed, so a caller with a deadline can bound the teardown.
"""

from __future__ import annotations

import logging
import os
import shlex
import subprocess
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from edl_tpu_torch.api.quantity import ResourceList
from edl_tpu_torch.controller.cluster import NodeInfo, PodInfo, inquire_resource

log = logging.getLogger("edl_tpu_torch.controller.process_cluster")


@dataclass
class _ProcPod:
    info: PodInfo
    proc: Optional[subprocess.Popen] = None
    log_path: str = ""
    #: spawn spec, kept for Pending pods that place later.
    entrypoint: str = ""
    env: Dict[str, str] = field(default_factory=dict)
    workspace: str = ""


class ProcessCluster:
    """Local-process ClusterProvider with FakeCluster-style chip accounting."""

    def __init__(self, nodes: List[NodeInfo], log_dir: Optional[str] = None):
        self._lock = threading.RLock()
        self.nodes = list(nodes)
        self.pods: List[_ProcPod] = []
        self._parallelism: Dict[str, int] = {}
        self._templates: Dict[str, Dict[str, object]] = {}  # job -> role -> workload
        self._counter = 0
        self.log_dir = log_dir
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)

    # -- provider interface ----------------------------------------------------

    def inquire(self):
        with self._lock:
            self._reap()
            self._reschedule()
            return inquire_resource(self.nodes, [p.info for p in self.pods])

    def job_pods(self, job_name: str, role: str = "trainer") -> List[PodInfo]:
        with self._lock:
            self._reap()
            return [
                p.info for p in self.pods
                if p.info.job_name == job_name and p.info.role == role
            ]

    def get_trainer_parallelism(self, job_name: str) -> int:
        with self._lock:
            if job_name not in self._parallelism:
                raise KeyError(f"unknown trainer job {job_name}")
            return self._parallelism[job_name]

    def set_trainer_parallelism(self, job_name: str, parallelism: int) -> None:
        with self._lock:
            if job_name not in self._parallelism:
                raise KeyError(f"unknown trainer job {job_name}")
            self._parallelism[job_name] = parallelism
            self._reconcile(job_name)

    def create_role(self, job_name: str, role: str, replicas: int,
                    requests: ResourceList, limits: ResourceList,
                    workload=None) -> None:
        with self._lock:
            if role == "trainer":
                self._parallelism[job_name] = replicas
            self._templates.setdefault(job_name, {})[role] = (
                replicas, requests, limits, workload
            )
            for _ in range(replicas):
                self._spawn(job_name, role, requests, limits, workload)

    def delete_role(self, job_name: str, role: str) -> None:
        with self._lock:
            doomed = [p for p in self.pods
                      if p.info.job_name == job_name and p.info.role == role]
            for pod in doomed:
                self._terminate(pod)
                self.pods.remove(pod)
            if role == "trainer":
                self._parallelism.pop(job_name, None)

    # -- process management ----------------------------------------------------

    def wait_all(self, timeout: float = 300.0) -> None:
        """Block until every live process exits (test/driver convenience)."""
        with self._lock:
            procs = [p.proc for p in self.pods if p.proc is not None]
        for proc in procs:
            proc.wait(timeout=timeout)
        with self._lock:
            self._reap()

    def shutdown(self, grace: float = 10.0) -> None:
        """Terminate every pod, each given ``grace`` seconds after its
        SIGTERM before its whole group is killed."""
        with self._lock:
            for pod in self.pods:
                self._terminate(pod, grace=grace)
            self.pods.clear()

    def _spawn(self, job_name: str, role: str, requests: ResourceList,
               limits: ResourceList, workload) -> _ProcPod:
        self._counter += 1
        name = f"{job_name}-{role}-{self._counter}"
        pod = _ProcPod(
            info=PodInfo(name=name, job_name=job_name, role=role,
                         phase="Pending", requests=requests.copy(),
                         limits=limits.copy()),
        )
        if workload is not None:
            pod.entrypoint = workload.entrypoint
            pod.env = dict(workload.env)
            pod.workspace = getattr(workload, "workspace", "") or ""
        self.pods.append(pod)
        self._place_and_start(pod)
        return pod

    def _place_and_start(self, pod: _ProcPod) -> None:
        snap = inquire_resource(
            self.nodes, [p.info for p in self.pods if p is not pod]
        )
        node = snap.search_assignable_node(pod.info.requests)
        if node is None:
            return  # stays Pending; _reschedule retries
        pod.info.node = node
        if not pod.entrypoint:
            pod.info.phase = "Running"  # accounting-only pod (no workload)
            return
        env = dict(os.environ)
        env.update(pod.env)
        env["EDL_POD_NAME"] = pod.info.name
        stdout = subprocess.DEVNULL
        if self.log_dir:
            pod.log_path = os.path.join(self.log_dir, f"{pod.info.name}.log")
            stdout = open(pod.log_path, "w")
        try:
            # Each pod is a process GROUP (session): a pod kill must take the
            # launcher AND its training children down together, the way a
            # K8s pod sandbox teardown does — an orphaned trainer would keep
            # heartbeating and holding leases for a "deleted" pod.
            pod.proc = subprocess.Popen(
                shlex.split(pod.entrypoint), env=env,
                cwd=pod.workspace or None,
                stdout=stdout, stderr=subprocess.STDOUT,
                start_new_session=True,
            )
            pod.info.phase = "Running"
            log.info("spawned %s: %s (pid %d)",
                     pod.info.name, pod.entrypoint, pod.proc.pid)
        except OSError as e:
            log.error("spawn of %s failed: %s", pod.info.name, e)
            pod.info.phase = "Failed"
        finally:
            if stdout is not subprocess.DEVNULL:
                stdout.close()

    def _terminate(self, pod: _ProcPod, grace: float = 10.0) -> None:
        import signal

        if pod.proc is None:
            return
        if pod.proc.poll() is None:
            # SIGTERM to the leader only (K8s signals PID 1; the launcher
            # forwards to its entry for the graceful drain)...
            pod.proc.terminate()
            try:
                pod.proc.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                # ...but the grace-expiry escalation kills the whole pod
                # group, like a sandbox teardown: killing only a wedged
                # leader would orphan trainer children that keep
                # heartbeating and holding leases while the cluster re-books
                # their chips.
                try:
                    os.killpg(os.getpgid(pod.proc.pid), signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pod.proc.kill()
                pod.proc.wait()
        # Once the leader is gone, whatever is left of its group goes too, as
        # a container's other processes die with its PID 1: a coordinator
        # pod's leader dies on SIGTERM at once and would otherwise orphan
        # its native server, still holding the job's port and state file.
        # The group's id is the leader's pid (each pod is a new session).
        try:
            os.killpg(pod.proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass

    def _reap(self) -> None:
        for pod in self.pods:
            if pod.proc is not None and pod.info.phase == "Running":
                rc = pod.proc.poll()
                if rc is not None:
                    pod.info.phase = "Succeeded" if rc == 0 else "Failed"

    def _reconcile(self, job_name: str) -> None:
        want = self._parallelism[job_name]
        live = [p for p in self.pods
                if p.info.job_name == job_name and p.info.role == "trainer"
                and p.info.phase in ("Pending", "Running")]
        if len(live) > want:
            # Newest-first eviction (K8s Job parallelism reduction). SIGTERM
            # gives the worker its leave()/checkpoint path; survivors observe
            # the membership epoch bump and rescale.
            for pod in live[want:]:
                self._terminate(pod)
                self.pods.remove(pod)
        elif len(live) < want:
            template = self._templates.get(job_name, {}).get("trainer")
            if template is None:
                return
            _, requests, limits, workload = template
            for _ in range(want - len(live)):
                self._spawn(job_name, "trainer", requests, limits, workload)

    def _reschedule(self) -> None:
        for pod in self.pods:
            if pod.info.phase == "Pending":
                self._place_and_start(pod)

    # -- chaos / failure-recovery surface --------------------------------------

    def kill_pod(self, pod_name: str) -> None:
        """SIGKILL the whole pod (process group) — a node crash / OOM kill /
        forced eviction: no SIGTERM, no drain, no termination log. The pod
        reaps to Failed; `restart_failed` models the Job controller's
        replacement."""
        import signal

        with self._lock:
            for pod in self.pods:
                if pod.info.name == pod_name and pod.proc is not None:
                    delivered = True
                    try:
                        os.killpg(os.getpgid(pod.proc.pid), signal.SIGKILL)
                    except ProcessLookupError:
                        pass  # already gone; reap below
                    except PermissionError:
                        delivered = False  # never block the cluster lock
                        pod.proc.kill()    # waiting on an unkilled group
                    if delivered:
                        pod.proc.wait()
                    else:
                        try:
                            pod.proc.wait(timeout=5.0)
                        except subprocess.TimeoutExpired:
                            pass
                    self._reap()
                    return
        raise KeyError(f"no live pod {pod_name}")

    def restart_failed(self, job_name: str, role: str = "trainer") -> int:
        """The K8s controller's reconcile for crashed pods: replace Failed
        pods of ``role`` with fresh ones up to the role's target count —
        the job's parallelism for trainers, the created replica count for
        every other role. A replaced trainer registers as a new worker and
        the dead one's membership/leases expire by TTL; a replaced
        COORDINATOR pod re-runs its workload with the same EDL_* env —
        same port, state_file, and run_id — so it resumes its journal
        (the master-ReplicaSet recovery, `pkg/controller.go:119-134`).
        Returns pods spawned."""
        with self._lock:
            self._reap()
            template = self._templates.get(job_name, {}).get(role)
            if template is None:
                return 0
            if role == "trainer" and job_name not in self._parallelism:
                return 0
            failed = [p for p in self.pods
                      if p.info.job_name == job_name
                      and p.info.role == role
                      and p.info.phase == "Failed"]
            for pod in failed:  # terminal records: GC like a Job controller
                self.pods.remove(pod)
            before = len(self.pods)
            if role == "trainer":
                self._reconcile(job_name)  # the spawn-up half lives there
            else:
                replicas, requests, limits, workload = template
                live = [p for p in self.pods
                        if p.info.job_name == job_name and p.info.role == role
                        and p.info.phase in ("Pending", "Running")]
                for _ in range(max(0, replicas - len(live))):
                    self._spawn(job_name, role, requests, limits, workload)
            return len(self.pods) - before
