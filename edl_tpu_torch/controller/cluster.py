"""Cluster resource accounting.

Equivalent of the reference's `pkg/cluster.go:32-291`: a snapshot type
(``ClusterResource``) the scheduler does arithmetic on, produced by scanning
nodes and non-terminated pods (``InquiryResource``, `pkg/cluster.go:176-242`),
plus the thin actuation edge (get/update trainer replica counts, create/delete
role workloads) behind a ``ClusterProvider`` interface.

TPU-native difference: alongside divisible cpu/memory, nodes carry an integer
``tpu`` chip count, and trainers consume chips in indivisible slice granules on
a single host (SURVEY §7 hard part 3) — so per-node idle accounting, which the
reference only used for memory node-fit (`pkg/autoscaler.go:191-199`), is
load-bearing for TPU placement.

The in-memory ``FakeCluster`` plays the role of the reference's generated fake
clientset (`pkg/client/clientset/versioned/fake/`): full controller loops are
testable with no real cluster behind them.

A copy of the JAX package's ``edl_tpu/controller/cluster.py`` with the
imports pointing at this package. The accelerator keeps the JAX package's
internal key ``tpu``, so one job YAML and one ResourceList read the same in
both packages; in this port the key counts H100 cards (``nvidia.com/gpu`` at
the Kubernetes edge, `k8s.cluster`).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol

from edl_tpu_torch.api.quantity import ResourceList


@dataclass
class NodeInfo:
    """Allocatable capacity of one host (TPU VM or CPU node)."""

    name: str
    allocatable: ResourceList = field(default_factory=ResourceList)


@dataclass
class PodInfo:
    """One running/pending workload replica, as the scheduler sees it."""

    name: str
    job_name: str
    role: str  # "trainer" | "coordinator"
    phase: str  # "Pending" | "Running" | "Succeeded" | "Failed"
    requests: ResourceList = field(default_factory=ResourceList)
    limits: ResourceList = field(default_factory=ResourceList)
    node: str = ""  # assigned node, "" if unscheduled


@dataclass
class ClusterResource:
    """Whole-cluster totals + per-node idle maps (ref: pkg/cluster.go:32-61).

    All quantities in base units. ``node_idle`` maps node name -> free
    ResourceList; the TPU scheduler's node-fit search runs over it.
    """

    total: ResourceList = field(default_factory=ResourceList)
    requested: ResourceList = field(default_factory=ResourceList)
    limited: ResourceList = field(default_factory=ResourceList)
    node_idle: Dict[str, ResourceList] = field(default_factory=dict)

    def copy(self) -> "ClusterResource":
        return ClusterResource(
            total=self.total.copy(),
            requested=self.requested.copy(),
            limited=self.limited.copy(),
            node_idle={k: v.copy() for k, v in self.node_idle.items()},
        )

    # -- scheduler arithmetic helpers -----------------------------------------

    def free(self, key: str) -> float:
        return self.total.get_q(key) - self.requested.get_q(key)

    def util(self, key: str) -> float:
        total = self.total.get_q(key)
        return self.requested.get_q(key) / total if total > 0 else 0.0

    def search_assignable_node(self, request: ResourceList) -> Optional[str]:
        """First node whose idle resources fit the request
        (ref: pkg/autoscaler.go:191-199). For TPU jobs this enforces the
        slice-granule constraint: all chips of one trainer on one host."""
        for name, idle in self.node_idle.items():
            if request.fits_within(idle):
                return name
        return None

    def assign(self, node: str, request: ResourceList) -> None:
        """Account a placement decision into the snapshot (dry-run mutation)."""
        self.requested.add(request)
        self.node_idle[node].sub(request)

    def release_any(self, request: ResourceList) -> None:
        """Account a scale-down: return resources to the emptiest-fit node.

        The reference adjusts only the global pools on scale-down
        (`pkg/autoscaler.go:209-217`); with indivisible TPU granules we must
        also return chips to a node pool so subsequent dry-run placements see
        them. Which node is approximate in a dry run — we pick the node with
        the least idle TPU (the fullest), emulating removing its trainer.
        """
        self.requested.sub(request)
        if not self.node_idle:
            return
        tpu_need = request.get_q("tpu")
        if tpu_need > 0:
            node = min(self.node_idle, key=lambda n: self.node_idle[n].get_q("tpu"))
        else:
            node = min(self.node_idle, key=lambda n: self.node_idle[n].get_q("cpu"))
        self.node_idle[node].add(request)


def inquire_resource(nodes: List[NodeInfo], pods: List[PodInfo]) -> ClusterResource:
    """Build a ClusterResource snapshot (ref: pkg/cluster.go:176-242).

    Scans allocatable capacity over nodes, accumulates requests/limits of all
    non-terminated pods (phase not in Succeeded/Failed), and derives per-node
    idle resources (ref: updateNodesIdleResource, pkg/cluster.go:156-173).
    """
    snap = ClusterResource()
    for node in nodes:
        snap.total.add(node.allocatable)
        snap.node_idle[node.name] = node.allocatable.copy()
    for pod in pods:
        if pod.phase in ("Succeeded", "Failed"):
            continue
        snap.requested.add(pod.requests)
        snap.limited.add(pod.limits)
        if pod.node and pod.node in snap.node_idle:
            snap.node_idle[pod.node].sub(pod.requests)
    return snap


class ClusterProvider(Protocol):
    """The I/O edge the controller/autoscaler drive (ref: pkg/cluster.go:91-291).

    Implementations: FakeCluster (tests / single-host), a Kubernetes provider
    (gated on the kubernetes client being installed), or a local process pool.
    """

    def inquire(self) -> ClusterResource: ...

    def job_pods(self, job_name: str, role: str = "trainer") -> List[PodInfo]: ...

    def get_trainer_parallelism(self, job_name: str) -> int: ...

    def set_trainer_parallelism(self, job_name: str, parallelism: int) -> None: ...

    def create_role(self, job_name: str, role: str, replicas: int,
                    requests: ResourceList, limits: ResourceList,
                    workload: Optional[object] = None) -> None:
        """Materialize a role. ``workload`` is the full RoleWorkload (image,
        entrypoint, env) — required by providers that launch real containers
        (K8sCluster); accounting-only providers may ignore it."""
        ...

    def delete_role(self, job_name: str, role: str) -> None: ...


class FakeCluster:
    """In-memory ClusterProvider with a toy bin-packing scheduler.

    Plays the role of the reference's fake clientset + the K8s scheduler: pods
    created here are placed first-fit onto nodes; unplaceable pods stay
    Pending — which is exactly the signal the autoscaler's pending-job logic
    (`pkg/autoscaler.go:406-422`) needs to trigger rebalancing.
    """

    def __init__(self, nodes: List[NodeInfo]):
        self._lock = threading.RLock()
        self.nodes = list(nodes)
        self.pods: List[PodInfo] = []
        self._parallelism: Dict[str, int] = {}
        self._role_templates: Dict[str, Dict[str, tuple]] = {}
        self._counter = 0

    # -- provider interface ----------------------------------------------------

    def inquire(self) -> ClusterResource:
        with self._lock:
            self._reschedule()
            return inquire_resource(self.nodes, self.pods)

    def job_pods(self, job_name: str, role: str = "trainer") -> List[PodInfo]:
        with self._lock:
            return [p for p in self.pods if p.job_name == job_name and p.role == role]

    def get_trainer_parallelism(self, job_name: str) -> int:
        with self._lock:
            return self._parallelism.get(job_name, 0)

    def set_trainer_parallelism(self, job_name: str, parallelism: int) -> None:
        """The actual scale actuator (ref: pkg/cluster.go:91-113): reconcile
        the trainer pod set of the job to the new replica count."""
        with self._lock:
            if job_name not in self._parallelism:
                raise KeyError(f"unknown trainer job {job_name}")
            self._parallelism[job_name] = parallelism
            self._reconcile(job_name)

    def create_role(self, job_name: str, role: str, replicas: int,
                    requests: ResourceList, limits: ResourceList,
                    workload: Optional[object] = None) -> None:
        with self._lock:
            if role == "trainer":
                self._parallelism[job_name] = replicas
            self._role_templates.setdefault(job_name, {})[role] = (requests, limits)
            for _ in range(replicas):
                self._spawn(job_name, role, requests, limits)

    def delete_role(self, job_name: str, role: str) -> None:
        with self._lock:
            self.pods = [p for p in self.pods
                         if not (p.job_name == job_name and p.role == role)]
            if role == "trainer":
                self._parallelism.pop(job_name, None)

    # -- internals -------------------------------------------------------------

    def _spawn(self, job_name: str, role: str, requests: ResourceList,
               limits: ResourceList) -> PodInfo:
        self._counter += 1
        pod = PodInfo(
            name=f"{job_name}-{role}-{self._counter}",
            job_name=job_name, role=role, phase="Pending",
            requests=requests.copy(), limits=limits.copy(),
        )
        self.pods.append(pod)
        self._place(pod)
        return pod

    def _reconcile(self, job_name: str) -> None:
        want = self._parallelism[job_name]
        trainers = [p for p in self.pods if p.job_name == job_name and p.role == "trainer"
                    and p.phase in ("Pending", "Running")]
        if len(trainers) > want:
            # Evict newest-first, like K8s Job parallelism reduction.
            for pod in trainers[want:]:
                self.pods.remove(pod)
        elif len(trainers) < want:
            req, lim = self._role_templates.get(job_name, {}).get(
                "trainer", (ResourceList(), ResourceList()))
            for _ in range(want - len(trainers)):
                self._spawn(job_name, "trainer", req, lim)

    def _place(self, pod: PodInfo) -> None:
        snap = inquire_resource(self.nodes, [p for p in self.pods if p is not pod])
        node = snap.search_assignable_node(pod.requests)
        if node is not None:
            pod.node = node
            pod.phase = "Running"

    def _reschedule(self) -> None:
        for pod in self.pods:
            if pod.phase == "Pending":
                self._place(pod)
