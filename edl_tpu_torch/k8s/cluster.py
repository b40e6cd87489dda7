"""K8sCluster: the Kubernetes-backed ClusterProvider.

The production implementation of the `ClusterProvider` protocol
(`controller/cluster.py`), mirroring what the reference's
`Cluster` does against a live apiserver (`pkg/cluster.go`):

- ``inquire``           — scan node allocatables + non-terminated pod
  requests/limits into a ``ClusterResource`` snapshot (`cluster.go:176-242`).
- ``job_pods``          — label-selector pod listing (`cluster.go:117-136`).
- ``get/set_trainer_parallelism`` — the scale actuator: read/patch the trainer
  Job's ``spec.parallelism`` (`cluster.go:91-113`).
- ``create_role`` / ``delete_role`` — materialize the coordinator as a
  Deployment+Service and trainers as a batch Job, GC pods by label
  (`cluster.go:245-291`, `pkg/updater/trainingJobUpdater.go:99-207`).

The schedulable accelerator is the node resource ``nvidia.com/gpu`` (H100
cards on this host), surfaced internally under the ``tpu`` key the
autoscaler's granule-aware dry run consumes, as the reference counted
``nvidia.com/gpu`` (`pkg/cluster.go:224-232`).

A copy of the JAX package's ``edl_tpu/k8s/cluster.py`` with the imports
pointing at this package. One difference: the JAX package maps ``tpu`` to
``google.com/tpu``; here it maps to ``nvidia.com/gpu`` both ways, so pod
manifests request H100 cards and every other field of every manifest is the
JAX package's.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

from edl_tpu_torch.api.quantity import ResourceList, format_quantity, parse_quantity
from edl_tpu_torch.controller.cluster import NodeInfo, PodInfo, inquire_resource
from edl_tpu_torch.controller.jobparser import (
    LABEL_JOB,
    LABEL_ROLE,
    ROLE_COORDINATOR,
    ROLE_TRAINER,
    RoleWorkload,
    role_labels,
)
from edl_tpu_torch.k8s.client import ApiClient, ApiError

log = logging.getLogger("edl_tpu_torch.k8s.cluster")

#: the accelerator resource as the NVIDIA device plugin exposes it (one
#: H100 card a unit); mapped to the internal "tpu" key.
ACCELERATOR_RESOURCE = "nvidia.com/gpu"

#: internal key -> K8s resource name (identity except the accelerator).
_TO_K8S_KEY = {"tpu": ACCELERATOR_RESOURCE}
_FROM_K8S_KEY = {ACCELERATOR_RESOURCE: "tpu"}


def resources_from_k8s(spec: Optional[dict]) -> ResourceList:
    """K8s resource map (``{"cpu": "2", "nvidia.com/gpu": "4"}``) → ResourceList."""
    out = ResourceList()
    for key, value in (spec or {}).items():
        out[_FROM_K8S_KEY.get(key, key)] = float(parse_quantity(value))
    return out


def resources_to_k8s(rl: ResourceList) -> dict:
    """ResourceList → K8s resource map, cards as integer counts."""
    out = {}
    for key, value in rl.items():
        k8s_key = _TO_K8S_KEY.get(key, key)
        if key == "tpu":
            out[k8s_key] = str(int(value))
        else:
            out[k8s_key] = format_quantity(value)
    return out


def _selector(labels: Dict[str, str]) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))


def _pod_info(pod: dict) -> PodInfo:
    meta = pod.get("metadata", {})
    labels = meta.get("labels", {}) or {}
    requests = ResourceList()
    limits = ResourceList()
    spec = pod.get("spec", {}) or {}
    for container in spec.get("containers", []) or []:
        res = container.get("resources", {}) or {}
        requests.add(resources_from_k8s(res.get("requests")))
        limits.add(resources_from_k8s(res.get("limits")))
    return PodInfo(
        name=meta.get("name", ""),
        job_name=labels.get(LABEL_JOB, ""),
        role=labels.get(LABEL_ROLE, ""),
        phase=(pod.get("status", {}) or {}).get("phase", "Pending"),
        requests=requests,
        limits=limits,
        node=spec.get("nodeName", "") or "",
    )


class K8sCluster:
    """ClusterProvider over a live (or fake, in tests) kube-apiserver."""

    def __init__(self, api: ApiClient, namespace: Optional[str] = None):
        self.api = api
        self.namespace = namespace or api.config.namespace or "default"

    # -- naming ----------------------------------------------------------------

    @staticmethod
    def workload_name(job_name: str, role: str) -> str:
        return f"{job_name}-{role}"

    def _ns_path(self, group_version: str, kind: str, name: str = "") -> str:
        base = (
            f"/api/{group_version}" if group_version == "v1"
            else f"/apis/{group_version}"
        )
        path = f"{base}/namespaces/{self.namespace}/{kind}"
        return f"{path}/{name}" if name else path

    # -- inquiry (ref: InquiryResource, pkg/cluster.go:176-242) ----------------

    def inquire(self):
        nodes = [
            NodeInfo(
                name=n.get("metadata", {}).get("name", ""),
                allocatable=resources_from_k8s(
                    (n.get("status", {}) or {}).get("allocatable")
                ),
            )
            for n in self.api.get("/api/v1/nodes").get("items", [])
        ]
        # All namespaces: other tenants' pods consume capacity too
        # (ref: Pods(all ns) listing, cluster.go:202-210).
        pods = [
            _pod_info(p) for p in self.api.get("/api/v1/pods").get("items", [])
        ]
        live = [p for p in pods if p.phase not in ("Succeeded", "Failed")]
        return inquire_resource(nodes, live)

    def job_pods(self, job_name: str, role: str = ROLE_TRAINER) -> List[PodInfo]:
        data = self.api.get(
            self._ns_path("v1", "pods"),
            params={"labelSelector": _selector(role_labels(job_name, role))},
        )
        return [_pod_info(p) for p in data.get("items", [])]

    # -- scale actuation (ref: Get/UpdateTrainerJob, pkg/cluster.go:91-113) ----

    def get_trainer_parallelism(self, job_name: str) -> int:
        try:
            job = self.api.get(
                self._ns_path(
                    "batch/v1", "jobs", self.workload_name(job_name, ROLE_TRAINER)
                )
            )
        except ApiError as e:
            if e.not_found:
                return 0
            raise
        return int((job.get("spec", {}) or {}).get("parallelism", 0))

    def set_trainer_parallelism(self, job_name: str, parallelism: int) -> None:
        name = self.workload_name(job_name, ROLE_TRAINER)
        try:
            self.api.patch(
                self._ns_path("batch/v1", "jobs", name),
                {"spec": {"parallelism": int(parallelism)}},
            )
        except ApiError as e:
            if e.not_found:
                raise KeyError(f"unknown trainer job {job_name}") from e
            raise

    # -- role materialization (ref: CreateJob/CreateReplicaSet,
    #    pkg/cluster.go:245-267; manifests pkg/jobparser.go:74-227) ------------

    def create_role(
        self,
        job_name: str,
        role: str,
        replicas: int,
        requests: ResourceList,
        limits: ResourceList,
        workload: Optional[RoleWorkload] = None,
    ) -> None:
        """Create the role's workload. ``workload`` carries image/entrypoint/
        env; without it a bare pause-style manifest is created (enough for
        accounting tests, not for a real job — the updater always passes it).
        """
        labels = role_labels(job_name, role)
        container = {
            "name": role,
            "image": workload.image if workload else "edl-tpu-torch:latest",
            "resources": {
                "requests": resources_to_k8s(requests),
                "limits": resources_to_k8s(limits),
            },
        }
        if workload:
            if workload.entrypoint:
                container["command"] = ["/bin/sh", "-c", workload.entrypoint]
            container["env"] = [
                {"name": k, "value": v} for k, v in sorted(workload.env.items())
            ]
        pod_template = {
            "metadata": {"labels": labels},
            "spec": {
                "containers": [container],
                # Ref: trainer RestartPolicy Never (`pkg/jobparser.go:160`) —
                # the Job controller replaces failed pods up to parallelism;
                # per-process retry policy lives in our launcher.
                "restartPolicy": "Never" if role == ROLE_TRAINER else "Always",
            },
        }
        if role == ROLE_COORDINATOR and workload:
            # Back the coordinator's state file (launch.py start_coordinator
            # keeps the task queue/done-set/KV there). With
            # spec.coordinator.state_pvc the volume is a PersistentVolumeClaim
            # — state survives pod RESCHEDULING, the full etcd-sidecar
            # durability story; otherwise a pod-lifetime emptyDir still
            # covers container crashes.
            workspace = workload.env.get("EDL_WORKSPACE")
            if workspace:
                if workload.state_pvc:
                    volume = {
                        "name": "coordinator-state",
                        "persistentVolumeClaim": {"claimName": workload.state_pvc},
                    }
                else:
                    volume = {"name": "coordinator-state", "emptyDir": {}}
                pod_template["spec"]["volumes"] = [volume]
                container["volumeMounts"] = [
                    {"name": "coordinator-state", "mountPath": workspace}
                ]
        name = self.workload_name(job_name, role)
        if role == ROLE_COORDINATOR:
            self._create(
                self._ns_path("apps/v1", "deployments"),
                {
                    "apiVersion": "apps/v1",
                    "kind": "Deployment",
                    "metadata": {"name": name, "labels": labels},
                    "spec": {
                        "replicas": int(replicas),
                        "selector": {"matchLabels": labels},
                        "template": pod_template,
                    },
                },
            )
            # Headless service = the stable coordinator DNS name pods dial
            # (jobparser.coordinator_endpoint), replacing the reference's
            # resolve-the-master-pod-IP dance (`docker/paddle_k8s:131-134`).
            self._create(
                self._ns_path("v1", "services"),
                {
                    "apiVersion": "v1",
                    "kind": "Service",
                    "metadata": {"name": name, "labels": labels},
                    "spec": {
                        "clusterIP": "None",
                        "selector": labels,
                        "ports": [{"name": "coordinator", "port": 7164}],
                    },
                },
            )
        else:
            self._create(
                self._ns_path("batch/v1", "jobs"),
                {
                    "apiVersion": "batch/v1",
                    "kind": "Job",
                    "metadata": {"name": name, "labels": labels},
                    "spec": {
                        "parallelism": int(replicas),
                        # No `completions`: like the reference's elastic
                        # trainer Job, done-ness is decided by our updater's
                        # phase rules, not by a fixed completion count.
                        "backoffLimit": 1000000,
                        "template": pod_template,
                    },
                },
            )

    def _create(self, path: str, manifest: dict) -> None:
        try:
            self.api.post(path, manifest)
        except ApiError as e:
            if e.conflict:  # already exists → adopt (controller restart replay)
                log.info("adopting existing %s", manifest["metadata"]["name"])
                return
            raise

    def delete_role(self, job_name: str, role: str) -> None:
        """Delete the role workload and GC its pods by label selector
        (ref: pod GC, pkg/updater/trainingJobUpdater.go:99-154)."""
        name = self.workload_name(job_name, role)
        targets = (
            [("apps/v1", "deployments"), ("v1", "services")]
            if role == ROLE_COORDINATOR
            else [("batch/v1", "jobs")]
        )
        for group_version, kind in targets:
            try:
                self.api.delete(
                    self._ns_path(group_version, kind, name),
                    params={"propagationPolicy": "Background"},
                )
            except ApiError as e:
                if not e.not_found:
                    raise
        try:
            self.api.delete(
                self._ns_path("v1", "pods"),
                params={"labelSelector": _selector(role_labels(job_name, role))},
            )
        except ApiError as e:
            if not e.not_found:
                raise
