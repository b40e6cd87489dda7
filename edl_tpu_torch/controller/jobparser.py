"""Materialize a TrainingJob into role workloads + the env-var protocol.

Equivalent of the reference job parsers (`pkg/jobparser.go:74-311`,
`pkg/updater/jobparser.go:67-335`): given an admitted spec, produce per-role
workload descriptions (replica counts, resources, labels) and the environment
protocol every pod receives. The reference speaks ``PADDLE_*``
(`pkg/jobparser.go:263-311`); ours is ``EDL_*`` and TPU-shaped — instead of
pserver endpoint lists and sparse-port blocks (`pkg/jobparser.go:232-247`),
pods get the coordinator endpoint, the mesh-axis layout, and the TPU slice
shape; rank/world come from the coordinator at runtime, not from static env.

A copy of the JAX package's ``edl_tpu/controller/jobparser.py`` with the
imports pointing at this package. The env keys stay the JAX package's
(``EDL_TPU_CHIPS`` and the rest), which the port's launcher and entries read;
here ``EDL_TPU_CHIPS`` counts H100 cards.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List

from edl_tpu_torch.api.quantity import ResourceList
from edl_tpu_torch.api.types import ReplicaSpec, TrainingJob

#: label keys (ref: pkg/updater/labels.go:9-18)
LABEL_JOB = "edl.tpu/job-name"
LABEL_ROLE = "edl.tpu/role"

ROLE_COORDINATOR = "coordinator"
ROLE_TRAINER = "trainer"


def role_labels(job_name: str, role: str) -> Dict[str, str]:
    """Selector labels for one role's pods (ref: pkg/updater/labels.go:9-18)."""
    return {LABEL_JOB: job_name, LABEL_ROLE: role}


@dataclass
class RoleWorkload:
    """One role's materialized workload: what the cluster provider creates.

    The analog of the reference's ReplicaSet/Job manifests
    (`pkg/jobparser.go:74-227`), reduced to what a ClusterProvider needs.
    """

    job_name: str
    role: str
    replicas: int
    image: str
    entrypoint: str
    requests: ResourceList
    limits: ResourceList
    env: Dict[str, str] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    #: PVC to mount at the role's workspace (coordinator durability across
    #: pod rescheduling); empty -> pod-lifetime emptyDir.
    state_pvc: str = ""


def coordinator_endpoint(job: TrainingJob) -> str:
    """Stable coordinator address pods dial: a service-DNS-style name.

    The reference publishes MASTER_IP by resolving the master pod
    (`docker/paddle_k8s:131-134`); a headless-service name avoids that lookup.
    """
    return f"{job.name}-coordinator.{job.namespace}:{job.spec.port}"


def make_env(job: TrainingJob, role: str) -> Dict[str, str]:
    """The controller→pod env protocol (ref: pkg/jobparser.go:263-311).

    Deliberately rank-free: the reference bakes PADDLE_INIT_TRAINER_ID into
    the pod env via the sorted-pod-name trick (`docker/k8s_tools.py:127-151`),
    which breaks when pods churn. Here ranks are leased from the coordinator
    at register time (`edl_tpu_torch.coordinator`), so a replaced pod can't collide.
    """
    spec = job.spec
    env = {
        "EDL_JOB_NAME": job.name,
        "EDL_NAMESPACE": job.namespace,
        "EDL_ROLE": role,
        "EDL_COORDINATOR_ENDPOINT": coordinator_endpoint(job),
        "EDL_PORT": str(spec.port),
        "EDL_NUM_TRAINERS": str(spec.trainer.min_instance),
        "EDL_MAX_TRAINERS": str(spec.trainer.max_instance),
        "EDL_FAULT_TOLERANT": "1" if spec.fault_tolerant else "0",
        "EDL_PASSES": str(spec.passes),
        "EDL_TPU_ACCELERATOR": spec.tpu.accelerator_type,
        "EDL_TPU_CHIPS": str(spec.tpu.chips_per_trainer),
        "EDL_MESH_AXES": json.dumps(spec.parallelism),
        "EDL_CHECKPOINT_DIR": spec.checkpoint_dir,
        "EDL_CHECKPOINT_INTERVAL": str(spec.checkpoint_interval),
        # Run identity for the coordinator's state file: the K8s object UID
        # when the apiserver assigned one, else namespace/name (in-memory
        # stores). Keeps a re-created job from resuming its predecessor's
        # done-set out of a reused workspace volume.
        "EDL_RUN_ID": job.uid or f"{job.namespace}/{job.name}",
    }
    if spec.auth_token:
        # Per-job coordinator secret: the coordinator binary reads it at
        # startup, CoordinatorClient attaches it to every call. Same value
        # in every pod of the job by construction.
        env["EDL_COORD_TOKEN"] = spec.auth_token
    replica: ReplicaSpec = spec.trainer if role == ROLE_TRAINER else spec.coordinator
    if replica.entrypoint:
        env["EDL_ENTRY"] = replica.entrypoint
    if replica.workspace:
        env["EDL_WORKSPACE"] = replica.workspace
    if spec.data_shards:
        env["EDL_DATA_SHARDS"] = json.dumps(spec.data_shards)
    env.update(replica.env)  # user env wins, like container env override order
    return env


def parse_to_coordinator(job: TrainingJob) -> RoleWorkload:
    """Coordinator workload (ref: ParseToMaster + etcd sidecar,
    `pkg/jobparser.go:167-227`) — one replica owning membership, leases, KV.
    The etcd sidecar has no analog: the native coordinator keeps its own state
    and restarts are survivable via the trainers' durable checkpoints.
    """
    spec = job.spec
    requests = spec.coordinator.resources.requests.copy()
    limits = spec.coordinator.resources.limits.copy()
    if not requests:  # fixed small footprint (ref: pkg/updater/jobparser.go:180-192)
        requests = ResourceList.make({"cpu": "250m", "memory": "128Mi"})
    return RoleWorkload(
        job_name=job.name,
        role=ROLE_COORDINATOR,
        replicas=1,
        image=spec.coordinator.image or spec.image,
        entrypoint=spec.coordinator.entrypoint
        or f"edl-launch start_coordinator --port {spec.port}",
        requests=requests,
        limits=limits,
        env=make_env(job, ROLE_COORDINATOR),
        labels=role_labels(job.name, ROLE_COORDINATOR),
        state_pvc=spec.coordinator.state_pvc,
    )


def parse_to_trainer(job: TrainingJob) -> RoleWorkload:
    """Trainer workload (ref: ParseToTrainer, `pkg/jobparser.go:120-165`).

    Starts at min_instance like the reference's initial Parallelism; the
    autoscaler raises it toward max_instance. Restart policy is the FakeCluster
    reconcile loop's job (ref: RestartPolicy Never + K8s Job replacement).
    """
    spec = job.spec
    return RoleWorkload(
        job_name=job.name,
        role=ROLE_TRAINER,
        replicas=spec.trainer.min_instance,
        image=spec.trainer.image or spec.image,
        entrypoint=spec.trainer.entrypoint or "edl-launch start_trainer",
        requests=job.trainer_request(),
        limits=job.trainer_limit(),
        env=make_env(job, ROLE_TRAINER),
        labels=role_labels(job.name, ROLE_TRAINER),
    )


def parse_job(job: TrainingJob) -> List[RoleWorkload]:
    """All workloads for a job, in creation order: coordinator first — trainers
    dial it at startup (ref creation order master→pserver→trainer,
    `pkg/updater/trainingJobUpdater.go:282-293`)."""
    return [parse_to_coordinator(job), parse_to_trainer(job)]
