"""TrainingJob resource types.

TPU-native redesign of the reference's job schema
(`pkg/resource/training_job.go:61-212`, `pkg/apis/paddlepaddle/v1/types.go:36-173`).
Differences from the reference, by design:

- Roles are ``coordinator`` + ``trainer``. The reference's third role, the
  parameter server (`pkg/resource/training_job.go:84-93`), does not exist on
  TPU: parameters live in HBM sharded by the mesh, and the pserver's
  registration/discovery duties moved into the coordinator.
- Accelerators are TPU slices (``TPUSpec``: accelerator type + chips per
  trainer + mesh topology), not ``nvidia.com/gpu`` counts
  (`pkg/resource/training_job.go:194-207`).
- ``parallelism`` describes the logical mesh axes (data/model/sequence/expert)
  the trainer runtime should build — the reference has only implicit data
  parallelism via trainer count.

Phases and predicates keep reference semantics: ``elastic`` iff
min_instance < max_instance (`pkg/resource/training_job.go:189-191`), elastic
implies fault_tolerant (`pkg/updater/jobparser.go:47-71`), phase machine
None→Creating→Running→Scaling→Succeeded/Failed
(`pkg/apis/paddlepaddle/v1/types.go:95-106`).
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from edl_tpu_torch.api.quantity import ResourceList


class JobPhase(str, enum.Enum):
    """Lifecycle phases (ref: pkg/apis/paddlepaddle/v1/types.go:95-106)."""

    NONE = "None"
    CREATING = "Creating"
    RUNNING = "Running"
    SCALING = "Scaling"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"

    def terminal(self) -> bool:
        return self in (JobPhase.SUCCEEDED, JobPhase.FAILED)


class TrainerStatus(str, enum.Enum):
    """Per-replica states (ref: pkg/apis/paddlepaddle/v1/types.go:141-148)."""

    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"


@dataclass
class ResourceRequirements:
    """Per-replica host resources: requests/limits maps in base units."""

    requests: ResourceList = field(default_factory=ResourceList)
    limits: ResourceList = field(default_factory=ResourceList)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "ResourceRequirements":
        d = d or {}
        return cls(
            requests=ResourceList.make(d.get("requests")),
            limits=ResourceList.make(d.get("limits")),
        )

    def to_dict(self) -> dict:
        return {"requests": dict(self.requests), "limits": dict(self.limits)}


@dataclass
class TPUSpec:
    """The schedulable accelerator unit: a TPU slice shape per trainer.

    Replaces the reference's GPU-count accounting
    (`pkg/resource/training_job.go:194-207`, `pkg/cluster.go:224-232`). The
    autoscaler treats ``chips_per_trainer`` as the indivisible scheduling
    granule — you can't hand a trainer half a slice.

    The port keeps the block's name, keys and defaults, so one job YAML
    reads the same in both packages; here a chip is one H100 card
    (``nvidia.com/gpu`` at the Kubernetes edge) and ``accelerator_type``
    passes through to the pods as ``EDL_TPU_ACCELERATOR``.
    """

    accelerator_type: str = "v5e"
    chips_per_trainer: int = 4
    #: logical mesh axis sizes within one trainer's slice, e.g. {"data": 4}.
    topology: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "TPUSpec":
        d = d or {}
        return cls(
            accelerator_type=d.get("accelerator_type", "v5e"),
            chips_per_trainer=int(d.get("chips_per_trainer", 4)),
            topology=dict(d.get("topology", {})),
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass
class ReplicaSpec:
    """One role's replica template (ref: pkg/apis/paddlepaddle/v1/types.go:67-90)."""

    entrypoint: str = ""
    workspace: str = ""
    image: str = ""
    min_instance: int = 1
    max_instance: int = 1
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)
    env: Dict[str, str] = field(default_factory=dict)
    #: name of a PersistentVolumeClaim to mount at ``workspace`` instead of
    #: the default pod-lifetime emptyDir. For the coordinator role this makes
    #: the durable state file (queue/done/KV) survive pod RESCHEDULING, not
    #: just container crashes — the full etcd-sidecar durability story.
    state_pvc: str = ""

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "ReplicaSpec":
        d = d or {}
        return cls(
            entrypoint=d.get("entrypoint", ""),
            workspace=d.get("workspace", ""),
            image=d.get("image", ""),
            min_instance=int(d.get("min_instance", d.get("min-instance", 1))),
            max_instance=int(d.get("max_instance", d.get("max-instance", 1))),
            resources=ResourceRequirements.from_dict(d.get("resources")),
            env=dict(d.get("env", {})),
            state_pvc=d.get("state_pvc", d.get("state-pvc", "")),
        )

    def to_dict(self) -> dict:
        return {
            "entrypoint": self.entrypoint,
            "workspace": self.workspace,
            "image": self.image,
            "min_instance": self.min_instance,
            "max_instance": self.max_instance,
            "resources": self.resources.to_dict(),
            "env": dict(self.env),
            "state_pvc": self.state_pvc,
        }


@dataclass
class ServingSpec:
    """Marks a job as a serving-tier job: its replicas run the
    continuous-batching inference frontend (`edl_tpu.serving`) over the
    artifact at ``model_dir`` instead of a train loop, and the autoscaler
    scales them on scraped `edl_serve_*` p99 latency + queue depth
    instead of cluster utilization."""

    model_dir: str = ""
    buckets: List[int] = field(default_factory=lambda: [1, 8, 32])
    #: grow a replica when the tier p99 breaches this
    slo_p99_seconds: float = 0.25
    #: ... or the mean queue backlog per replica exceeds this
    max_queue_per_replica: float = 8.0

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> Optional["ServingSpec"]:
        if d is None:
            return None
        return cls(
            model_dir=d.get("model_dir", d.get("model-dir", "")),
            buckets=[int(b) for b in d.get("buckets", [1, 8, 32])],
            slo_p99_seconds=float(d.get("slo_p99_seconds", 0.25)),
            max_queue_per_replica=float(d.get("max_queue_per_replica", 8.0)),
        )

    def to_dict(self) -> dict:
        return {
            "model_dir": self.model_dir,
            "buckets": list(self.buckets),
            "slo_p99_seconds": self.slo_p99_seconds,
            "max_queue_per_replica": self.max_queue_per_replica,
        }


@dataclass
class TrainingJobSpec:
    """Job spec (ref: pkg/resource/training_job.go:61-106).

    ``parallelism`` names the logical mesh axes the runtime builds with
    ``edl_tpu.parallel``; sizes are per-trainer-slice local factors — the data
    axis additionally spans trainers.
    """

    image: str = ""
    port: int = 7164
    fault_tolerant: bool = False
    passes: int = 1
    tpu: TPUSpec = field(default_factory=TPUSpec)
    trainer: ReplicaSpec = field(default_factory=ReplicaSpec)
    coordinator: ReplicaSpec = field(default_factory=lambda: ReplicaSpec(min_instance=1, max_instance=1))
    parallelism: Dict[str, int] = field(default_factory=dict)
    #: dataset shard descriptors fed to the coordinator's task queue.
    data_shards: List[str] = field(default_factory=list)
    #: steps between async checkpoints (also taken on rescale signals).
    checkpoint_interval: int = 1000
    checkpoint_dir: str = ""
    #: per-job coordinator secret (EDL_COORD_TOKEN): the updater generates
    #: one at admission when empty, and every pod of the job gets it via
    #: make_env — so the 0.0.0.0-bound coordinator rejects other jobs'
    #: (or strangers') pods. Stored in the spec, the in-tree stand-in for
    #: projecting a K8s Secret; the reference's etcd sidecar had no auth
    #: at all (pkg/jobparser.go:167-184).
    auth_token: str = ""
    #: non-None marks a serving-tier job (see :class:`ServingSpec`)
    serving: Optional["ServingSpec"] = None

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "TrainingJobSpec":
        d = d or {}
        return cls(
            image=d.get("image", ""),
            port=int(d.get("port", 7164)),
            fault_tolerant=bool(d.get("fault_tolerant", False)),
            passes=int(d.get("passes", 1)),
            tpu=TPUSpec.from_dict(d.get("tpu")),
            trainer=ReplicaSpec.from_dict(d.get("trainer")),
            coordinator=ReplicaSpec.from_dict(d.get("coordinator")),
            parallelism={k: int(v) for k, v in (d.get("parallelism") or {}).items()},
            data_shards=list(d.get("data_shards", [])),
            checkpoint_interval=int(d.get("checkpoint_interval", 1000)),
            checkpoint_dir=d.get("checkpoint_dir", ""),
            auth_token=d.get("auth_token", ""),
            serving=ServingSpec.from_dict(d.get("serving")),
        )

    def to_dict(self) -> dict:
        out = {
            "image": self.image,
            "port": self.port,
            "fault_tolerant": self.fault_tolerant,
            "passes": self.passes,
            "tpu": self.tpu.to_dict(),
            "trainer": self.trainer.to_dict(),
            "coordinator": self.coordinator.to_dict(),
            "parallelism": dict(self.parallelism),
            "data_shards": list(self.data_shards),
            "checkpoint_interval": self.checkpoint_interval,
            "checkpoint_dir": self.checkpoint_dir,
            "auth_token": self.auth_token,
        }
        if self.serving is not None:
            out["serving"] = self.serving.to_dict()
        return out


@dataclass
class ScaleRecord:
    """One autoscaler decision, kept in status for observability."""

    timestamp: float
    from_replicas: int
    to_replicas: int
    reason: str = ""


@dataclass
class TrainingJobStatus:
    """Job status (ref: pkg/apis/paddlepaddle/v1/types.go:151-162)."""

    phase: JobPhase = JobPhase.NONE
    reason: str = ""
    #: current actuated trainer replica count (the scale target).
    parallelism: int = 0
    replica_statuses: Dict[str, TrainerStatus] = field(default_factory=dict)
    scale_history: List[ScaleRecord] = field(default_factory=list)


@dataclass
class TrainingJob:
    """A named job: metadata + spec + status (ref: training_job.go:109-131)."""

    name: str
    namespace: str = "default"
    spec: TrainingJobSpec = field(default_factory=TrainingJobSpec)
    status: TrainingJobStatus = field(default_factory=TrainingJobStatus)
    labels: Dict[str, str] = field(default_factory=dict)
    #: server-assigned object identity (K8s metadata.uid). Distinguishes two
    #: runs of a same-named job — stamped into pods as EDL_RUN_ID so the
    #: coordinator never resumes a previous run's state file.
    uid: str = ""

    # -- predicates (ref: pkg/resource/training_job.go:189-207) ---------------

    def elastic(self) -> bool:
        """Elastic iff the trainer instance range is a real range."""
        return self.spec.trainer.min_instance < self.spec.trainer.max_instance

    def serving(self) -> bool:
        """True for serving-tier jobs: replicas run the inference frontend
        and scale on SLO signals, not cluster utilization."""
        return self.spec.serving is not None

    def need_tpu(self) -> bool:
        return self.spec.tpu.chips_per_trainer > 0

    # -- resource math for the scheduler --------------------------------------

    def trainer_request(self) -> ResourceList:
        """Per-trainer resource demand, incl. the TPU slice granule."""
        req = self.spec.trainer.resources.requests.copy()
        if self.need_tpu():
            req["tpu"] = float(self.spec.tpu.chips_per_trainer)
        return req

    def trainer_limit(self) -> ResourceList:
        lim = self.spec.trainer.resources.limits.copy()
        if self.need_tpu():
            lim["tpu"] = float(self.spec.tpu.chips_per_trainer)
        return lim

    @classmethod
    def from_dict(cls, d: dict) -> "TrainingJob":
        meta = d.get("metadata", {})
        job = cls(
            name=meta.get("name", d.get("name", "")),
            namespace=meta.get("namespace", d.get("namespace", "default")),
            spec=TrainingJobSpec.from_dict(d.get("spec")),
            labels=dict(meta.get("labels", {})),
            uid=meta.get("uid", ""),
        )
        st = d.get("status")
        if st:
            job.status = TrainingJobStatus(
                phase=JobPhase(st.get("phase", "None")),
                reason=st.get("reason", ""),
                parallelism=int(st.get("parallelism", 0)),
                replica_statuses={
                    k: TrainerStatus(v) for k, v in st.get("replica_statuses", {}).items()
                },
                scale_history=[ScaleRecord(**r) for r in st.get("scale_history", [])],
            )
        return job

    def to_dict(self) -> dict:
        meta = {
            "name": self.name,
            "namespace": self.namespace,
            "labels": dict(self.labels),
        }
        if self.uid:
            meta["uid"] = self.uid
        return {
            "metadata": meta,
            "spec": self.spec.to_dict(),
            "status": {
                "phase": self.status.phase.value,
                "reason": self.status.reason,
                "parallelism": self.status.parallelism,
                "replica_statuses": {
                    k: v.value for k, v in self.status.replica_statuses.items()
                },
                "scale_history": [dataclasses.asdict(r) for r in self.status.scale_history],
            },
        }

    @classmethod
    def from_yaml(cls, text: str) -> "TrainingJob":
        import yaml

        return cls.from_dict(yaml.safe_load(text))
