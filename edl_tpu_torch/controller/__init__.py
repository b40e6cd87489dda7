"""Control plane: cluster accounting, autoscaler, controller, per-job updater.

Re-design of the reference Go control plane (`pkg/controller.go`,
`pkg/autoscaler.go`, `pkg/cluster.go`, `pkg/updater/`): same split — a pure,
exhaustively-testable scheduling core; thin I/O edges behind a provider
interface; one actor goroutine-equivalent (thread) per job.

Copies of the JAX package's ``edl_tpu/controller/`` with the imports pointing
at this package, and the same ``__all__``; `process_cluster` (local
processes as pods) is imported from its module, as there.
"""

from edl_tpu_torch.controller.cluster import (
    ClusterProvider, ClusterResource, FakeCluster, NodeInfo, PodInfo,
)
from edl_tpu_torch.controller.autoscaler import (
    Autoscaler,
    AutoscalerConfig,
    JobState,
    fulfillment,
    make_room_dry_run,
    scale_all_dry_run,
    scale_dry_run,
    sorted_jobs_by_fulfillment,
)
from edl_tpu_torch.controller.controller import Controller
from edl_tpu_torch.controller.jobparser import (
    ROLE_COORDINATOR,
    ROLE_TRAINER,
    RoleWorkload,
    coordinator_endpoint,
    make_env,
    parse_job,
    parse_to_coordinator,
    parse_to_trainer,
    role_labels,
)
from edl_tpu_torch.controller.store import FuncWatcher, JobStore, Watcher
from edl_tpu_torch.controller.updater import JobUpdater, UpdaterConfig

__all__ = [
    "Autoscaler",
    "AutoscalerConfig",
    "ClusterProvider",
    "ClusterResource",
    "Controller",
    "FakeCluster",
    "FuncWatcher",
    "JobState",
    "JobStore",
    "JobUpdater",
    "NodeInfo",
    "PodInfo",
    "ROLE_COORDINATOR",
    "ROLE_TRAINER",
    "RoleWorkload",
    "UpdaterConfig",
    "Watcher",
    "coordinator_endpoint",
    "fulfillment",
    "make_env",
    "make_room_dry_run",
    "parse_job",
    "parse_to_coordinator",
    "parse_to_trainer",
    "role_labels",
    "scale_all_dry_run",
    "scale_dry_run",
    "sorted_jobs_by_fulfillment",
]
