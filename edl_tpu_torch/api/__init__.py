"""Job-spec type system for edl_tpu.

TPU-native re-design of the reference's TrainingJob resource types
(`pkg/resource/training_job.go`, `pkg/apis/paddlepaddle/v1/types.go`): the
schedulable accelerator unit is a TPU slice shape (e.g. ``v5e-4``) instead of an
``nvidia.com/gpu`` count, and the pserver role is gone — its state lives in HBM,
sharded by the mesh; its discovery role moved to the coordinator.
"""

from edl_tpu_torch.api.quantity import (
    Quantity,
    ResourceList,
    parse_quantity,
    format_quantity,
)
from edl_tpu_torch.api.types import (
    JobPhase,
    ReplicaSpec,
    ResourceRequirements,
    ScaleRecord,
    ServingSpec,
    TPUSpec,
    TrainerStatus,
    TrainingJob,
    TrainingJobSpec,
    TrainingJobStatus,
)
from edl_tpu_torch.api.validation import ValidationError, normalize, set_defaults, validate

__all__ = [
    "JobPhase",
    "Quantity",
    "ReplicaSpec",
    "ResourceList",
    "ResourceRequirements",
    "ScaleRecord",
    "TPUSpec",
    "TrainerStatus",
    "TrainingJob",
    "ServingSpec",
    "TrainingJobSpec",
    "TrainingJobStatus",
    "ValidationError",
    "format_quantity",
    "normalize",
    "parse_quantity",
    "set_defaults",
    "validate",
]
