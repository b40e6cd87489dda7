"""Defaulting + validation for TrainingJob specs.

Keeps the reference's defaulting/validation semantics
(`pkg/updater/jobparser.go:40-64`, `pkg/jobparser.go:47-71`): fill default
port/image/passes, force ``fault_tolerant`` when the job is elastic, reject
inverted instance ranges — plus TPU-specific checks (power-of-two-ish slice
shapes, mesh-axis product must divide the chip count).
"""

from __future__ import annotations

from edl_tpu_torch.api.types import TrainingJob

DEFAULT_PORT = 7164
DEFAULT_PASSES = 1


class ValidationError(ValueError):
    pass


def set_defaults(job: TrainingJob) -> TrainingJob:
    """Fill reference-style defaults in place and return the job."""
    spec = job.spec
    if spec.port <= 0:
        spec.port = DEFAULT_PORT
    if spec.passes <= 0:
        spec.passes = DEFAULT_PASSES
    if not spec.trainer.image:
        spec.trainer.image = spec.image
    if not spec.coordinator.image:
        spec.coordinator.image = spec.image
    # Elastic implies fault tolerant (ref: pkg/jobparser.go:56-58) — a job whose
    # trainer count changes mid-flight must tolerate member churn.
    if job.elastic():
        spec.fault_tolerant = True
    spec.coordinator.min_instance = spec.coordinator.max_instance = 1
    if not spec.parallelism:
        spec.parallelism = {"data": max(1, spec.tpu.chips_per_trainer)}
    return job


def validate(job: TrainingJob) -> TrainingJob:
    """Raise ValidationError on a malformed spec; return the job otherwise."""
    spec = job.spec
    if not job.name:
        raise ValidationError("job name is required")
    t = spec.trainer
    if t.min_instance < 1:
        raise ValidationError(f"trainer.min_instance must be >= 1, got {t.min_instance}")
    if t.max_instance < t.min_instance:
        raise ValidationError(
            f"trainer.max_instance ({t.max_instance}) < min_instance ({t.min_instance})"
        )
    if spec.tpu.chips_per_trainer < 0:
        raise ValidationError("tpu.chips_per_trainer must be >= 0")
    if spec.port <= 0 or spec.port > 65535:
        raise ValidationError(f"invalid port {spec.port}")
    if spec.passes < 1:
        raise ValidationError(f"passes must be >= 1, got {spec.passes}")
    if job.elastic() and not spec.fault_tolerant:
        raise ValidationError("elastic jobs must be fault_tolerant (run set_defaults first)")
    # Parallelism sizes are per-trainer-slice local factors (the data axis
    # additionally spans trainers), so their product must divide the slice.
    # CPU-only jobs (chips_per_trainer == 0) map axes onto virtual host
    # devices instead, with no divisibility constraint to enforce here.
    axis_product = 1
    for axis, size in spec.parallelism.items():
        if size < 1:
            raise ValidationError(f"parallelism axis {axis!r} must be >= 1, got {size}")
        axis_product *= size
    local_chips = spec.tpu.chips_per_trainer
    if local_chips > 0 and local_chips % axis_product != 0:
        raise ValidationError(
            f"parallelism axes product {axis_product} must divide "
            f"chips_per_trainer {local_chips}"
        )
    if spec.serving is not None:
        s = spec.serving
        if not s.model_dir:
            raise ValidationError("serving.model_dir is required")
        if not s.buckets or any(b <= 0 for b in s.buckets) \
                or any(a >= b for a, b in zip(s.buckets, s.buckets[1:])):
            raise ValidationError(
                f"serving.buckets must be positive and strictly "
                f"ascending, got {s.buckets}"
            )
        if s.slo_p99_seconds <= 0:
            raise ValidationError("serving.slo_p99_seconds must be > 0")
        if s.max_queue_per_replica <= 0:
            raise ValidationError("serving.max_queue_per_replica must be > 0")
    return job


def normalize(job: TrainingJob) -> TrainingJob:
    """set_defaults + validate, the controller's admission path."""
    return validate(set_defaults(job))
