"""Fault-injection helpers for resilience tests (not shipped runtime code)."""

from edl_tpu_torch.testing.chaosproxy import (
    ChaosProxy, ChaosScenario, StepSlowShim,
)

__all__ = ["ChaosProxy", "ChaosScenario", "StepSlowShim"]
