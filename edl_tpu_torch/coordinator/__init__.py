"""Coordinator service: membership epochs, leased task queue, barriers, KV.

Copies of the JAX package's ``edl_tpu/coordinator`` modules with their
imports pointed at this package; the port imports nothing of ``edl_tpu``.
The native coordinator (``native/coordinator``) speaks newline JSON, so the
port's client talks to the same binary, found and built at the same path.

- ``CoordinatorClient`` — blocking TCP client speaking the newline-JSON
  protocol; what trainers embed.
- ``CoordinatorServer`` — spawns/manages the C++ binary (builds it on first
  use if the toolchain is present).
- ``InProcessCoordinator`` — pure-Python twin of the C++ state machine for
  hermetic tests and single-host runs.
- ``RetryPolicy`` / ``OutboxClient`` — outage resilience: typed retries in
  the client, buffered side effects + degraded-mode reads in the worker.
- ``CoordinatorSupervisor`` — keeps a native coordinator process alive,
  restarting it with the same state_file + run_id.
- ``watch.EpochWatch`` — the membership-epoch push stream, with a pull
  fallback.
"""

from edl_tpu_torch.coordinator.client import (
    CoordinatorAuthError, CoordinatorClient, CoordinatorError,
    CoordinatorTimeout, CoordinatorUnreachable,
)
from edl_tpu_torch.coordinator.inprocess import InProcessCoordinator
from edl_tpu_torch.coordinator.outbox import Outbox, OutboxClient
from edl_tpu_torch.coordinator.retry import RetryPolicy
from edl_tpu_torch.coordinator.server import CoordinatorServer, CoordinatorSupervisor

__all__ = [
    "CoordinatorClient",
    "CoordinatorAuthError",
    "CoordinatorError",
    "CoordinatorTimeout",
    "CoordinatorUnreachable",
    "CoordinatorServer",
    "CoordinatorSupervisor",
    "InProcessCoordinator",
    "Outbox",
    "OutboxClient",
    "RetryPolicy",
]
