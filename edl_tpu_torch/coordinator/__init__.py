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
- ``RetryPolicy`` — typed retries in the client.
- ``CoordinatorSupervisor`` — keeps a native coordinator process alive,
  restarting it with the same state_file + run_id.

The outbox (buffered side effects in an outage) and the watch stream wait
for a later slice.
"""

from edl_tpu_torch.coordinator.client import (
    CoordinatorAuthError, CoordinatorClient, CoordinatorError,
    CoordinatorTimeout, CoordinatorUnreachable,
)
from edl_tpu_torch.coordinator.inprocess import InProcessCoordinator
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
    "RetryPolicy",
]
