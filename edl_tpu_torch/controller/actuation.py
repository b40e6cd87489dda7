"""Actuation bridge: control-plane scale decisions → the job's coordinator.

The reference's scale actuation is one write — `Spec.Parallelism` on the
trainer Job (`pkg/autoscaler.go:339-376`) — because its data
plane discovers world size from Kubernetes itself. Ours is two writes: the
provider reconciles the pod count, but live workers rendezvous at the world
size read from the coordinator KV (``edl/expected_world``,
`runtime/distributed.py`). This module is the second write:

1. **publish** the target world under ``edl/expected_world`` *before* the
   provider actuates, so a worker (re)starting mid-rescale already sees the
   new target;
2. **nudge** the membership epoch after actuation (``bump_epoch``), so
   workers parked in ``sync()`` resync immediately instead of waiting for a
   pod-churn membership event — this is what turns an autoscaler decision
   into a live-job warm restart.

Endpoints default to the controller-stamped DNS name
(`jobparser.coordinator_endpoint`); hermetic tests and local process pools
override per-job with ``set_endpoint``.

A copy of the JAX package's ``edl_tpu/controller/actuation.py`` over this
package's coordinator client and ``obs``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Tuple

from edl_tpu_torch.api.types import TrainingJob
from edl_tpu_torch.controller.jobparser import coordinator_endpoint
from edl_tpu_torch.obs.metrics import get_registry
from edl_tpu_torch.obs.tracing import get_tracer, rescale_trace_id

#: rescale actuations that reached the job's coordinator (epoch bumped).
_M_NUDGES = get_registry().counter(
    "edl_controller_nudges_total",
    "epoch-bump actuations delivered to job coordinators, by kind",
    labelnames=("kind",),  # nudge | publish_and_nudge
)

log = logging.getLogger("edl_tpu_torch.controller.actuation")

#: KV key the runtime reads its target world size from
#: (must match runtime/distributed.py:EXPECTED_WORLD_KEY).
EXPECTED_WORLD_KEY = "edl/expected_world"


class CoordinatorActuator:
    """Dials per-job coordinators to publish rescale targets."""

    def __init__(self, dial_timeout: float = 3.0, dial_backoff: float = 5.0):
        self.dial_timeout = dial_timeout
        #: after a dial failure, skip dialing that job this long — an
        #: unreachable coordinator (still materializing, or a DNS name that
        #: only resolves in-cluster) must not stall every autoscaler loop
        #: for the full dial timeout
        self.dial_backoff = dial_backoff
        self._lock = threading.Lock()
        self._endpoints: Dict[str, Tuple[str, int]] = {}
        self._backoff_until: Dict[str, float] = {}
        #: per-job coordinator secrets (spec.auth_token): the controller's
        #: own writes must authenticate like any pod's, or every rescale
        #: publish/nudge would be rejected the moment a job has auth on.
        self._tokens: Dict[str, str] = {}

    # -- endpoint registry -----------------------------------------------------

    def track(self, job: TrainingJob) -> None:
        """Derive the job's coordinator endpoint from its spec (the stable
        service DNS name the pods themselves dial) and record its auth
        token (the updater may mint it after the first track call, so the
        token refreshes on every call even though the endpoint is sticky)."""
        host, _, port = coordinator_endpoint(job).rpartition(":")
        with self._lock:
            # An explicit endpoint (set_endpoint) wins over the derived one:
            # tests and local pools register the real host:port first.
            self._endpoints.setdefault(job.name, (host, int(port)))
            if job.spec.auth_token:
                self._tokens[job.name] = job.spec.auth_token

    def set_endpoint(self, job_name: str, host: str, port: int,
                     token: str = "") -> None:
        with self._lock:
            self._endpoints[job_name] = (host, int(port))
            if token:
                self._tokens[job_name] = token

    def forget(self, job_name: str) -> None:
        with self._lock:
            self._endpoints.pop(job_name, None)
            # a re-created same-name job must not inherit this backoff
            self._backoff_until.pop(job_name, None)
            self._tokens.pop(job_name, None)

    def _dial(self, job_name: str, force: bool = False):
        import time

        with self._lock:
            endpoint = self._endpoints.get(job_name)
            token = self._tokens.get(job_name, "")
            if endpoint is None:
                return None
            if (not force
                    and time.monotonic() < self._backoff_until.get(job_name, 0.0)):
                return None
        from edl_tpu_torch.coordinator.client import CoordinatorClient

        try:
            client = CoordinatorClient(
                host=endpoint[0], port=endpoint[1],
                worker=f"controller/{job_name}",
                connect_timeout=self.dial_timeout,
                token=token,
            )
        except Exception:
            with self._lock:
                self._backoff_until[job_name] = (
                    time.monotonic() + self.dial_backoff
                )
            raise
        with self._lock:
            self._backoff_until.pop(job_name, None)
        return client

    # -- the two writes --------------------------------------------------------

    def publish_expected_world(self, job_name: str, world: int) -> bool:
        """Write the rescale target. Failures (including dial failures — the
        coordinator may still be materializing, or the DNS name may not
        resolve outside the cluster) are non-fatal: workers fall back to
        membership-driven convergence (`EDL_NUM_TRAINERS` + epoch events),
        and the provider actuation must never be blocked by this write."""
        try:
            client = self._dial(job_name)
            if client is None:
                return False
            with client:
                client.kv_put(EXPECTED_WORLD_KEY, str(int(world)))
            return True
        except Exception as e:
            log.debug("publish expected_world=%d to %s failed: %s",
                      world, job_name, e)
            return False

    def nudge(self, job_name: str) -> bool:
        """Bump the membership epoch so parked workers resync now."""
        t0 = time.time()
        try:
            client = self._dial(job_name)
            if client is None:
                return False
            with client:
                epoch = client.bump_epoch()
            # The bump_epoch reply hands us the SAME epoch every worker will
            # adopt on re-register — the cross-process rescale correlator.
            get_tracer().record("actuate", t0, time.time(),
                                trace_id=rescale_trace_id(epoch),
                                component="controller", job=job_name)
            _M_NUDGES.inc(kind="nudge")
            log.info("nudged %s to epoch %d", job_name, epoch)
            return True
        except Exception as e:
            log.debug("nudge of %s failed: %s", job_name, e)
            return False

    def publish_and_nudge(self, job_name: str, world: int) -> bool:
        """Both writes over ONE dial — the scale-down path needs the epoch
        moved before any pod is killed, and two sequential dial timeouts
        against an unreachable coordinator would stall the autoscaler loop
        twice as long for nothing.

        Ignores the dial backoff (``force``): shrinks are rare and this
        write is correctness-relevant (it dissolves the gang at a round
        boundary before the SIGTERMs land), so it always deserves a fresh
        dial attempt. A *still*-unreachable coordinator logs a warning —
        the caller proceeds anyway (the controller may legitimately sit
        outside the coordinator's network, e.g. a DNS name that only
        resolves in-cluster; workers then fall back to termination-driven
        membership events and poll/TTL timeouts)."""
        t0 = time.time()
        try:
            client = self._dial(job_name, force=True)
            if client is None:
                self._warn_unreachable(job_name, world)
                return False
            with client:
                client.kv_put(EXPECTED_WORLD_KEY, str(int(world)))
                epoch = client.bump_epoch()
            get_tracer().record("actuate", t0, time.time(),
                                trace_id=rescale_trace_id(epoch),
                                component="controller", job=job_name,
                                world=int(world))
            _M_NUDGES.inc(kind="publish_and_nudge")
            log.info("published world=%d and nudged %s to epoch %d",
                     world, job_name, epoch)
            return True
        except Exception as e:
            self._warn_unreachable(job_name, world, e)
            return False

    def _warn_unreachable(self, job_name, world, err=None):
        log.warning(
            "scale-down of %s to world=%d proceeds WITHOUT the "
            "epoch-before-SIGTERM handshake (coordinator unreachable%s); "
            "victims that miss their graceful drain leave survivors to "
            "recover via poll timeouts / membership TTL",
            job_name, world, f": {err}" if err else "",
        )
