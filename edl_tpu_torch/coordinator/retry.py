"""Retry policy for coordinator RPCs: backoff, jitter, per-call deadline.

The reference tolerates etcd/master blips implicitly — etcd clients retry
and the trainer's task loop just sees an empty queue until the lease
machinery recovers. Our coordinator client historically crashed the worker
on the first transport error instead. This module is the typed core of the
fix: a small, immutable policy object the client consults on every call.

Error taxonomy (see client.py for the exception types):

- ``CoordinatorAuthError`` — fatal. The pod's token disagrees with the
  job's; retrying cannot help and would mask a deployment bug.
- ``CoordinatorTimeout`` — an *outcome*, not a transport failure. The
  request may have been processed (a barrier arrival, a lease grant whose
  reply was slow); blindly re-sending would break request/reply pairing
  semantics for rendezvous ops. Callers that can re-issue safely do so at
  their own layer (LeaseReader, rendezvous loops).
- ``CoordinatorUnreachable`` — connect refused / reset / closed. The
  retryable class: the client re-dials with exponential backoff until the
  policy deadline, then surfaces ``CoordinatorUnreachable`` so degraded-mode
  callers (outbox, park logic) can take over.

Jitter is seeded so chaos tests replay identical schedules.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Iterator, Optional

__all__ = ["RetryPolicy", "DEFAULT_RETRY"]


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff + jitter + per-call deadline.

    ``deadline`` bounds the total time one logical ``call()`` may spend
    across attempts (first try included). It is a *per-call* budget, not
    per-attempt: a worker in its heartbeat loop sees a failure within
    ``deadline`` seconds and can drop to degraded mode instead of hanging.
    """

    #: max seconds one call may spend retrying before raising.
    deadline: float = 20.0
    #: first backoff sleep, seconds.
    initial_backoff: float = 0.05
    #: backoff ceiling, seconds.
    max_backoff: float = 2.0
    #: backoff growth factor per attempt.
    multiplier: float = 2.0
    #: +/- fraction of each sleep randomized (0.5 -> 50%..150% of nominal).
    jitter: float = 0.5
    #: seed for the jitter stream; None draws from the global RNG. Chaos
    #: tests pin this so failure schedules replay byte-identically.
    seed: Optional[int] = None

    def sleeps(self) -> Iterator[float]:
        """Infinite stream of backoff sleeps (jittered, monotone-capped)."""
        rng = random.Random(self.seed)
        backoff = self.initial_backoff
        while True:
            spread = 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
            yield max(0.0, backoff * spread)
            backoff = min(self.max_backoff, backoff * self.multiplier)


#: The client default: ~20 s of re-dialing covers a coordinator restart
#: (state-file reload is sub-second; process supervision adds a few) while
#: staying inside ROADMAP's <30 s recovery budget.
DEFAULT_RETRY = RetryPolicy()
