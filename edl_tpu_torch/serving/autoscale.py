"""Serving-tier autoscaler signal: p99 latency + queue depth from scrapes.
A copy of `edl_tpu.serving.autoscale`.

Training jobs scale on cluster utilization; a serving replica's load is
invisible to that signal — its devices are "busy" whether it meets its
latency SLO or not.
The serving tier instead scales on what its users feel: the p99 of
`edl_serve_request_latency_seconds` and the `edl_serve_queue_depth`
backlog, scraped from each replica's `/metrics` (the autoscaler consumes
the same exposition text any Prometheus would).

The p99 comes from the histogram's cumulative buckets, aggregated ACROSS
replicas before the quantile is taken (an overloaded replica must not be
averaged away), with linear interpolation inside the winning bucket —
the standard histogram_quantile estimator.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["ServeSignal", "ServingSLO", "histogram_quantile",
           "scrape_serve_signal", "aggregate_signals", "desired_replica_delta",
           "LMServeSignal", "LMServingSLO", "scrape_lm_signal",
           "aggregate_lm_signals", "desired_lm_replica_delta"]

log = logging.getLogger("edl_tpu_torch.serving.autoscale")

_LATENCY_FAMILY = "edl_serve_request_latency_seconds"
_QUEUE_FAMILY = "edl_serve_queue_depth"
_TOKEN_LATENCY_FAMILY = "edl_lm_token_latency_seconds"
_KV_OCCUPANCY_FAMILY = "edl_lm_kv_occupancy"


@dataclass
class ServeSignal:
    """One replica's scraped load state."""

    #: cumulative (le_upper_bound, count) pairs, +inf last
    latency_buckets: List[Tuple[float, float]]
    latency_count: float
    queue_depth: float


@dataclass
class ServingSLO:
    """The serving tier's scaling contract. Defaults target interactive
    inference: grow when p99 breaches, shrink only when comfortably under
    BOTH signals (hysteresis — the gap between grow and shrink thresholds
    is what keeps the replica count from oscillating)."""

    p99_seconds: float = 0.25
    max_queue_per_replica: float = 8.0
    #: shrink only when p99 < shrink_frac * p99_seconds ...
    shrink_frac: float = 0.3
    #: ... and queue/replica < shrink_queue_frac * max_queue_per_replica
    shrink_queue_frac: float = 0.25


def histogram_quantile(
    buckets: Sequence[Tuple[float, float]], q: float
) -> Optional[float]:
    """Quantile estimate from Prometheus-style cumulative buckets.

    ``buckets``: (upper_bound, cumulative_count), ascending, +inf last.
    Linear interpolation within the winning bucket; the +inf bucket clamps
    to the last finite bound (the estimator can't see past it). None when
    the histogram is empty.
    """
    if not buckets:
        return None
    total = buckets[-1][1]
    if total <= 0:
        return None
    rank = q * total
    prev_bound, prev_count = 0.0, 0.0
    for bound, count in buckets:
        if count >= rank:
            if bound == float("inf"):
                return prev_bound  # clamp: everything above the last finite le
            if count == prev_count:
                return bound
            frac = (rank - prev_count) / (count - prev_count)
            return prev_bound + (bound - prev_bound) * frac
        prev_bound, prev_count = bound, count
    return buckets[-1][0]


def _parse_bucket_samples(samples: Dict[str, float],
                          family: str) -> List[Tuple[float, float]]:
    out = []
    prefix = family + "_bucket{"
    for name, value in samples.items():
        if not name.startswith(prefix):
            continue
        # labelset is exactly {le="..."} for unlabelled histograms
        le = name[name.find('le="') + 4:name.rfind('"')]
        out.append((float(le), value))
    out.sort(key=lambda pair: pair[0])
    return out


def scrape_serve_signal(url: str, timeout: float = 2.0) -> Optional[ServeSignal]:
    """Scrape one replica's `/metrics` into a :class:`ServeSignal`; None
    when the replica is unreachable or not yet exporting the families
    (booting replicas don't get to veto the scaling decision)."""
    from edl_tpu_torch.obs.http import scrape_metrics
    from edl_tpu_torch.obs.metrics import parse_prometheus

    try:
        families = parse_prometheus(scrape_metrics(url, timeout=timeout))
    except (OSError, ValueError) as e:
        log.debug("serve scrape of %s failed: %s", url, e)
        return None
    latency = families.get(_LATENCY_FAMILY)
    queue = families.get(_QUEUE_FAMILY)
    if latency is None or queue is None:
        return None
    buckets = _parse_bucket_samples(latency["samples"], _LATENCY_FAMILY)
    count = latency["samples"].get(_LATENCY_FAMILY + "_count", 0.0)
    depth = queue["samples"].get(_QUEUE_FAMILY, 0.0)
    return ServeSignal(latency_buckets=buckets, latency_count=count,
                       queue_depth=depth)


def aggregate_signals(
    signals: Sequence[ServeSignal],
) -> Optional[Tuple[Optional[float], float]]:
    """(p99 across ALL replicas' requests, mean queue depth per replica).

    Buckets are summed across replicas before the quantile: the tier's p99
    is the p99 of the union of requests, not the mean of per-replica p99s
    (which would let one drowning replica hide behind nine idle ones)."""
    if not signals:
        return None
    summed: Dict[float, float] = {}
    for sig in signals:
        for bound, count in sig.latency_buckets:
            summed[bound] = summed.get(bound, 0.0) + count
    buckets = sorted(summed.items())
    p99 = histogram_quantile(buckets, 0.99)
    queue = sum(sig.queue_depth for sig in signals) / len(signals)
    return p99, queue


# -- the LM tier's signal ------------------------------------------------------
#
# An LM replica's user-felt load is per-TOKEN latency (a stream is hundreds
# of device steps; request latency just measures generation length), and
# its capacity ceiling is KV-cache memory, not queue slots. So the LM
# scaling signal pairs the `edl_lm_token_latency_seconds` p99 with the
# `edl_lm_kv_occupancy` gauge — and occupancy aggregates by MAX, not mean:
# streams cannot split across replicas, so one full pool rejects real
# traffic no matter how empty its neighbors are.


@dataclass
class LMServeSignal:
    """One LM replica's scraped load state."""

    #: cumulative (le_upper_bound, count) pairs, +inf last
    token_latency_buckets: List[Tuple[float, float]]
    token_count: float
    kv_occupancy: float


@dataclass
class LMServingSLO:
    """The LM tier's scaling contract: interactive decode targets ~10
    tokens/s/stream felt as <100 ms between tokens; KV headroom keeps
    admission from 429ing bursts."""

    p99_token_seconds: float = 0.1
    max_kv_occupancy: float = 0.85
    shrink_frac: float = 0.3
    shrink_occupancy_frac: float = 0.4


def scrape_lm_signal(url: str, timeout: float = 2.0) -> Optional[LMServeSignal]:
    """Scrape one LM replica's `/metrics` into an :class:`LMServeSignal`;
    None when unreachable or not yet exporting the LM families."""
    from edl_tpu_torch.obs.http import scrape_metrics
    from edl_tpu_torch.obs.metrics import parse_prometheus

    try:
        families = parse_prometheus(scrape_metrics(url, timeout=timeout))
    except (OSError, ValueError) as e:
        log.debug("LM serve scrape of %s failed: %s", url, e)
        return None
    latency = families.get(_TOKEN_LATENCY_FAMILY)
    occupancy = families.get(_KV_OCCUPANCY_FAMILY)
    if latency is None or occupancy is None:
        return None
    buckets = _parse_bucket_samples(latency["samples"], _TOKEN_LATENCY_FAMILY)
    count = latency["samples"].get(_TOKEN_LATENCY_FAMILY + "_count", 0.0)
    occ = occupancy["samples"].get(_KV_OCCUPANCY_FAMILY, 0.0)
    return LMServeSignal(token_latency_buckets=buckets, token_count=count,
                         kv_occupancy=occ)


def aggregate_lm_signals(
    signals: Sequence[LMServeSignal],
) -> Optional[Tuple[Optional[float], float]]:
    """(per-token p99 across ALL replicas' tokens, MAX KV occupancy)."""
    if not signals:
        return None
    summed: Dict[float, float] = {}
    for sig in signals:
        for bound, count in sig.token_latency_buckets:
            summed[bound] = summed.get(bound, 0.0) + count
    buckets = sorted(summed.items())
    p99 = histogram_quantile(buckets, 0.99)
    occupancy = max(sig.kv_occupancy for sig in signals)
    return p99, occupancy


def desired_lm_replica_delta(
    signals: Sequence[LMServeSignal],
    slo: LMServingSLO,
) -> int:
    """+1 / 0 / -1 LM replica from the aggregated signal, same hysteresis
    discipline as :func:`desired_replica_delta`. A shrink hands the
    doomed replica's streams to the router's migration path — the delta
    here only says the pool is oversized, never which streams move."""
    agg = aggregate_lm_signals(signals)
    if agg is None:
        return 0  # no scrapes landed: hold, never flap blind
    p99, occupancy = agg
    if (p99 is not None and p99 > slo.p99_token_seconds) \
            or occupancy > slo.max_kv_occupancy:
        return 1
    if (p99 is None or p99 < slo.shrink_frac * slo.p99_token_seconds) \
            and occupancy < slo.shrink_occupancy_frac * slo.max_kv_occupancy:
        return -1
    return 0


def desired_replica_delta(
    signals: Sequence[ServeSignal],
    slo: ServingSLO,
) -> int:
    """+1 / 0 / -1 replica from the aggregated SLO signal. The caller
    (controller autoscaler) clamps to [min, max] and commits through
    cluster-resource accounting — this function only reads the SLO."""
    agg = aggregate_signals(signals)
    if agg is None:
        return 0  # no scrapes landed: hold, never flap blind
    p99, queue = agg
    if (p99 is not None and p99 > slo.p99_seconds) \
            or queue > slo.max_queue_per_replica:
        return 1
    if (p99 is None or p99 < slo.shrink_frac * slo.p99_seconds) \
            and queue < slo.shrink_queue_frac * slo.max_queue_per_replica:
        return -1
    return 0
