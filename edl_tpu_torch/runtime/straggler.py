"""Straggler detection: slow-host eviction through the revocation path.

A copy of `edl_tpu.runtime.straggler`.

Hosts degrade long before they die — thermal throttling, a flaky HBM
channel, a noisy neighbor on the NIC — and in lockstep data-parallel
training the whole fleet steps at the slowest host's pace. The detector
watches per-host step times over a trailing window (fed from the same
telemetry the metrics plane already scrapes), flags a host whose step-time
quantile runs persistently above the fleet median, and mitigates by
issuing the SAME ``preempt_notice`` a scheduled revocation uses — one
drain mechanism, two triggers (doc/robustness.md, scheduled revocation).

The statistics are deliberately boring and robust:

- per host, the ``quantile`` (default p95, nearest-rank) of its last
  ``window_steps`` step times — nearest-rank over a >=20-sample window
  shrugs off a single outlier by construction;
- the fleet baseline is the MEDIAN of the per-host medians — a degrading
  host cannot drag its own yardstick up, and half the fleet would have to
  degrade together to mask one straggler;
- a host breaches when quantile / baseline exceeds ``ratio_threshold``
  with at least ``min_samples`` observations; eviction requires
  ``consecutive_breaches`` successive evaluations to breach (hysteresis:
  one slow step — or one slow window — never evicts).

``clock`` is injectable so the trailing window runs in fake time under
test, matching the FTPolicy convention.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from edl_tpu_torch.obs.instruments import PreemptInstruments

__all__ = ["StragglerConfig", "StragglerDetector", "nearest_rank_quantile"]


def nearest_rank_quantile(samples: List[float], q: float) -> float:
    """Nearest-rank quantile on a small sample list (0.0 when empty).
    Same estimator `FTPolicy.outage_quantile` uses — no interpolation."""
    if not samples:
        return 0.0
    ordered = sorted(samples)
    rank = max(0, int(len(ordered) * q + 0.5) - 1)
    return ordered[min(rank, len(ordered) - 1)]


@dataclass
class StragglerConfig:
    """Knobs for the slow-host trigger. Defaults are conservative: a host
    must run 50% over the fleet for three straight evaluations before the
    detector spends capacity replacing it."""

    #: trailing per-host step-time samples retained.
    window_steps: int = 32
    #: per-host quantile compared against the fleet baseline.
    quantile: float = 0.95
    #: host quantile / fleet median above which a window breaches.
    ratio_threshold: float = 1.5
    #: observations a host needs before it can breach (a joining worker's
    #: first compile-laden steps never condemn it).
    min_samples: int = 16
    #: successive breaching evaluations required to evict (hysteresis).
    consecutive_breaches: int = 3
    #: advance notice granted to an evicted straggler's drain.
    notice_s: float = 30.0
    #: per-host quiet period after an eviction verdict (suppresses repeat
    #: verdicts while the drain is in flight).
    cooldown_s: float = 300.0

    def __post_init__(self) -> None:
        if not 0.0 < self.quantile <= 1.0:
            raise ValueError(
                f"StragglerConfig.quantile must be in (0, 1], "
                f"got {self.quantile!r}")
        if self.ratio_threshold <= 1.0:
            raise ValueError(
                f"StragglerConfig.ratio_threshold must be > 1.0, "
                f"got {self.ratio_threshold!r}")
        if self.consecutive_breaches < 1:
            raise ValueError(
                f"StragglerConfig.consecutive_breaches must be >= 1, "
                f"got {self.consecutive_breaches!r}")


class StragglerDetector:
    """Trailing-window slow-host detector with breach hysteresis.

    Wiring contract: the step loop (or a metrics-plane scraper) calls
    :meth:`note_step` per (host, step_seconds); the controller calls
    :meth:`evaluate` once per check interval and passes any verdicts to
    :meth:`evict` — which routes them through ``client.preempt_notice``,
    the identical drain path a scheduled revocation takes.
    """

    def __init__(self, config: Optional[StragglerConfig] = None,
                 instruments: Optional[PreemptInstruments] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config if config is not None else StragglerConfig()
        self.obs = instruments if instruments is not None \
            else PreemptInstruments()
        self.clock = clock
        self._samples: Dict[str, List[float]] = {}
        self._breach_streak: Dict[str, int] = {}
        self._cooldown_until: Dict[str, float] = {}
        self.evictions = 0

    # -- feeds -----------------------------------------------------------------

    def note_step(self, host: str, seconds: float) -> None:
        w = self._samples.setdefault(host, [])
        w.append(max(0.0, float(seconds)))
        if len(w) > self.config.window_steps:
            del w[:len(w) - self.config.window_steps]

    def forget(self, host: str) -> None:
        """Host left (drained, died, rescaled away): drop its window so a
        replacement under the same name starts clean."""
        self._samples.pop(host, None)
        self._breach_streak.pop(host, None)
        self._cooldown_until.pop(host, None)

    # -- statistics ------------------------------------------------------------

    def fleet_median(self) -> float:
        """Median of the per-host median step times (hosts with at least
        ``min_samples`` observations only)."""
        meds = [nearest_rank_quantile(w, 0.5)
                for w in self._samples.values()
                if len(w) >= self.config.min_samples]
        return nearest_rank_quantile(meds, 0.5)

    def host_ratio(self, host: str) -> float:
        """Host step-time quantile over the fleet median (0.0 until both
        sides have enough samples)."""
        w = self._samples.get(host, [])
        if len(w) < self.config.min_samples:
            return 0.0
        base = self.fleet_median()
        if base <= 0.0:
            return 0.0
        return nearest_rank_quantile(w, self.config.quantile) / base

    # -- the trigger -----------------------------------------------------------

    def evaluate(self) -> List[str]:
        """One detection round: returns hosts whose breach streak just
        crossed the hysteresis bar (eviction verdicts). A fleet of one is
        never evaluated — there is no peer to be slower than."""
        cfg = self.config
        now = self.clock()
        eligible = [h for h, w in self._samples.items()
                    if len(w) >= cfg.min_samples]
        if len(eligible) < 2:
            return []
        verdicts: List[str] = []
        for host in sorted(eligible):
            ratio = self.host_ratio(host)
            self.obs.straggler_ratio.set(ratio, host=host)
            if now < self._cooldown_until.get(host, 0.0):
                continue
            if ratio > cfg.ratio_threshold:
                streak = self._breach_streak.get(host, 0) + 1
                self._breach_streak[host] = streak
                self.obs.straggler_breaches.inc(host=host)
                if streak >= cfg.consecutive_breaches:
                    verdicts.append(host)
                    self._breach_streak[host] = 0
                    self._cooldown_until[host] = now + cfg.cooldown_s
            else:
                self._breach_streak[host] = 0
        return verdicts

    # -- the mitigation --------------------------------------------------------

    def evict(self, client, hosts: List[str]) -> List[str]:
        """Route eviction verdicts through the revocation drain path: the
        coordinator pushes each host a ``{"notify":"preempt"}`` frame with
        ``notice_s`` to drain, and the normal notice-budget machinery
        (FTPolicy, evacuate, replan) takes it from there. Returns the
        revoked names."""
        if not hosts:
            return []
        revoked = client.preempt_notice(list(hosts),
                                        notice_s=self.config.notice_s,
                                        reason="straggler")
        for _ in revoked:
            self.evictions += 1
            self.obs.straggler_evictions.inc()
            self.obs.evictions.inc(trigger="straggler")
        return revoked
