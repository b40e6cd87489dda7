"""Adaptive fault-tolerance policy: choose the recovery mode per incident.

A copy of `edl_tpu.runtime.ft_policy`.

The runtime has the recovery *mechanisms* (outbox degraded mode, in-place
re-register, gang warm-restart, checkpoint-and-park) and the *sensors*
(outage totals, retry counters, rescale phase timings); a frozen 60 s
``outage_budget`` alone would pay identically for a 200 ms network blip
and a coordinator storm. This module is the decision layer (Chameleon,
PAPERS.md; the 100k-GPU fault-tolerant-HSDP playbook): per incident, pick
the cheapest recovery
mode from live failure statistics —

======================  =====================================================
mode                    when
======================  =====================================================
``wait``                outage still inside what history predicts: leased
                        batches keep stepping, mutations buffer (degraded
                        mode costs nothing the coordinator was providing).
``reconnect``           the coordinator answered again before the threshold:
                        in-place re-register (``takeover=False``) keeps every
                        lease — the blip path, free.
``warm_restart``        the escalation terminal for a lockstep multi-host
                        gang: one process cannot park alone, the whole gang
                        exits ``RESCALE_EXIT_CODE`` and restores.
``park``                the escalation terminal for a single-host worker:
                        checkpoint durably, then poll re-register until the
                        coordinator returns.
======================  =====================================================

The escalation threshold is *computed, not configured*: once ``min_history``
incidents have closed, it is

    clamp(max(Q_q(outage history) * quantile_margin,
              park_cost_factor * (checkpoint + restore + re-step cost)),
          min_wait, outage_budget)

— wait as long as outages have historically lasted (times a margin), but
never less than it would cost to park and come back (parking during a blip
is pure loss), and never longer than the static budget (the old worst
case). Re-step cost is live: steps since the last durable checkpoint times
the step-seconds EMA — right after a checkpoint parking is cheap, late in
an interval it is not. Under a failure *storm* (closed-incident rate above
``storm_rate_per_min``) the policy also shortens the transport's retry
deadline so calls fail fast into degraded mode instead of burning the
budget inside one RPC.

**Hysteresis is structural, not tuned.** Two properties make mode flapping
impossible by construction rather than unlikely:

1. the threshold is *frozen when the incident opens* — history that
   accumulates mid-incident cannot move the goalposts under the comparison,
   so ``elapsed > threshold`` flips at most once per incident;
2. the per-incident decision ladder is *monotone* — ``wait`` may escalate
   to the terminal mode, never the reverse; de-escalation only happens by
   the incident closing (reconnect), which starts a fresh incident with a
   fresh frozen threshold.

``policy="static"`` is the escape hatch: the threshold is pinned to
``outage_budget`` exactly (the pre-policy semantics), while the telemetry
below still flows.

Every decision is auditable: ``edl_ft_policy_*`` gauges/counters expose the
current mode, the frozen threshold, and each decision input, and each
transition emits an ``ft_decision`` span event carrying the numbers the
choice was made from. See doc/robustness.md (policy layer).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from edl_tpu_torch.obs.instruments import FTPolicyInstruments
from edl_tpu_torch.obs.tracing import Tracer, get_tracer

__all__ = [
    "WAIT",
    "RECONNECT",
    "WARM_RESTART",
    "PARK",
    "PEER_RESTORE",
    "DRAIN_SHRINK",
    "RIDE_OUT",
    "MODE_CODES",
    "FTPolicyConfig",
    "FTPolicy",
]

#: recovery modes, ordered by escalation cost.
WAIT = "wait"
RECONNECT = "reconnect"
WARM_RESTART = "warm_restart"
PARK = "park"
#: restore served from the memory-resident checkpoint plane (peer-replicated
#: ZeRO shards) instead of the blob store — not an escalation rung but a
#: restore-source decision, recorded with the same audit machinery.
PEER_RESTORE = "peer_restore"
#: advance-notice revocation outcomes (the notice-budget decision): enough
#: notice to evacuate shards + replan + shrink before the deadline...
DRAIN_SHRINK = "drain_shrink"
#: ...or so little that the cheapest move is to keep stepping and let the
#: surprise-failure machinery (peer replicas, requeued leases) absorb it.
RIDE_OUT = "ride_out"

#: numeric encoding for the ``edl_ft_policy_mode`` gauge (Prometheus
#: gauges carry floats; the mapping is part of the metric's contract).
MODE_CODES: Dict[str, int] = {WAIT: 0, RECONNECT: 1, WARM_RESTART: 2, PARK: 3,
                              PEER_RESTORE: 4, DRAIN_SHRINK: 5, RIDE_OUT: 6}


@dataclass
class FTPolicyConfig:
    """Knobs for the adaptive policy. The defaults are deliberately
    conservative: with no incident history the engine behaves exactly like
    the static budget, so a fleet upgrade changes nothing until evidence
    accumulates."""

    #: ``adaptive`` computes the escalation threshold from live statistics;
    #: ``static`` pins it to ``outage_budget`` (the pre-policy semantics).
    policy: str = "adaptive"
    #: the static threshold, and the adaptive threshold's hard ceiling —
    #: adaptive may escalate sooner than the old budget, never later.
    outage_budget: float = 60.0
    #: closed incidents required before the adaptive rule activates;
    #: below this the static budget applies (cold start = old behavior).
    min_history: int = 3
    #: outage-duration quantile the wait window is sized from.
    residual_quantile: float = 0.95
    #: margin multiplier on the quantile: wait a bit longer than history's
    #: worst typical outage before concluding this one is different.
    quantile_margin: float = 1.5
    #: escalation must cost less than waiting: the park break-even is this
    #: factor times (checkpoint + restore + re-step) cost.
    park_cost_factor: float = 2.0
    #: adaptive threshold floor — never escalate on sub-blip noise.
    min_wait: float = 1.0
    #: closed-incident rate (per minute, over the trailing window) above
    #: which the regime counts as a storm.
    storm_rate_per_min: float = 6.0
    #: transport retry deadline to apply during a storm (seconds); the
    #: default client deadline otherwise. Failing fast into degraded mode
    #: beats spending the outage budget inside one RPC's retry loop.
    storm_retry_deadline: float = 5.0
    #: closed incidents retained for the quantile / rate estimates.
    history_size: int = 64
    #: EMA smoothing for the step/checkpoint/restore cost estimates.
    cost_alpha: float = 0.3
    #: safety divisor on an advance-notice budget: a drain is attempted
    #: only when the remaining notice covers its predicted cost with this
    #: much headroom (clock skew, straggling evacuation chunks).
    notice_margin: float = 1.25

    def __post_init__(self) -> None:
        if self.policy not in ("adaptive", "static"):
            raise ValueError(
                f"FTPolicyConfig.policy must be 'adaptive' or 'static', "
                f"got {self.policy!r}")
        if self.outage_budget <= 0:
            raise ValueError(
                f"FTPolicyConfig.outage_budget must be > 0, "
                f"got {self.outage_budget!r}")
        if self.min_history < 1:
            raise ValueError(
                f"FTPolicyConfig.min_history must be >= 1, "
                f"got {self.min_history!r}")
        if not 0.0 < self.residual_quantile <= 1.0:
            raise ValueError(
                f"FTPolicyConfig.residual_quantile must be in (0, 1], "
                f"got {self.residual_quantile!r}")


class FTPolicy:
    """Per-worker recovery-mode selector.

    Wiring contract (see ``ElasticWorker`` / ``MultiHostWorker``):

    - cost feeds: :meth:`note_step`, :meth:`note_checkpoint_cost`,
      :meth:`note_restore_cost` keep the break-even live;
    - each degraded-mode poll calls :meth:`on_outage` with the elapsed
      outage and gets back ``wait`` or the caller's escalation terminal
      (``park`` single-host, ``warm_restart`` lockstep gang);
    - :meth:`note_outage_closed` (the OutboxClient ``on_outage_close``
      callback, or the caller's own clock) closes the incident, feeds the
      duration history, and records the ``reconnect`` decision when the
      incident closed without escalating.

    ``clock`` is injectable so policy tests run in deterministic fake time.
    """

    def __init__(
        self,
        config: Optional[FTPolicyConfig] = None,
        worker: str = "",
        instruments: Optional[FTPolicyInstruments] = None,
        tracer: Optional[Tracer] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.config = config if config is not None else FTPolicyConfig()
        self.worker = worker
        self.obs = instruments if instruments is not None \
            else FTPolicyInstruments()
        self.tracer = tracer if tracer is not None else get_tracer()
        self.clock = clock
        #: closed-incident durations, oldest first (trailing window).
        self.history: List[float] = []
        #: clock() stamps of incident closes (failure-rate estimate).
        self._closed_at: List[float] = []
        self.incidents = 0
        #: decision counts by mode, mirrored into the counter metric.
        self.decisions: Dict[str, int] = {m: 0 for m in MODE_CODES}
        self._last_mode = RECONNECT  # "healthy" between incidents
        # -- live cost model (EMA) --
        self._step_ema = 0.0
        self._ckpt_ema = 0.0
        self._restore_ema = 0.0
        self._peer_restore_ema = 0.0
        self._replan_ema = 0.0
        self._steps_since_ckpt = 0
        # -- incident state (the hysteresis core) --
        #: threshold frozen at incident open; None while healthy.
        self._frozen_threshold: Optional[float] = None
        #: monotone escalation latch: once the incident escalated, every
        #: further poll re-reports the terminal mode without re-deciding.
        self._escalated: Optional[str] = None
        self.obs.mode.set(float(MODE_CODES[self._last_mode]))

    # -- cost feeds ------------------------------------------------------------

    def _ema(self, prev: float, x: float) -> float:
        a = self.config.cost_alpha
        return x if prev == 0.0 else (1.0 - a) * prev + a * x

    def note_step(self, seconds: float) -> None:
        self._step_ema = self._ema(self._step_ema, max(0.0, seconds))
        self._steps_since_ckpt += 1

    def note_checkpoint_cost(self, seconds: float) -> None:
        self._ckpt_ema = self._ema(self._ckpt_ema, max(0.0, seconds))
        self._steps_since_ckpt = 0
        self.obs.checkpoint_cost.set(self._ckpt_ema)

    def note_restore_cost(self, seconds: float) -> None:
        self._restore_ema = self._ema(self._restore_ema, max(0.0, seconds))
        self.obs.restore_cost.set(self._restore_ema, source="blob")

    def note_replan_cost(self, seconds: float) -> None:
        """Layout-replanner solve + relayout time: one input of the
        notice-budget drain decision."""
        self._replan_ema = self._ema(self._replan_ema, max(0.0, seconds))

    def note_peer_restore(self, seconds: float) -> None:
        """A restore was served from the checkpoint plane: feed its cost EMA
        and record the ``peer_restore`` decision (the fallback-ladder audit
        trail — 'why did this worker NOT read the blob store?')."""
        self._peer_restore_ema = self._ema(
            self._peer_restore_ema, max(0.0, seconds))
        self.obs.restore_cost.set(self._peer_restore_ema, source="peer")
        self._decide(PEER_RESTORE, seconds)

    def restore_source(self) -> str:
        """Break-even restore-source choice: ``"peer"`` unless BOTH costs
        have been measured and the blob restore is cheaper. Optimistic
        peer-first is safe — an unreadable plane demotes to the blob
        restore anyway, so the only cost of guessing wrong is one failed
        in-memory probe; guessing blob wrongly forgoes the fast path."""
        if (self._peer_restore_ema > 0.0 and self._restore_ema > 0.0
                and self._restore_ema < self._peer_restore_ema):
            return "blob"
        return "peer"

    def effective_restore_cost(self) -> float:
        """Restore cost the park break-even should price: the cheapest
        measured source (a worker that restores from peers in 100 ms should
        not wait out an outage as if it paid the blob read)."""
        costs = [c for c in (self._restore_ema, self._peer_restore_ema)
                 if c > 0.0]
        return min(costs) if costs else 0.0

    def restep_cost(self) -> float:
        """Re-train cost of losing uncheckpointed progress right now."""
        return self._steps_since_ckpt * self._step_ema

    def park_breakeven(self) -> float:
        """Waiting longer than this costs more than parking would."""
        return self.config.park_cost_factor * (
            self._ckpt_ema + self.effective_restore_cost()
            + self.restep_cost()
        )

    # -- history statistics ----------------------------------------------------

    def outage_quantile(self) -> float:
        """``residual_quantile`` of the closed-incident durations (0.0 with
        no history). Nearest-rank on the sorted trailing window — 64 floats,
        no interpolation subtleties."""
        if not self.history:
            return 0.0
        ordered = sorted(self.history)
        rank = max(0, int(len(ordered) * self.config.residual_quantile + 0.5) - 1)
        return ordered[min(rank, len(ordered) - 1)]

    def failure_rate_per_min(self) -> float:
        """Closed incidents per minute over the trailing history window."""
        if len(self._closed_at) < 2:
            return 0.0
        span = self._closed_at[-1] - self._closed_at[0]
        if span <= 0.0:
            return 0.0
        return (len(self._closed_at) - 1) * 60.0 / span

    def in_storm(self) -> bool:
        return (len(self.history) >= self.config.min_history
                and self.failure_rate_per_min()
                >= self.config.storm_rate_per_min)

    def retry_deadline(self) -> Optional[float]:
        """Transport retry deadline this regime wants, or None for the
        client default. Under a storm every RPC should fail fast into
        degraded mode instead of retrying through the whole budget."""
        if self.in_storm():
            return self.config.storm_retry_deadline
        return None

    # -- the decision ----------------------------------------------------------

    def threshold(self) -> float:
        """The escalation threshold the *next* incident would open with
        (an open incident keeps its frozen value — see :meth:`on_outage`)."""
        cfg = self.config
        if cfg.policy == "static" or len(self.history) < cfg.min_history:
            return cfg.outage_budget
        want = max(
            self.outage_quantile() * cfg.quantile_margin,
            self.park_breakeven(),
        )
        return min(cfg.outage_budget, max(cfg.min_wait, want))

    def drain_cost(self) -> float:
        """Predicted seconds a drain-and-shrink takes: evacuate the doomed
        ranks' shards (priced as one checkpoint pass), re-solve the mesh,
        restore on the survivors. Unmeasured terms price as 0 — cold start
        is optimistic by design (attempting a drain that overruns degrades
        to exactly what riding it out would have cost)."""
        return (self._ckpt_ema + self._replan_ema
                + self.effective_restore_cost())

    def on_preempt_notice(self, notice_remaining_s: float) -> str:
        """The notice-budget decision: with ``notice_remaining_s`` seconds
        until revocation, pick the cheapest exit.

        - ``drain_shrink`` when the margin-discounted budget covers the
          full measured drain cost (evacuate + replan + restore): the job
          shrinks onto the survivors with zero lost steps.
        - ``park`` when the budget covers at least a durable checkpoint:
          save and park, resume when replacement capacity shows up.
        - ``ride_out`` when the notice is shorter than even a checkpoint:
          spending it on a doomed save is pure loss — keep stepping and let
          the surprise-failure machinery absorb the kill.

        Stateless with respect to the outage machinery: a revocation is not
        an outage (the coordinator is healthy), so no incident opens and no
        hysteresis latch applies — each notice decides fresh."""
        budget = max(0.0, notice_remaining_s) / max(
            1.0, self.config.notice_margin)
        if budget >= self.drain_cost():
            mode = DRAIN_SHRINK
        elif self._ckpt_ema > 0.0 and budget >= self._ckpt_ema:
            mode = PARK
        else:
            mode = RIDE_OUT
        self._decide(mode, notice_remaining_s,
                     notice_remaining_s=round(notice_remaining_s, 6),
                     drain_cost=round(self.drain_cost(), 6))
        return mode

    def on_outage(self, elapsed: float, escalate_mode: str = PARK) -> str:
        """One degraded-mode poll: ``elapsed`` seconds into the current
        outage, decide ``wait`` or ``escalate_mode``.

        First call of an incident freezes the threshold (hysteresis rule 1)
        and publishes the decision inputs; once escalated, the latch
        re-reports the terminal mode without re-evaluating (rule 2)."""
        if self._frozen_threshold is None:
            self._frozen_threshold = self.threshold()
            self._escalated = None
            self.incidents += 1
            self.obs.incidents.inc()
            self._publish_inputs()
            self._decide(WAIT, elapsed)
        if self._escalated is not None:
            return self._escalated
        if elapsed > self._frozen_threshold:
            self._escalated = escalate_mode
            self._decide(escalate_mode, elapsed)
            return escalate_mode
        return WAIT

    def note_outage_closed(self, duration: float) -> None:
        """Incident over (the coordinator answered again). Feeds the
        duration into history, and — when the incident closed without
        escalating — records the in-place ``reconnect`` decision. Also
        closes incidents the poll loop never saw (sub-heartbeat blips the
        outbox opened and closed between two beats)."""
        cfg = self.config
        self.history.append(max(0.0, duration))
        self._closed_at.append(self.clock())
        if len(self.history) > cfg.history_size:
            self.history = self.history[-cfg.history_size:]
            self._closed_at = self._closed_at[-cfg.history_size:]
        if self._frozen_threshold is None:
            self.incidents += 1  # blip closed before any poll saw it
            self.obs.incidents.inc()
        escalated = self._escalated
        self._frozen_threshold = None
        self._escalated = None
        if escalated is None:
            self._decide(RECONNECT, duration)
        self._publish_inputs()

    def _decide(self, mode: str, elapsed: float, **extra) -> None:
        self.decisions[mode] += 1
        self._last_mode = mode
        self.obs.decisions.inc(mode=mode)
        self.obs.mode.set(float(MODE_CODES[mode]))
        self.tracer.event(
            "ft_decision",
            component="worker",
            worker=self.worker,
            mode=mode,
            policy=self.config.policy,
            elapsed=round(elapsed, 6),
            threshold=round(self._frozen_threshold
                            if self._frozen_threshold is not None
                            else self.threshold(), 6),
            outage_quantile=round(self.outage_quantile(), 6),
            park_breakeven=round(self.park_breakeven(), 6),
            failure_rate_per_min=round(self.failure_rate_per_min(), 4),
            incidents=self.incidents,
            history=len(self.history),
            **extra,
        )

    def _publish_inputs(self) -> None:
        self.obs.park_threshold.set(
            self._frozen_threshold if self._frozen_threshold is not None
            else self.threshold())
        self.obs.outage_quantile.set(self.outage_quantile())
        self.obs.restep_cost.set(self.restep_cost())
        self.obs.checkpoint_cost.set(self._ckpt_ema)
        self.obs.failure_rate.set(self.failure_rate_per_min())

    # -- introspection ---------------------------------------------------------

    @property
    def last_mode(self) -> str:
        return self._last_mode

    @property
    def incident_open(self) -> bool:
        return self._frozen_threshold is not None

    @property
    def frozen_threshold(self) -> float:
        """The threshold governing the open incident (the would-be value
        for the next incident when healthy)."""
        return (self._frozen_threshold if self._frozen_threshold is not None
                else self.threshold())

    def state(self) -> Dict:
        """The auditable policy state: published to the coordinator KV
        (``edl/ft_policy/<worker>``), surfaced by ``edl-tpu status`` and the
        worker's ``/healthz``."""
        return {
            "policy": self.config.policy,
            "mode": self._last_mode,
            "incidents": self.incidents,
            "decisions": dict(self.decisions),
            "threshold": round(
                self._frozen_threshold if self._frozen_threshold is not None
                else self.threshold(), 3),
            "outage_quantile": round(self.outage_quantile(), 3),
            "park_breakeven": round(self.park_breakeven(), 3),
            "restore_source": self.restore_source(),
            "restore_cost_blob": round(self._restore_ema, 3),
            "restore_cost_peer": round(self._peer_restore_ema, 3),
            "replan_cost": round(self._replan_ema, 3),
            "drain_cost": round(self.drain_cost(), 3),
            "failure_rate_per_min": round(self.failure_rate_per_min(), 3),
            "storm": self.in_storm(),
            "history": len(self.history),
        }
