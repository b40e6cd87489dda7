"""Shared instrument sets for the runtime's moving parts: a copy of
`edl_tpu.obs.instruments`.

The metric *names* live here, once, and are the JAX package's letter for
letter: `ElasticWorker` and `MultiHostWorker` record into the same
``edl_worker_*`` families (with the checkpoint plane's, the preemption
plane's and the fault-tolerance policy's), and the serving replicas into
``edl_serve_*`` and ``edl_lm_*``. Dashboards, the `/metrics` scrape and the
JAX package's autoscaler and router read them, so a renamed family would
break them. Creation is get-or-create against the registry, so a second
worker or replica in one process reuses the same instruments.
"""

from __future__ import annotations

import time
from typing import Optional

from edl_tpu_torch.obs.metrics import MetricsRegistry, get_registry

__all__ = ["WorkerInstruments", "FTPolicyInstruments", "ServeInstruments",
           "LMServeInstruments", "CkptPlaneInstruments", "PreemptInstruments",
           "OUTAGE_BUCKETS", "SERVE_LATENCY_BUCKETS", "NOTICE_BUCKETS",
           "TOKEN_LATENCY_BUCKETS"]

#: outage-duration buckets: sub-second blips through multi-minute storms.
#: The default latency buckets top out at 60 s — exactly where the park
#: decision gets interesting — so outages get their own scale.
OUTAGE_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                  120.0, 300.0, 600.0)

#: notice-to-drained buckets: spot notices run 25-120 s, and a healthy
#: drain (evacuate + replan + shrink) should finish in single-digit
#: seconds — the interesting resolution is "how much notice was left".
NOTICE_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 20.0, 30.0, 45.0, 60.0, 120.0)

#: request-latency buckets: the serving SLO lives in the 1 ms - 1 s band
#: (queue wait + pad + device step), far below the default latency
#: buckets' 60 s ceiling. The autoscaler computes its p99 from these
#: cumulative buckets, so the resolution here bounds its signal quality.
SERVE_LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                         0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

#: per-token decode latency buckets: a healthy decode step runs in the
#: 1-100 ms band (one single-token step plus its batch assembly), and
#: anything past 1 s means a stream stalled behind a warm-up or a rescale.
#: Finer low-end resolution than the request buckets because the LM SLO is
#: per *token*, not per request.
TOKEN_LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                         0.1, 0.25, 0.5, 1.0, 2.5)


class WorkerInstruments:
    """The worker-side sensor suite: heartbeat latency, outbox depth,
    degraded-mode time, epoch observations, rescales, parks."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        r = registry if registry is not None else get_registry()
        self.heartbeat_latency = r.histogram(
            "edl_worker_heartbeat_latency_seconds",
            "coordinator heartbeat round-trip time (dedicated beats only; "
            "coalesced beats cost no RPC and record no latency)",
        )
        self.heartbeats = r.counter(
            "edl_worker_heartbeats_total",
            "heartbeat observations, by transport path",
            labelnames=("path",),  # dedicated | coalesced
        )
        self.outbox_depth = r.gauge(
            "edl_worker_outbox_depth",
            "mutations buffered for replay (degraded mode)",
        )
        self.degraded_seconds = r.gauge(
            "edl_worker_degraded_seconds",
            "seconds of the CURRENT coordinator outage (0 while reachable)",
        )
        self.outage_seconds_total = r.gauge(
            "edl_worker_outage_seconds_total",
            "cumulative seconds spent with the coordinator unreachable",
        )
        self.outage_duration = r.histogram(
            "edl_worker_outage_duration_seconds",
            "per-incident coordinator outage lengths (the distribution the "
            "adaptive fault-tolerance policy sizes its wait window from; "
            "the running-total gauge loses exactly this)",
            buckets=OUTAGE_BUCKETS,
        )
        self.epoch = r.gauge(
            "edl_worker_epoch",
            "membership epoch this worker last adopted",
        )
        self.epoch_observations = r.counter(
            "edl_worker_epoch_observations_total",
            "membership epoch adoptions (register / rescale / outage rejoin)",
        )
        self.epoch_notify_latency = r.histogram(
            "edl_worker_epoch_notify_latency_seconds",
            "delay between a pushed epoch notification arriving on the "
            "watch stream and the worker loop consuming it (watch-based "
            "discovery only; pull rounds never record here)",
        )
        self.epoch_notifies = r.counter(
            "edl_worker_epoch_notifies_total",
            "pushed epoch notifications consumed from the watch stream",
        )
        self.pulls_suppressed = r.counter(
            "edl_worker_epoch_pulls_suppressed_total",
            "dedicated pull rounds skipped because a healthy watch "
            "subscription already covers epoch discovery",
        )
        self.rescales = r.counter(
            "edl_worker_rescales_total",
            "completed elastic rescales (first post-rescale step done)",
        )
        self.parks = r.counter(
            "edl_worker_parks_total",
            "times the outage budget expired and the worker checkpointed and parked",
        )
        self.steps = r.counter(
            "edl_worker_steps_total",
            "optimizer steps completed by this process",
        )

    # -- convenience recorders -------------------------------------------------

    def timed_heartbeat(self, client):
        """``client.heartbeat()`` with latency + path accounting."""
        t0 = time.perf_counter()
        reply = client.heartbeat()
        self.heartbeat_latency.observe(time.perf_counter() - t0)
        self.heartbeats.inc(path="dedicated")
        return reply

    def note_coalesced_heartbeat(self) -> None:
        self.heartbeats.inc(path="coalesced")

    def note_outage_state(self, client) -> None:
        """Refresh degraded-mode gauges from an OutboxClient-surface client.
        Safe on plain clients (missing surface reads as healthy)."""
        outage_seconds = getattr(client, "outage_seconds", None)
        self.degraded_seconds.set(
            float(outage_seconds()) if callable(outage_seconds) else 0.0
        )
        outbox = getattr(client, "outbox", None)
        self.outbox_depth.set(float(len(outbox)) if outbox is not None else 0.0)
        total = getattr(client, "outage_total_seconds", None)
        if isinstance(total, (int, float)):
            self.outage_seconds_total.set(
                float(total)
                + (float(outage_seconds()) if callable(outage_seconds) else 0.0)
            )

    def note_epoch(self, epoch: int) -> None:
        self.epoch.set(float(epoch))
        self.epoch_observations.inc()

    def note_epoch_notify(self, latency_seconds: float) -> None:
        """One pushed epoch notification consumed ``latency_seconds`` after
        it arrived on the watch stream."""
        self.epoch_notifies.inc()
        self.epoch_notify_latency.observe(max(0.0, latency_seconds))

    def note_pull_suppressed(self) -> None:
        self.pulls_suppressed.inc()


class ServeInstruments:
    """The serving replica's sensor suite: request latency (the autoscaler's
    p99 source), queue depth (its second signal), per-bucket dispatch
    counts (bucket-config tuning), and model-swap progress. One scrape
    answers both "is this replica keeping up?" and "which artifact version
    is it serving?"."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        r = registry if registry is not None else get_registry()
        self.requests = r.counter(
            "edl_serve_requests_total",
            "requests finished, by outcome",
            labelnames=("outcome",),  # ok | error | rejected
        )
        self.latency = r.histogram(
            "edl_serve_request_latency_seconds",
            "enqueue-to-result latency per request (queue wait + padding + "
            "device step); the autoscaler's p99 is computed from these "
            "cumulative buckets",
            buckets=SERVE_LATENCY_BUCKETS,
        )
        self.queue_wait = r.histogram(
            "edl_serve_queue_wait_seconds",
            "time a request sat queued before its batch was formed",
            buckets=SERVE_LATENCY_BUCKETS,
        )
        self.queue_depth = r.gauge(
            "edl_serve_queue_depth",
            "requests currently queued (sampled at enqueue and dispatch)",
        )
        self.inflight = r.gauge(
            "edl_serve_inflight_requests",
            "requests accepted and not yet resolved",
        )
        self.batches = r.counter(
            "edl_serve_batches_total",
            "batches dispatched, by bucket size (the bucket hit-rate table)",
            labelnames=("bucket",),
        )
        self.batch_occupancy = r.histogram(
            "edl_serve_batch_occupancy",
            "real requests / bucket slots per dispatched batch (1.0 = no "
            "padding waste; persistently low occupancy means the bucket "
            "ladder is too coarse or max_batch_delay too short)",
            buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0),
        )
        self.model_step = r.gauge(
            "edl_serve_model_step",
            "training step of the artifact currently being served",
        )
        self.model_swaps = r.counter(
            "edl_serve_model_swaps_total",
            "rolling model-version swaps completed without dropping requests",
        )
        self.compile_seconds = r.gauge(
            "edl_serve_compile_seconds",
            "warm-up time per bucket: one run on a zero batch, paid before "
            "the first request, never on the request path",
            labelnames=("bucket",),
        )


class LMServeInstruments:
    """The LM replica's sensor suite: token throughput (the headline
    number), per-token latency (the LM SLO), stream lifecycle by outcome,
    KV-block pressure (the admission currency), and prefill/decode batch
    sizes (how full the two phases' steps actually run). One scrape
    answers "how fast is this replica decoding, and is KV memory the
    bottleneck?"."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        r = registry if registry is not None else get_registry()
        self.tokens = r.counter(
            "edl_lm_tokens_total",
            "tokens emitted, by phase (prefill = the prompt's first "
            "generated token, decode = every subsequent one)",
            labelnames=("phase",),  # prefill | decode
        )
        self.token_latency = r.histogram(
            "edl_lm_token_latency_seconds",
            "inter-token latency per emitted token (previous emit — or "
            "admission, for the first token — to this emit); the LM "
            "autoscaler's p99 source",
            buckets=TOKEN_LATENCY_BUCKETS,
        )
        self.ttft = r.histogram(
            "edl_lm_ttft_seconds",
            "time to first token: admission to the prompt's first "
            "generated token (queue wait + prefill dispatch)",
            buckets=SERVE_LATENCY_BUCKETS,
        )
        self.streams = r.counter(
            "edl_lm_streams_total",
            "streams finished, by outcome (eos | length | rejected | "
            "evicted | error); evicted streams resume elsewhere — the "
            "router, not the replica, owns the zero-drop contract",
            labelnames=("outcome",),
        )
        self.active_streams = r.gauge(
            "edl_lm_active_streams",
            "streams holding KV cache and decoding right now",
        )
        self.waiting_streams = r.gauge(
            "edl_lm_waiting_streams",
            "admitted streams queued for their prefill dispatch",
        )
        self.kv_blocks_used = r.gauge(
            "edl_lm_kv_blocks_used",
            "KV-cache pool blocks currently reserved by live streams",
        )
        self.kv_blocks_free = r.gauge(
            "edl_lm_kv_blocks_free",
            "KV-cache pool blocks on the freelist (the admission headroom)",
        )
        self.kv_occupancy = r.gauge(
            "edl_lm_kv_occupancy",
            "fraction of KV-cache pool blocks reserved (1.0 = admission "
            "rejects everything until a stream retires)",
        )
        self.kv_fragmentation = r.gauge(
            "edl_lm_kv_fragmentation",
            "internal fragmentation: fraction of reserved KV token slots "
            "never written (max_new_tokens budgets running past actual "
            "generation lengths)",
        )
        self.prefill_batch = r.histogram(
            "edl_lm_prefill_batch_size",
            "real prompts per prefill dispatch (before padding to the "
            "batch bucket)",
            buckets=(1, 2, 4, 8, 16, 32, 64),
        )
        self.decode_batch = r.histogram(
            "edl_lm_decode_batch_size",
            "real streams per decode step dispatch (before padding); "
            "persistently low means the pool is starved or the seq-bucket "
            "ladder is splitting the batch",
            buckets=(1, 2, 4, 8, 16, 32, 64),
        )
        self.decode_steps = r.counter(
            "edl_lm_decode_steps_total",
            "decode-step executions, by (batch bucket, seq bucket) "
            "step — the LM analogue of the bucket hit-rate table",
            labelnames=("bucket", "seq_bucket"),
        )
        self.compile_seconds = r.gauge(
            "edl_lm_compile_seconds",
            "warm-up time per (phase, batch bucket, seq bucket): one run "
            "on a zero batch, paid before the first request",
            labelnames=("phase", "bucket", "seq_bucket"),
        )


class CkptPlaneInstruments:
    """The memory-resident checkpoint plane's sensor suite: how far behind
    the durable checkpoint the peer replicas run, how many bytes ride the
    wire, and — the fallback-ladder audit — which source each restore was
    served from (peer memory vs blob store)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        r = registry if registry is not None else get_registry()
        self.replication_lag = r.gauge(
            "edl_ckpt_plane_replication_lag_seconds",
            "seconds the last shard replication took end-to-end (host "
            "gather + serialize + wire); the window in which a worker loss "
            "would find the plane one step stale",
        )
        self.replicated_bytes = r.counter(
            "edl_ckpt_plane_replicated_bytes_total",
            "shard bytes pushed to the coordinator's memory-resident store",
        )
        self.replications = r.counter(
            "edl_ckpt_plane_replications_total",
            "shard replications completed (one per covered checkpoint)",
        )
        self.restores = r.counter(
            "edl_ckpt_plane_restores_total",
            "state restores by source: 'peer' = assembled from the plane "
            "in memory, 'blob' = fell back to the durable Checkpointer",
            labelnames=("source",),
        )
        self.restore_bytes = r.counter(
            "edl_ckpt_plane_restore_bytes_total",
            "restore bytes served, by source (peer vs blob)",
            labelnames=("source",),
        )


class PreemptInstruments:
    """The preemption plane's sensor suite: advance-notice revocations and
    the straggler detector that feeds the same drain path. One scrape
    answers "did we beat the deadline, and what did it cost?"."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        r = registry if registry is not None else get_registry()
        self.notices = r.counter(
            "edl_preempt_notices_total",
            "advance-notice revocation frames consumed, by reason "
            "(spot/maintenance/straggler/...)",
            labelnames=("reason",),
        )
        self.notice_remaining = r.gauge(
            "edl_preempt_notice_remaining_seconds",
            "seconds left on the most recently consumed notice when the "
            "policy decided (negative = decided after the deadline)",
        )
        self.notice_to_drained = r.histogram(
            "edl_preempt_notice_to_drained_seconds",
            "notice-arrival to drain-complete latency per revocation "
            "(evacuate + replan + shrink; must sit under the notice window)",
            buckets=NOTICE_BUCKETS,
        )
        self.evictions = r.counter(
            "edl_preempt_evictions_total",
            "workers drained out through the revocation path, by trigger "
            "(revocation = scheduler notice, straggler = slow-host evict)",
            labelnames=("trigger",),
        )
        self.steps_lost = r.counter(
            "edl_preempt_steps_lost_total",
            "optimizer steps re-trained because a revocation beat the "
            "drain (0 is the contract for any notice >= the drain cost)",
        )
        self.straggler_ratio = r.gauge(
            "edl_straggler_step_ratio",
            "trailing-window per-host step-time quantile over the fleet "
            "median (1.0 = keeping pace; the eviction trigger compares "
            "this against its threshold for consecutive windows)",
            labelnames=("host",),
        )
        self.straggler_breaches = r.counter(
            "edl_straggler_breaches_total",
            "windows in which a host's step-time quantile breached the "
            "eviction threshold (hysteresis counts these, not raw steps)",
            labelnames=("host",),
        )
        self.straggler_evictions = r.counter(
            "edl_straggler_evictions_total",
            "hosts evicted by the straggler detector (always also counted "
            "in edl_preempt_evictions_total{trigger=straggler})",
        )


class FTPolicyInstruments:
    """The fault-tolerance policy engine's audit surface: which mode was
    chosen, how often, and the live inputs the choice was computed from.
    One scrape answers "why did this worker park?"."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        r = registry if registry is not None else get_registry()
        self.decisions = r.counter(
            "edl_ft_policy_decisions_total",
            "recovery-mode decisions taken, by mode",
            labelnames=("mode",),  # wait | reconnect | warm_restart | park
        )
        self.mode = r.gauge(
            "edl_ft_policy_mode",
            "last decided recovery mode "
            "(0=wait 1=reconnect 2=warm_restart 3=park)",
        )
        self.incidents = r.counter(
            "edl_ft_policy_incidents_total",
            "coordinator-outage incidents the policy adjudicated",
        )
        self.park_threshold = r.gauge(
            "edl_ft_policy_park_threshold_seconds",
            "escalation threshold (frozen per incident; the static budget "
            "until min_history incidents close)",
        )
        self.outage_quantile = r.gauge(
            "edl_ft_policy_outage_quantile_seconds",
            "residual quantile of the closed-incident outage durations",
        )
        self.checkpoint_cost = r.gauge(
            "edl_ft_policy_checkpoint_cost_seconds",
            "EMA of measured durable-checkpoint cost (park break-even input)",
        )
        self.restep_cost = r.gauge(
            "edl_ft_policy_restep_cost_seconds",
            "live cost of re-training steps since the last durable "
            "checkpoint (steps x step-seconds EMA)",
        )
        self.failure_rate = r.gauge(
            "edl_ft_policy_failure_rate_per_min",
            "closed incidents per minute over the trailing window "
            "(storm detector input)",
        )
        self.restore_cost = r.gauge(
            "edl_ft_policy_restore_cost_seconds",
            "EMA of measured restore cost by source (peer = checkpoint "
            "plane, blob = durable store); the break-even the policy's "
            "restore_source() and park pricing read",
            labelnames=("source",),
        )
