"""The serving tier's instrument sets: the `ServeInstruments` and
`LMServeInstruments` halves of `edl_tpu.obs.instruments`.

The metric *names* live here, once, and are the JAX package's letter for
letter (``edl_serve_*``, ``edl_lm_*``): its autoscaler and router scrape
them, so a renamed family would break the controller. Creation is
get-or-create against the registry, so a second replica in one process
reuses the same instruments.
"""

from __future__ import annotations

from typing import Optional

from edl_tpu_torch.obs.metrics import MetricsRegistry, get_registry

__all__ = ["ServeInstruments", "LMServeInstruments", "SERVE_LATENCY_BUCKETS",
           "TOKEN_LATENCY_BUCKETS"]

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
