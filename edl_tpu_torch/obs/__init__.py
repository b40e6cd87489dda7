"""The telemetry plane of the workers and the serving tier: copies of
`edl_tpu.obs`.

- :mod:`edl_tpu_torch.obs.metrics` — the metrics registry, Prometheus text
  exposition and its parser.
- :mod:`edl_tpu_torch.obs.tracing` — the span recorder, the rescale
  trace id (the membership epoch) and the timeline stitcher.
- :mod:`edl_tpu_torch.obs.http` — `/metrics`, `/healthz` and `/spans` on a
  stdlib HTTP server, and `scrape_metrics`.
- :mod:`edl_tpu_torch.obs.bridge` — the native coordinator's ``status``
  counters republished as ``edl_coordinator_*`` gauges at scrape time, so
  one scrape of a worker sees the control plane and the data plane.
- :mod:`edl_tpu_torch.obs.instruments` — the worker, checkpoint-plane,
  preemption, fault-tolerance-policy and serving instrument sets, with the
  JAX package's family names.

``python -m edl_tpu_torch.obs`` is the obs smoke (`obs.__main__`).

Stdlib-only: importing it loads no torch.
"""

from edl_tpu_torch.obs.bridge import CoordinatorStatusBridge
from edl_tpu_torch.obs.http import MetricsServer, ObsRequestHandler, scrape_metrics
from edl_tpu_torch.obs.instruments import (LMServeInstruments, ServeInstruments,
                                           WorkerInstruments)
from edl_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    parse_prometheus,
)
from edl_tpu_torch.obs.tracing import (Span, Tracer, get_tracer, load_spans,
                                      rescale_timeline, rescale_trace_id)

__all__ = [
    "CoordinatorStatusBridge",
    "Counter",
    "Gauge",
    "Histogram",
    "LMServeInstruments",
    "MetricsRegistry",
    "MetricsServer",
    "ObsRequestHandler",
    "ServeInstruments",
    "Span",
    "Tracer",
    "WorkerInstruments",
    "get_registry",
    "get_tracer",
    "load_spans",
    "parse_prometheus",
    "rescale_timeline",
    "rescale_trace_id",
    "scrape_metrics",
]
