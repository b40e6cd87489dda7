"""The telemetry plane the serving tier needs: copies of `edl_tpu.obs`.

- :mod:`edl_tpu_torch.obs.metrics` — the metrics registry, Prometheus text
  exposition and its parser.
- :mod:`edl_tpu_torch.obs.tracing` — the span recorder.
- :mod:`edl_tpu_torch.obs.http` — `/metrics`, `/healthz` and `/spans` on a
  stdlib HTTP server, and `scrape_metrics`.
- :mod:`edl_tpu_torch.obs.instruments` — the batch and LM serving
  instrument sets, with the JAX package's family names.

Stdlib-only: importing it loads no torch.
"""

from edl_tpu_torch.obs.http import MetricsServer, ObsRequestHandler, scrape_metrics
from edl_tpu_torch.obs.instruments import LMServeInstruments, ServeInstruments
from edl_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    parse_prometheus,
)
from edl_tpu_torch.obs.tracing import Span, Tracer, get_tracer

__all__ = [
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
    "get_registry",
    "get_tracer",
    "parse_prometheus",
    "scrape_metrics",
]
