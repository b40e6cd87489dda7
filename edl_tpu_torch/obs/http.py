"""`/metrics` + `/healthz` (+ `/spans`) on a stdlib HTTP server: a copy of
`edl_tpu.obs.http`.

One :class:`MetricsServer` per process: Prometheus
scrapes `/metrics`, liveness probes hit `/healthz`, and `/spans` dumps the
tracer's ring as JSONL so a rescale timeline can be stitched from a live
process without log access. No dependencies beyond ``http.server`` — pods
must not grow a web framework to be observable.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from edl_tpu_torch.obs.metrics import MetricsRegistry, get_registry
from edl_tpu_torch.obs.tracing import Tracer, get_tracer

__all__ = ["MetricsServer", "ObsRequestHandler", "scrape_metrics"]


class _Handler(BaseHTTPRequestHandler):
    server_version = "edl-obs/1"

    # set per-server via the factory in MetricsServer.start
    registry: MetricsRegistry
    tracer: Optional[Tracer]
    health: Optional[Callable[[], Dict]]

    def do_GET(self) -> None:  # noqa: N802 (stdlib handler contract)
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            try:
                body = self.registry.render_prometheus().encode()
            except Exception as e:  # edl: noqa[EDL005] surfaced to the scraper as HTTP 500 — a broken collector fails the scrape loudly instead of killing the server thread
                self.send_error(500, f"scrape failed: {type(e).__name__}: {e}")
                return
            self._reply(body, "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/healthz":
            payload = {"ok": True, "time": time.time()}
            if self.health is not None:
                try:
                    payload.update(self.health())
                except Exception as e:  # edl: noqa[EDL005] health detail is best-effort; the probe still answers (degraded, visibly)
                    payload.update(ok=False, error=f"{type(e).__name__}: {e}")
            self._reply(json.dumps(payload).encode(), "application/json")
        elif path == "/spans":
            tracer = self.tracer if self.tracer is not None else get_tracer()
            self._reply(tracer.to_jsonl().encode(), "application/jsonl")
        else:
            self.send_error(404, "try /metrics, /healthz or /spans")

    def _reply(self, body: bytes, content_type: str) -> None:
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, format: str, *args) -> None:
        pass  # scrapes every few seconds must not spam the pod log


#: public alias for subclassing: the serving frontend extends this handler
#: with `do_POST /predict` while inheriting /metrics, /healthz and /spans.
ObsRequestHandler = _Handler


class MetricsServer:
    """Serve the registry (and tracer) over HTTP on a daemon thread.

    ``port=0`` binds an ephemeral port (tests); :attr:`port` reports the
    actual one after :meth:`start`. ``health`` is an optional callable whose
    dict merges into `/healthz` — a serving replica puts its status there.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 host: str = "0.0.0.0", port: int = 0,
                 health: Optional[Callable[[], Dict]] = None,
                 handler_cls: type = _Handler,
                 handler_attrs: Optional[Dict] = None):
        self.registry = registry if registry is not None else get_registry()
        self.tracer = tracer
        self.host = host
        self.port = port
        self.health = health
        self.handler_cls = handler_cls
        self.handler_attrs = dict(handler_attrs or {})
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsServer":
        if self._httpd is not None:
            return self
        registry, tracer, health = self.registry, self.tracer, self.health

        class Handler(self.handler_cls):
            pass

        Handler.registry = registry
        Handler.tracer = tracer
        # staticmethod: a plain function stored as a class attribute would
        # otherwise bind as a method and receive the handler instance as an
        # unwanted first argument (bound methods happened to work, functions
        # and lambdas broke).
        Handler.health = None if health is None else staticmethod(health)
        for key, value in self.handler_attrs.items():
            # same binding trap as `health`: bare functions become methods.
            if isinstance(value, type(scrape_metrics)):
                value = staticmethod(value)
            setattr(Handler, key, value)
        httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        httpd.daemon_threads = True
        self._httpd = httpd
        self.port = httpd.server_address[1]
        self._thread = threading.Thread(
            target=httpd.serve_forever, name="edl-metrics-http", daemon=True,
            kwargs={"poll_interval": 0.2},
        )
        self._thread.start()
        return self

    @property
    def url(self) -> str:
        host = "127.0.0.1" if self.host in ("0.0.0.0", "") else self.host
        return f"http://{host}:{self.port}"

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def scrape_metrics(url: str, timeout: float = 5.0) -> str:
    """GET ``url`` (a full /metrics URL or a server base URL) and return the
    exposition text — the smoke target's and tests' scrape path."""
    if not url.rstrip("/").endswith("/metrics"):
        url = url.rstrip("/") + "/metrics"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()
