"""Structured span tracing: the span recorder of `edl_tpu.obs.tracing`.

A :class:`Span` is a named interval with a ``trace_id`` correlator, a
``component`` (which side of the system emitted it) and free-form
attributes. Spans append to an in-memory ring (for same-process assertions
and the `/spans` endpoint) and, when a sink is attached, stream as JSONL —
one JSON object per line, the same shape as the JAX package's spans.

The serving tier records ``serve_request``, ``model_swap``, ``lm_prefill``
and ``lm_decode_step`` spans here. The JAX package's rescale-timeline
stitching arrives with the elastic worker's slice.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, TextIO

__all__ = ["Span", "Tracer", "get_tracer", "set_tracer"]


@dataclass
class Span:
    """One named interval. ``start``/``end`` are epoch seconds (wall clock:
    spans from different processes must land on one timeline)."""

    name: str
    start: float
    end: float
    trace_id: str = ""
    component: str = ""
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def to_dict(self) -> dict:
        d = {
            "kind": "span",
            "name": self.name,
            "start": round(self.start, 6),
            "end": round(self.end, 6),
            "seconds": round(self.seconds, 6),
            "trace_id": self.trace_id,
            "component": self.component,
        }
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class Tracer:
    """Span recorder: bounded in-memory ring + optional JSONL sink.

    Thread-safe (the engine thread, the dispatch and watcher threads and the
    HTTP handlers all record concurrently); the critical section is a list
    append — sink writes happen outside the lock.
    """

    def __init__(self, component: str = "", sink: Optional[TextIO] = None,
                 window: int = 50_000):
        self.component = component
        self.sink = sink
        self.window = window
        self.spans: List[Span] = []
        self._lock = threading.Lock()

    # -- recording -------------------------------------------------------------

    def record(self, name: str, start: float, end: float, trace_id: str = "",
               component: str = "", **attrs: Any) -> Span:
        """Record an interval measured by the caller. Zero-length intervals
        are clamped to a microsecond so a span's duration is strictly
        positive; a microsecond, not a nanosecond, because double precision
        on epoch seconds (~2e9) eats anything under ~2.4e-7."""
        if end <= start:
            end = start + 1e-6
        span = Span(name=name, start=start, end=end, trace_id=trace_id,
                    component=component or self.component, attrs=dict(attrs))
        sink = self.sink
        with self._lock:
            self.spans.append(span)
            if len(self.spans) > self.window:
                del self.spans[: len(self.spans) - self.window]
        if sink is not None:
            try:
                sink.write(json.dumps(span.to_dict()) + "\n")
                sink.flush()
            except (OSError, ValueError):
                pass  # a torn or closed sink must not kill the caller; the ring keeps the span
        return span

    # -- reading ---------------------------------------------------------------

    def find(self, trace_id: Optional[str] = None,
             name: Optional[str] = None) -> List[Span]:
        with self._lock:
            spans = list(self.spans)
        return [s for s in spans
                if (trace_id is None or s.trace_id == trace_id)
                and (name is None or s.name == name)]

    def to_jsonl(self) -> str:
        with self._lock:
            spans = list(self.spans)
        return "".join(json.dumps(s.to_dict()) + "\n" for s in spans)


#: Process-wide default tracer, mirroring the metrics registry's role.
_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    global _TRACER
    prev = _TRACER
    _TRACER = tracer
    return prev
