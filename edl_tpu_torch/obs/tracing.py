"""Structured span tracing with cross-process correlation ids: a copy of
`edl_tpu.obs.tracing`.

A :class:`Span` is a named interval with a ``trace_id`` correlator, a
``component`` (which side of the system emitted it: "worker",
"controller", "bench"), and free-form attributes. Spans append to an
in-memory ring (for same-process assertions and the `/spans` endpoint)
and, when a sink is attached, stream as JSONL — one JSON object per line,
the shape :func:`load_spans` reads back, the same as the JAX package's.

The serving tier records ``serve_request``, ``model_swap``, ``lm_prefill``
and ``lm_decode_step`` spans here. For the one lifecycle that spans
processes — an elastic rescale — the membership epoch IS the shared id:
every worker adopts the same epoch from its re-register, and
:func:`rescale_trace_id` turns it into the common ``trace_id``.
:func:`rescale_timeline` stitches every side's spans into the
phase-attributed recovery breakdown (`RESCALE_PHASES`).
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, TextIO, Union

__all__ = [
    "Span",
    "Tracer",
    "get_tracer",
    "rescale_trace_id",
    "rescale_timeline",
    "load_spans",
    "RESCALE_PHASES",
]

#: The rescale lifecycle's phase vocabulary, in causal order. The e2e test
#: and the bench assert all of these appear under one rescale trace id.
#: ``preempt_drain`` is the advance-notice window (notice arrival through
#: doomed-rank shard evacuation — degenerate-but-present on rescales no
#: notice triggered, keeping the completeness gate unconditional),
#: ``replan`` is the layout search (planner argmin over candidate meshes —
#: degenerate-but-present on data-only resizes) and ``reshard`` is the
#: host-to-device window that moves restored state onto the new mesh layout.
RESCALE_PHASES = ("preempt_drain", "drain", "checkpoint", "replan",
                  "warm_compile", "restore", "reshard", "first_step")


def rescale_trace_id(epoch: int) -> str:
    """The shared rescale correlator: both sides observe the same membership
    epoch (bump_epoch reply on the controller, register/sync reply on the
    worker), so both stamp the same id without talking to each other."""
    return f"rescale-e{int(epoch):06d}"


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

    Thread-safe (worker main loop, pump thread, warm-compile thread and the
    scrape handler all record concurrently); the critical section is a list
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
        """Record an interval measured by the caller (after-the-fact spans:
        the drain interval is only attributable once the new epoch is
        known). Zero-length intervals are clamped to a microsecond so phase
        durations are strictly positive — "this phase happened" must never
        round down to "it took no time". A microsecond, not a nanosecond:
        these are epoch-seconds floats (~2e9), where double precision eats
        anything under ~2.4e-7 and a 1e-9 clamp silently rounds back to
        zero length."""
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
            except (OSError, ValueError):  # edl: noqa[EDL005] a torn/closed sink must not kill the training loop; the in-memory ring still has the span
                pass
        return span

    @contextlib.contextmanager
    def span(self, name: str, trace_id: str = "", **attrs: Any):
        """Context-managed span; records on exit (also on exception, with
        ``error`` attached — a failed phase is still a phase)."""
        t0 = time.time()
        try:
            yield
        except BaseException as e:
            self.record(name, t0, time.time(), trace_id=trace_id,
                        error=type(e).__name__, **attrs)
            raise
        self.record(name, t0, time.time(), trace_id=trace_id, **attrs)

    def event(self, name: str, trace_id: str = "", **attrs: Any) -> Span:
        """Point-in-time marker (epoch observation, decision taken)."""
        now = time.time()
        return self.record(name, now, now, trace_id=trace_id, **attrs)

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


#: Process-wide default tracer, mirroring the metrics registry's role: every
#: layer records into one stream so a single export carries the whole story.
_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    global _TRACER
    prev = _TRACER
    _TRACER = tracer
    return prev


# -- cross-process stitching ---------------------------------------------------


def load_spans(path: str) -> List[dict]:
    """Read a JSONL event stream, keeping span records only. Tolerates
    interleaved non-span lines (profiler records, collector samples) — in a
    pod all streams may share one stdout."""
    out: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # foreign line in a shared stream
            if isinstance(rec, dict) and rec.get("kind") == "span":
                out.append(rec)
    return out


def _as_dict(span: Union[Span, dict]) -> dict:
    return span.to_dict() if isinstance(span, Span) else span


def rescale_timeline(spans: Iterable[Union[Span, dict]],
                     trace_id: Optional[str] = None) -> Dict[str, dict]:
    """Stitch spans (from any number of processes) into per-trace phase
    breakdowns.

    Returns ``{trace_id: {"phases": {name: {...}}, "components": [...],
    "wall_seconds": ..., "span_count": n}}``. A phase recorded more than
    once under one trace (both sides timing "restore") keeps the longest
    observation — its ``attrs`` ride along — and counts the repeats. ``wall_seconds`` is last end minus
    first start across the whole trace — the number recovery budgets are
    written against; per-phase seconds attribute it (phases may overlap:
    warm_compile runs concurrent with restore by design, so the sum of
    phases can exceed the wall).

    Every recorded phase appears in ``phases`` — nothing is filtered against
    ``RESCALE_PHASES`` here — and names outside that vocabulary are
    additionally listed under ``unknown_phases`` so a misspelled or
    unregistered phase surfaces in the timeline instead of silently failing
    downstream completeness gates (which iterate ``RESCALE_PHASES`` and
    would otherwise never look at the stray name).
    """
    by_trace: Dict[str, List[dict]] = {}
    for s in spans:
        d = _as_dict(s)
        tid = d.get("trace_id", "")
        if not tid or (trace_id is not None and tid != trace_id):
            continue
        by_trace.setdefault(tid, []).append(d)
    out: Dict[str, dict] = {}
    for tid, recs in sorted(by_trace.items()):
        phases: Dict[str, dict] = {}
        for d in sorted(recs, key=lambda r: (r.get("start", 0.0), r.get("name", ""))):
            name = d.get("name", "")
            seconds = float(d.get("seconds",
                                  d.get("end", 0.0) - d.get("start", 0.0)))
            cur = phases.get(name)
            if cur is None:
                phases[name] = {
                    "seconds": seconds,
                    "start": d.get("start", 0.0),
                    "end": d.get("end", 0.0),
                    "component": d.get("component", ""),
                    "attrs": dict(d.get("attrs") or {}),
                    "count": 1,
                }
            else:
                cur["count"] += 1
                if seconds > cur["seconds"]:
                    cur.update(seconds=seconds, start=d.get("start", 0.0),
                               end=d.get("end", 0.0),
                               component=d.get("component", ""),
                               attrs=dict(d.get("attrs") or {}))
        starts = [d.get("start", 0.0) for d in recs]
        ends = [d.get("end", 0.0) for d in recs]
        out[tid] = {
            "phases": phases,
            "unknown_phases": sorted(
                n for n in phases if n not in RESCALE_PHASES),
            "components": sorted({d.get("component", "") for d in recs} - {""}),
            "wall_seconds": (max(ends) - min(starts)) if recs else 0.0,
            "span_count": len(recs),
        }
    return out
