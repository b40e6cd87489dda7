"""Process-wide metrics registry with Prometheus text exposition: a copy of
`edl_tpu.obs.metrics`.

Stdlib-only and import-cheap: the serving tier instruments itself when it
is built, and nothing here pulls torch along.

Three instrument kinds, all label-aware:

- :class:`Counter` — monotonic float, ``inc()``.
- :class:`Gauge` — last-write-wins float, ``set()`` / ``inc()``.
- :class:`Histogram` — cumulative buckets + sum + count, ``observe()``.

Instruments are created through the registry (``registry.counter(...)``),
which is get-or-create by metric name: every call site referring to one
family shares one instrument. The default process registry is
:func:`get_registry`.

Exposition: :meth:`MetricsRegistry.render_prometheus` emits the Prometheus
text format (``# HELP``/``# TYPE`` + samples; histograms as ``_bucket``/
``_sum``/``_count`` with cumulative ``le``) — what `/metrics` serves.
:meth:`MetricsRegistry.snapshot` returns the same data as JSON-ready dicts.
:func:`parse_prometheus` is the matching parser the serve smokes and the
tests assert through, so the format is validated by round-trip. The family
names the serving tier exports are the JAX package's, letter for letter:
its autoscaler and router scrape them.

Collectors: pull-model sources register a callback via
:meth:`MetricsRegistry.register_collector`; it runs at scrape time, *before*
the registry lock is taken, so a collector that blocks on I/O never stalls
other scrapes and instrument writes.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "set_registry",
    "parse_prometheus",
]

#: Default histogram buckets: 1 ms .. 60 s, tuned for step/RPC latencies
#: (the two things this system times most).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labelnames: Sequence[str], labels: Mapping[str, str]) -> _LabelKey:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} do not match declared {sorted(labelnames)}"
        )
    return tuple((k, str(labels[k])) for k in labelnames)


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(key: _LabelKey, extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = list(key)
    if extra is not None:
        pairs.append(extra)
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in pairs)
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    """Shared shell: name, help, declared label names, per-labelset cells."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 lock: threading.Lock):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock  # the owning registry's lock (one lock, no nesting)
        self._cells: Dict[_LabelKey, object] = {}

    def _key(self, labels: Mapping[str, str]) -> _LabelKey:
        return _label_key(self.labelnames, labels)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._cells[key] = float(self._cells.get(key, 0.0)) + amount

    def value(self, **labels: str) -> float:
        with self._lock:
            return float(self._cells.get(self._key(labels), 0.0))

    def _render(self) -> List[str]:
        with self._lock:
            cells = dict(self._cells)
        return [f"{self.name}{_fmt_labels(k)} {_fmt_value(v)}"
                for k, v in sorted(cells.items())]

    def _samples(self) -> List[dict]:
        with self._lock:
            cells = dict(self._cells)
        return [{"labels": dict(k), "value": v} for k, v in sorted(cells.items())]


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._cells[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._cells[key] = float(self._cells.get(key, 0.0)) + amount

    def value(self, **labels: str) -> float:
        with self._lock:
            return float(self._cells.get(self._key(labels), 0.0))

    _render = Counter._render
    _samples = Counter._samples


class _HistCell:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # per-bucket (non-cumulative) counts
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 lock: threading.Lock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames, lock)
        b = sorted(float(x) for x in buckets)
        if not b:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = tuple(b)  # +Inf is implicit

    def observe(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        v = float(value)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = _HistCell(len(self.buckets) + 1)
            idx = len(self.buckets)  # +Inf slot
            for i, le in enumerate(self.buckets):
                if v <= le:
                    idx = i
                    break
            cell.counts[idx] += 1
            cell.sum += v
            cell.count += 1

    def cell(self, **labels: str) -> Dict[str, float]:
        with self._lock:
            c = self._cells.get(self._key(labels))
            if c is None:
                return {"sum": 0.0, "count": 0.0}
            return {"sum": c.sum, "count": float(c.count)}

    def _render(self) -> List[str]:
        with self._lock:
            cells = [(k, list(c.counts), c.sum, c.count)
                     for k, c in self._cells.items()]
        lines: List[str] = []
        for key, counts, total, count in sorted(cells, key=lambda t: t[0]):
            cum = 0
            for le, n in zip(self.buckets, counts):
                cum += n
                lines.append(
                    f"{self.name}_bucket{_fmt_labels(key, ('le', _fmt_value(le)))} {cum}"
                )
            lines.append(
                f"{self.name}_bucket{_fmt_labels(key, ('le', '+Inf'))} {count}"
            )
            lines.append(f"{self.name}_sum{_fmt_labels(key)} {_fmt_value(total)}")
            lines.append(f"{self.name}_count{_fmt_labels(key)} {count}")
        return lines

    def _samples(self) -> List[dict]:
        with self._lock:
            cells = [(k, c.sum, c.count) for k, c in self._cells.items()]
        return [{"labels": dict(k), "sum": s, "count": n}
                for k, s, n in sorted(cells, key=lambda t: t[0])]


class MetricsRegistry:
    """Name -> instrument map plus scrape-time collectors.

    One lock guards both the name map and every cell (instruments share it);
    all critical sections are dict/list operations — blocking work
    (collector callbacks) runs outside it by construction.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: List[Callable[[], None]] = []

    # -- instrument factories (get-or-create by name) --------------------------

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kwargs) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind} "
                        f"with labels {m.labelnames}"
                    )
                return m
            m = cls(name, help, labelnames, self._lock, **kwargs)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    # -- collectors ------------------------------------------------------------

    def register_collector(self, fn: Callable[[], None]) -> None:
        """``fn`` runs at every scrape, before rendering — pull-model sources
        (status bridges, cluster snapshots) refresh their gauges there. It
        may block on I/O (it runs outside the registry lock) but should
        bound its own timeouts: the scrape waits on it."""
        with self._lock:
            self._collectors.append(fn)

    def unregister_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def _run_collectors(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            fn()  # a collector that can fail guards itself

    # -- exposition ------------------------------------------------------------

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4 of everything registered."""
        self._run_collectors()
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        out: List[str] = []
        for m in metrics:
            if m.help:
                out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.kind}")
            out.extend(m._render())
        return "\n".join(out) + "\n"

    def snapshot(self) -> Dict[str, dict]:
        """JSON-ready view: {name: {kind, help, samples}} (histogram samples
        carry sum/count, not buckets — benches want the moments)."""
        self._run_collectors()
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        return {
            m.name: {"kind": m.kind, "help": m.help, "samples": m._samples()}
            for m in metrics
        }


#: The process-wide default registry. Module-level instrument creation all
#: over the tree funnels here, which is the point: one scrape, every layer.
_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process default (tests isolating counters). Returns the
    previous registry so callers can restore it. Note instruments cached by
    long-lived objects keep pointing at the old registry — swap before
    constructing the system under test."""
    global _REGISTRY
    prev = _REGISTRY
    _REGISTRY = registry
    return prev


# -- exposition parser ---------------------------------------------------------


def parse_prometheus(text: str) -> Dict[str, dict]:
    """Parse text exposition into {family: {"kind", "samples": {...}}}.

    ``samples`` maps the rendered sample name + labelset (verbatim, e.g.
    ``edl_step_time_seconds_bucket{le="0.05"}``) to its float value.
    Histogram/summary series (``_bucket``/``_sum``/``_count``) attach to
    their declared family. Raises ValueError on lines that fit neither the
    comment nor the sample grammar — the e2e test's "parses as Prometheus
    text exposition" is this function succeeding.
    """
    families: Dict[str, dict] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                # TYPE is authoritative even when a HELP line (or a sample)
                # already created the family as untyped.
                fam = families.setdefault(parts[2], {"samples": {}})
                fam["kind"] = parts[3]
            elif len(parts) >= 3 and parts[1] == "HELP":
                families.setdefault(parts[2], {"kind": "untyped", "samples": {}})
            continue
        # sample line: name[{labels}] value
        brace = line.find("{")
        if brace >= 0:
            close = line.rfind("}")
            if close < brace:
                raise ValueError(f"unbalanced labels: {line!r}")
            name = line[:brace]
            rest = line[close + 1:].strip()
        else:
            name, _, rest = line.partition(" ")
            rest = rest.strip()
        if not name or not rest:
            raise ValueError(f"not a sample line: {line!r}")
        value = float(rest.split()[0])  # tolerate a trailing timestamp
        family = name
        for suffix in ("_bucket", "_sum", "_count"):
            base = name[: -len(suffix)] if name.endswith(suffix) else None
            if base and base in families:
                family = base
                break
        families.setdefault(family, {"kind": "untyped", "samples": {}})
        key = line[: close + 1] if brace >= 0 else name
        families[family]["samples"][key] = value
    return families
