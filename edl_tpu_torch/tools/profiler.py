"""Step-time and trace instrumentation for the training runtime: the port of
`edl_tpu.tools.profiler`.

Three pieces, as in the JAX package:

- :class:`StepProfiler` — host-side per-step accounting (wall time,
  samples, rolling throughput, percentiles). Pure data structure; feed it
  from any loop via :meth:`StepProfiler.step` or wrap an iterator. It
  never synchronises the device: on a card, as on a TPU, a host step
  measures the launch rate until the queue fills.
- :func:`trace` — context manager around ``torch.profiler`` that writes a
  TensorBoard-loadable trace (CPU and CUDA activity) of the enclosed steps.
- :func:`annotate_step` / :func:`annotation` — named ranges
  (``torch.profiler.record_function``) so the hot loop's phases are
  visible in traces.

Device memory introspection (:func:`device_memory_stats`) reports the
caching allocator's figures and the card's capacity for each card this
process has initialised; on the CPU it returns {}.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, TextIO

import torch

from edl_tpu_torch.obs.metrics import get_registry

__all__ = [
    "StepProfiler",
    "StepRecord",
    "trace",
    "annotation",
    "annotate_step",
    "device_memory_stats",
]

log = logging.getLogger("edl_tpu_torch.tools.profiler")


@dataclass
class StepRecord:
    """One step's host-side observation."""

    step: int
    seconds: float
    samples: int
    loss: Optional[float] = None
    #: excluded from steady-state summaries (first step / post-rescale).
    warmup: bool = False
    #: host-side batch placement time (wire encode + H2D copy) attributed
    #: to this step. In the synchronous loop it is part of ``seconds``; in
    #: the pipelined loop it ran on the pump thread and overlapped an
    #: earlier step's device compute.
    place_seconds: Optional[float] = None
    #: analytic bandwidth-model ESTIMATE of this step's data-plane
    #: collective time (`Trainer.data_plane` — bytes-on-wire closed form
    #: over per-tier bandwidths), not a measurement: it exposes the
    #: bytes-vs-time structure next to the measured ``seconds``.
    collective_seconds: Optional[float] = None

    def to_dict(self) -> dict:
        d = {"step": self.step, "seconds": round(self.seconds, 6), "samples": self.samples}
        if self.loss is not None and not math.isnan(self.loss):
            d["loss"] = self.loss
        if self.warmup:
            d["warmup"] = True
        if self.place_seconds is not None:
            d["place_ms"] = round(self.place_seconds * 1e3, 3)
        if self.collective_seconds is not None:
            d["collective_ms"] = round(self.collective_seconds * 1e3, 3)
        return d


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return float("nan")
    idx = q * (len(sorted_vals) - 1)
    lo = int(math.floor(idx))
    hi = int(math.ceil(idx))
    if lo == hi:
        return sorted_vals[lo]
    frac = idx - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


class StepProfiler:
    """Accumulates per-step wall times and derives throughput statistics.

    Skips the first ``warmup`` steps in summaries (they include the first
    step's allocations and, in the workers, a rescale's rebuild) but still
    records them, so traces line up with records. A bounded window keeps
    memory constant on long runs.
    """

    def __init__(self, warmup: int = 1, window: int = 10_000,
                 sink: Optional[TextIO] = None, model: Optional[Any] = None,
                 n_chips: Optional[int] = None):
        self.warmup = warmup
        self.window = window
        self.sink = sink
        #: optional zoo model: when it declares analytic ``flops_per_step``
        #: (models.base convention) the summary also reports achieved
        #: TFLOP/s a card and MFU against the card's peak.
        self.model = model
        #: None = unset (Trainer.run fills it from its mesh); an explicit
        #: value — including 1 for whole-job figures — is never overwritten.
        self.n_chips = n_chips
        #: the card the MFU peak is read for; None = unset (Trainer.run
        #: fills it with its device; else the current CUDA device).
        self.device: Any = None
        #: None = unset; Trainer.run fills it with its `data_plane` dict so
        #: the summary can report ``grad_bytes_per_step`` next to the
        #: measured step times without re-deriving the byte model here.
        self.data_plane: Optional[Dict[str, Any]] = None
        self.records: List[StepRecord] = []
        self._count = 0
        self._mark: Optional[float] = None
        self._pending_warmup = 0
        # Registry mirrors of the per-step series: JSONL sinks carry the
        # full history, /metrics carries the live distribution. Get-or-create
        # means every profiler in the process feeds the same families.
        registry = get_registry()
        self._m_step_time = registry.histogram(
            "edl_step_time_seconds",
            "training step wall time, by phase (steady vs warmup/recompile)",
            labelnames=("phase",),
        )
        self._m_samples = registry.counter(
            "edl_step_samples_total", "training examples consumed",
        )
        self._m_place_time = registry.histogram(
            "edl_place_time_seconds",
            "host-side batch placement time (wire decode + H2D sharding)",
        )
        self._m_collective_est = registry.gauge(
            "edl_collective_time_estimate_seconds",
            "analytic data-plane collective-time estimate for the current "
            "mesh/layout (a model, not a measurement)",
        )

    # -- feeding ---------------------------------------------------------------

    def start(self) -> None:
        """Mark the start of a step (optional; ``step`` falls back to the
        previous step's end)."""
        self._mark = time.perf_counter()

    def mark_warmup(self, n: int = 1) -> None:
        """Flag the next ``n`` steps as warmup — call when the upcoming step
        runs on a rebuilt Trainer (after an elastic rescale)."""
        self._pending_warmup += n

    def step(self, samples: int, loss: Optional[float] = None,
             place_seconds: Optional[float] = None,
             collective_seconds: Optional[float] = None) -> StepRecord:
        """Record one completed step of ``samples`` examples.

        ``place_seconds`` — this batch's host placement time, recorded as
        its own series so the place/step split survives into jsonl sinks
        and summaries (the pipelined loop's placement happens off the
        dispatch thread, invisible to ``seconds``).

        ``collective_seconds`` — the analytic data-plane collective
        estimate for this step (`Trainer.data_plane`); a model series, not
        a measurement, kept per-record so jsonl sinks line it up against
        the measured ``seconds``."""
        now = time.perf_counter()
        start = self._mark if self._mark is not None else now
        is_warmup = self._count < self.warmup or self._pending_warmup > 0
        if self._pending_warmup > 0:
            self._pending_warmup -= 1
        rec = StepRecord(step=self._count, seconds=now - start,
                         samples=samples, loss=loss, warmup=is_warmup,
                         place_seconds=place_seconds,
                         collective_seconds=collective_seconds)
        self._count += 1
        self._mark = now
        self._m_step_time.observe(rec.seconds,
                                  phase="warmup" if is_warmup else "steady")
        self._m_samples.inc(samples)
        if place_seconds is not None:
            self._m_place_time.observe(place_seconds)
        if collective_seconds is not None:
            self._m_collective_est.set(collective_seconds)
        self.records.append(rec)
        if len(self.records) > self.window:
            del self.records[: len(self.records) - self.window]
        if self.sink is not None:
            self.sink.write(json.dumps(rec.to_dict()) + "\n")
            self.sink.flush()
        return rec

    def wrap(self, batches: Iterator[Dict[str, Any]],
             batch_size_of=lambda b: len(next(iter(b.values())))) -> Iterator[Dict[str, Any]]:
        """Yield from ``batches`` while timing each consumer iteration."""
        self.start()
        for batch in batches:
            yield batch
            self.step(batch_size_of(batch))

    # -- summaries -------------------------------------------------------------

    @property
    def steady(self) -> List[StepRecord]:
        return [r for r in self.records if not r.warmup]

    def summary(self) -> Dict[str, float]:
        steady = self.steady
        if not steady:
            # Well-defined empty summary: same keys as the populated one,
            # all finite zeros — a zero-step run (rescale before the first
            # steady step, a crashed worker's flush) must aggregate cleanly,
            # never throw or emit NaN percentiles downstream.
            return {
                "steps": float(self._count),
                "steady_steps": 0.0,
                "samples_per_sec": 0.0,
                "step_time_mean_s": 0.0,
                "step_time_p50_s": 0.0,
                "step_time_p95_s": 0.0,
                "step_time_max_s": 0.0,
            }
        times = sorted(r.seconds for r in steady)
        total = sum(times)
        samples = sum(r.samples for r in steady)
        out = {
            "steps": float(self._count),
            "steady_steps": float(len(steady)),
            # total == 0 can only happen with clamped/mocked clocks; report
            # 0 throughput rather than inf (inf is not JSON-representable).
            "samples_per_sec": samples / total if total > 0 else 0.0,
            "step_time_mean_s": total / len(steady),
            "step_time_p50_s": _percentile(times, 0.5),
            "step_time_p95_s": _percentile(times, 0.95),
            "step_time_max_s": times[-1],
        }
        places = sorted(r.place_seconds for r in steady
                        if r.place_seconds is not None)
        if places:
            out["place_time_mean_s"] = sum(places) / len(places)
            out["place_time_p50_s"] = _percentile(places, 0.5)
        colls = [r.collective_seconds for r in steady
                 if r.collective_seconds is not None]
        if colls:
            # an estimate series (see StepRecord.collective_seconds) —
            # constant within a mesh/layout, so mean is the whole story
            out["collective_time_est_mean_s"] = sum(colls) / len(colls)
        if self.data_plane is not None:
            out["grad_bytes_per_step"] = float(
                self.data_plane["grad_bytes_per_step"]
            )
            out["data_plane_bytes_per_step"] = float(
                self.data_plane["bytes_per_step"]
            )
        if getattr(self.model, "flops_per_step", None) is not None \
                and total > 0 and samples:
            from edl_tpu_torch.tools.mfu import mfu_fields

            # One accounting implementation (mfu.mfu_fields): analytic
            # FLOPs are linear in batch size, so batch_size=1 at the steady
            # samples/s rate gives the achieved figure. Only the non-null
            # fields join the summary.
            acct = mfu_fields(self.model, 1, samples / total,
                              n_chips=self.n_chips or 1, device=self.device)
            if acct.get("tflops_per_sec") is not None:
                out["tflops_per_sec"] = acct["tflops_per_sec"]
            if acct.get("mfu") is not None:
                out["mfu"] = acct["mfu"]
        return out


# -- trace capture -------------------------------------------------------------


@contextlib.contextmanager
def trace(logdir: str):
    """Write a TensorBoard-loadable trace of the enclosed block to
    ``logdir`` (``torch.profiler`` over the CPU and, with a card, CUDA
    activity; `tensorboard_trace_handler` writes it as the block ends).

    A profiler that is already running in this process (a second session
    raises) or one that fails to start degrades to a logged no-op instead
    of failing the training run. Profiler errors surface at ``__enter__``/
    ``__exit__`` — both are guarded; errors from the traced block itself
    propagate untouched.
    """
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    prof = None
    if torch.autograd.profiler._is_profiler_enabled:
        log.warning("trace(%s): a profiler is already running; not tracing", logdir)
    else:
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        try:
            prof = profile(activities=activities,
                           on_trace_ready=tensorboard_trace_handler(logdir))
            prof.__enter__()
        except Exception:  # edl: noqa[EDL005] degrade to no-op: a profiler that cannot start must not kill training
            log.warning("trace(%s): the profiler did not start; not tracing", logdir,
                        exc_info=True)
            prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
            except Exception:  # edl: noqa[EDL005] trace teardown is best-effort; errors from the traced block propagate separately
                log.warning("trace(%s): writing the trace failed", logdir, exc_info=True)


def annotation(name: str):
    """Named range visible in captured traces (host + device timeline)."""
    return torch.profiler.record_function(name)


def annotate_step(step: int):
    """Step marker that groups a training step's ops in a trace: a range
    named ``train#<step>`` (torch's own steps are ``ProfilerStep#<n>``)."""
    return torch.profiler.record_function(f"train#{step}")


# -- device memory -------------------------------------------------------------


def _initialised_cards() -> List[int]:
    """The cards this process has a CUDA context on, read without making
    one on any other card (a port process is one rank on one card)."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    has_context = getattr(torch._C, "_cuda_hasPrimaryContext", None)
    if has_context is None:
        return [torch.cuda.current_device()]
    return [i for i in range(torch.cuda.device_count()) if has_context(i)]


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per-card memory stats, as the JAX package reports a TPU's HBM:
    ``{card index: {bytes_in_use, peak_bytes_in_use, bytes_reserved,
    peak_bytes_reserved, num_allocs, bytes_limit, bytes_free}}``, ints.
    The first five are the caching allocator's (`torch.cuda.memory_stats`),
    the last two the card's (`torch.cuda.mem_get_info`: its capacity, and
    what no process holds). Only the cards this process has initialised;
    {} on the CPU, as the JAX CPU backend reports.
    """
    out: Dict[str, Dict[str, int]] = {}
    for i in _initialised_cards():
        stats = torch.cuda.memory_stats(i)
        free, total = torch.cuda.mem_get_info(i)
        out[str(i)] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
            "peak_bytes_reserved": int(stats.get("reserved_bytes.all.peak", 0)),
            "num_allocs": int(stats.get("allocation.all.allocated", 0)),
            "bytes_limit": int(total),
            "bytes_free": int(free),
        }
    return out
