"""The serving replica: bucketed continuous batching over an exported
artifact, with rolling model-version swap. The port of
`edl_tpu.serving.worker`.

One :class:`ServingReplica` is one schedulable unit of the serving tier. It
loads a `load_inference_model` artifact onto its device, runs every batch
bucket once on a zero batch before it accepts traffic (PyTorch compiles
nothing ahead of time; the warm-up pays the first-call costs — cuBLAS
handles and workspaces, the caching allocator's blocks — off the request
path), then runs a continuous-batching dispatch loop: requests queue,
coalesce for at most ``max_batch_delay_s``, pad to the smallest bucket that
fits, and resolve per-request futures. A watcher thread polls the exporter
directory's atomic ``LATEST`` pointer, warms the new artifact's buckets and
swaps it in between batches — in-flight requests always run against a
complete module, so a version swap drops nothing.

Threading model: the dispatch loop, the version watcher, and the HTTP
frontend's request threads share the replica. Hand-off points are the queue
(its own lock), `concurrent.futures.Future` (its own lock), and every other
mutable field — module, warmed shapes, stats — behind ``self._lock``.
Batches read the module under the lock but run the device step OUTSIDE it,
so a swap never waits on a dispatch and vice versa.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from edl_tpu_torch.obs.instruments import ServeInstruments
from edl_tpu_torch.obs.metrics import MetricsRegistry
from edl_tpu_torch.obs.tracing import Tracer, get_tracer
from edl_tpu_torch.serving.batcher import (pad_batch, pick_bucket, split_rows,
                                           validate_buckets)

__all__ = ["ServingConfig", "ServingReplica", "ServeOverloadError",
           "ServeCompileError", "SERVING_KV_PREFIX"]

log = logging.getLogger("edl_tpu_torch.serving.worker")

#: coordinator KV slot a replica publishes its status to; the JAX package's
#: `edl-tpu status` joins members() against these keys
SERVING_KV_PREFIX = "edl/serving/"


class ServeOverloadError(RuntimeError):
    """Queue at capacity — the request was rejected, not dropped: the
    caller gets this synchronously and can retry against another replica
    (the autoscaler sees the same pressure via the queue-depth gauge)."""


class ServeCompileError(RuntimeError):
    """A bucket failed its warm-up run at startup (or a swap's). Raised
    from `start()`, never on the request path: a bucket the model cannot
    run fails the replica fast, before it takes traffic."""


@dataclass
class ServingConfig:
    """Knobs for one serving replica."""

    model_dir: str
    buckets: Tuple[int, ...] = (1, 8, 32)
    #: how long the dispatcher waits to fill a batch beyond its first
    #: request. 0 disables coalescing.
    max_batch_delay_s: float = 0.005
    queue_capacity: int = 1024
    request_timeout_s: float = 30.0
    #: LATEST-pointer poll period for the rolling-swap watcher
    version_poll_s: float = 0.25
    #: None: no HTTP frontend; 0: ephemeral port (tests); N: fixed port
    port: Optional[int] = None
    name: str = "serve-0"
    #: coordinator KV status publication period
    publish_interval_s: float = 1.0
    #: where the module runs: None is the CUDA device (raises without one)
    device: Optional[str] = None

    def __post_init__(self):
        self.buckets = validate_buckets(self.buckets)
        if self.max_batch_delay_s < 0:
            raise ValueError("max_batch_delay_s must be >= 0")
        if self.queue_capacity <= 0:
            raise ValueError("queue_capacity must be positive")


@dataclass
class _Pending:
    features: Dict[str, np.ndarray]
    future: Future
    t_enqueue: float  # epoch seconds (span clock)
    t_mono: float  # monotonic (latency math)


class ServingReplica:
    """Continuous-batching serving worker over one exported artifact.

    Lifecycle: ``start()`` loads the artifact, warms every bucket (all
    shapes run once BEFORE the first request is accepted), and starts the
    dispatch/watcher threads plus the optional HTTP frontend. ``submit()``
    enqueues one request and returns a future; ``stop()`` drains the queue
    (every accepted request resolves) and shuts down.
    """

    def __init__(self, config: ServingConfig,
                 client: Optional[Any] = None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        self.config = config
        self.client = client  # coordinator KV surface (status publication)
        self.instruments = ServeInstruments(registry)
        self.registry = registry
        self.tracer = tracer if tracer is not None else get_tracer()
        self._queue: "queue.Queue[_Pending]" = queue.Queue(
            maxsize=config.queue_capacity)
        self._lock = threading.Lock()
        # swap state + stats, all guarded by _lock
        self._art = None
        self._version: Optional[Tuple] = None
        self._model_step: Optional[int] = None
        self._last_swap_step: Optional[int] = None
        self._warmed: Set[int] = set()
        self._cold: Set[int] = set()  # dispatched bucket shapes no warm-up ran
        self._bucket_hits: Dict[int, int] = {}
        self._swaps = 0
        self._completed = 0
        self._rejected = 0
        self._errors = 0
        self._last_publish = 0.0
        # set once in start() before any worker thread exists
        self._feature_avals: Dict[str, Tuple[Tuple[int, ...], np.dtype]] = {}
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._server = None
        self._started = False

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "ServingReplica":
        if self._started:
            return self
        from edl_tpu_torch.runtime.export import (artifact_version,
                                                  load_inference_model)

        cfg = self.config
        art = load_inference_model(cfg.model_dir, device=cfg.device)
        if art.model.predict is None:
            raise NotImplementedError(
                f"model {art.model.name!r} defines no predict entrypoint")
        with self._lock:
            self._feature_avals = self._derive_feature_avals(art.model)
        self._warm_buckets(art)
        with self._lock:
            self._art = art
            self._warmed = set(cfg.buckets)
            self._version = artifact_version(cfg.model_dir)
            self._model_step = art.step
        self.instruments.model_step.set(float(art.step or 0))
        self._register()
        dispatch = threading.Thread(target=self._dispatch_loop,
                                    name=f"edl-serve-dispatch-{cfg.name}",
                                    daemon=True)
        watcher = threading.Thread(target=self._watch_loop,
                                   name=f"edl-serve-watch-{cfg.name}",
                                   daemon=True)
        with self._lock:
            self._threads = [dispatch, watcher]
        for t in (dispatch, watcher):
            t.start()
        if cfg.port is not None:
            from edl_tpu_torch.serving.frontend import make_frontend

            server = make_frontend(self, port=cfg.port, registry=self.registry,
                                   tracer=self.tracer)
            with self._lock:
                self._server = server
        with self._lock:
            self._started = True
        return self

    def stop(self, drain: bool = True) -> None:
        """Shut down; with ``drain`` every already-accepted request is
        served first — the zero-drop half of a replica-count change."""
        if not drain:
            self._fail_queued(RuntimeError("replica stopping"))
        self._stop.set()
        with self._lock:
            threads, self._threads = self._threads, []
            server, self._server = self._server, None
        for t in threads:  # join OUTSIDE the lock: batches need it to run
            t.join(timeout=30)
        if server is not None:
            server.stop()
        self._publish_status(force=True)
        with self._lock:
            self._started = False

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    @property
    def url(self) -> Optional[str]:
        return self._server.url if self._server is not None else None

    @property
    def started(self) -> bool:
        """True between a successful ``start()`` and ``stop()`` — the
        router's health predicate."""
        with self._lock:
            return self._started

    # -- request path ----------------------------------------------------------

    def submit(self, features: Dict[str, Any]) -> Future:
        """Enqueue one request (a dict of per-example feature arrays, no
        batch dim) and return a future resolving to its output row."""
        if not self._started:
            raise RuntimeError("replica not started")
        row = self._coerce_features(features)
        fut: Future = Future()
        item = _Pending(features=row, future=fut,
                        t_enqueue=time.time(), t_mono=time.monotonic())
        try:
            self._queue.put_nowait(item)
        except queue.Full:
            self.instruments.requests.inc(outcome="rejected")
            with self._lock:
                self._rejected += 1
            raise ServeOverloadError(
                f"queue at capacity ({self.config.queue_capacity})") from None
        self.instruments.inflight.inc(1.0)
        self.instruments.queue_depth.set(float(self._queue.qsize()))
        return fut

    def predict(self, features: Dict[str, Any]) -> Any:
        """Blocking convenience wrapper over :meth:`submit`."""
        return self.submit(features).result(timeout=self.config.request_timeout_s)

    def _coerce_features(self, features: Dict[str, Any]) -> Dict[str, np.ndarray]:
        if not isinstance(features, dict):
            raise TypeError("request features must be a dict")
        row = {}
        for key, (shape, dtype) in self._feature_avals.items():
            if key not in features:
                raise KeyError(f"request missing feature {key!r}")
            value = np.asarray(features[key], dtype=dtype)
            if value.shape != shape:
                raise ValueError(
                    f"feature {key!r} has shape {value.shape}, expected {shape}")
            row[key] = value
        return row

    # -- warm-up ---------------------------------------------------------------

    @staticmethod
    def _derive_feature_avals(model) -> Dict[str, Tuple[Tuple[int, ...], np.dtype]]:
        """Per-example feature shapes and dtypes from the model's own
        synthetic batch, minus its label keys — the serving tier learns
        request shapes from the model contract, never from the first
        request (shapes must be known BEFORE any request so every bucket
        can be warmed up front)."""
        sample = model.synthetic_batch(np.random.default_rng(0), 1)
        labels = set(getattr(model, "label_keys", ()) or ())
        return {
            key: (tuple(np.shape(value)[1:]), np.asarray(value).dtype)
            for key, value in sample.items() if key not in labels
        }

    def _warm_buckets(self, art) -> None:
        """Run ``art``'s predict once per bucket on a zero batch, all before
        the replica (or a swap) serves with it. A bucket that fails raises
        `ServeCompileError` naming it."""
        import torch

        for bucket in self.config.buckets:
            t0 = time.perf_counter()
            batch = {key: np.zeros((bucket,) + shape, dtype=dtype)
                     for key, (shape, dtype) in self._feature_avals.items()}
            try:
                art.predict(batch)
                if art.device.type == "cuda":
                    torch.cuda.synchronize(art.device)
            except Exception as exc:
                raise ServeCompileError(
                    f"bucket {bucket} failed its warm-up run on {art.device}: "
                    f"{exc}") from exc
            self.instruments.compile_seconds.set(time.perf_counter() - t0,
                                                 bucket=str(bucket))

    def jit_cache_size(self) -> int:
        """Dispatch shapes that no warm-up ran: the counterpart of the JAX
        tier's jit dispatch cache. Every bucket is warmed in ``start()``
        (and by a swap, before it flips), so this stays 0 under bucketed
        traffic."""
        with self._lock:
            return len(self._cold)

    # -- dispatch loop ---------------------------------------------------------

    def _dispatch_loop(self) -> None:
        while True:
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set():
                    return  # drained: stop() only wins once the queue is dry
                continue
            items = [first]
            deadline = time.monotonic() + self.config.max_batch_delay_s
            largest = self.config.buckets[-1]
            while len(items) < largest:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    items.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            self.instruments.queue_depth.set(float(self._queue.qsize()))
            self._run_batch(items)

    def _run_batch(self, items: List[_Pending]) -> None:
        n = len(items)
        bucket = pick_bucket(n, self.config.buckets)
        with self._lock:
            art = self._art
            model_step = self._model_step
            if bucket not in self._warmed:
                self._cold.add(bucket)
            self._bucket_hits[bucket] = self._bucket_hits.get(bucket, 0) + 1
        t_batch = time.monotonic()
        try:
            batch = pad_batch([it.features for it in items], bucket,
                              self._feature_avals)
            rows = split_rows(art.predict(batch), n)
        except Exception as e:  # resolved into every request future below; the loop must survive one poisoned batch
            log.exception("batch of %d (bucket %d) failed", n, bucket)
            with self._lock:
                self._errors += n
            for it in items:
                it.future.set_exception(e)
                self.instruments.requests.inc(outcome="error")
                self.instruments.inflight.inc(-1.0)
            return
        now, now_mono = time.time(), time.monotonic()
        for it, row in zip(items, rows):
            it.future.set_result(row)
            self.instruments.requests.inc(outcome="ok")
            self.instruments.inflight.inc(-1.0)
            self.instruments.latency.observe(now_mono - it.t_mono)
            self.instruments.queue_wait.observe(t_batch - it.t_mono)
            self.tracer.record(
                "serve_request", it.t_enqueue, now, component="serving",
                bucket=bucket, batch_size=n, model_step=model_step)
        with self._lock:
            self._completed += n
        self.instruments.batches.inc(bucket=str(bucket))
        self.instruments.batch_occupancy.observe(n / bucket)

    def _fail_queued(self, error: Exception) -> None:
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            item.future.set_exception(error)
            self.instruments.requests.inc(outcome="error")
            self.instruments.inflight.inc(-1.0)

    # -- rolling model swap ----------------------------------------------------

    def _watch_loop(self) -> None:
        while not self._stop.wait(self.config.version_poll_s):
            try:
                self._maybe_swap()
            except Exception:  # logged loudly; a torn export or transient FS error must not kill the watcher — the next poll retries
                log.exception("model-version watch failed")
            self._publish_status()

    def _maybe_swap(self) -> None:
        from edl_tpu_torch.runtime.export import (artifact_version,
                                                  load_inference_model)

        version = artifact_version(self.config.model_dir)
        with self._lock:
            current = self._version
            device = self._art.device
        if version is None or version == current:
            return
        t0 = time.time()
        art = load_inference_model(self.config.model_dir, device=device)
        # requests keep flowing on the old module while the new one warms
        self._warm_buckets(art)
        with self._lock:
            self._art = art
            self._version = version
            self._model_step = art.step
            self._last_swap_step = art.step
            self._swaps += 1
        self.instruments.model_swaps.inc()
        self.instruments.model_step.set(float(art.step or 0))
        self.tracer.record("model_swap", t0, time.time(), component="serving",
                           model_step=art.step)
        log.info("swapped to artifact step %s (version %s)", art.step, version[2])

    # -- status ----------------------------------------------------------------

    def status(self) -> Dict[str, Any]:
        """The replica's serving-state snapshot: what `edl-tpu status`
        renders and the coordinator KV publication carries."""
        with self._lock:
            return {
                "name": self.config.name,
                "kind": "batch",  # LM replicas publish kind="lm" to the same KV slot
                "model_step": self._model_step,
                "version": self._version[2] if self._version else None,
                "queue_depth": self._queue.qsize(),
                "buckets": list(self.config.buckets),
                "bucket_hits": {str(k): v
                                for k, v in sorted(self._bucket_hits.items())},
                "last_swap_step": self._last_swap_step,
                "swaps": self._swaps,
                "completed": self._completed,
                "rejected": self._rejected,
                "errors": self._errors,
            }

    def _health(self) -> Dict[str, Any]:
        return self.status()

    def _register(self) -> None:
        if self.client is None:
            return
        try:
            self.client.register(takeover=True)
        except Exception:  # status publication is best-effort; serving must come up even with the coordinator down
            log.warning("coordinator register failed; status publication "
                        "will retry", exc_info=True)

    def _publish_status(self, force: bool = False) -> None:
        if self.client is None:
            return
        now = time.monotonic()
        with self._lock:
            if (not force and
                    now - self._last_publish < self.config.publish_interval_s):
                return
            self._last_publish = now
        try:
            self.client.heartbeat()
            self.client.kv_put(SERVING_KV_PREFIX + self.config.name,
                               json.dumps(self.status()))
        except Exception:  # best-effort: a coordinator blip must not take the serving path down; the next interval retries
            log.debug("serving status publish failed", exc_info=True)
