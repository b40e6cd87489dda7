"""The LM serving replica: decode-step continuous batching over paged KV.
The port of `edl_tpu.serving.lm`.

An autoregressive LM request is a *stream* that holds K/V state across
hundreds of device steps, so throughput lives in per-token scheduling, not
per-request. Three separations, as in the JAX engine:

- **Continuous batching at decode-step granularity.** One persistent loop
  owns the device. Batch membership changes *per token*: admitted streams
  join at the next step boundary, streams leave the instant they hit EOS or
  their token budget.
- **Prefill/decode phase separation.** Prompts run through the prefill
  step at their *prompt* seq bucket and hand their K/V to the stream; every
  later token runs the single-token decode step at the stream's *capacity*
  seq bucket. Both phases run once per (batch bucket, seq bucket) on a zero
  batch before the first request — ``jit_cache_size() == 0`` holds under LM
  traffic.
- **Memory as the admission currency.** A stream is admitted iff the
  :class:`~edl_tpu_torch.serving.kvcache.BlockPool` can reserve blocks for
  its full ``prompt + max_new_tokens`` budget (429 otherwise), so decode
  never deadlocks on allocation mid-stream.

Cache residence: the steps are stateless — prefill *returns* K/V, decode
*returns* the one new position's K/V. The JAX engine keeps each stream's
cache in host numpy and re-assembles the batch on the host every step; here
each stream's cache is a device tensor (L, C, H, Dh) of its capacity
bucket, a decode step stacks the members' caches into the (L, B, C, H, Dh)
operand with ``torch.stack`` on the device, and the returned position is
written in place at ``length``. Values and order are the JAX engine's; only
the residence changes. Join and leave stay free: no cache compaction when
membership changes.

Threading: one engine thread runs admit/prefill/decode and status
publication; HTTP frontend threads call ``submit``. Shared state — waiting
list, active map, stats — lives behind ``self._lock``; device dispatch and
future resolution happen OUTSIDE it. The BlockPool has its own lock.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from edl_tpu_torch.obs.instruments import LMServeInstruments
from edl_tpu_torch.obs.metrics import MetricsRegistry
from edl_tpu_torch.obs.tracing import Tracer, get_tracer
from edl_tpu_torch.serving.batcher import (pad_token_rows, pick_bucket,
                                           pick_seq_bucket, plan_chunks,
                                           validate_buckets)
from edl_tpu_torch.serving.kvcache import BlockPool, KVCacheConfig
from edl_tpu_torch.serving.worker import SERVING_KV_PREFIX, ServeCompileError

__all__ = ["LMServingConfig", "LMServingReplica", "LMStreamHandle"]

log = logging.getLogger("edl_tpu_torch.serving.lm")


@dataclass
class LMServingConfig:
    """Knobs for one LM serving replica."""

    model_dir: str
    #: batch-slot ladder, shared by prefill and decode dispatches
    batch_buckets: Tuple[int, ...] = (1, 4)
    #: token-capacity ladder: a stream's capacity bucket must hold
    #: prompt + max_new_tokens; prompts prefill at their own (smaller)
    #: bucket. The largest entry is the admission ceiling (SeqTooLong
    #: beyond it) and must fit the model's trained seq_len.
    seq_buckets: Tuple[int, ...] = (64, 128, 256)
    #: KV block pool shape (memory admission currency)
    kv_blocks: int = 64
    kv_block_tokens: int = 16
    #: token budget when a request names none
    default_max_new_tokens: int = 32
    #: greedy decode stops on this token id (per-request override wins)
    eos_id: Optional[int] = None
    #: engine idle wait between wake-up checks when no stream is live
    idle_wait_s: float = 0.002
    request_timeout_s: float = 60.0
    #: None: no HTTP frontend; 0: ephemeral port (tests); N: fixed port
    port: Optional[int] = None
    name: str = "lm-0"
    #: coordinator KV status publication period
    publish_interval_s: float = 1.0
    #: where the model runs: None is the CUDA device (raises without one)
    device: Optional[str] = None

    def __post_init__(self):
        self.batch_buckets = validate_buckets(self.batch_buckets)
        self.seq_buckets = validate_buckets(self.seq_buckets)
        if self.default_max_new_tokens <= 0:
            raise ValueError("default_max_new_tokens must be positive")
        if self.kv_blocks * self.kv_block_tokens < self.seq_buckets[0]:
            raise ValueError(
                f"KV pool of {self.kv_blocks}x{self.kv_block_tokens} tokens "
                f"cannot hold even the smallest seq bucket "
                f"{self.seq_buckets[0]}")


@dataclass
class LMStreamHandle:
    """One admitted stream: resolve via ``result()`` to a dict with
    ``tokens`` (generated ids), ``finish_reason`` (eos | length),
    ``prompt_tokens``, and ``model_step``."""

    stream_id: str
    future: Future

    def result(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        return self.future.result(timeout=timeout)

    def done(self) -> bool:
        return self.future.done()


@dataclass
class _Stream:
    id: str
    prompt: np.ndarray  # 1-D int32
    max_new_tokens: int
    eos_id: Optional[int]
    capacity: int  # seq bucket covering prompt + max_new_tokens
    future: Future
    t_admit: float  # monotonic
    generated: List[int] = field(default_factory=list)
    k: Optional[torch.Tensor] = None  # (L, C, H, Dh) bf16, on the device
    v: Optional[torch.Tensor] = None
    length: int = 0  # tokens written into the cache
    t_last: Optional[float] = None  # last emit (inter-token latency)


class LMServingReplica:
    """Continuous-batching LM decode engine over one exported transformer.

    Lifecycle mirrors :class:`~edl_tpu_torch.serving.worker.ServingReplica`:
    ``start()`` loads the artifact, runs every (batch bucket, seq bucket)
    shape of BOTH phases once, then starts the engine thread and optional
    HTTP frontend. ``submit()`` admits one stream (or raises the typed
    rejection) and returns a handle; ``evict_streams()`` hands live streams
    to the router for zero-drop migration; ``stop()`` drains.
    """

    def __init__(self, config: LMServingConfig,
                 client: Optional[Any] = None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        self.config = config
        self.client = client  # coordinator KV surface (status publication)
        self.instruments = LMServeInstruments(registry)
        self.registry = registry
        self.tracer = tracer if tracer is not None else get_tracer()
        self.pool: Optional[BlockPool] = None  # built in start()
        self._lock = threading.Lock()
        self._waiting: List[_Stream] = []
        self._active: Dict[str, _Stream] = {}
        self._counter = 0
        self._completed = 0
        self._rejected = 0
        self._evicted = 0
        self._tokens_generated = 0
        self._emit_times: deque = deque(maxlen=8192)  # monotonic stamps
        self._last_publish = 0.0
        # set once in start() before the engine thread exists
        self._art = None
        self._model_cfg = None
        self._version: Optional[Tuple] = None
        self._prefill = None
        self._decode = None
        self._pads: Dict[int, torch.Tensor] = {}  # seq bucket -> zero cache
        self._warmed: Set[Tuple[str, int, int]] = set()
        self._cold: Set[Tuple[str, int, int]] = set()
        self._stop = threading.Event()
        self._work = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._server = None
        self._started = False

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "LMServingReplica":
        if self._started:
            return self
        from edl_tpu_torch.models.transformer import (lm_cache_bytes_per_token,
                                                      make_decode_step,
                                                      make_prefill_step)
        from edl_tpu_torch.runtime.export import (artifact_version,
                                                  load_inference_model)

        cfg = self.config
        art = load_inference_model(cfg.model_dir, device=cfg.device)
        mcfg = getattr(art.model, "config", None)
        if mcfg is None or not hasattr(mcfg, "n_layers"):
            raise TypeError(
                f"model {art.model.name!r} carries no transformer config — "
                f"the LM serving path needs a transformer artifact")
        if cfg.seq_buckets[-1] > mcfg.seq_len:
            raise ValueError(
                f"largest seq bucket {cfg.seq_buckets[-1]} exceeds the "
                f"model's trained seq_len {mcfg.seq_len}")
        pool = BlockPool(KVCacheConfig(
            n_blocks=cfg.kv_blocks, block_tokens=cfg.kv_block_tokens,
            bytes_per_token=lm_cache_bytes_per_token(mcfg)))
        L, H, Dh = mcfg.n_layers, mcfg.n_heads, mcfg.head_dim
        with self._lock:
            self._prefill = make_prefill_step(mcfg)
            self._decode = make_decode_step(mcfg)
            self._art = art
            self._model_cfg = mcfg
            self._version = artifact_version(cfg.model_dir)
            self._pads = {s: torch.zeros((L, s, H, Dh), dtype=torch.bfloat16,
                                         device=art.device)
                          for s in cfg.seq_buckets}
            self.pool = pool
        self._warm_all()
        self._register()
        thread = threading.Thread(target=self._engine_loop,
                                  name=f"edl-lm-engine-{cfg.name}", daemon=True)
        with self._lock:
            self._thread = thread
        thread.start()
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
        """Shut down; with ``drain`` every admitted stream decodes to its
        natural finish first (the router uses :meth:`evict_streams` when
        finishing elsewhere is the better trade)."""
        if not drain:
            error = RuntimeError("replica stopping")
            for s in self._take_all_streams():
                self.pool.release(s.id)
                self.instruments.streams.inc(outcome="error")
                s.future.set_exception(error)
        self._stop.set()
        self._work.set()
        with self._lock:
            thread, self._thread = self._thread, None
            server, self._server = self._server, None
        if thread is not None:
            thread.join(timeout=60)
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
        with self._lock:
            return self._started

    # -- admission -------------------------------------------------------------

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_id: Optional[int] = None,
               stream_id: Optional[str] = None) -> LMStreamHandle:
        """Admit one stream or raise the typed rejection.

        Raises :class:`~edl_tpu_torch.serving.batcher.SeqTooLongError` when
        ``prompt + max_new_tokens`` outruns the largest seq bucket (400 —
        retrying cannot help) and
        :class:`~edl_tpu_torch.serving.kvcache.KVCacheExhaustedError` when
        the block pool cannot cover the budget (429 — retry elsewhere or
        later). Admitted streams join the decode batch at the next step
        boundary.
        """
        if not self.started:
            raise RuntimeError("replica not started")
        if self._stop.is_set():
            raise RuntimeError("replica stopping")
        ids = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if ids.size == 0:
            raise ValueError("prompt must contain at least one token")
        budget = int(max_new_tokens if max_new_tokens is not None
                     else self.config.default_max_new_tokens)
        if budget <= 0:
            raise ValueError(f"max_new_tokens must be positive: {budget}")
        total = int(ids.size) + budget
        try:
            capacity = pick_seq_bucket(total, self.config.seq_buckets)
        except ValueError:
            with self._lock:
                self._rejected += 1
            self.instruments.streams.inc(outcome="rejected")
            raise
        with self._lock:
            self._counter += 1
            sid = stream_id or f"{self.config.name}-s{self._counter}"
        try:
            self.pool.reserve(sid, total, capacity=capacity)
        except Exception:
            with self._lock:
                self._rejected += 1
            self.instruments.streams.inc(outcome="rejected")
            raise
        stream = _Stream(
            id=sid, prompt=ids, max_new_tokens=budget,
            eos_id=eos_id if eos_id is not None else self.config.eos_id,
            capacity=capacity, future=Future(), t_admit=time.monotonic())
        with self._lock:
            self._waiting.append(stream)
            self.instruments.waiting_streams.set(float(len(self._waiting)))
        self._work.set()
        return LMStreamHandle(stream_id=sid, future=stream.future)

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 eos_id: Optional[int] = None) -> Dict[str, Any]:
        """Blocking convenience wrapper over :meth:`submit`."""
        return self.submit(prompt, max_new_tokens, eos_id).result(
            timeout=self.config.request_timeout_s)

    # -- warm-up ---------------------------------------------------------------

    def _warm_all(self) -> None:
        """Run prefill and decode once for every (batch bucket, seq bucket)
        on a zero batch, all before the first request."""
        mcfg, device = self._model_cfg, self._art.device
        L, H, Dh = mcfg.n_layers, mcfg.n_heads, mcfg.head_dim
        module = self._art.module
        for phase in ("prefill", "decode"):
            for b in self.config.batch_buckets:
                for s in self.config.seq_buckets:
                    t0 = time.perf_counter()
                    zeros = torch.zeros((b,), dtype=torch.int32, device=device)
                    try:
                        if phase == "prefill":
                            out = self._prefill(module, torch.zeros(
                                (b, s), dtype=torch.int32, device=device), zeros)
                        else:
                            cache = torch.zeros((L, b, s, H, Dh),
                                                dtype=torch.bfloat16, device=device)
                            out = self._decode(module, cache, cache, zeros, zeros)
                        out[0].cpu()  # waits for the step, as a dispatch does
                    except Exception as exc:
                        raise ServeCompileError(
                            f"LM {phase} (bucket {b}, seq {s}) failed its "
                            f"warm-up run on {device}: {exc}") from exc
                    self.instruments.compile_seconds.set(
                        time.perf_counter() - t0, phase=phase,
                        bucket=str(b), seq_bucket=str(s))
                    self._warmed.add((phase, b, s))

    def _note_shape(self, phase: str, bucket: int, seq_bucket: int) -> None:
        key = (phase, bucket, seq_bucket)
        if key not in self._warmed:
            with self._lock:
                self._cold.add(key)

    def jit_cache_size(self) -> int:
        """(phase, batch bucket, seq bucket) shapes dispatched that no
        warm-up ran: the counterpart of the JAX tier's jit dispatch caches.
        Stays 0 under LM traffic: both phases only dispatch warmed shapes."""
        with self._lock:
            return len(self._cold)

    # -- the engine loop -------------------------------------------------------

    def _engine_loop(self) -> None:
        while True:
            worked = False
            try:
                worked |= self._prefill_waiting()
                worked |= self._decode_once()
            except Exception:  # logged loudly; a poisoned batch must not kill the engine — affected stream futures already carry the error
                log.exception("LM engine step failed")
            self._publish_status()
            with self._lock:
                idle = not self._waiting and not self._active
            if self._stop.is_set() and idle:
                return
            if not worked:
                self._work.wait(self.config.idle_wait_s)
                self._work.clear()

    def _take_all_streams(self) -> List[_Stream]:
        with self._lock:
            streams = self._waiting + list(self._active.values())
            self._waiting = []
            self._active = {}
            self.instruments.waiting_streams.set(0.0)
            self.instruments.active_streams.set(0.0)
        return streams

    def _claim_waiting(self, chunk: List[_Stream]) -> List[_Stream]:
        """Atomically remove ``chunk``'s still-waiting streams from the
        queue and return them; streams an eviction already took are not
        ours to resolve."""
        with self._lock:
            waiting_ids = {w.id for w in self._waiting}
            owned = [s for s in chunk if s.id in waiting_ids]
            done_ids = {s.id for s in owned}
            self._waiting = [w for w in self._waiting if w.id not in done_ids]
            self.instruments.waiting_streams.set(float(len(self._waiting)))
        return owned

    def _chunked(self, streams: List[_Stream]) -> List[List[_Stream]]:
        """Split a same-seq-bucket group along the batch ladder."""
        out, i = [], 0
        for size in plan_chunks(len(streams), self.config.batch_buckets):
            out.append(streams[i:i + size])
            i += size
        return out

    # -- prefill phase ---------------------------------------------------------

    def _prefill_waiting(self) -> bool:
        # Streams STAY in _waiting until their chunk's post-dispatch commit:
        # an evict_streams() racing with the prefill dispatch must still see
        # them (the commit below re-checks membership, mirroring decode).
        with self._lock:
            waiting = list(self._waiting)
        if not waiting:
            return False
        groups: Dict[int, List[_Stream]] = {}
        for s in waiting:
            # prompts bucket by their own length, not the stream capacity:
            # prefill compute scales with the prompt bucket, and the K/V it
            # returns is copied into the capacity-sized stream cache.
            groups.setdefault(
                pick_seq_bucket(int(s.prompt.size), self.config.seq_buckets), [],
            ).append(s)
        for seq_bucket in sorted(groups):
            for chunk in self._chunked(groups[seq_bucket]):
                self._prefill_chunk(chunk, seq_bucket)
        return True

    def _prefill_chunk(self, chunk: List[_Stream], seq_bucket: int) -> None:
        n = len(chunk)
        bucket = pick_bucket(n, self.config.batch_buckets)
        tokens, lengths = pad_token_rows([s.prompt for s in chunk], bucket,
                                         seq_bucket)
        self._note_shape("prefill", bucket, seq_bucket)
        t0 = time.time()
        try:
            with self._lock:
                module = self._art.module
                device = self._art.device
            next_tokens, k_cache, v_cache = self._prefill(
                module, torch.from_numpy(tokens).to(device),
                torch.from_numpy(lengths).to(device))
            next_tokens = next_tokens.tolist()
        except Exception as e:  # resolved into every stream future below; the engine must survive one poisoned prefill
            log.exception("prefill of %d (bucket %d, seq %d) failed",
                          n, bucket, seq_bucket)
            owned = self._claim_waiting(chunk)
            for s in owned:
                self.pool.release(s.id)
                self.instruments.streams.inc(outcome="error")
                s.future.set_exception(e)
            return
        self.instruments.prefill_batch.observe(float(n))
        L, H, Dh = k_cache.shape[0], k_cache.shape[3], k_cache.shape[4]
        finished: List[Tuple[_Stream, str]] = []
        owned: List[_Stream] = []
        with self._lock:
            waiting_ids = {w.id for w in self._waiting}
            for i, s in enumerate(chunk):
                if s.id not in waiting_ids:
                    continue  # evicted mid-prefill: the router owns it now
                owned.append(s)
                plen = int(s.prompt.size)
                s.k = torch.zeros((L, s.capacity, H, Dh), dtype=k_cache.dtype,
                                  device=k_cache.device)
                s.v = torch.zeros_like(s.k)
                s.k[:, :plen] = k_cache[:, i, :plen]
                s.v[:, :plen] = v_cache[:, i, :plen]
                s.length = plen
                outcome = self._emit_locked(s, next_tokens[i], "prefill")
                if outcome:
                    finished.append((s, outcome))
                else:
                    self._active[s.id] = s
            done_ids = {s.id for s in owned}
            self._waiting = [w for w in self._waiting if w.id not in done_ids]
            self.instruments.waiting_streams.set(float(len(self._waiting)))
            self.instruments.active_streams.set(float(len(self._active)))
        for s in owned:
            self.pool.note_tokens(s.id, s.length)
            self.tracer.record("lm_prefill", t0, time.time(),
                               component="serving", stream=s.id,
                               bucket=bucket, seq_bucket=seq_bucket)
        for s, outcome in finished:
            self._retire(s, outcome)

    # -- decode phase ----------------------------------------------------------

    def _decode_once(self) -> bool:
        with self._lock:
            groups: Dict[int, List[_Stream]] = {}
            for s in self._active.values():
                groups.setdefault(s.capacity, []).append(s)
        if not groups:
            return False
        for capacity in sorted(groups):
            for chunk in self._chunked(groups[capacity]):
                self._decode_chunk(chunk, capacity)
        return True

    def _decode_chunk(self, chunk: List[_Stream], capacity: int) -> None:
        # The groups were snapshotted under the lock, and an eviction since
        # then took some members and dropped their caches: keep the members
        # still active, with their caches read under the lock.
        with self._lock:
            module = self._art.module
            device = self._art.device
            chunk = [s for s in chunk if s.id in self._active]
            caches = [(s.k, s.v) for s in chunk]
        if not chunk:
            return
        n = len(chunk)
        bucket = pick_bucket(n, self.config.batch_buckets)
        self._note_shape("decode", bucket, capacity)
        t0 = time.time()
        try:
            pads = [self._pads[capacity]] * (bucket - n)
            # the (L, bucket, C, H, Dh) operands, gathered on the device
            k_batch = torch.stack([k for k, _ in caches] + pads, dim=1)
            v_batch = torch.stack([v for _, v in caches] + pads, dim=1)
            del caches
            tokens = np.zeros((bucket,), dtype=np.int32)
            lengths = np.zeros((bucket,), dtype=np.int32)
            for i, s in enumerate(chunk):
                tokens[i] = s.generated[-1]
                lengths[i] = s.length
            next_tokens, k_new, v_new = self._decode(
                module, k_batch, v_batch, torch.from_numpy(tokens).to(device),
                torch.from_numpy(lengths).to(device))
            del k_batch, v_batch
            next_tokens = next_tokens.tolist()
        except Exception as e:  # resolved into every stream future below; the engine must survive one poisoned decode step
            log.exception("decode step of %d (bucket %d, seq %d) failed",
                          n, bucket, capacity)
            with self._lock:
                owned = [s for s in chunk if s.id in self._active]
                for s in owned:
                    del self._active[s.id]
                self.instruments.active_streams.set(float(len(self._active)))
            for s in owned:
                self.pool.release(s.id)
                self.instruments.streams.inc(outcome="error")
                s.future.set_exception(e)
            return
        self.instruments.decode_batch.observe(float(n))
        self.instruments.decode_steps.inc(bucket=str(bucket),
                                          seq_bucket=str(capacity))
        finished: List[Tuple[_Stream, str]] = []
        with self._lock:
            for i, s in enumerate(chunk):
                if s.id not in self._active:
                    continue  # evicted mid-step: the router owns it now
                self._append_kv(s, k_new[:, i], v_new[:, i])
                s.length += 1
                outcome = self._emit_locked(s, next_tokens[i], "decode")
                if outcome:
                    finished.append((s, outcome))
                    del self._active[s.id]
            self.instruments.active_streams.set(float(len(self._active)))
        for s in chunk:
            self.pool.note_tokens(s.id, s.length)
        self.tracer.record("lm_decode_step", t0, time.time(),
                           component="serving", batch_size=n,
                           bucket=bucket, seq_bucket=capacity)
        for s, outcome in finished:
            self._retire(s, outcome)

    @staticmethod
    def _append_kv(s: _Stream, k: torch.Tensor, v: torch.Tensor) -> None:
        """Write one decoded position's K/V, (L, H, Dh) each, into the
        stream's cache at index ``length`` (the position the step decoded)."""
        s.k[:, s.length] = k
        s.v[:, s.length] = v

    # -- stream lifecycle ------------------------------------------------------

    def _emit_locked(self, s: _Stream, token: int, phase: str) -> Optional[str]:
        """Record one emitted token (caller holds ``self._lock``); returns
        the finish outcome when this token ends the stream, else None."""
        now = time.monotonic()
        if s.t_last is None:
            self.instruments.ttft.observe(now - s.t_admit)
        self.instruments.token_latency.observe(
            now - (s.t_last if s.t_last is not None else s.t_admit))
        self.instruments.tokens.inc(phase=phase)
        s.generated.append(token)
        s.t_last = now
        self._tokens_generated += 1
        self._emit_times.append(now)
        if s.eos_id is not None and token == s.eos_id:
            return "eos"
        if len(s.generated) >= s.max_new_tokens:
            return "length"
        return None

    def _retire(self, s: _Stream, outcome: str) -> None:
        self.pool.release(s.id)
        s.k = s.v = None  # the cache's device memory goes back to the allocator
        with self._lock:
            self._completed += 1
            model_step = self._art.step
        self.instruments.streams.inc(outcome=outcome)
        s.future.set_result({
            "stream_id": s.id,
            "tokens": list(s.generated),
            "finish_reason": outcome,
            "prompt_tokens": int(s.prompt.size),
            "model_step": model_step,
        })

    def evict_streams(self) -> List[Dict[str, Any]]:
        """Detach every live stream for migration: blocks are released,
        futures are NOT resolved — the router resubmits each stream's
        remainder elsewhere and stitches the token lists, which is how a
        shrinking pool keeps ``dropped_streams == 0``. Returns one snapshot
        per stream: prompt, generated-so-far, remaining budget, eos id, and
        the unresolved future to fulfil."""
        streams = self._take_all_streams()
        snapshots = []
        for s in streams:
            self.pool.release(s.id)
            s.k = s.v = None
            self.instruments.streams.inc(outcome="evicted")
            with self._lock:
                self._evicted += 1
            snapshots.append({
                "stream_id": s.id,
                "prompt": s.prompt,
                "generated": list(s.generated),
                "max_new_tokens": s.max_new_tokens - len(s.generated),
                "eos_id": s.eos_id,
                "future": s.future,
            })
        return snapshots

    # -- status ----------------------------------------------------------------

    def tokens_per_s(self, window_s: float = 2.0) -> float:
        """Decode throughput over the trailing window (0 when idle)."""
        now = time.monotonic()
        with self._lock:
            recent = sum(1 for t in self._emit_times if now - t <= window_s)
        return recent / window_s

    def status(self) -> Dict[str, Any]:
        """The replica's LM-serving snapshot: what `edl-tpu status`
        renders and the router's affinity policy reads (kv.free_blocks)."""
        kv = self.pool.stats() if self.pool is not None else {}
        rate = self.tokens_per_s()
        with self._lock:
            return {
                "name": self.config.name,
                "kind": "lm",
                "model_step": self._art.step if self._art else None,
                "version": self._version[2] if self._version else None,
                "active_streams": len(self._active),
                "waiting_streams": len(self._waiting),
                "completed": self._completed,
                "rejected": self._rejected,
                "evicted": self._evicted,
                "tokens_generated": self._tokens_generated,
                "tokens_per_s": round(rate, 2),
                "batch_buckets": list(self.config.batch_buckets),
                "seq_buckets": list(self.config.seq_buckets),
                "kv": kv,
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
        stats = self.pool.stats() if self.pool is not None else None
        if stats is not None:
            self.instruments.kv_blocks_used.set(float(stats["used_blocks"]))
            self.instruments.kv_blocks_free.set(float(stats["free_blocks"]))
            self.instruments.kv_occupancy.set(float(stats["occupancy"]))
            self.instruments.kv_fragmentation.set(float(stats["fragmentation"]))
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
        except Exception:  # best-effort: a coordinator blip must not take the decode loop down; the next interval retries
            log.debug("LM serving status publish failed", exc_info=True)
