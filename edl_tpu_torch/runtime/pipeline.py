"""Device-side input pipeline: background batch placement. The port of
`edl_tpu.runtime.pipeline`.

:class:`DevicePrefetcher` runs the placement function (wire encode + the
host->device copy) on a pump thread, up to ``depth`` batches ahead of the
consumer, so batch N+1's host work and copy overlap step N on the device.

Contract (as the JAX package's, and ``prefetch_iter`` in
:mod:`edl_tpu_torch.runtime.data` delegates here):

- **Exception transparency** — anything the source iterator or the placement
  function raises, ``SystemExit`` included, re-raises in the CONSUMER, not
  the pump thread, so control flow is identical to plain iteration.
- **Clean drain** — a source that returns early (a ``LeaseReader`` hitting a
  stop) ends the stream normally; batches already placed are still
  delivered.
- **No leaked pumps** — an abandoned consumer (early ``break``, an exception
  in the training loop) cannot park the pump forever: puts are
  timeout-polled against a stop flag, and :meth:`close` (also run by the
  iterator's ``finally`` and the context manager) joins the thread and
  drops buffered batches.

On a CUDA ``device`` the placement is ordered by streams and events:

- the pump thread sets its current device (the current device is per
  thread) and runs ``place_fn`` on a side stream of its own, so the copies
  it enqueues run beside the consumer's kernels;
- after ``place_fn`` returns, the pump records a CUDA event on the side
  stream; the consumer's stream waits on it before the item is yielded, so
  the step reads the batch only once its copies have landed;
- the consumer calls ``record_stream`` on every CUDA tensor of the item, so
  the caching allocator does not hand their memory back to the side stream
  while the step still reads it.

The copies overlap only from pinned host memory (``non_blocking=True`` from
pageable memory is a synchronous copy): ``Trainer.place_batch`` pins each
batch through PyTorch's caching host allocator, which keeps a pinned block
out of reuse until the copy that reads it has finished.

The placement function binds each batch to the program that steps it
(``Trainer.place_bound``), so a wire-codec widening during placement does
not re-route batches already in flight.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, NamedTuple, Optional

import torch

__all__ = ["DevicePrefetcher", "PlacedItem"]


class PlacedItem(NamedTuple):
    """One pumped batch: the placed payload plus its accounting."""

    #: whatever ``place_fn`` returned (the batch itself when ``place_fn`` is
    #: None — the raw read-ahead mode ``prefetch_iter`` uses).
    payload: Any
    #: host-side row count (0 when the batch shape is opaque).
    samples: int
    #: wall seconds the pump spent inside ``place_fn`` for this batch —
    #: the work that overlapped device compute instead of preceding it.
    place_seconds: float
    #: on a CUDA device, the event recorded on the pump's stream after
    #: ``place_fn``; None elsewhere
    ready: Optional[Any] = None


def _default_samples(batch: Any) -> int:
    """Leading-dim row count of a mapping batch; 0 for opaque items."""
    try:
        first = next(iter(batch.values()))
        return int(len(first))
    except (AttributeError, TypeError, StopIteration):
        return 0


def _cuda_tensors(obj: Any) -> Iterator[torch.Tensor]:
    """The CUDA tensors in a payload of dicts, tuples and lists."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _cuda_tensors(v)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _cuda_tensors(v)


class DevicePrefetcher:
    """Depth-N background placer: ``place_fn`` runs on a pump thread.

    Iterating yields :class:`PlacedItem` in source order. The pump starts
    eagerly at construction, stays at most ``depth`` placed batches ahead,
    and relays exceptions — ``BaseException`` included, so ``SystemExit``
    keeps its meaning — through the queue to the consumer. ``device``
    (a CUDA device) turns on the stream ordering in the module docstring.

    No explicit lock: the bounded :class:`queue.Queue` is the only shared
    state, and the stop flag is an :class:`threading.Event`.
    """

    def __init__(
        self,
        batches: Iterable[Any],
        place_fn: Optional[Callable[[Any], Any]] = None,
        depth: int = 2,
        samples_of: Optional[Callable[[Any], int]] = None,
        thread_name: str = "edl-place-pump",
        device: Optional[torch.device] = None,
    ):
        self._batches = iter(batches)
        self._place = place_fn
        self._samples_of = samples_of or _default_samples
        self._device = (torch.device(device) if device is not None
                        and torch.device(device).type == "cuda" else None)
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device is not None else None)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._pump_thread = threading.Thread(
            target=self._pump, daemon=True, name=thread_name
        )
        self._pump_thread.start()

    # -- pump side -------------------------------------------------------------

    def _put(self, msg) -> bool:
        # Timeout-put so an abandoned consumer cannot leave the pump parked
        # in q.put forever, pinning the source iterator and placed buffers.
        while not self._stop.is_set():
            try:
                self._q.put(msg, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _place_one(self, batch: Any):
        if self._stream is None:
            return (batch if self._place is None else self._place(batch)), None
        with torch.cuda.stream(self._stream):
            payload = batch if self._place is None else self._place(batch)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return payload, ready

    def _pump(self) -> None:
        try:
            if self._device is not None:
                torch.cuda.set_device(self._device)
            for batch in self._batches:
                if self._stop.is_set():
                    return
                samples = self._samples_of(batch)
                t0 = time.perf_counter()
                payload, ready = self._place_one(batch)
                dt = time.perf_counter() - t0
                if not self._put(("item", PlacedItem(payload, samples, dt, ready))):
                    return
            self._put(("end", None))
        except BaseException as e:  # edl: noqa[EDL005] relayed, not swallowed: the consumer re-raises it from the queue
            self._put(("err", e))

    # -- consumer side ---------------------------------------------------------

    def _hand_over(self, item: PlacedItem) -> PlacedItem:
        """Order the consumer's stream after the item's copies, and keep
        its tensors' memory from the side stream while the step reads it."""
        if item.ready is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(item.ready)
            for t in _cuda_tensors(item.payload):
                t.record_stream(stream)
        return item

    def __iter__(self) -> Iterator[PlacedItem]:
        try:
            while True:
                try:
                    kind, val = self._q.get(timeout=0.5)
                except queue.Empty:
                    if self._stop.is_set() or not self._pump_thread.is_alive():
                        return  # closed, or pump died post-close: stream over
                    continue
                if kind == "item":
                    yield self._hand_over(val)
                elif kind == "end":
                    return
                else:
                    raise val
        finally:
            self.close()

    def close(self, timeout: float = 5.0) -> None:
        """Stop the pump, join it, and drop buffered batches. Idempotent;
        safe from any thread (including the iterator's own ``finally``)."""
        self._stop.set()
        t = self._pump_thread
        if t is not threading.current_thread() and t.is_alive():
            t.join(timeout)
        while True:  # free placed device buffers an abandoned consumer left
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
