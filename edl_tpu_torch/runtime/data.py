"""Lease-driven data pipeline: the cloud_reader equivalent. A copy of the
JAX package's `edl_tpu.runtime.data`: the shard files, task ids, seeds and
row orders are the same, so a shard written by either package reads row
for row the same in the other.

The reference's fault-tolerant trainers pull chunked tasks from the master's
etcd-backed queue (`cloud_reader(etcd_endpoint)`,
`example/fit_a_line/train_ft.py:111-114`); non-FT trainers statically split
files by rank (`example/fit_a_line/fluid/common.py:24-40`), and the CTR
example downloads per-trainer file shards before training
(`example/ctr/ctr/train.py:221-227`). Here a shard is a coordinator lease:
trainers acquire, produce that shard's batches, complete. At-least-once: a
shard leased by a departed/stalled trainer requeues, and replays are
deterministic (synthetic batches derive from the shard id; file batches from
the file's bytes).

Two sources:

- ``SyntheticShardSource`` — hermetic: batches generated from the shard id.
- ``FileShardSource``      — production: shard id → ``.npz`` file under a
  root directory, with a sidecar row count so rank 0 can publish exact
  lockstep step counts for genuinely uneven shards
  (the multi-host runtime). Every batch has the SAME static shape — a
  partial tail is padded by wrapping rows — as the JAX package's step needs
  for one compilation over the whole dataset.
"""

from __future__ import annotations

import hashlib
import json
import os
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Mapping, Optional

import numpy as np

from edl_tpu_torch.models.base import Model


def shard_names(prefix: str, count: int) -> List[str]:
    """Canonical shard-id scheme: '<prefix>/part-00000'..."""
    return [f"{prefix}/part-{i:05d}" for i in range(count)]


def pass_task(shard: str, pass_idx: int) -> str:
    """Task id for training ``shard`` on dataset pass ``pass_idx``.

    Multi-pass training (``spec.passes``; ref ``--num_passes`` wiring,
    `docker/paddle_k8s:205-216`, default `pkg/jobparser.go:63`) enqueues every
    pass's visit of every shard as its own lease: pass 0 keeps the bare shard
    id (back-compat), later passes suffix ``#p<k>``. All passes seed the queue
    UPFRONT (FIFO: pass 0 drains first) — re-seeding at pass boundaries would
    race workers observing a momentarily empty queue as job completion.
    """
    return shard if pass_idx == 0 else f"{shard}#p{pass_idx}"


def split_pass(task: str) -> tuple:
    """(base shard id, pass index) for a task id from ``pass_task``."""
    base, sep, suffix = task.rpartition("#p")
    if sep and suffix.isdigit():
        return base, int(suffix)
    return task, 0


def pass_tasks(shards: List[str], passes: int) -> List[str]:
    """The full multi-pass task list, pass-major (pass 0 first)."""
    return [pass_task(s, k) for k in range(max(1, passes)) for s in shards]


def shard_seed(shard: str) -> int:
    """Stable 64-bit seed for a shard id (sha256-based — NOT ``hash()``,
    which is salted per process and would break cross-run determinism)."""
    return int.from_bytes(hashlib.sha256(shard.encode()).digest()[:8], "little")


_shard_seed = shard_seed  # internal alias, kept for existing callers


@dataclass
class SyntheticShardSource:
    """Deterministic batches for a shard id: replaying a requeued lease yields
    bit-identical data, so elastic replays do not skew training distribution."""

    model: Model
    batch_size: int
    batches_per_shard: int

    def read(self, shard: str) -> Iterator[Dict[str, np.ndarray]]:
        # Seed from the BASE shard id: pass 2's visit of a shard is the same
        # dataset slice as pass 1's, not fresh data.
        base, _ = split_pass(shard)
        rng = np.random.default_rng(_shard_seed(base))
        for _ in range(self.batches_per_shard):
            yield self.model.synthetic_batch(rng, self.batch_size)

    def batch_count(self, shard: str) -> int:
        """Lockstep metadata: lets rank 0 publish a round's exact step count
        (the multi-host runtime) instead of assuming equal shards."""
        return self.batches_per_shard


def write_shard(root: str, shard: str, arrays: Mapping[str, np.ndarray]) -> str:
    """Write one shard: stacked arrays (leading dim = rows) to
    ``<root>/<shard>.npz`` plus a ``.meta.json`` sidecar with the row count —
    the metadata ``FileShardSource.batch_count`` serves without decompressing
    the arrays. Returns the data file path."""
    rows = {a.shape[0] for a in arrays.values()}
    if len(rows) != 1:
        raise ValueError(f"arrays disagree on row count: { {k: v.shape for k, v in arrays.items()} }")
    path = os.path.join(root, f"{shard}.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)  # atomic: a concurrent reader sees old or new, never half
    meta = {"rows": int(next(iter(rows)))}
    tmp_meta = f"{path}.meta.json.tmp-{os.getpid()}"
    with open(tmp_meta, "w") as f:
        json.dump(meta, f)
    os.replace(tmp_meta, f"{path}.meta.json")
    return path


@dataclass
class FileShardSource:
    """Shard id → on-disk ``.npz`` file; deterministic replay, static shapes.

    The production source the reference gets from per-trainer file downloads
    (`example/ctr/ctr/train.py:221-227`) and file-split readers
    (`example/fit_a_line/fluid/common.py:24-40`) — but lease-driven instead of
    rank-keyed, so elastic membership changes redistribute files instead of
    orphaning them.

    ``shuffle_seed`` enables within-shard row shuffling (the reference wraps
    its readers in `paddle.reader.shuffle` with a 100x-batch buffer,
    `example/ctr/ctr/train.py:124-126`); the permutation derives from
    (shard id, seed), so replaying a requeued shard remains bit-identical —
    elastic replays never skew the sample distribution.

    Replay determinism: batches are row slices of the (optionally permuted)
    file in a fixed order; a partial tail is padded by wrapping to keep the
    batch shape static (the JAX package compiles one step for it).
    """

    root: str
    batch_size: int
    #: None -> file order; int -> deterministic per-shard row permutation.
    shuffle_seed: Optional[int] = None

    def path(self, shard: str) -> str:
        # Pass suffixes address a VISIT of a shard, not a different file.
        base, _ = split_pass(shard)
        return os.path.join(self.root, f"{base}.npz")

    def read(self, shard: str) -> Iterator[Dict[str, np.ndarray]]:
        with np.load(self.path(shard)) as data:
            arrays = {k: data[k] for k in data.files}
        rows = next(iter(arrays.values())).shape[0] if arrays else 0
        if self.shuffle_seed is not None and rows > 1:
            # Seed from the FULL task id: each pass re-visits the same rows
            # in a fresh (but replay-deterministic) order.
            rng = np.random.default_rng(
                (_shard_seed(shard) ^ self.shuffle_seed) & 0xFFFFFFFFFFFFFFFF
            )
            perm = rng.permutation(rows)
            arrays = {k: a[perm] for k, a in arrays.items()}
        for start in range(0, rows, self.batch_size):
            idx = np.arange(start, start + self.batch_size)
            # wrap the tail: static batch shape, no rows dropped
            yield {k: np.take(a, idx, axis=0, mode="wrap")
                   for k, a in arrays.items()}

    def rows(self, shard: str) -> int:
        meta_path = f"{self.path(shard)}.meta.json"
        try:
            with open(meta_path) as f:
                return int(json.load(f)["rows"])
        except (OSError, ValueError, KeyError):
            # Sidecar missing (foreign writer): fall back to reading the file.
            try:
                with np.load(self.path(shard)) as data:
                    if not data.files:
                        return 0
                    return int(data[data.files[0]].shape[0])
            except OSError:
                return 0

    def batch_count(self, shard: str) -> int:
        """Real lockstep metadata for uneven shards: ceil(rows/batch_size)."""
        rows = self.rows(shard)
        return -(-rows // self.batch_size) if rows > 0 else 0

    def list_shards(self) -> List[str]:
        """All shard ids present under root (relative paths, no extension)."""
        out = []
        for dirpath, _, files in os.walk(self.root):
            for name in files:
                if name.endswith(".npz"):
                    rel = os.path.relpath(os.path.join(dirpath, name), self.root)
                    out.append(rel[: -len(".npz")])
        return sorted(out)


def prefetch_iter(it: Iterator, depth: int = 2) -> Iterator:
    """Run ``it`` on a background thread, staying ``depth`` items ahead.

    Batch-level read-ahead for iterators whose production cost (file
    decompression, array slicing) should overlap the consumer's device
    compute — the lockstep multihost path uses this (its shard-level
    pipeline lives in ``LeaseReader`` and needs lease RPCs the lockstep
    protocol routes differently). Exceptions — including SystemExit from
    a source that demands a gang restart — re-raise in the CONSUMER, not
    the pump thread, so control flow is identical to plain iteration.

    Thin wrapper over :class:`edl_tpu_torch.runtime.pipeline.DevicePrefetcher`
    in raw read-ahead mode (no placement function): one pump
    implementation serves both the read-ahead and the device-placement
    pipelines.
    """
    from edl_tpu_torch.runtime.pipeline import DevicePrefetcher

    with DevicePrefetcher(
        it, place_fn=None, depth=depth, thread_name="edl-batch-prefetch"
    ) as pf:
        for item in pf:
            yield item.payload


class LeaseReader:
    """Iterate (shard, batch) pairs by leasing shards from the coordinator.

    ``stop_check`` is polled between batches — the elastic worker passes its
    epoch-change detector so a rescale interrupts mid-shard, failing the lease
    back to the queue for replay on the new mesh.

    ``defer_completion=True`` turns immediate completion into **completion
    lag**: a fully-read shard moves to ``consumed`` with its lease still held,
    and the caller completes it only once a durable checkpoint covers its
    updates (``take_consumed`` -> ``client.complete_task``). A hard crash
    (kill -9) between checkpoints therefore replays exactly the shards whose
    updates the restored checkpoint lacks — true at-least-once, the guarantee
    the reference gets from pserver-held state + master lease requeue
    (`docker/paddle_k8s:26-32`). Immediate completion is at-MOST-once across
    crashes: a completed-but-uncovered shard would be lost forever.

    ``prefetch=True`` pipelines the data path: the NEXT shard's read happens
    on a background thread while the current shard's batches feed training,
    so the accelerator never stalls on a shard load (the reference
    double-buffers host feeding the same way: `py_reader.start()`,
    `example/ctr/ctr/train.py:120-129,158`). Costs one extra held lease and
    up to two shards of host RAM; all coordinator RPCs stay on the calling
    thread (the client connection is not thread-safe).
    """

    def __init__(
        self,
        client,  # CoordinatorClient | InProcessClient
        source,  # object with .read(shard) -> Iterator[batch]
        stop_check: Optional[Callable[[], bool]] = None,
        defer_completion: bool = False,
        prefetch: bool = False,
        soft_stop_check: Optional[Callable[[], bool]] = None,
    ):
        self.client = client
        self.source = source
        self.stop_check = stop_check or (lambda: False)
        #: polled at shard BOUNDARIES only: a soft stop finishes (and
        #: completes) the in-flight shard, then stops leasing — the
        #: replay-free drain an advance-notice revocation takes when its
        #: budget affords it, vs. stop_check's mid-shard interrupt that
        #: fails the lease back for replay.
        self.soft_stop_check = soft_stop_check or (lambda: False)
        self.defer_completion = defer_completion
        self.prefetch = prefetch
        self.completed: List[str] = []
        #: defer mode: fully-read shards whose leases are still held, awaiting
        #: a covering checkpoint. A deque because under the pipelined loop
        #: (`DevicePrefetcher`) ``_finish`` runs on the pump thread while
        #: ``take_consumed`` drains on the consumer: append/popleft are
        #: GIL-atomic, so the drain can never drop a shard.
        self.consumed: "deque" = deque()
        #: the task whose batches are currently being yielded (per-pass
        #: metrics attribution; see ``split_pass``).
        self.current: Optional[str] = None
        self.interrupted: Optional[str] = None
        #: a soft stop fired: the reader stopped at a shard boundary with
        #: nothing failed back (no replay pending anywhere).
        self.drained = False
        self.exhausted = False

    def take_consumed(self) -> List[str]:
        """Drain the consumed-but-uncompleted list (defer mode). The caller
        completes these AFTER the checkpoint covering them is durable.
        Popleft-based so a concurrent ``_finish`` append (pump thread under
        the pipelined loop) is either drained now or kept for next time —
        never lost."""
        out: List[str] = []
        while True:
            try:
                out.append(self.consumed.popleft())
            except IndexError:
                return out

    def _finish(self, task: str) -> None:
        if self.defer_completion:
            self.consumed.append(task)
        else:
            self.client.complete_task(task)
            self.completed.append(task)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.prefetch:
            yield from self._iter_prefetch()
        else:
            yield from self._iter_sync()

    def _iter_sync(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            if self.soft_stop_check():
                self.drained = True
                return
            reply = self.client.acquire()
            task = reply.get("task")
            if task is None:
                self.exhausted = bool(reply.get("exhausted"))
                return
            self.current = task
            for batch in self.source.read(task):
                if self.stop_check():
                    # Rescale signal mid-shard: give the lease back for a
                    # deterministic replay on the new mesh.
                    self.client.fail_task(task)
                    self.interrupted = task
                    return
                yield batch
            self._finish(task)

    def _iter_prefetch(self) -> Iterator[Dict[str, np.ndarray]]:
        ex = ThreadPoolExecutor(1, thread_name_prefix="edl-prefetch")
        try:
            yield from self._prefetch_loop(ex)
        finally:
            # No wait: on a rescale interrupt the in-flight prefetched load
            # is garbage (its lease already failed back) — blocking recovery
            # on a full shard read would bill dead work to the <30 s budget.
            ex.shutdown(wait=False, cancel_futures=True)

    def _prefetch_loop(self, ex: ThreadPoolExecutor) -> Iterator[Dict[str, np.ndarray]]:
        def load(shard: str) -> Future:
            # Materializing the shard bounds RAM at <= 2 shards and keeps the
            # loader thread free of client RPCs.
            return ex.submit(lambda s=shard: list(self.source.read(s)))

        reply = self.client.acquire()
        cur = reply.get("task")
        if cur is None:
            self.exhausted = bool(reply.get("exhausted"))
            return
        fut = load(cur)
        while cur is not None:
            if self.soft_stop_check():
                # Boundary drain under the pipelined loop: stop leasing
                # ahead — cur (possibly last round's look-ahead, already
                # leased + loaded) still trains to completion.
                nxt, nfut = None, None
            else:
                nxt = self.client.acquire().get("task")  # overlaps training
                nfut = load(nxt) if nxt is not None else None
            self.current = cur
            for batch in fut.result():
                if self.stop_check():
                    self.client.fail_task(cur)
                    if nxt is not None:
                        if nfut is not None:
                            nfut.cancel()
                        self.client.fail_task(nxt)
                    self.interrupted = cur
                    return
                yield batch
            self._finish(cur)
            cur, fut = nxt, nfut
        if self.soft_stop_check():
            self.drained = True
            return
        # The pipeline's look-ahead acquire saw an empty queue one shard ago;
        # re-check now that the final shard completed. A task appearing here
        # (late requeue) goes back to the queue — the caller's outer loop
        # re-enters a reader for it.
        final = self.client.acquire()
        if final.get("task") is not None:
            self.client.fail_task(final["task"])
            self.exhausted = False
        else:
            self.exhausted = bool(final.get("exhausted"))
