"""Bucketed continuous batching: the pure math under the serving frontend,
a copy of `edl_tpu.serving.batcher`.

A small ladder of fixed bucket sizes: coalesce queued requests, pad up to
the smallest bucket that fits, and dispatch a step whose shape was warmed
once per bucket before the first request. Fixed shapes keep the device's
work per dispatch predictable and are what a later CUDA-graph capture per
bucket needs. This module holds the ladder math and the pad/split
plumbing; it is numpy-pure (no torch at module scope, no threads) so every
edge case is unit-testable in microseconds.

The LM tier adds a SECOND bucket axis: sequence length. A decode or
prefill step is shaped (batch slots, token capacity), so autoregressive
requests bucket twice — batch slot count by the ladder above, token
capacity by :func:`pick_seq_bucket`. Unlike the batch axis (where the
dispatcher chunks overflow via :func:`plan_chunks`), sequence overflow is a
hard admission error: a stream longer than the largest seq bucket can never
fit any warmed shape, so it is rejected with the typed
:class:`SeqTooLongError` before any memory is allocated.
"""

from __future__ import annotations

import numpy as np
from typing import Dict, List, Sequence, Tuple

__all__ = ["pick_bucket", "plan_chunks", "pad_batch", "split_rows",
           "validate_buckets", "pick_seq_bucket", "pad_token_rows",
           "SeqTooLongError"]


class SeqTooLongError(ValueError):
    """Request needs more token capacity than the largest seq bucket —
    no warmed (bucket, seq-bucket) shape can ever run it, so the
    admission path rejects it synchronously (HTTP 400, not 429: retrying
    the same request can never succeed)."""


def validate_buckets(buckets: Sequence[int]) -> Tuple[int, ...]:
    """Normalize a bucket ladder: positive, strictly ascending, non-empty."""
    out = tuple(int(b) for b in buckets)
    if not out:
        raise ValueError("bucket ladder must be non-empty")
    if any(b <= 0 for b in out):
        raise ValueError(f"bucket sizes must be positive: {out}")
    if any(b >= c for b, c in zip(out, out[1:])):
        raise ValueError(f"bucket ladder must be strictly ascending: {out}")
    return out


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits ``n`` requests; the largest bucket when
    none does (the caller chunks first via :func:`plan_chunks`)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def plan_chunks(n: int, buckets: Sequence[int]) -> List[int]:
    """Split ``n`` queued requests into dispatchable chunk sizes: full
    largest-buckets first, remainder in the smallest bucket that fits.
    ``sum(plan_chunks(n, ...)) == n`` always — no request is left behind."""
    chunks: List[int] = []
    largest = buckets[-1]
    while n > largest:
        chunks.append(largest)
        n -= largest
    if n:
        chunks.append(n)
    return chunks


def pad_batch(
    rows: List[Dict[str, np.ndarray]],
    bucket: int,
    feature_avals: Dict[str, Tuple[Tuple[int, ...], np.dtype]],
) -> Dict[str, np.ndarray]:
    """Stack per-request feature rows and zero-pad to ``bucket`` slots.

    ``rows`` are single-example dicts (no batch dim); ``feature_avals``
    maps key -> (per-example shape, dtype) and is the authority for both —
    a row missing a key or shaped differently raises rather than padding
    garbage into the model.
    """
    if len(rows) > bucket:
        raise ValueError(f"{len(rows)} rows exceed bucket {bucket}")
    out: Dict[str, np.ndarray] = {}
    for key, (shape, dtype) in feature_avals.items():
        shape = tuple(shape)
        try:
            # Fast path (the per-batch hot loop): submit() already coerced
            # every row, so one stack + one zero-filled tail covers the
            # whole bucket without a per-row Python loop.
            stacked = np.stack([row[key] for row in rows]).astype(
                dtype, copy=False
            )
            if stacked.shape != (len(rows),) + shape:
                raise ValueError  # shape drift: diagnose per row below
            arr = np.zeros((bucket,) + shape, dtype=dtype)
            arr[: len(rows)] = stacked
        except (KeyError, ValueError, TypeError):
            # Slow path only on mismatch: re-walk row by row to raise the
            # error that names the offending request and feature.
            arr = np.zeros((bucket,) + shape, dtype=dtype)
            for i, row in enumerate(rows):
                if key not in row:
                    raise KeyError(f"request {i} missing feature {key!r}")
                value = np.asarray(row[key], dtype=dtype)
                if value.shape != shape:
                    raise ValueError(
                        f"feature {key!r} of request {i} has shape "
                        f"{value.shape}, expected {shape}"
                    )
                arr[i] = value
        out[key] = arr
    return out


def split_rows(outputs, n: int) -> List:
    """The first ``n`` rows of a batched output (a tensor, or a dict, list
    or tuple of them), one numpy entry per real request — the padded tail
    rows are dropped.

    One device-to-host copy of the whole batch, then host-side row
    slicing: this sits on the per-batch hot path, and a copy per (row,
    leaf) would cost one transfer each instead."""
    host = _to_host(outputs)
    return [_row(host, i) for i in range(n)]


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if hasattr(tree, "detach"):  # a tensor: one copy to the host
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _row(tree, i: int):
    if isinstance(tree, dict):
        return {k: _row(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_row(v, i) for v in tree)
    return tree[i]


# -- the sequence-length bucket axis (LM serving) ------------------------------


def pick_seq_bucket(tokens: int, seq_buckets: Sequence[int]) -> int:
    """Smallest seq bucket with capacity for ``tokens``; raises
    :class:`SeqTooLongError` when even the largest cannot hold it.

    Unlike :func:`pick_bucket` this never clamps: a batch overflow splits
    into more chunks, but a sequence cannot be split across steps —
    admission must reject what the ladder cannot carry."""
    if tokens <= 0:
        raise ValueError(f"token count must be positive, got {tokens}")
    for b in seq_buckets:
        if tokens <= b:
            return b
    raise SeqTooLongError(
        f"request needs {tokens} token slots but the largest seq bucket "
        f"is {seq_buckets[-1]}"
    )


def pad_token_rows(
    rows: List[np.ndarray], bucket: int, seq_bucket: int,
    pad_id: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens, lengths) for a prefill dispatch: ``rows`` are 1-D int
    token-id arrays of varying length, right-padded with ``pad_id`` to
    ``seq_bucket`` and stacked into ``bucket`` slots (tail slots all-pad).

    Returns int32 arrays shaped (bucket, seq_bucket) and (bucket,).
    Rows longer than ``seq_bucket`` raise :class:`SeqTooLongError` — the
    caller's admission check should have bucketed them already."""
    if len(rows) > bucket:
        raise ValueError(f"{len(rows)} rows exceed bucket {bucket}")
    tokens = np.full((bucket, seq_bucket), pad_id, dtype=np.int32)
    lengths = np.zeros((bucket,), dtype=np.int32)
    for i, row in enumerate(rows):
        ids = np.asarray(row, dtype=np.int32).reshape(-1)
        if ids.size > seq_bucket:
            raise SeqTooLongError(
                f"prompt of {ids.size} tokens exceeds seq bucket {seq_bucket}"
            )
        tokens[i, : ids.size] = ids
        lengths[i] = ids.size
    return tokens, lengths
