"""Paged KV-cache block allocator: memory, not batch slots, is the
admission currency of the LM tier. A copy of `edl_tpu.serving.kvcache`.

A CTR replica admits a request when a queue slot is free; an LM stream
holds key/value state for its whole lifetime, so the scarce resource is
KV-cache device memory. This module manages that memory the way vLLM-style paged
attention does: a **preallocated pool of fixed-size blocks** (one block =
``block_tokens`` token slots of per-layer K/V), a freelist recycling
blocks when streams retire, and a per-stream **block table** mapping the
stream's logical token positions onto pool blocks.

Admission is a reservation against the stream's declared maximum:
``blocks_for(prompt + max_new_tokens)`` blocks are claimed up front, so
an admitted stream can always run to its token budget — decode never
deadlocks on allocation mid-stream (the failure mode lazy allocation
buys in exchange for higher occupancy). The cost of that guarantee is
*internal* fragmentation: reserved-but-unwritten token slots, which
:meth:`BlockPool.fragmentation` reports as a first-class metric
alongside occupancy.

Stdlib-pure and single-lock, like :mod:`edl_tpu_torch.serving.batcher`:
every edge case (exhaustion, double-free, freelist recycling order) is
unit-testable in microseconds, and the LM replica treats it as the one
authority on "can this stream be admitted?".
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["KVCacheConfig", "BlockPool", "KVCacheExhaustedError"]


class KVCacheExhaustedError(RuntimeError):
    """Not enough free blocks to cover the stream's token budget. The
    request was rejected, not dropped — the frontend maps this to HTTP
    429 and the router retries against a replica with free blocks."""


@dataclass(frozen=True)
class KVCacheConfig:
    """Shape of the block pool.

    ``n_blocks * block_tokens`` bounds the total token slots live streams
    can hold; ``bytes_per_token`` (2 * layers * heads * head_dim * itemsize
    for K+V) is carried so occupancy can be reported in bytes as well as
    slots — the number capacity planning actually wants.
    """

    n_blocks: int = 64
    block_tokens: int = 16
    bytes_per_token: int = 0

    def __post_init__(self):
        if self.n_blocks <= 0:
            raise ValueError(f"n_blocks must be positive: {self.n_blocks}")
        if self.block_tokens <= 0:
            raise ValueError(
                f"block_tokens must be positive: {self.block_tokens}"
            )

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to hold ``tokens`` token slots (ceil)."""
        return -(-int(tokens) // self.block_tokens)


@dataclass
class _Reservation:
    blocks: List[int]
    reserved_tokens: int
    used_tokens: int = 0
    meta: dict = field(default_factory=dict)


class BlockPool:
    """The preallocated block pool + freelist.

    ``reserve(stream_id, tokens)`` claims blocks for a stream's full
    token budget or raises :class:`KVCacheExhaustedError` atomically
    (no partial claims to unwind). ``note_tokens`` advances the stream's
    used-token high-water mark (fragmentation accounting only — the
    reservation already owns the memory). ``release`` returns the blocks
    to the freelist in LIFO order, so a hot pool reuses recently-touched
    blocks (the friendly pattern for a real allocator's page tables; here
    it simply makes recycling observable in tests).
    """

    def __init__(self, config: KVCacheConfig):
        self.config = config
        self._lock = threading.Lock()
        self._free: List[int] = list(range(config.n_blocks - 1, -1, -1))
        self._streams: Dict[str, _Reservation] = {}
        self._peak_blocks_used = 0

    # -- admission -------------------------------------------------------------

    def can_admit(self, tokens: int) -> bool:
        """Would ``reserve`` succeed for a ``tokens``-budget stream now?
        Advisory (another thread may win the race); the router's affinity
        policy reads this through replica status rather than calling it."""
        with self._lock:
            return self.config.blocks_for(tokens) <= len(self._free)

    def reserve(self, stream_id: str, tokens: int, **meta) -> List[int]:
        """Claim blocks covering ``tokens`` token slots for ``stream_id``.

        Returns the block table (pool indices, in logical-position order).
        Raises :class:`KVCacheExhaustedError` when the freelist cannot
        cover it and ``ValueError`` on a duplicate stream id.
        """
        need = self.config.blocks_for(tokens)
        with self._lock:
            if stream_id in self._streams:
                raise ValueError(f"stream {stream_id!r} already holds blocks")
            if need > len(self._free):
                raise KVCacheExhaustedError(
                    f"stream {stream_id!r} needs {need} blocks "
                    f"({tokens} tokens) but only {len(self._free)} of "
                    f"{self.config.n_blocks} are free"
                )
            blocks = [self._free.pop() for _ in range(need)]
            self._streams[stream_id] = _Reservation(
                blocks=blocks, reserved_tokens=need * self.config.block_tokens,
                meta=dict(meta),
            )
            used = self.config.n_blocks - len(self._free)
            self._peak_blocks_used = max(self._peak_blocks_used, used)
            return list(blocks)

    def note_tokens(self, stream_id: str, used_tokens: int) -> None:
        """Advance ``stream_id``'s written-token high-water mark (feeds
        the fragmentation metric; never allocates)."""
        with self._lock:
            res = self._streams.get(stream_id)
            if res is None:
                return  # stream already released: racing final update is fine
            res.used_tokens = min(max(res.used_tokens, int(used_tokens)),
                                  res.reserved_tokens)

    def release(self, stream_id: str) -> int:
        """Return ``stream_id``'s blocks to the freelist; returns the
        count recycled (0 when the stream held nothing — release is
        idempotent so retire paths never double-free)."""
        with self._lock:
            res = self._streams.pop(stream_id, None)
            if res is None:
                return 0
            self._free.extend(reversed(res.blocks))
            return len(res.blocks)

    def block_table(self, stream_id: str) -> Optional[List[int]]:
        with self._lock:
            res = self._streams.get(stream_id)
            return list(res.blocks) if res is not None else None

    # -- metrics ---------------------------------------------------------------

    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    def used_blocks(self) -> int:
        with self._lock:
            return self.config.n_blocks - len(self._free)

    def occupancy(self) -> float:
        """Fraction of the pool's blocks currently reserved."""
        return self.used_blocks() / self.config.n_blocks

    def fragmentation(self) -> float:
        """Internal fragmentation: fraction of reserved token slots no
        token has been written to. High values mean admission budgets
        (``max_new_tokens``) run far beyond what streams actually
        generate — the knob to tighten before growing the pool."""
        with self._lock:
            reserved = sum(r.reserved_tokens for r in self._streams.values())
            used = sum(r.used_tokens for r in self._streams.values())
        if reserved == 0:
            return 0.0
        return (reserved - used) / reserved

    def stats(self) -> Dict[str, float]:
        """One snapshot for status publication / the `edl_lm_kv_*`
        gauges: pool shape, live usage, fragmentation, peak."""
        with self._lock:
            free = len(self._free)
            used = self.config.n_blocks - free
            reserved = sum(r.reserved_tokens for r in self._streams.values())
            written = sum(r.used_tokens for r in self._streams.values())
            streams = len(self._streams)
            peak = self._peak_blocks_used
        frag = 0.0 if reserved == 0 else (reserved - written) / reserved
        out = {
            "n_blocks": self.config.n_blocks,
            "block_tokens": self.config.block_tokens,
            "used_blocks": used,
            "free_blocks": free,
            "peak_blocks_used": peak,
            "streams": streams,
            "reserved_tokens": reserved,
            "written_tokens": written,
            "occupancy": round(used / self.config.n_blocks, 4),
            "fragmentation": round(frag, 4),
        }
        if self.config.bytes_per_token:
            out["used_bytes"] = reserved * self.config.bytes_per_token
        return out
