"""Compact host->device wire format for training batches: the port of
`edl_tpu.runtime.wire`.

Batches cross the host->device link in the smallest dtype that keeps the
training semantics and are decoded on the device as the step's first act.
Encodings (chosen per key from an example batch), as in the JAX package:

- ``bf16``: float32/64 -> bfloat16. The models' matmuls run in bf16, so
  feature precision beyond bf16 never reaches the math.
- ``u8``:  non-negative ints < 256 (labels, small categoricals) -> uint8.
- ``u24``: non-negative ints < 2^24 (hashed sparse ids; CTR's vocab is
  1e6+1) -> 3 little-endian bytes in a trailing dim of 3, reassembled with
  shifts on the device.
- ``raw``: anything else passes through.

``encode`` validates every batch against the chosen encoding (a later batch
overflowing the example's range raises instead of corrupting), so inference
from one example batch is safe.

``encode`` returns host tensors (``torch.Tensor`` on the CPU): numpy has no
bfloat16, and the JAX package's ``ml_dtypes`` is not a dependency of the
port. The bf16 cast is ``torch.Tensor.to(torch.bfloat16)``, round to
nearest even as ``ml_dtypes``' ``astype`` is, with NaNs written as
``ml_dtypes`` writes them, so the encoded bits are the JAX package's. ``to_spec`` writes the same JSON as the JAX codec, so a spec
either package publishes builds the same codec in the other.

`KVCodecChannel` agrees on one codec across the ranks of a mesh through
the coordinator KV, with the JAX package's keys and JSON, so every rank
decodes the same layout and no rank widens alone.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

__all__ = ["KVCodecChannel", "WireCodec", "WireOverflowError", "WireRestartRequired"]

_U24_MAX = (1 << 24) - 1

#: widths ordered narrow -> wide, for floor comparisons
_WIDTH_ORDER = {"u8": 0, "u24": 1, "bf16": 1, "raw": 2}


class WireOverflowError(ValueError):
    """A batch value exceeds the range of its negotiated wire encoding."""

    def __init__(self, key: str, message: str):
        super().__init__(message)
        self.key = key


@dataclass(frozen=True)
class _KeyCodec:
    encoding: str  # "raw" | "bf16" | "u8" | "u24"
    dtype: np.dtype  # original host dtype (decode target modulo width)


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def _host(a: Any) -> np.ndarray:
    """A batch value as a numpy array (host tensors are viewed, not copied)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _to_bf16(a: np.ndarray) -> torch.Tensor:
    """``a`` rounded to bf16 to nearest even, bit for bit ``ml_dtypes``'
    ``astype``: torch's cast, with each NaN made the quiet NaN of its sign
    (``ml_dtypes`` writes 0x7FC0 / 0xFFC0; torch's CPU cast writes 0xFFFF)."""
    out = torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
    nan = np.isnan(a)
    if nan.any():
        quiet = np.where(np.signbit(a[nan]), 0xFFC0, 0x7FC0).astype(np.uint16)
        out.view(torch.int16)[torch.from_numpy(nan)] = torch.from_numpy(quiet.view(np.int16))
    return out


class WireCodec:
    """Per-key transport encodings inferred once, applied per batch."""

    def __init__(self, keys: Dict[str, _KeyCodec]):
        self.keys = keys

    # -- inference -------------------------------------------------------------

    @classmethod
    def infer(
        cls,
        example: Dict[str, np.ndarray],
        no_lossy_keys: Iterable[str] = (),
    ) -> "WireCodec":
        """Infer per-key encodings from one example batch.

        ``no_lossy_keys`` names keys whose values must cross the wire
        exactly (regression targets, sample weights read by an f32 loss):
        float keys in the set stay ``raw``; integer keys keep their u8/u24
        encodings, which are exact (validated per batch)."""
        no_lossy = frozenset(no_lossy_keys)
        keys: Dict[str, _KeyCodec] = {}
        for name, arr in example.items():
            a = _host(arr)
            if a.dtype in (np.float32, np.float64):
                keys[name] = _KeyCodec("raw" if name in no_lossy else "bf16", a.dtype)
            elif np.issubdtype(a.dtype, np.integer) and a.size:
                lo, hi = int(a.min()), int(a.max())
                if lo >= 0 and hi < 256:
                    keys[name] = _KeyCodec("u8", a.dtype)
                elif lo >= 0 and hi <= _U24_MAX:
                    keys[name] = _KeyCodec("u24", a.dtype)
                else:
                    keys[name] = _KeyCodec("raw", a.dtype)
            else:
                keys[name] = _KeyCodec("raw", a.dtype)
        return cls(keys)

    # -- host side -------------------------------------------------------------

    def encode(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Encode a host batch; returns CPU tensors (bf16, uint8, or the
        original dtype for ``raw``)."""
        out: Dict[str, torch.Tensor] = {}
        for name, arr in batch.items():
            kc = self.keys.get(name)
            a = _host(arr)
            if kc is None or kc.encoding == "raw":
                out[name] = torch.from_numpy(np.ascontiguousarray(a))
            elif kc.encoding == "bf16":
                out[name] = _to_bf16(a)
            elif kc.encoding == "u8":
                if a.size and (a.min() < 0 or a.max() > 255):
                    raise WireOverflowError(name, f"{name}: value outside u8 range")
                out[name] = torch.from_numpy(a.astype(np.uint8))
            elif kc.encoding == "u24":
                if a.size and (a.min() < 0 or a.max() > _U24_MAX):
                    raise WireOverflowError(name, f"{name}: value outside u24 range")
                # the low three of each id's four little-endian bytes; torch's
                # strided copy is several times numpy's for a 3-byte row
                le = np.ascontiguousarray(a.astype("<i4", copy=False))
                out[name] = torch.from_numpy(
                    le.view(np.uint8).reshape(a.shape + (4,)))[..., :3].contiguous()
            else:  # pragma: no cover
                raise ValueError(f"unknown encoding {kc.encoding}")
        return out

    # -- device side -----------------------------------------------------------

    def decode(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Decode an encoded batch where it lies (the device, in a step):
        plain torch ops, as the JAX decode is plain jnp."""
        out: Dict[str, torch.Tensor] = {}
        for name, arr in batch.items():
            kc = self.keys.get(name)
            if kc is None or kc.encoding == "raw":
                out[name] = arr
            elif kc.encoding in ("bf16", "u8"):
                out[name] = arr.to(_torch_dtype(kc.dtype))
            elif kc.encoding == "u24":
                b = arr.to(torch.int32)
                v = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
                out[name] = v.to(_torch_dtype(kc.dtype))
            else:  # pragma: no cover
                raise ValueError(f"unknown encoding {kc.encoding}")
        return out

    def widen(self, key: str) -> "WireCodec":
        """Return a codec with ``key``'s int encoding one step wider
        (u8 -> u24 -> raw), to self-heal after a WireOverflowError; float
        encodings never overflow. Raises KeyError for keys that cannot
        widen further."""
        kc = self.keys[key]
        if kc.encoding == "u8":
            wider = _KeyCodec("u24", kc.dtype)
        elif kc.encoding == "u24":
            wider = _KeyCodec("raw", kc.dtype)
        else:
            raise KeyError(f"{key}: encoding {kc.encoding!r} cannot widen")
        return WireCodec({**self.keys, key: wider})

    # -- cross-process agreement ----------------------------------------------

    def to_spec(self) -> str:
        """JSON wire-spec, the JAX codec's string for the same codec: enough
        for a peer process to rebuild the identical codec."""
        return json.dumps(
            {k: {"e": kc.encoding, "d": np.dtype(kc.dtype).str}
             for k, kc in sorted(self.keys.items())},
            sort_keys=True,
        )

    @classmethod
    def from_spec(cls, spec: str) -> "WireCodec":
        return cls({
            k: _KeyCodec(v["e"], np.dtype(v["d"]))
            for k, v in json.loads(spec).items()
        })

    def apply_floor(self, floor: Dict[str, str]) -> "WireCodec":
        """Return a codec whose int encodings are at least as wide as
        ``floor`` (key -> encoding): widths that an earlier run learned from
        an overflow, so a renegotiated codec cannot repeat it."""
        keys = dict(self.keys)
        for k, enc in floor.items():
            kc = keys.get(k)
            if kc is None or kc.encoding in ("raw", "bf16"):
                continue
            if _WIDTH_ORDER.get(enc, 0) > _WIDTH_ORDER[kc.encoding]:
                keys[k] = _KeyCodec(enc, kc.dtype)
        return WireCodec(keys)

    def is_encoded(self, batch: Dict[str, Any]) -> bool:
        """True if ``batch`` looks wire-encoded: numpy arrays or tensors,
        on the host or the device."""
        for name, kc in self.keys.items():
            if name in batch and kc.encoding != "raw":
                enc = batch[name].dtype
                if isinstance(enc, torch.dtype):
                    return enc == (torch.bfloat16 if kc.encoding == "bf16" else torch.uint8)
                if kc.encoding == "bf16":
                    return str(enc) == "bfloat16"
                return enc == np.uint8
        return False

    def wire_bytes(self, batch: Dict[str, np.ndarray]) -> int:
        return sum(t.numel() * t.element_size() for t in self.encode(batch).values())


class WireRestartRequired(RuntimeError):
    """Multi-process codec agreement broke (a batch overflowed the
    negotiated codec, or rank 0 died before publishing one). Widening in
    place would leave the peers decoding the old layout, so every process
    must warm-restart and renegotiate: the gang restart a rescale takes."""

    def __init__(self, key: str, message: Optional[str] = None):
        super().__init__(
            message
            or f"wire key {key!r} overflowed the negotiated codec; widened "
               "floor published — exit for gang warm-restart to renegotiate"
        )
        self.key = key


class KVCodecChannel:
    """Codec agreement for multi-process jobs, over the coordinator KV.

    Every rank must decode the same layout, so the codec cannot be inferred
    per rank from local batches (their ranges differ). Protocol, as in the
    JAX package:

    - rank 0 infers from its first batch, applies the persistent widen
      floor, and publishes the spec under one key holding
      ``{"epoch": N, "spec": ...}``: a rescale (new epoch, possibly a new
      rank 0) renegotiates, and dead epochs never pile up in the KV;
    - the other ranks poll that key for this epoch's spec, heartbeating;
    - an overflow on ANY rank raises that key's width in the (epoch-less)
      floor and asks for a gang warm-restart (`WireRestartRequired`); the
      renegotiated codec starts from the floor, so the overflow cannot
      recur (u8 -> u24 -> raw: at most two restarts per key, ever)."""

    SPEC_KEY = "edl/wire_codec"
    FLOOR_KEY = "edl/wire_floor"

    def __init__(self, client, epoch: int):
        self.client = client
        self.epoch = int(epoch)

    def floor(self) -> Dict[str, str]:
        raw = self.client.kv_get(self.FLOOR_KEY)
        return json.loads(raw) if raw else {}

    def publish(self, codec: WireCodec) -> WireCodec:
        """Rank 0: pin the (floored) codec for this epoch; returns it."""
        floored = codec.apply_floor(self.floor())
        self.client.kv_put(self.SPEC_KEY,
                           json.dumps({"epoch": self.epoch, "spec": floored.to_spec()}))
        return floored

    def fetch(self, timeout: float = 60.0) -> WireCodec:
        """Ranks > 0: block until rank 0 publishes THIS epoch's codec,
        heartbeating while polling (negotiation can outlast the heartbeat
        TTL, and an evicted waiter would bump the epoch for nothing). A
        timeout means rank 0 died before publishing: the gang restarts."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            raw = self.client.kv_get(self.SPEC_KEY)
            if raw:
                msg = json.loads(raw)
                if int(msg.get("epoch", -1)) == self.epoch:
                    return WireCodec.from_spec(msg["spec"])
            self.client.heartbeat()
            time.sleep(0.05)
        raise WireRestartRequired(
            "", message=f"no wire codec published for epoch {self.epoch} within "
                        f"{timeout}s (rank 0 died pre-publish?) — exit for gang "
                        "warm-restart")

    def raise_floor(self, key: str, encoding: str) -> None:
        """Record that ``key`` needs at least ``encoding`` before restarting.
        Floors only widen and restarts re-apply them, so a lost concurrent
        update costs at most one more restart for the other key."""
        floor = self.floor()
        if _WIDTH_ORDER.get(encoding, 0) > _WIDTH_ORDER.get(floor.get(key, "u8"), -1):
            floor[key] = encoding
            self.client.kv_put(self.FLOOR_KEY, json.dumps(floor, sort_keys=True))
