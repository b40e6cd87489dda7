"""The flash kernels' tile table: tuned (block_q, block_k) by shape and dtype.

The counterpart of `edl_tpu.ops.flash_tuning`, with its names and semantics.
On the card a pair names the forward kernel's tile: ``block_q`` query rows a
block and ``block_k`` keys a pipeline stage (the two backward kernels keep
one tile for each head-dim class). Which pair is fastest depends on the
sequence length, the head dim and the dtype, and only a sweep on the card
can find it: ``python3 chip_smoke.py --kernels`` times every compiled
forward tile at the sweep's shapes and prints the winners, and a chip call's
winners are committed in ``flash_blocks.json`` beside this module.
`flash_attention` consults `lookup` whenever the caller did not pin both
blocks, falling back to `DEFAULT_BLOCKS` wherever the table is silent.

Key scheme: ``"{S_bucket},{D},{dtype}"`` where ``S_bucket`` is the key
sequence length rounded DOWN to a power of two (from 128), and ``dtype`` is
the JAX package's name of the type (``bfloat16``, ``float16``, ``float32``),
so that one table file reads the same in both packages.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, Optional, Tuple

#: the forward kernel's tile before the table existed: 128 query rows a
#: block, 64 keys a stage; a silent table changes nothing that runs
DEFAULT_BLOCKS: Tuple[int, int] = (128, 64)

_TABLE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "flash_blocks.json")

#: torch's dtype names (and the JAX package's own) to the JAX package's
_JAX_NAMES = {"torch.bfloat16": "bfloat16", "torch.float16": "float16",
              "torch.float32": "float32", "torch.float64": "float64"}


def dtype_name(dtype) -> str:
    """The JAX package's name of ``dtype`` (a torch dtype or a name)."""
    name = str(dtype)
    return _JAX_NAMES.get(name, name)


def _bucket(s: int) -> int:
    b = 128
    while b * 2 <= s:
        b *= 2
    return b


def _key(s_bucket: int, d: int, dtype: str) -> str:
    return f"{s_bucket},{d},{dtype}"


@functools.lru_cache(maxsize=1)
def _load_table(path: str = _TABLE_PATH) -> Dict[str, Tuple[int, int]]:
    try:
        with open(path) as f:
            raw = json.load(f)
        return {k: tuple(v) for k, v in raw.get("blocks", {}).items()}
    except (OSError, ValueError):
        return {}


def lookup(seq_len: int, head_dim: int, dtype, *,
           path: Optional[str] = None) -> Tuple[int, int]:
    """Tuned (block_q, block_k) for a key-sequence length / head dim /
    dtype, falling back through lower buckets and dtype-agnostic (``"any"``)
    entries to `DEFAULT_BLOCKS`. Never returns blocks larger than the sweep
    proved."""
    table = _load_table(path) if path else _load_table()
    dtype = dtype_name(dtype)
    sb = _bucket(max(128, seq_len))
    while sb >= 128:
        for key in (_key(sb, head_dim, dtype), _key(sb, head_dim, "any")):
            if key in table:
                return table[key]
        sb //= 2
    return DEFAULT_BLOCKS


def save_table(blocks: Dict[str, Tuple[int, int]], meta: Dict,
               path: str = _TABLE_PATH) -> None:
    """Persist sweep winners; clears the lookup cache so the running process
    sees the new table. The write is atomic."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"blocks": {k: list(v) for k, v in blocks.items()},
                   "meta": meta}, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    _load_table.cache_clear()
