"""Carry weights across: a JAX transformer checkpoint as the port's state_dict.

`params_from_jax` takes the JAX package's transformer params as nested dicts
of numpy arrays (``jax.device_get(params)``) and returns the state_dict of
`models.transformer.TransformerLM`. The JAX package stacks every block param
on a leading layer dim, ``blocks.wqkv`` (L, D, 3, H, Dh), ``blocks.wo``
(L, H, Dh, D) and so on; the port keeps one module per layer, so the stack is
split into ``blocks.{i}.{name}`` with the per-layer shapes unchanged. It takes
numpy only and needs no JAX.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch

#: per-layer block params of the dense transformer, in module order
BLOCK_PARAMS = ("ln1", "wqkv", "bqkv", "wo", "bo", "ln2", "win", "bin", "wout", "bout")


def params_from_jax(tree: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """JAX params {embed, pos, blocks: {name: (L, ...)}, lnf, head} -> state_dict."""
    blocks = tree["blocks"]
    missing = set(BLOCK_PARAMS) - set(blocks)
    if missing:
        raise KeyError(f"JAX block params lack {sorted(missing)} (a dense FFN "
                       f"transformer has {list(BLOCK_PARAMS)})")
    n_layers = {np.shape(blocks[name])[0] for name in BLOCK_PARAMS}
    if len(n_layers) != 1:
        raise ValueError(f"block params disagree on the layer count: {n_layers}")

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    out["embed"] = tensor(tree["embed"])
    out["pos"] = tensor(tree["pos"])
    for i in range(n_layers.pop()):
        for name in BLOCK_PARAMS:
            out[f"blocks.{i}.{name}"] = tensor(np.asarray(blocks[name])[i])
    out["lnf"] = tensor(tree["lnf"])
    out["head"] = tensor(tree["head"])
    return out
