"""Carry weights across: a JAX checkpoint of a zoo model as the port's state_dict.

Each function takes one model's JAX params as nested dicts and lists of
numpy arrays (``jax.device_get(params)``) and returns the state_dict of that
model's module; `PARAMS_FROM_JAX` names the function for each zoo module.
They take numpy only and need no JAX.

- The transformer (`params_from_jax`): the JAX package stacks every block
  param on a leading layer dim, ``blocks.wqkv`` (L, D, 3, H, Dh) and so on;
  the port keeps one module per layer, so the stack is split into
  ``blocks.{i}.{name}`` with the per-layer shapes unchanged.
- The other five (`tree_params_from_jax`): a dict key becomes a name, a list
  index a numbered submodule (CTR's ``mlp``, ResNet's ``blocks``), and
  tables, padded rows included, carry across whole. A 4-D leaf is a conv
  weight, HWIO in the JAX package and OIHW in the port.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Mapping

import numpy as np
import torch

#: per-layer block params of the dense transformer, in module order
BLOCK_PARAMS = ("ln1", "wqkv", "bqkv", "wo", "bo", "ln2", "win", "bin", "wout", "bout")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


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

    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    out["embed"] = _tensor(tree["embed"])
    out["pos"] = _tensor(tree["pos"])
    for i in range(n_layers.pop()):
        for name in BLOCK_PARAMS:
            out[f"blocks.{i}.{name}"] = _tensor(np.asarray(blocks[name])[i])
    out["lnf"] = _tensor(tree["lnf"])
    out["head"] = _tensor(tree["head"])
    return out


def tree_params_from_jax(tree: Any) -> "OrderedDict[str, torch.Tensor]":
    """JAX params of ctr, fit_a_line, word2vec, mnist or resnet -> state_dict:
    ``{"mlp": [{"w": a}]}`` becomes ``mlp.0.w``; HWIO conv weights become
    OIHW."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def walk(node, prefix: str) -> None:
        if isinstance(node, Mapping):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            a = np.asarray(node)
            out[prefix] = _tensor(a.transpose(3, 2, 0, 1) if a.ndim == 4 else a)
            return
        for key, child in items:
            walk(child, f"{prefix}.{key}" if prefix else str(key))

    walk(tree, "")
    return out


#: zoo module name -> its params-from-JAX function
PARAMS_FROM_JAX = {
    "transformer": params_from_jax,
    "ctr": tree_params_from_jax,
    "fit_a_line": tree_params_from_jax,
    "word2vec": tree_params_from_jax,
    "mnist": tree_params_from_jax,
    "resnet": tree_params_from_jax,
}
