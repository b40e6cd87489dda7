"""Carry weights across, both ways: a JAX checkpoint of a zoo model as the
port's state_dict, and the port's state_dict as the JAX package's tree.

Each ``*_from_jax`` function takes one model's JAX params as nested dicts
and lists of numpy arrays (``jax.device_get(params)``) or CPU tensors and
returns the state_dict of that model's module; `PARAMS_FROM_JAX` names the
function for each zoo module. Each ``*_to_jax`` function is its inverse,
keyed alike in `PARAMS_TO_JAX`: a state_dict becomes the JAX package's
nested dicts and lists of CPU tensors of their own, in the params' dtypes. Together they
make a serving artifact written by either package load in the other
(`runtime/export.py`). They need no JAX.

- The transformer (`params_from_jax`): the JAX package stacks every block
  param on a leading layer dim, ``blocks.wqkv`` (L, D, 3, H, Dh) and so on;
  the port keeps one module per layer, so the stack is split into
  ``blocks.{i}.{name}`` with the per-layer shapes unchanged.
- The other five (`tree_params_from_jax`): a dict key becomes a name, a list
  index a numbered submodule (CTR's ``mlp``, ResNet's ``blocks``), and
  tables, padded rows included, carry across whole. A 4-D leaf is a conv
  weight, HWIO in the JAX package and OIHW in the port.

The reverse re-stacks the transformer's ``blocks.{i}.*`` to (L, ...), turns
numbered submodules back into lists and OIHW back into HWIO.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Mapping

import numpy as np
import torch

#: per-layer block params of the dense transformer, in module order
BLOCK_PARAMS = ("ln1", "wqkv", "bqkv", "wo", "bo", "ln2", "win", "bin", "wout", "bout")


def _tensor(a) -> torch.Tensor:
    """An f32 tensor of its own from a numpy array or a tensor (a bf16 leaf
    widens exactly)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32, copy=True)
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
            out[f"blocks.{i}.{name}"] = _tensor(blocks[name][i])
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
            t = _tensor(node)
            out[prefix] = t.permute(3, 2, 0, 1).contiguous() if t.ndim == 4 else t
            return
        for key, child in items:
            walk(child, f"{prefix}.{key}" if prefix else str(key))

    walk(tree, "")
    return out


def _host(t: torch.Tensor) -> torch.Tensor:
    """A CPU copy of its own: a later in-place update of the param does not
    reach it."""
    return t.detach().to("cpu", copy=True)


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The transformer's state_dict -> JAX params {embed, pos, blocks: {name:
    (L, ...)}, lnf, head}: the inverse of `params_from_jax`."""
    n_layers = sum(1 for k in state_dict if k.startswith("blocks.") and k.endswith(".ln1"))
    return {
        "embed": _host(state_dict["embed"]),
        "pos": _host(state_dict["pos"]),
        "blocks": {name: _host(torch.stack([state_dict[f"blocks.{i}.{name}"].detach()
                                            for i in range(n_layers)]))
                   for name in BLOCK_PARAMS},
        "lnf": _host(state_dict["lnf"]),
        "head": _host(state_dict["head"]),
    }


def tree_params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Any:
    """A state_dict of ctr, fit_a_line, word2vec, mnist or resnet -> the JAX
    package's nested tree: ``mlp.0.w`` becomes ``{"mlp": [{"w": t}]}``;
    OIHW conv weights become HWIO. The inverse of `tree_params_from_jax`."""
    root: dict = {}
    for key, t in state_dict.items():
        *parents, leaf = key.split(".")
        node = root
        for part in parents:
            node = node.setdefault(part, {})
        t = _host(t)
        node[leaf] = t.permute(2, 3, 1, 0).contiguous() if t.ndim == 4 else t

    def lists(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


#: zoo module name -> its params-from-JAX function
PARAMS_FROM_JAX = {
    "transformer": params_from_jax,
    "ctr": tree_params_from_jax,
    "fit_a_line": tree_params_from_jax,
    "word2vec": tree_params_from_jax,
    "mnist": tree_params_from_jax,
    "resnet": tree_params_from_jax,
}

#: zoo module name -> its params-to-JAX function, the inverse of
#: `PARAMS_FROM_JAX`'s
PARAMS_TO_JAX = {
    "transformer": params_to_jax,
    "ctr": tree_params_to_jax,
    "fit_a_line": tree_params_to_jax,
    "word2vec": tree_params_to_jax,
    "mnist": tree_params_to_jax,
    "resnet": tree_params_to_jax,
}
