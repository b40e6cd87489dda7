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
  ``blocks.{i}.{name}`` with the per-layer shapes unchanged. A block has
  the dense FFN's leaves (`BLOCK_PARAMS`) or the mixture of experts'
  (`MOE_BLOCK_PARAMS`), as the keys present say.
- The other five (`tree_params_from_jax`): a dict key becomes a name, a list
  index a numbered submodule (CTR's ``mlp``, ResNet's ``blocks``), and
  tables, padded rows included, carry across whole. A 4-D leaf is a conv
  weight, HWIO in the JAX package and OIHW in the port.

The reverse re-stacks the transformer's ``blocks.{i}.*`` to (L, ...), turns
numbered submodules back into lists and OIHW back into HWIO.

A JAX checkpoint of the interleaved pipeline stores its stacked block rows
in the chunk-major order of `parallel.pipeline.interleaved_layout`: pass
that permutation as ``layout`` and row ``p`` becomes ``blocks.{perm[p]}``
(the port names blocks by their logical layer), and back.

On a mesh of ranks (`parallel.mesh.Mesh`) a param that the model's
``param_spec`` shards (`models.base.normalize_spec`) is held in parts:
`shard_state_dict` cuts a full state_dict (from JAX params, numpy, or a
checkpoint) to this rank's part, each split dim to the rank's slice
``[r*L, (r+1)*L)`` (``r`` its index on the axis) and a param held whole by
another index of an axis (a pipeline stage's layers) left out; and
`gather_state_dict` puts every rank's parts back together (a collective).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Mapping

import numpy as np
import torch

#: per-layer block params of the dense transformer, in module order
BLOCK_PARAMS = ("ln1", "wqkv", "bqkv", "wo", "bo", "ln2", "win", "bin", "wout", "bout")
#: per-layer block params of the mixture-of-experts transformer, in module order
MOE_BLOCK_PARAMS = ("ln1", "wqkv", "bqkv", "wo", "bo", "ln2", "router", "w_up", "b_up",
                    "w_down", "b_down")


def block_params(names) -> tuple:
    """The block param set, dense or MoE, that ``names`` (a block's leaf
    names) hold whole. Both sets whole, or neither, raises ``KeyError``."""
    names = set(names)
    whole = [want for want in (BLOCK_PARAMS, MOE_BLOCK_PARAMS) if names >= set(want)]
    if len(whole) != 1:
        raise KeyError(f"block params {sorted(names)} must hold exactly one of the "
                       f"dense set {list(BLOCK_PARAMS)} and the MoE set "
                       f"{list(MOE_BLOCK_PARAMS)}")
    return whole[0]


def _tensor(a) -> torch.Tensor:
    """An f32 tensor of its own from a numpy array or a tensor (a bf16 leaf
    widens exactly)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32, copy=True)
    return torch.from_numpy(np.array(a, dtype=np.float32))


def params_from_jax(tree: Mapping, layout=None) -> "OrderedDict[str, torch.Tensor]":
    """JAX params {embed, pos, blocks: {name: (L, ...)}, lnf, head} ->
    state_dict, blocks in logical layer order. ``layout``: the storage
    permutation of the stacked rows (row p is logical layer ``layout[p]``;
    None: the identity)."""
    blocks = tree["blocks"]
    names = block_params(blocks)
    n_layers = {np.shape(blocks[name])[0] for name in names}
    if len(n_layers) != 1:
        raise ValueError(f"block params disagree on the layer count: {n_layers}")
    n = n_layers.pop()
    row = np.arange(n) if layout is None else np.argsort(np.asarray(layout))

    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    out["embed"] = _tensor(tree["embed"])
    out["pos"] = _tensor(tree["pos"])
    for i in range(n):
        for name in names:
            out[f"blocks.{i}.{name}"] = _tensor(blocks[name][int(row[i])])
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


def params_to_jax(state_dict: Mapping[str, torch.Tensor], layout=None) -> dict:
    """The transformer's state_dict -> JAX params {embed, pos, blocks: {name:
    (L, ...)}, lnf, head}: the inverse of `params_from_jax` (stacked rows in
    the storage order ``layout``, None: logical order)."""
    n_layers = sum(1 for k in state_dict if k.startswith("blocks.") and k.endswith(".ln1"))
    names = block_params(k.split(".", 2)[2] for k in state_dict if k.startswith("blocks.0."))
    order = range(n_layers) if layout is None else [int(i) for i in layout]
    return {
        "embed": _host(state_dict["embed"]),
        "pos": _host(state_dict["pos"]),
        "blocks": {name: _host(torch.stack([state_dict[f"blocks.{i}.{name}"].detach()
                                            for i in order]))
                   for name in names},
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


def _held_elsewhere(shards, mesh) -> bool:
    """Whether a param with these shards is held whole by another index of
    one of their axes (and so not by this rank)."""
    return any(sh.dim is None and mesh.axis_size(sh.axis) > 1
               and sh.index != mesh.axis_index(sh.axis) for sh in shards)


def _cut(t: torch.Tensor, shards, mesh, name: str) -> torch.Tensor:
    """This rank's slice of ``t`` on each split dim of ``shards``."""
    for sh in shards:
        n = mesh.axis_size(sh.axis) if sh.dim is not None else 1
        if n > 1:
            size = t.shape[sh.dim]
            if size % n:
                raise ValueError(f"{name}: dim {sh.dim} of size {size} does not split "
                                 f"over {n} {sh.axis!r} shards")
            t = t.narrow(sh.dim, mesh.axis_index(sh.axis) * (size // n), size // n)
    return t


def shard_state_dict(state_dict: Mapping[str, Any], spec: Mapping[str, Any], mesh
                     ) -> "OrderedDict[str, torch.Tensor]":
    """A full state_dict (tensors or numpy arrays) cut to this rank's part
    on ``mesh``: each param in ``spec`` (a model's ``param_spec``, see
    `models.base.normalize_spec`) keeps its slice of every split dim, and a
    param held whole by another index of an axis is left out; the others
    stay whole. Tensors of their own."""
    from edl_tpu_torch.models.base import normalize_spec

    spec = normalize_spec(spec)
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for name, v in state_dict.items():
        t = v.detach() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        shards = spec.get(name, ())
        if mesh is not None and shards:
            if _held_elsewhere(shards, mesh):
                continue
            t = _cut(t, shards, mesh, name)
        out[name] = t.to("cpu", copy=True)
    return out


def _gather_held(local: "OrderedDict[str, torch.Tensor]", held: Mapping[str, str],
                 mesh) -> "OrderedDict[str, torch.Tensor]":
    """The params held whole by one index of an axis (``held``: {name:
    axis}), from every index of it: each index's names and shapes go round
    as objects, then each tensor from its holder by broadcast (on the host
    over gloo). Host tensors, in index order."""
    import torch.distributed as dist

    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for axis in dict.fromkeys(held.values()):
        group = mesh.group(axis)
        mine = [(n, tuple(local[n].shape), str(local[n].dtype))
                for n, a in held.items() if a == axis]
        if group is None:
            for n, _, _ in mine:
                out[n] = local[n].to("cpu", copy=True)
            continue
        lists = [None] * dist.get_world_size(group)
        dist.all_gather_object(lists, mine, group=group)
        gloo = dist.get_backend(group) == "gloo"
        device = next(iter(local.values())).device if local else torch.device("cpu")
        me = mesh.axis_index(axis)
        for i, names in enumerate(lists):
            src = mesh.neighbor(axis, i - me, wrap=False)
            for n, shape, dtype in names:
                if i == me:
                    t = local[n].detach().contiguous()
                    t = t.cpu() if gloo else t
                else:
                    t = torch.empty(shape, dtype=getattr(torch, dtype.split(".")[-1]),
                                    device="cpu" if gloo else device)
                dist.broadcast(t, src=src, group=group)
                out[n] = t.to("cpu", copy=True)
    return out


def gather_state_dict(state_dict: Mapping[str, torch.Tensor], spec: Mapping[str, Any],
                      mesh) -> "OrderedDict[str, torch.Tensor]":
    """Every rank's parts of the params in ``spec`` put back together: each
    split dim gathered in rank order on its axis, then the params held
    whole by one index of an axis collected from every index; the others
    as they are. A collective: every rank of ``mesh`` must call it, with
    the same names up to the held ones. Returns full host tensors of their
    own (``.numpy()`` gives the JAX package's arrays) on every rank: the
    replicated and split params first, in ``state_dict``'s order, then the
    held ones, in index order."""
    from edl_tpu_torch.models.base import normalize_spec
    from edl_tpu_torch.parallel.collective import gather_dim

    spec = normalize_spec(spec)
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    held: "OrderedDict[str, str]" = OrderedDict()
    whole: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for name, t in state_dict.items():
        t = t.detach()
        for sh in spec.get(name, ()):
            if mesh is None:
                break
            if sh.dim is None:
                held[name] = sh.axis
                continue
            group = mesh.group(sh.axis)
            if group is not None and mesh.axis_size(sh.axis) > 1:
                t = gather_dim(t.contiguous(), group, sh.dim)
        if name in held:
            whole[name] = t
        else:
            out[name] = t.to("cpu", copy=True)
    if held:
        out.update(_gather_held(whole, held, mesh))
    return out
