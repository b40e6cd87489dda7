"""Inference-model export: the port of `edl_tpu.runtime.export`.

Same on-disk format as the JAX package's, so an artifact written by either
package loads in the other. The artifact is **(model reference + config +
params)**: the loader rebuilds the module from the zoo
(`edl_tpu_torch.models.resolve`, which takes the same module names and
``make_model`` kwargs as the JAX zoo) and loads the weights onto the device
that serves them.

Artifact layout (one directory):

- ``manifest.json`` — format version, model module ref + config kwargs,
  step, the weights filename, and the flattened leaf index (tree paths +
  logical dtypes);
- ``params-<step>.npz`` — leaves keyed ``leaf_00000...``, in manifest
  order. The leaves are the JAX package's params tree (`models.convert`'s
  ``PARAMS_TO_JAX``), dict keys sorted as JAX flattens them. bfloat16
  travels as uint16 bit patterns with the logical dtype recorded in the
  manifest; it is encoded and decoded bit for bit through ``torch.int16``
  views, with no ``ml_dtypes``.

Concurrent-reader safety (the pattern is infer-while-train): weights files
are step-unique and published before the manifest, and the manifest is
renamed into place atomically — a poller that reads a manifest always finds
exactly the weights it names (the previous artifact's weights are kept one
generation as grace for a reader holding an older manifest). The versioned
layout puts each export in a ``v<step>`` directory and advances an atomic
``LATEST`` pointer only once the directory is complete.

On a mesh of ranks (``mesh=``) the export is rank-collective, as the JAX
package's ``_gather_host`` is: every rank reaches the gather at the same
step, the row-sharded tables (the model's ``param_spec``) are put back
together whole, and rank 0 writes. So a CTR trained at world 2 exports
the same file layout as one trained on one device, and
``load_inference_model`` of either package reads it.

**Layer order: logical, by choice.** The port names a transformer's blocks
by logical layer on every mesh (``blocks.i`` is layer i, whichever pipeline
stage holds it), so its artifact stacks the layers in logical order under
every schedule: it serves, in either package, the model that was trained.
The JAX package writes its params as it stores them, and under
``1f1b-interleaved`` with ``virtual_stages > 1`` on a pipe axis above 1 it
stores the layers chunk-major (storage row p is logical layer
``interleaved_layout(L, pipe, v)[p]``, `edl_tpu.models.transformer`); the
manifest does not record ``pipe``, so no loader can undo that from the
artifact alone. Such a JAX artifact therefore loads in the port (as in the
JAX package's own loader) with its layers in that storage order. The JAX
package leaves the re-permutation to the caller, and so does the port.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from edl_tpu_torch.device import DeviceLike, resolve_device
from edl_tpu_torch.models.convert import (PARAMS_FROM_JAX, PARAMS_TO_JAX,
                                          tree_params_from_jax,
                                          tree_params_to_jax)

__all__ = ["save_inference_model", "load_inference_model", "read_artifact",
           "InferenceModel", "PeriodicExporter", "artifact_version",
           "resolve_artifact_dir", "LATEST"]

MANIFEST = "manifest.json"
#: atomic pointer file in a versioned export root naming the newest
#: complete version directory — the serving tier's swap watcher reads this
LATEST = "LATEST"
_VERSION_PREFIX = "v"
_FORMAT = 1
#: orphaned .tmp files and incomplete version directories older than this
#: are swept during the GC pass
_TMP_SWEEP_AGE_SEC = 300.0

#: logical dtype name <-> torch dtype, for the dtypes a params leaf can have
_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


# -- the params tree: flatten, encode, rebuild ---------------------------------


def _flatten(tree: Any, path: Tuple = ()) -> List[Tuple[list, torch.Tensor]]:
    """(encoded path, leaf) pairs in JAX's flattening order: dict keys
    sorted, list items in order."""
    if isinstance(tree, Mapping):
        out = []
        for key in sorted(tree):
            out += _flatten(tree[key], path + (["d", key],))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, child in enumerate(tree):
            out += _flatten(child, path + (["s", i],))
        return out
    return [(list(path), tree)]


def _encode(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(numpy container, logical dtype name); bf16 as its uint16 bits."""
    t = t.detach().cpu().contiguous()
    logical = _DTYPE_NAMES.get(t.dtype)
    if logical is None:
        raise TypeError(f"leaf dtype {t.dtype} has no wire representation; "
                        f"supported: {sorted(_DTYPES)}")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), logical
    return t.numpy(), logical


def _decode(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    if logical not in _DTYPES:
        raise TypeError(f"artifact leaf dtype {logical!r} is not supported")
    return torch.from_numpy(np.ascontiguousarray(arr))


def _rebuild(paths_and_leaves) -> Any:
    """Nested dicts/lists from (encoded path, leaf) pairs: the JAX package's
    nesting, dicts and lists included."""
    if not paths_and_leaves:
        return {}
    root: Any = {} if paths_and_leaves[0][0][0][0] == "d" else []

    def ensure(container, key, kind):
        template: Any = {} if kind == "d" else []
        if isinstance(container, dict):
            return container.setdefault(key, template)
        while len(container) <= key:
            container.append(None)
        if container[key] is None:
            container[key] = template
        return container[key]

    for path, leaf in paths_and_leaves:
        node = root
        for (kind, key), nxt in zip(path[:-1], path[1:]):
            node = ensure(node, key, nxt[0])
        kind, key = path[-1]
        if isinstance(node, dict):
            node[key] = leaf
        else:
            while len(node) <= key:
                node.append(None)
            node[key] = leaf
    return root


def _state_dict(source: Any) -> Dict[str, torch.Tensor]:
    """A module, a `TrainState` (its ``params`` is the module) or a
    state_dict, as a state_dict."""
    if isinstance(source, Mapping):
        return dict(source)
    module = getattr(source, "params", source)
    if not isinstance(module, nn.Module):
        raise TypeError(f"expected a module, a TrainState or a state_dict, got "
                        f"{type(source).__name__}")
    return module.state_dict()


def _host_tree(model_ref: str, source: Any, config: Optional[Dict[str, Any]] = None,
               mesh=None) -> Any:
    """The JAX package's params tree of ``source``, as CPU tensors of their
    own (a later in-place update of the params does not reach them). On a
    ``mesh`` the sharded params are gathered whole first: a collective,
    which every rank must reach."""
    to_jax = PARAMS_TO_JAX.get(model_ref, tree_params_to_jax)
    state_dict = _state_dict(source)
    if mesh is not None and mesh.distributed:
        from edl_tpu_torch import models as zoo
        from edl_tpu_torch.models.convert import gather_state_dict

        model = zoo.resolve(model_ref, config or None)
        spec = model.param_spec(mesh) if model.param_spec is not None else {}
        state_dict = gather_state_dict(state_dict, spec, mesh)
    return to_jax(state_dict)


# -- writing -------------------------------------------------------------------


def _write_artifact(directory, model_ref, tree, config, step) -> None:
    os.makedirs(directory, exist_ok=True)
    # Never regress a published artifact: a warm restart replays the steps
    # between the restored checkpoint and the crash, which would otherwise
    # overwrite a newer manifest with older weights.
    try:
        with open(os.path.join(directory, MANIFEST)) as f:
            prev_manifest = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        prev_manifest = {}
    if step is not None:
        published = prev_manifest.get("step")
        if published is not None and published >= step:
            return
    arrays: Dict[str, np.ndarray] = {}
    leaves = []
    for i, (path, t) in enumerate(_flatten(tree)):
        arr, logical = _encode(t)
        arrays[f"leaf_{i:05d}"] = arr
        leaves.append({"path": path, "dtype": logical})
    # Unique weights name published BEFORE the manifest that names it: a
    # reader pairing manifest -> weights can never mix two exports.
    weights_name = (f"params-{step}.npz" if step is not None
                    else f"params-final-{uuid.uuid4().hex[:8]}.npz")
    manifest = {
        "format": _FORMAT,
        "model": model_ref,
        "config": config or {},
        "step": step,
        "weights": weights_name,
        "leaves": leaves,
    }
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, os.path.join(directory, weights_name))
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".json.tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(directory, MANIFEST))
    # GC superseded weights. The grace generation is EXACTLY the file the
    # just-replaced manifest named; everything else is unreachable.
    spare = {weights_name, prev_manifest.get("weights")}
    for stale in os.listdir(directory):
        if (stale.startswith("params-") and stale.endswith(".npz")
                and stale not in spare):
            os.unlink(os.path.join(directory, stale))
    # Sweep orphaned mkstemp leftovers (a writer that died between mkstemp
    # and os.replace); age-gated so a concurrent writer's live tmp survives.
    now = time.time()
    for p in os.listdir(directory):
        if p.endswith((".npz.tmp", ".json.tmp")):
            full = os.path.join(directory, p)
            try:
                if now - os.path.getmtime(full) > _TMP_SWEEP_AGE_SEC:
                    os.unlink(full)
            except OSError:
                pass  # already gone or being replaced


def _read_latest(directory: str) -> Optional[str]:
    try:
        with open(os.path.join(directory, LATEST)) as f:
            name = f.read().strip()
    except OSError:
        return None
    return name or None


def resolve_artifact_dir(directory: str) -> str:
    """Follow a versioned root's ``LATEST`` pointer to the version directory
    it names; a flat (unversioned) artifact directory resolves to itself."""
    name = _read_latest(directory)
    if name:
        candidate = os.path.join(directory, name)
        if os.path.isdir(candidate):
            return candidate
    return directory


def artifact_version(directory: str) -> Optional[Tuple]:
    """Published-artifact identity ``(step, weights_name, dir_name)`` or
    ``None`` when nothing complete is published: what the serving tier's
    swap watcher polls. LATEST is replaced atomically only after a version
    directory is complete, so the identity never names a half-written
    export."""
    resolved = resolve_artifact_dir(directory)
    try:
        with open(os.path.join(resolved, MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return (manifest.get("step"), manifest.get("weights"),
            os.path.basename(resolved))


def _version_step(name: str) -> Optional[int]:
    try:
        return int(name[len(_VERSION_PREFIX):])
    except (ValueError, TypeError):
        return None  # step-less "vfinal-<uuid>" dirs are unordered


def _write_versioned(directory, model_ref, tree, config, step) -> None:
    """One complete artifact per ``v<step>`` subdirectory, published by
    atomically replacing the ``LATEST`` pointer AFTER the directory is
    complete. A writer that crashes mid-export leaves an orphan directory
    LATEST never pointed at; it is swept (age-gated) on a later export."""
    os.makedirs(directory, exist_ok=True)
    prev = _read_latest(directory)
    prev_step = _version_step(prev) if prev else None
    if step is not None and prev_step is not None and prev_step >= step:
        return  # same high-water regression guard as the flat layout
    vname = (f"{_VERSION_PREFIX}{int(step):010d}" if step is not None  # lexical == numeric
             else f"{_VERSION_PREFIX}final-{uuid.uuid4().hex[:8]}")
    _write_artifact(os.path.join(directory, vname), model_ref, tree, config, step)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".latest.tmp")
    with os.fdopen(fd, "w") as f:
        f.write(vname)
    os.replace(tmp, os.path.join(directory, LATEST))
    # GC: keep the generation LATEST names plus the one it just replaced;
    # every other COMPLETE version is unreachable and goes. Incomplete
    # orphans are swept only once aged, so a slow concurrent writer's live
    # directory survives.
    spare = {vname, prev}
    now = time.time()
    for name in os.listdir(directory):
        full = os.path.join(directory, name)
        if (name in spare or not name.startswith(_VERSION_PREFIX)
                or not os.path.isdir(full)):
            continue
        complete = os.path.exists(os.path.join(full, MANIFEST))
        try:
            aged = now - os.path.getmtime(full) > _TMP_SWEEP_AGE_SEC
        except OSError:
            continue  # raced with another sweep
        if complete or aged:
            shutil.rmtree(full, ignore_errors=True)
    for name in os.listdir(directory):
        if name.endswith(".latest.tmp"):
            full = os.path.join(directory, name)
            try:
                if now - os.path.getmtime(full) > _TMP_SWEEP_AGE_SEC:
                    os.unlink(full)
            except OSError:
                pass  # already gone or being replaced


def save_inference_model(
    directory: str,
    model_ref: str,
    params: Any,
    config: Optional[Dict[str, Any]] = None,
    step: Optional[int] = None,
    versioned: bool = False,
    mesh=None,
) -> None:
    """Write the serving artifact of ``params`` (a module, a `TrainState`
    or a state_dict) of zoo model ``model_ref``. On a ``mesh`` every rank
    calls it with its own params: they are gathered, and rank 0 writes.

    ``model_ref`` is the zoo module name (``"ctr"``, ``"transformer"``,
    ...); ``config`` the ``make_model`` kwargs that built the trained
    variant (omit for the module's default ``MODEL``). ``versioned=True``
    writes each export to its own ``v<step>`` subdirectory and atomically
    advances the ``LATEST`` pointer (the layout the serving tier's swap
    watcher needs)."""
    tree = _host_tree(model_ref, params, config, mesh)
    if mesh is None or mesh.rank == 0:
        writer = _write_versioned if versioned else _write_artifact
        writer(directory, model_ref, tree, config, step)


# -- reading -------------------------------------------------------------------


def read_artifact(directory: str) -> Tuple[Dict[str, Any], Any]:
    """(manifest, params tree) of the artifact at ``directory`` (a versioned
    root follows ``LATEST``): the JAX package's nested tree of CPU tensors
    in the leaves' logical dtypes, bf16 bit for bit."""
    directory = resolve_artifact_dir(directory)
    with open(os.path.join(directory, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != _FORMAT:
        raise ValueError(f"unknown artifact format {manifest.get('format')!r}")
    with np.load(os.path.join(directory, manifest["weights"])) as npz:
        pairs = [(tuple(map(tuple, entry["path"])),
                  _decode(npz[f"leaf_{i:05d}"], entry["dtype"]))
                 for i, entry in enumerate(manifest["leaves"])]
    return manifest, _rebuild(pairs)


@dataclass
class InferenceModel:
    """A loaded serving artifact: the rebuilt zoo model and its module on
    ``device``."""

    model: Any
    module: nn.Module
    device: torch.device
    step: Optional[int]
    config: Dict[str, Any] = field(default_factory=dict)

    def predict(self, batch: Mapping[str, Any]):
        """The zoo model's ``predict`` on ``batch`` (numpy arrays or
        tensors), placed on the module's device; no gradients are kept."""
        if self.model.predict is None:
            raise NotImplementedError(
                f"model {self.model.name!r} defines no predict entrypoint")
        placed = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        with torch.no_grad():
            return self.model.predict(self.module, placed)


def load_inference_model(directory: str, device: DeviceLike = None) -> InferenceModel:
    """Rebuild the zoo model and load its weights onto ``device`` (the CUDA
    device by default; pass ``device="cpu"`` to serve on the CPU).

    The module is built from the manifest's model ref and config, then takes
    the artifact's params: a bf16 leaf widens exactly into its f32 param."""
    from edl_tpu_torch import models as zoo

    device = resolve_device(device)
    manifest, tree = read_artifact(directory)
    ref = manifest["model"]
    model = zoo.resolve(ref, manifest.get("config") or None)
    module = model.build(device=device, generator=torch.Generator().manual_seed(0))
    from_jax = PARAMS_FROM_JAX.get(ref, tree_params_from_jax)
    module.load_state_dict(from_jax(tree))
    module.eval()
    return InferenceModel(model=model, module=module, device=device,
                          step=manifest.get("step"),
                          config=manifest.get("config") or {})


class PeriodicExporter:
    """Periodic serving export: ``save_inference_model`` every ``interval``
    steps. Called as ``exporter(step, trainer_or_state)``; it reads the
    module's state_dict at that step on the caller's thread (a copy on the
    host, so later steps cannot reach it) and writes the files on a
    background thread, so the step loop pays only the device-to-host copy.
    A new export first waits for the previous write — bounded, and it
    surfaces a failed write instead of losing it.

    On a ``mesh`` every rank calls it at every step, in lockstep: the
    gather is collective, so the interval and the high-water mark (the
    same on every rank) decide alone whether a step exports, and only rank
    0 writes."""

    def __init__(self, directory: str, model_ref: str, interval: int,
                 config: Optional[Dict[str, Any]] = None,
                 versioned: bool = False, mesh=None):
        self.directory = directory
        self.mesh = mesh
        self.model_ref = model_ref
        self.interval = max(1, int(interval))
        self.config = config
        #: versioned=True: each export lands in its own v<step> dir and the
        #: atomic LATEST pointer advances only once the dir is complete —
        #: required when a serving tier's swap watcher polls this directory.
        self.versioned = versioned
        self.exports = 0
        #: high-water mark, not last-seen: a post-restore replay re-visits
        #: old step numbers, and re-exporting them would hand a serving
        #: poller OLDER weights
        self._high_water = -1
        self._pool: Optional[ThreadPoolExecutor] = None
        self._inflight = None

    def __call__(self, step: int, state: Any) -> None:
        if step <= self._high_water or step % self.interval:
            return
        self._high_water = step
        # collective on every rank; discarded off the writer
        tree = _host_tree(self.model_ref, state, self.config, self.mesh)
        if self.mesh is not None and self.mesh.rank != 0:
            return
        self.wait()  # bounded; surfaces a failed previous write loudly
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="edl-export")
        writer = _write_versioned if self.versioned else _write_artifact
        self._inflight = self._pool.submit(writer, self.directory, self.model_ref,
                                           tree, self.config, step)
        self.exports += 1

    def wait(self) -> None:
        """Block until the in-flight write (if any) is durable; surfaces
        write errors (a background failure would otherwise be silent)."""
        if self._inflight is not None:
            self._inflight.result()

    def close(self) -> None:
        """Wait for the last write and stop the writer thread."""
        self.wait()
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
