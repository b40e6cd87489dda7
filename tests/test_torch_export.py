"""Serving artifacts shared by both packages, on the CPU.

An artifact written by the JAX package's ``save_inference_model`` loads in
the port with every leaf equal bit for bit, bf16 included, and the port's
artifact loads in `edl_tpu.runtime.export.load_inference_model` with every
leaf equal bit for bit; both ways for every zoo model at test size. The
versioned ``LATEST`` layout, its garbage collection and the step-regression
guard behave the same on both sides, on one export root written in turns.

Tolerances: none for the leaves (bit for bit). A model served from the other
package's artifact predicts within fit_a_line's f32 tolerance of the module
that wrote it (rtol 1e-5, as `tests/test_torch_zoo.py`; measured: at most
1.2e-6, summation order).
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from edl_tpu import models as jax_models
from edl_tpu.runtime import export as jax_export
from edl_tpu.runtime.export import _serving_mesh
from edl_tpu_torch import models as torch_models
from edl_tpu_torch.models.convert import PARAMS_FROM_JAX, PARAMS_TO_JAX
from edl_tpu_torch.runtime import (PeriodicExporter, Trainer, TrainerConfig,
                                   artifact_version, load_inference_model,
                                   read_artifact, resolve_artifact_dir,
                                   save_inference_model)
from edl_tpu_torch.runtime.export import LATEST

#: zoo module -> make_model kwargs at test size (None: the default MODEL)
CONFIGS = {
    "fit_a_line": None,
    "word2vec": None,
    "mnist": None,
    "ctr": {"sparse_dim": 100},
    "resnet": {"depth": 18, "num_classes": 10, "image_size": 32, "width": 8,
               "gn_groups": 4},
    "transformer": dict(vocab_size=61, d_model=16, n_layers=2, n_heads=2,
                        d_ff=32, seq_len=64, flash=False),
}


def _bits(a) -> np.ndarray:
    """A leaf's bytes as unsigned ints of its width: equal bits, equal
    arrays, whatever the dtype."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32, 8: np.uint64, 1: np.uint8}[a.itemsize])


def _dtype(a) -> str:
    return str(a.dtype).replace("torch.", "")


def _jax_params(name, bf16=False):
    model = jax_models.resolve(name, CONFIGS[name])
    params = model.init(jax.random.PRNGKey(1), _serving_mesh(model))
    if bf16:
        params = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), params)
    return params


def _port_module(name, bf16=False):
    module = torch_models.resolve(name, CONFIGS[name]).build(
        device="cpu", generator=torch.Generator().manual_seed(1))
    return module.to(torch.bfloat16) if bf16 else module


CASES = [(name, False) for name in CONFIGS] + [("fit_a_line", True), ("transformer", True)]
IDS = [f"{n}-{'bf16' if b else 'f32'}" for n, b in CASES]


@pytest.mark.parametrize("name,bf16", CASES, ids=IDS)
def test_jax_artifact_loads_in_the_port_bit_for_bit(name, bf16, tmp_path):
    params = _jax_params(name, bf16)
    jax_export.save_inference_model(str(tmp_path), name, params,
                                    config=CONFIGS[name], step=3)
    manifest, tree = read_artifact(str(tmp_path))
    assert manifest["model"] == name and manifest["step"] == 3
    want = jax.tree_util.tree_leaves_with_path(jax.device_get(params))
    got = jax.tree_util.tree_leaves_with_path(tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert _dtype(g) == str(w.dtype) and tuple(g.shape) == w.shape, path
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=str(path))
    art = load_inference_model(str(tmp_path), device="cpu")
    state = art.module.state_dict()
    expect = PARAMS_FROM_JAX[name](tree)
    assert state.keys() == expect.keys()
    assert all(torch.equal(state[k], expect[k]) for k in expect)


@pytest.mark.parametrize("name,bf16", CASES, ids=IDS)
def test_port_artifact_loads_in_the_jax_package_bit_for_bit(name, bf16, tmp_path):
    module = _port_module(name, bf16)
    save_inference_model(str(tmp_path), name, module, config=CONFIGS[name], step=5)
    art = jax_export.load_inference_model(str(tmp_path), mesh=_serving_mesh(
        jax_models.resolve(name, CONFIGS[name])))
    assert art.step == 5
    want = jax.tree_util.tree_leaves_with_path(PARAMS_TO_JAX[name](module.state_dict()))
    got = jax.tree_util.tree_leaves_with_path(jax.device_get(art.params))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert str(g.dtype) == _dtype(w) and g.shape == tuple(w.shape), path
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=str(path))
    if bf16:
        assert all(g.dtype == ml_dtypes.bfloat16 for _, g in got)


def test_predictions_carry_across_both_ways(tmp_path):
    jm = jax_models.resolve("fit_a_line")
    mesh = _serving_mesh(jm)
    batch = jm.synthetic_batch(np.random.default_rng(0), 16)
    module = _port_module("fit_a_line")
    save_inference_model(str(tmp_path / "port"), "fit_a_line", module, step=1)
    served = np.asarray(jax_export.load_inference_model(
        str(tmp_path / "port"), mesh=mesh).predict({"x": batch["x"]}))
    with torch.no_grad():
        direct = module.predict({"x": torch.from_numpy(batch["x"])}).numpy()
    np.testing.assert_allclose(served, direct, rtol=1e-5)

    params = _jax_params("fit_a_line")
    jax_export.save_inference_model(str(tmp_path / "jax"), "fit_a_line", params, step=1)
    served = load_inference_model(str(tmp_path / "jax"), device="cpu").predict(
        {"x": batch["x"]}).numpy()
    np.testing.assert_allclose(served, np.asarray(jm.predict(params, batch, mesh)),
                               rtol=1e-5)


# -- the layout, written in turns by both packages ----------------------------


def _versions(d):
    return sorted(p for p in os.listdir(d)
                  if p.startswith("v") and os.path.isdir(os.path.join(d, p)))


def test_versioned_layout_gc_and_regression_guard_match_the_jax_package(tmp_path):
    d = str(tmp_path / "vroot")
    module, params = _port_module("fit_a_line"), _jax_params("fit_a_line")
    save_inference_model(d, "fit_a_line", module, step=100, versioned=True)
    assert open(os.path.join(d, LATEST)).read() == "v0000000100"
    for side in (artifact_version, jax_export.artifact_version):
        assert side(d) == (100, "params-100.npz", "v0000000100")
    assert resolve_artifact_dir(d) == jax_export.resolve_artifact_dir(d)
    jax_export.save_inference_model(d, "fit_a_line", params, step=200, versioned=True)
    assert artifact_version(d)[0] == 200
    assert load_inference_model(d, device="cpu").step == 200
    # a replayed step regresses neither side's LATEST
    save_inference_model(d, "fit_a_line", module, step=150, versioned=True)
    jax_export.save_inference_model(d, "fit_a_line", params, step=150, versioned=True)
    assert artifact_version(d)[0] == jax_export.artifact_version(d)[0] == 200
    # LATEST's target + the generation it replaced survive the GC
    save_inference_model(d, "fit_a_line", module, step=300, versioned=True)
    assert _versions(d) == ["v0000000200", "v0000000300"]
    jax_export.save_inference_model(d, "fit_a_line", params, step=400, versioned=True)
    assert _versions(d) == ["v0000000300", "v0000000400"]
    assert jax_export.load_inference_model(d).step == 400


def test_flat_layout_guard_and_grace_generation(tmp_path):
    d = str(tmp_path / "flat")
    module = _port_module("fit_a_line")
    save_inference_model(d, "fit_a_line", module, step=10)
    save_inference_model(d, "fit_a_line", module, step=20)
    save_inference_model(d, "fit_a_line", module, step=15)  # replayed: ignored
    manifest = json.load(open(os.path.join(d, "manifest.json")))
    assert manifest["step"] == 20 and manifest["format"] == 1
    assert sorted(p for p in os.listdir(d) if p.endswith(".npz")) == [
        "params-10.npz", "params-20.npz"]
    save_inference_model(d, "fit_a_line", module, step=30)
    assert sorted(p for p in os.listdir(d) if p.endswith(".npz")) == [
        "params-20.npz", "params-30.npz"]
    jax_export.save_inference_model(d, "fit_a_line", _jax_params("fit_a_line"), step=25)
    assert artifact_version(d)[0] == 30  # the JAX side's guard reads the port's


def test_crash_mid_export_is_never_visible_and_is_swept_once_aged(tmp_path):
    d = str(tmp_path / "vcrash")
    module = _port_module("fit_a_line")
    save_inference_model(d, "fit_a_line", module, step=100, versioned=True)
    orphan = os.path.join(d, "v0000000150")
    os.makedirs(orphan)
    with open(os.path.join(orphan, "params-150.npz"), "wb") as f:
        f.write(b"torn")
    assert artifact_version(d) == (100, "params-100.npz", "v0000000100")
    save_inference_model(d, "fit_a_line", module, step=200, versioned=True)
    assert os.path.isdir(orphan)  # recent: could be a slow live writer
    old = time.time() - 3600
    os.utime(orphan, (old, old))
    save_inference_model(d, "fit_a_line", module, step=300, versioned=True)
    assert not os.path.exists(orphan)


def test_periodic_exporter_interval_high_water_and_background_write(tmp_path):
    trainer = Trainer(torch_models.resolve("fit_a_line"), device="cpu",
                      config=TrainerConfig(optimizer="sgd", learning_rate=0.1))
    state = trainer.init_state()
    batch = trainer.place_batch(trainer.model.synthetic_batch(np.random.default_rng(0), 8))
    d = str(tmp_path / "exp")
    exporter = PeriodicExporter(d, "fit_a_line", interval=2, versioned=True)
    snapshots = {}
    for step in (1, 2, 2, 3, 4, 3):  # a duplicate and a replayed step
        exporter(step, state)
        if step % 2 == 0 and step not in snapshots:
            snapshots[step] = {k: v.clone() for k, v in state.params.state_dict().items()}
        state, _ = trainer.train_step(state, batch)  # moves the params in place
    exporter.close()
    assert exporter.exports == 2
    assert artifact_version(d)[0] == 4
    art = load_inference_model(d, device="cpu")
    # the export holds the params of its step, not of the later steps
    assert all(torch.equal(v, snapshots[4][k]) for k, v in art.module.state_dict().items())
