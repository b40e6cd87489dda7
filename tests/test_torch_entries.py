"""The zoo's other entries of the port (`edl_tpu_torch/examples/`:
fit_a_line's ``train_local`` and ``train_elastic``, MNIST's and ResNet's
``train``, word2vec's ``train_ft``) against the JAX package's entries, in
local mode, on the CPU (the port asked for it with ``--device cpu``).

Each JAX entry runs in this process (`runpy`, as the JAX package's own
example tests run them as scripts), at the smallest sizes: ResNet-18 at
batch 8 and one batch a shard, MNIST 3 steps of 16. The printed JSON must
have the same keys, and the same step, world, pass and profiler counts.
The ``infer`` modes get the JAX entry's trained params carried across with
`models.convert` into a port checkpoint: the port's accuracy on the
held-out batch (seed 99) must be the JAX model's to within one example.
That comparison runs both sides in f32 (the JAX package's ``jnp.bfloat16``
and the port's ``COMPUTE_DTYPE``, as `test_torch_zoo.py` does): in bf16 the
two round the convolutions' inputs and outputs in different places, and
that alone flipped 2 of 512 near-tie MNIST predictions (0.4395 against
0.4355 after 3 steps)."""

import json
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.parallel import local_mesh as jax_local_mesh
from edl_tpu.runtime import Trainer as JaxTrainer, TrainerConfig as JaxConfig
from edl_tpu.runtime.checkpoint import Checkpointer as JaxCheckpointer
from edl_tpu.runtime.checkpoint import abstract_like, live_state_specs
from edl_tpu_torch.models.convert import tree_params_from_jax
from edl_tpu_torch.runtime import Checkpointer, Trainer, TrainerConfig
from edl_tpu_torch.runtime.train_loop import TrainState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lines(capsys) -> list:
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def _run_jax(entry, argv, monkeypatch, capsys) -> list:
    monkeypatch.setattr(sys, "argv", [entry, *argv])
    runpy.run_path(os.path.join(ROOT, "examples", entry))["main"]()
    return _lines(capsys)


def _run_port(module, argv, capsys) -> list:
    import importlib

    importlib.import_module(f"edl_tpu_torch.examples.{module}").main([*argv, "--device", "cpu"])
    return _lines(capsys)


@pytest.fixture
def local_mode(tmp_path, monkeypatch):
    """No coordinator endpoint (local mode); each package checkpoints under
    its own directory."""
    monkeypatch.delenv("EDL_COORDINATOR_ENDPOINT", raising=False)
    monkeypatch.delenv("EDL_CHECKPOINT_DIR", raising=False)

    def use(name):
        monkeypatch.setenv("EDL_CHECKPOINT_DIR", str(tmp_path / name))
        return str(tmp_path / name)

    return use


def test_fit_a_line_train_local_prints_the_jax_pass_lines(tmp_path, monkeypatch, capsys):
    """One line a pass with the JAX keys and step counts, and one
    checkpoint a pass."""
    argv = ["--passes", "3", "--steps-per-pass", "4", "--batch-size", "32"]
    want = _run_jax("fit_a_line/train_local.py",
                    [*argv, "--checkpoint-dir", str(tmp_path / "jax-ck")], monkeypatch, capsys)
    got = _run_port("fit_a_line.train_local",
                    [*argv, "--checkpoint-dir", str(tmp_path / "ck")], capsys)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert (g["pass"], g["steps"]) == (w["pass"], w["steps"])
        assert np.isfinite(g["final_loss"])
    assert got[-1]["final_loss"] < got[0]["final_loss"]
    assert Checkpointer(str(tmp_path / "ck")).all_steps() == [4, 8, 12]
    assert sorted(int(d) for d in os.listdir(tmp_path / "jax-ck") if d.isdigit()) == [4, 8, 12]


#: entry -> (JAX script, port module, batches a shard)
ELASTIC_ENTRIES = {
    "fit_a_line": ("fit_a_line/train_elastic.py", "fit_a_line.train_elastic", 20),
    "word2vec": ("word2vec/train_ft.py", "word2vec.train_ft", 10),
}


@pytest.mark.parametrize("name", sorted(ELASTIC_ENTRIES))
def test_the_elastic_entries_train_locally_as_the_jax_entries_do(name, local_mode,
                                                                monkeypatch, capsys):
    """The queue through an `ElasticWorker` at the entries' widths and
    batches (fit_a_line 20 batches of 256 a shard; word2vec 10 of 512 with
    a `StepProfiler`), over 2 shards named by ``EDL_DATA_SHARDS`` where the
    entries default to 8 (the JAX entries' collectives over the 8 virtual
    CPU devices crawl when the host is loaded): the JAX keys, steps, world,
    passes and rescales, and word2vec's steady profiled steps (a cold
    start's first step is warm-up) and its loss below uniform."""
    script, module, per = ELASTIC_ENTRIES[name]
    monkeypatch.setenv("EDL_DATA_SHARDS", json.dumps([f"{name}-00000", f"{name}-00001"]))
    local_mode("jax-ck")
    (want,) = _run_jax(script, [], monkeypatch, capsys)[-1:]
    local_mode("ck")
    (got,) = _run_port(module, [], capsys)[-1:]
    assert set(got) == set(want)
    for key in ("steps", "world", "passes_trained", "rescales"):
        assert got[key] == want[key], key
    assert got["steps"] == 2 * per
    assert np.isfinite(got["final_loss"])
    if name == "word2vec":
        assert got["profile_steady_steps"] == want["profile_steady_steps"] == 2 * per - 1
        assert got["final_loss"] < 7.7  # below uniform log(2074)


def _carry_across(model_dir, jax_model, accuracy, port_model, torch_dir, held_out):
    """The JAX entry's checkpoint restored as its ``infer`` restores it, its
    accuracy on the held-out batch (seed 99) as its ``infer`` computes it,
    jitted here (the entry runs it op by op, seconds longer for ResNet),
    and its params converted and saved as a port checkpoint at the same
    step. Returns (the step, the JAX accuracy)."""
    mesh = jax_local_mesh()
    trainer = JaxTrainer(jax_model, mesh, JaxConfig())
    fresh = trainer.init_state()
    state = JaxCheckpointer(model_dir).restore(abstract_like(fresh), mesh,
                                               live_state_specs(fresh))
    placed = trainer.place_batch(jax_model.synthetic_batch(np.random.default_rng(99), held_out))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "bfloat16", jnp.float32)  # f32 compute, see the module docstring
        acc = round(float(jax.jit(accuracy)(state.params, placed)), 4)
    port_trainer = Trainer(port_model, device="cpu", config=TrainerConfig())
    port = port_trainer.init_state()
    port.params.load_state_dict(tree_params_from_jax(jax.device_get(state.params)))
    ckpt = Checkpointer(torch_dir)
    ckpt.save(int(state.step), TrainState(int(state.step), port.params, port.opt_state))
    ckpt.wait()
    return int(state.step), acc


#: entry -> (train arguments, held-out batch size, steps trained)
INFER_ENTRIES = {
    "mnist": (["--steps", "3", "--batch-size", "16"], 512, 3),
    "resnet": (["--depth", "18", "--batch-size", "8", "--batches-per-shard", "1"], 128, 6),
}


@pytest.mark.parametrize("name", sorted(INFER_ENTRIES))
def test_train_then_infer_as_the_jax_entry_does(name, tmp_path, local_mode, monkeypatch,
                                                capsys):
    """``train`` in both packages: the JAX keys and step counts (MNIST
    through the Trainer with a `StepProfiler`, ResNet through an
    `ElasticWorker` over 6 shards). ``infer``: the port on its own
    checkpoint gives an accuracy at its step, and on the JAX entry's
    trained params (carried across) the JAX model's accuracy on the same
    held-out batch to within one example, both in f32."""
    from edl_tpu import models as jax_models
    from edl_tpu.models import mnist as jax_mnist
    from edl_tpu.models import resnet as jax_resnet
    from edl_tpu_torch import models as torch_models
    from edl_tpu_torch.examples.resnet.train import make_model

    argv, held_out, steps = INFER_ENTRIES[name]
    jax_dir, port_dir = str(tmp_path / "jax-model"), str(tmp_path / "model")
    script = os.path.join(ROOT, "examples", name, "train.py")
    local_mode("jax-ck")
    (want,) = _run_jax(f"{name}/train.py", ["train", *argv, "--model-dir", jax_dir],
                       monkeypatch, capsys)
    (got,) = _run_port(f"{name}.train", ["train", *argv, "--model-dir", port_dir], capsys)
    assert set(got) == set(want)
    assert got["steps"] == want["steps"] == steps
    assert got["model_dir"] == port_dir and np.isfinite(got["final_loss"])
    if name == "resnet":
        for key in ("world", "passes_trained", "rescales"):
            assert got[key] == want[key], key

    shape = ["--depth", "18"] if name == "resnet" else []
    (own,) = _run_port(f"{name}.train", ["infer", *shape, "--model-dir", port_dir], capsys)
    assert own["step"] == steps and 0.0 <= own["accuracy"] <= 1.0
    if name == "resnet":
        args = type("Args", (), {"imagenet": False, "depth": 18})
        jax_model, port_model = runpy.run_path(script)["make_model"](args), make_model(args)
        assert jax_model.name == port_model.name == "resnet18"

        def accuracy(params, batch):
            return jax_resnet.accuracy(jax_model, params, batch)
    else:
        jax_model, port_model = jax_models.resolve(name), torch_models.resolve(name)
        accuracy = jax_mnist.accuracy
    carried = str(tmp_path / "carried")
    step, jax_acc = _carry_across(jax_dir, jax_model, accuracy, port_model, carried, held_out)
    assert step == steps
    monkeypatch.setattr(getattr(torch_models, name), "COMPUTE_DTYPE", torch.float32)
    (from_jax,) = _run_port(f"{name}.train", ["infer", *shape, "--model-dir", carried], capsys)
    assert from_jax["step"] == step
    assert abs(from_jax["accuracy"] - jax_acc) <= 1.0 / held_out + 1e-4, (from_jax, jax_acc)
