"""The port's `Checkpointer` on the CPU, and a resumed run against the JAX
package's resumed run.

- A run saved at step k, restored into a fresh Trainer (fresh weights from
  another seed) and continued gives the uninterrupted run's losses and
  final params bit for bit (tolerance 0), for Adam (its moments and step
  counts) and for optax's adagrad (its ``sum_of_squares``).
- The same save-and-resume by the JAX package (orbax) from the same
  weights and batches: the port's resumed losses within rel 1e-3 of the
  JAX package's (the Trainer parity tolerance of
  `tests/test_torch_train_loop.py`; the two run their bf16 matmuls with
  their own roundings).
- ``save`` snapshots before it returns: a step that updates the params in
  place right after ``save``, while the writer is held back, does not
  reach the file.
- ``keep`` pruning, the torn-step fallback (an unreadable newest step
  demotes to the previous one with a log line; an explicit step raises;
  all steps torn raises; an empty directory raises FileNotFoundError), and
  ``restore_extra`` (a failed read logs and returns None), as the JAX
  package's `tests/test_checkpoint.py` holds its Checkpointer.
"""

import glob
import logging
import os
import threading

import jax
import numpy as np
import pytest
import torch

from edl_tpu.models import transformer as jax_tf
from edl_tpu.parallel import MeshSpec, build_mesh
from edl_tpu.runtime import Trainer as JaxTrainer, TrainerConfig as JaxConfig
from edl_tpu.runtime.checkpoint import Checkpointer as JaxCheckpointer
from edl_tpu.runtime.checkpoint import abstract_like, live_state_specs
from edl_tpu_torch.models import ctr, fit_a_line, transformer
from edl_tpu_torch.models.convert import params_from_jax
from edl_tpu_torch.runtime import Trainer, TrainerConfig
from edl_tpu_torch.runtime import checkpoint as ckpt_module
from edl_tpu_torch.runtime.checkpoint import Checkpointer

LM_KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=8, d_ff=64, seq_len=16)
CASES = {
    "adam_lm": (transformer.make_model(**LM_KW), dict(optimizer="adam", learning_rate=1e-2), 4),
    "adagrad_ctr": (ctr.make_model(sparse_dim=500), dict(optimizer="adagrad",
                                                         learning_rate=0.05), 32),
}
STEPS, SAVE_AT = 6, 3


def _batches(model, batch_size, n=STEPS):
    rng = np.random.default_rng(0)
    return [model.synthetic_batch(rng, batch_size) for _ in range(n)]


def _train(trainer, state, batches):
    losses = []
    for b in batches:
        state, loss = trainer.train_step(state, trainer.place_batch(b))
        losses.append(loss.item())
    return state, losses


@pytest.mark.parametrize("case", sorted(CASES))
def test_resume_equals_uninterrupted_bit_for_bit(tmp_path, case):
    model, kw, bs = CASES[case]
    batches = _batches(model, bs)
    trainer = Trainer(model, device="cpu", config=TrainerConfig(**kw))
    state = trainer.init_state()
    ck = Checkpointer(str(tmp_path))
    state, head = _train(trainer, state, batches[:SAVE_AT])
    ck.save(state.step, state, extra={"shard": "part-00003"})
    state, tail = _train(trainer, state, batches[SAVE_AT:])
    ck.wait()

    fresh = Trainer(model, device="cpu", config=TrainerConfig(**kw))
    resumed = ck.restore(fresh.init_state(torch.Generator().manual_seed(9)))
    assert resumed.step == SAVE_AT and ck.latest_step() == SAVE_AT
    assert ck.restore_extra() == {"shard": "part-00003"}
    resumed, again = _train(fresh, resumed, batches[SAVE_AT:])
    assert again == tail
    for (name, a), b in zip(state.params.state_dict().items(),
                            resumed.params.state_dict().values()):
        assert torch.equal(a, b), name
    for a, b in zip(state.opt_state.state.values(), resumed.opt_state.state.values()):
        for k in a:
            assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k
    ck.close()


def test_resumed_run_matches_the_jax_packages_resumed_run(tmp_path):
    kw = dict(optimizer="adam", learning_rate=1e-2)
    batches = _batches(transformer.make_model(**LM_KW), 4)
    jmodel = jax_tf.make_model(jax_tf.TransformerConfig(**LM_KW))
    mesh = build_mesh(MeshSpec({"data": 1}), jax.devices()[:1])
    jtrainer = JaxTrainer(jmodel, mesh, JaxConfig(**kw))
    jstate = jtrainer.init_state()
    init = params_from_jax(jax.device_get(jstate.params))
    for b in batches[:SAVE_AT]:
        jstate, _ = jtrainer.train_step(jstate, jtrainer.place_batch(b))
    jck = JaxCheckpointer(str(tmp_path / "jax"))
    jck.save(SAVE_AT, jstate)
    jck.wait()
    fresh = JaxTrainer(jmodel, mesh, JaxConfig(**kw)).init_state(jax.random.PRNGKey(5))
    jstate = jck.restore(abstract_like(fresh), mesh, live_state_specs(fresh))
    jlosses = []
    for b in batches[SAVE_AT:]:
        jstate, loss = jtrainer.train_step(jstate, jtrainer.place_batch(b))
        jlosses.append(float(loss))
    jck.close()

    model = transformer.make_model(**LM_KW)
    trainer = Trainer(model, device="cpu", config=TrainerConfig(**kw))
    state = trainer.init_state()
    state.params.load_state_dict(init)
    state, _ = _train(trainer, state, batches[:SAVE_AT])
    ck = Checkpointer(str(tmp_path / "port"))
    ck.save(SAVE_AT, state)
    ck.wait()
    fresh = Trainer(model, device="cpu", config=TrainerConfig(**kw))
    resumed = ck.restore(fresh.init_state(torch.Generator().manual_seed(5)))
    _, losses = _train(fresh, resumed, batches[SAVE_AT:])
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)


def test_save_snapshots_before_it_returns(tmp_path, monkeypatch):
    """The writer is held until after the next in-place step: the file
    must hold the params as they were at ``save``."""
    release, save = threading.Event(), torch.save

    def held_save(obj, f, *a, **k):
        assert release.wait(30)
        return save(obj, f, *a, **k)

    monkeypatch.setattr(ckpt_module.torch, "save", held_save)
    model = fit_a_line.MODEL
    trainer = Trainer(model, device="cpu", config=TrainerConfig(optimizer="sgd",
                                                                learning_rate=0.1))
    batches = _batches(model, 16, 2)
    state, _ = _train(trainer, trainer.init_state(), batches[:1])
    at_save = {k: v.clone() for k, v in state.params.state_dict().items()}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state)
    assert ck.saving()
    state, _ = _train(trainer, state, batches[1:])  # in place
    assert any(not torch.equal(at_save[k], v) for k, v in state.params.state_dict().items())
    release.set()
    ck.wait()
    assert not ck.saving()
    restored = ck.restore(Trainer(model, device="cpu").init_state())
    for k, v in restored.params.state_dict().items():
        assert torch.equal(v, at_save[k]), k


def _fit_checkpoints(tmp_path, steps, keep=3):
    model = fit_a_line.MODEL
    trainer = Trainer(model, device="cpu", config=TrainerConfig(optimizer="sgd"))
    state = trainer.init_state()
    ck = Checkpointer(str(tmp_path / "ck"), keep=keep)
    saved = {}
    for step, batch in zip(steps, _batches(model, 16, len(steps))):
        state, _ = _train(trainer, state, [batch])
        ck.save(step, state, extra={"step": step})
        ck.wait()
        saved[step] = {k: v.clone() for k, v in state.params.state_dict().items()}
    return ck, trainer, saved


def _truncate(directory, step):
    for f in glob.glob(os.path.join(directory, str(step), "*")):
        with open(f, "r+b") as fh:
            fh.truncate(os.path.getsize(f) // 2)


def test_keep_prunes_the_oldest_steps(tmp_path):
    ck, _, _ = _fit_checkpoints(tmp_path, [1, 2, 3, 4, 5])
    assert ck.all_steps() == [3, 4, 5] and ck.latest_step() == 5
    assert sorted(os.listdir(ck.directory)) == ["3", "4", "5"]  # no temporaries


def test_torn_newest_step_falls_back_with_a_log_line(tmp_path, caplog):
    ck, trainer, saved = _fit_checkpoints(tmp_path, [1, 2])
    _truncate(ck.directory, 2)
    with caplog.at_level(logging.WARNING, logger="edl_tpu_torch.runtime.checkpoint"):
        restored = ck.restore(trainer.init_state())
    assert any("unreadable" in r.message and "falling back" in r.message
               for r in caplog.records), caplog.records
    assert restored.step == 1
    for k, v in restored.params.state_dict().items():
        assert torch.equal(v, saved[1][k])


def test_explicit_torn_step_raises(tmp_path):
    ck, trainer, _ = _fit_checkpoints(tmp_path, [1, 2])
    _truncate(ck.directory, 2)
    with pytest.raises(Exception):
        ck.restore(trainer.init_state(), step=2)
    assert ck.restore(trainer.init_state(), step=1).step == 1


def test_all_steps_torn_or_none_raises(tmp_path):
    ck, trainer, _ = _fit_checkpoints(tmp_path, [1, 2])
    _truncate(ck.directory, 1)
    _truncate(ck.directory, 2)
    with pytest.raises(Exception):
        ck.restore(trainer.init_state())
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(trainer.init_state())


def test_restore_extra_reads_and_logs_a_failed_read(tmp_path, caplog):
    ck, _, _ = _fit_checkpoints(tmp_path, [1, 2])
    assert ck.restore_extra() == {"step": 2} and ck.restore_extra(1) == {"step": 1}
    with open(os.path.join(ck.directory, "2", "extra.json"), "w") as f:
        f.write("{torn")
    with caplog.at_level(logging.WARNING, logger="edl_tpu_torch.runtime.checkpoint"):
        assert ck.restore_extra() is None
    assert any("restore_extra" in r.message for r in caplog.records)
    assert Checkpointer(str(tmp_path / "none")).restore_extra() is None


# -- a checkpoint of two ranks ------------------------------------------------------

DP_CASES = {
    "adagrad_ctr": ("ctr", dict(sparse_dim=500),
                    dict(optimizer="adagrad", learning_rate=0.05, shard_opt_state=True), 16),
    "adam_lm": ("lm", LM_KW, dict(optimizer="adam", learning_rate=1e-2,
                                  shard_opt_state=True, grad_sync="psum"), 4),
}


def test_checkpoint_saved_at_world_2_restores_bit_for_bit(tmp_path):
    """On two gloo ranks (`torch_dp_worker`), CTR (tables row-sharded,
    adagrad's accumulators sharded with them and over ZeRO-1) and the LM
    (Adam's moments under ZeRO-1): a save at step 2, gathered whole and
    written by rank 0, restored by a fresh mesh Trainer, gives every rank
    its params, moments and step back, and the next two steps' losses and
    params, bit for bit (tolerance 0). The step on disk is the one-device
    format, whole tensors: a one-device Trainer restores it to the params
    the ranks hold together."""
    from torch_dp_worker import spawn_ranks

    tasks, models = [], {}
    for name, (kind, kw, cfg, batch) in sorted(DP_CASES.items()):
        model = ctr.make_model(**kw) if kind == "ctr" else transformer.make_model(**kw)
        models[name] = (model, cfg)
        params = model.build(device="cpu", generator=torch.Generator().manual_seed(4))
        tasks.append(("checkpoint", dict(
            model=kind, model_kwargs=kw, config=cfg, axes={"data": 2},
            params=params.state_dict(), batches=_batches(model, batch, 4), save_after=2,
            dir=str(tmp_path / name))))
    results = spawn_ranks(tmp_path, 2, tasks)
    for i, name in enumerate(sorted(DP_CASES)):
        for r, res in enumerate(results):
            got = res[i]
            assert got["restored"]["step"] == 2
            assert got["resumed"] == got["run"], (name, r)
            for key in ("module",):
                for leaf, t in got["saved"][key].items():
                    assert torch.equal(got["restored"][key][leaf], t), (name, r, leaf)
            for leaf, moments in got["saved"]["moments"].items():
                for k, t in moments.items():
                    assert torch.equal(got["restored"]["moments"][leaf][k], t), (name, r, leaf, k)
            for leaf, t in got["run_params"].items():
                assert torch.equal(got["resumed_params"][leaf], t), (name, r, leaf)
        model, cfg = models[name]
        one = Trainer(model, device="cpu", config=TrainerConfig(**cfg))
        state = Checkpointer(str(tmp_path / name)).restore(one.init_state())
        assert state.step == 2
        if name == "adagrad_ctr":
            halves = [res[i]["saved"]["module"]["deep_table"] for res in results]
            assert torch.equal(state.params.deep_table.detach(), torch.cat(halves))
        for leaf, t in state.params.state_dict().items():
            if leaf not in ("deep_table", "wide_table"):
                assert torch.equal(t, results[0][i]["saved"]["module"][leaf]), (name, leaf)


@pytest.mark.parametrize("next_call", ["wait", "save"])
def test_a_writer_failure_is_raised_once_by_the_next_call(tmp_path, monkeypatch, next_call):
    """A failure on the writer thread is handed to the caller's thread under
    the checkpointer's lock and raised by the next ``wait()`` or ``save()``,
    exactly once: the call after it runs clean. The lock is what the thread
    race rule (EDL006) asks of an attribute written on the writer thread
    and read and cleared on the caller's; the port's analyzer holds it."""
    from edl_tpu_torch.analysis import analyze

    save, calls = torch.save, []

    def failing_save(obj, f, *a, **k):
        calls.append(f)
        if len(calls) == 1:
            raise OSError("disk full")
        return save(obj, f, *a, **k)

    monkeypatch.setattr(ckpt_module.torch, "save", failing_save)
    model = fit_a_line.MODEL
    trainer = Trainer(model, device="cpu", config=TrainerConfig(optimizer="sgd"))
    state = trainer.init_state()
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(1, state)
    with pytest.raises(OSError, match="disk full"):
        ck.wait() if next_call == "wait" else ck.save(2, state)
    ck.wait()  # nothing left to raise
    ck.save(3, state)
    ck.wait()
    assert ck.latest_step() == 3 and 1 not in ck.all_steps()
    root = os.path.dirname(os.path.dirname(os.path.abspath(ckpt_module.__file__)))
    report = analyze([ckpt_module.__file__], root=os.path.dirname(root), rules=["EDL006"])
    assert report.findings == []
