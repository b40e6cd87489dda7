"""Elastic model-parallel jobs of the port: the `MultiHostWorker` over a mesh
of ``pipe``, ``model`` times ``data`` on gloo ranks (one process a rank,
`torch_mh_worker.py`, no JAX in them) against the native coordinator.

The JAX package's multi-process tests are skipped on this image, so the
whole-slice oracle is the JAX Trainer on a CPU mesh of the same shape, in
this process, fed the global batches the ranks trained (each step's global
batch is data index 0's batch, then data index 1's, as a JAX process's
local data fills its rows), from the same initial params (a step-0
checkpoint the ranks restore). The LM is small (`test_torch_model_parallel`'s:
4 layers, d_model 64, 4 heads, S 64, vocab 64, batch 8 a data index), with
the einsum attention. Tolerances are that file's: losses relative 1e-3
against the JAX Trainer on the same mesh and 2e-2 against the port's
one-device Trainer; params ``2 * steps * lr`` absolute (Adam moves an
element about lr a step, so this holds where each leaf lands, which a
misplaced leaf misses by its own size); every rank's losses equal,
exactly.

The rescales go through exit 75 and the launcher's relaunch: 4 -> 2 ranks
at a fixed ``{"pipe": 2}`` (both ranks of one data index SIGTERMed), and 2
-> 1 under a stub ``layout_planner`` (``{"pipe": 2}`` at two ranks,
``{"data": 1}`` at one), which re-cuts a pipe-split interleaved checkpoint
into the whole model. Each restore equals the checkpoint it read, bit for
bit, and the run after the rescale matches the port's one-device Trainer
restored from that checkpoint on the same batches: at world 1 exactly (one
rank's mesh step is the one-device step), at world 2 within the
one-device bounds above.
"""

import json
import os
import signal
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from edl_tpu.models import transformer as jax_tf
from edl_tpu.runtime import Trainer as JaxTrainer, TrainerConfig as JaxConfig
from edl_tpu_torch.coordinator import CoordinatorServer
from edl_tpu_torch.coordinator.server import ensure_built
from edl_tpu_torch.models import transformer as torch_tf
from edl_tpu_torch.models.convert import params_from_jax
from edl_tpu_torch.runtime import SyntheticShardSource, Trainer, TrainerConfig
from edl_tpu_torch.runtime.multihost import data_indices
from test_torch_model_parallel import (LM, LOSS_RTOL_JAX, LOSS_RTOL_ONE_DEVICE, _jax_mesh,
                                       _layout, _on_layout)
from test_torch_multihost import _mesh_of, _spawn, _until, _wait

TESTS = Path(__file__).resolve().parent
ADAM = dict(optimizer="adam", learning_rate=1e-3)
BATCH, BPS = 8, 2
INTERLEAVED = dict(pipeline_schedule="1f1b-interleaved", virtual_stages=2, microbatches=2)
ONE_DEVICE_KEYS = ("pipeline_schedule", "virtual_stages", "microbatches")


def _param_atol(steps):
    return 2 * steps * ADAM["learning_rate"]


def _knobs(kw, trainer, world, **extra):
    return dict(MODEL="lm", LM=json.dumps(kw), TRAINER=json.dumps(dict(ADAM, **trainer)),
                EDL_NUM_TRAINERS=world, BATCH_SIZE=BATCH, BATCHES_PER_SHARD=BPS, **extra)


def _runs(tmp_path, names):
    out = {}
    for name in names:
        path = tmp_path / f"{name}.jsonl"
        out[name] = [json.loads(line) for line in path.read_text().splitlines()]
    return out


def _checkpoint(tmp_path, step=None):
    ck = tmp_path / "ck"
    step = step if step is not None else max(int(n) for n in os.listdir(ck) if n.isdigit())
    return torch.load(ck / str(step) / "state.pt", weights_only=True)


def _global_batches(source, reads_by_index):
    """Each step's global batch: the data indices' batches side by side,
    round by round (one shard a data index a round)."""
    out = []
    for shards in zip(*reads_by_index):
        for parts in zip(*(source.read(s) for s in shards)):
            out.append({k: np.concatenate([p[k] for p in parts]) for k in parts[0]})
    return out


def _one_device(kw, saved=None, params=None):
    """The port's one-device Trainer of the LM ``kw``, from a whole state."""
    one_kw = {k: v for k, v in kw.items() if k not in ONE_DEVICE_KEYS}
    trainer = Trainer(torch_tf.make_model(torch_tf.TransformerConfig(**one_kw)),
                      config=TrainerConfig(**ADAM), device="cpu")
    state = trainer.init_state()
    if saved is not None:
        state = trainer.load_full_state(state, saved)
    if params is not None:
        state.params.load_state_dict(params)
    return trainer, state


def _assert_whole_equal(got, want):
    assert got["step"] == want["step"]
    assert got["module"].keys() == want["module"].keys()
    for k, v in want["module"].items():
        assert torch.equal(got["module"][k], v), k
    assert got["optimizer"]["state"].keys() == want["optimizer"]["state"].keys()
    for i, per in want["optimizer"]["state"].items():
        for k, v in per.items():
            assert torch.equal(torch.as_tensor(got["optimizer"]["state"][i][k]),
                               torch.as_tensor(v)), (i, k)


def _restores(tmp_path):
    return [torch.load(p, weights_only=False)
            for p in sorted(tmp_path.glob("restores.*.pt"), key=os.path.getmtime)]


# -- lockstep rounds over a model-parallel mesh, against the JAX Trainer -------


CASES = {
    # axes, world, model kwargs, trainer options, shards
    "model": ({"model": 2}, 2, {}, {}, 2),
    "pipe_data": ({"pipe": 2}, 4, INTERLEAVED, {"shard_opt_state": True}, 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_parallel_lockstep_matches_the_jax_trainer(case, tmp_path):
    """Lockstep rounds on ``{"model": 2}`` (2 ranks) and on ``{"pipe": 2,
    "data": 2}`` with the interleaved pipeline (v 2) and ZeRO-1 (4 ranks):
    one shard a data index a round, both ranks of a data index on the same
    shard, every rank's losses equal; the losses and the final params
    (the last checkpoint) against the JAX Trainer on the same mesh and
    global batches."""
    axes, world, model_kw, trainer_kw, n = CASES[case]
    kw = dict(LM, **model_kw)
    cfg = dict(ADAM, **trainer_kw)
    full_axes = dict(axes, data=world // int(np.prod(list(axes.values()))))
    layout = _layout(kw, full_axes)
    jtrainer = JaxTrainer(jax_tf.make_model(jax_tf.TransformerConfig(**kw)),
                          _jax_mesh(full_axes), JaxConfig(**cfg))
    jstate = jtrainer.init_state(jax.random.PRNGKey(0))
    init = params_from_jax(jax.device_get(jstate.params), layout)
    # the ranks start from the JAX init: a step-0 checkpoint they restore
    one, state = _one_device(kw, params=init)
    (tmp_path / "ck" / "0").mkdir(parents=True)
    torch.save(one.full_state(state), tmp_path / "ck" / "0" / "state.pt")

    ensure_built()
    names = [f"w{i}" for i in range(world)]
    with CoordinatorServer(task_lease_sec=60.0, heartbeat_ttl_sec=60.0) as server:
        admin = server.client("admin")
        admin.add_tasks([f"mp/part-{i:05d}" for i in range(n)])
        procs = [_spawn(server, name, tmp_path, **_knobs(kw, trainer_kw, world,
                                                         AXES=json.dumps(axes)))
                 for name in names]
        # compile the JAX step while the ranks train (on copies: the step
        # may donate its input state)
        source = SyntheticShardSource(torch_tf.make_model(torch_tf.TransformerConfig(**LM)),
                                      batch_size=BATCH, batches_per_shard=BPS)
        layouts = jax.tree_util.tree_map(lambda x: x.sharding, jstate)
        warm = jax.tree_util.tree_map(lambda x: _on_layout(np.asarray(x), x.sharding), jstate)
        jtrainer.train_step(warm, jtrainer.place_batch(
            _global_batches(source, [["warm"]] * full_axes["data"])[0]))
        outs = _wait(procs, 240)
        st = admin.status()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    assert int(st["done"]) == n and int(st["queued"]) == 0
    runs = {r["rank"]: r for rs in _runs(tmp_path, names).values() for r in rs}
    assert sorted(runs) == list(range(world))
    for r, run in runs.items():
        assert run["losses"] == runs[0]["losses"], r
        assert run["mesh"] == {a: full_axes[a] for a in run["mesh"]} and \
            run["world"] == world
    shares = {r: data_indices(_mesh_of(full_axes, r), "data") for r in range(world)}
    n_data = shares[0][0]
    by_index = {}
    for r, (_, i) in shares.items():
        by_index.setdefault(i, runs[r]["reads"])
        assert runs[r]["reads"] == by_index[i], r  # one shard a data index
    assert len({s for reads in by_index.values() for s in reads}) == n
    batches = _global_batches(source, [by_index[i] for i in range(n_data)])
    jlosses = []
    for b in batches:
        state_j, loss = jtrainer.train_step(jstate, jtrainer.place_batch(b))
        jstate = jax.tree_util.tree_map(_on_layout, state_j, layouts)
        jlosses.append(float(loss))
    got = runs[0]["losses"]
    assert len(got) == len(batches) == n // n_data * BPS
    np.testing.assert_allclose(got, jlosses, rtol=LOSS_RTOL_JAX, err_msg=case)
    final = _checkpoint(tmp_path)
    assert final["step"] == len(batches)
    want = params_from_jax(jax.device_get(jstate.params), layout)
    assert set(final["module"]) == set(want)
    for name, t in want.items():
        np.testing.assert_allclose(final["module"][name].numpy(), t.numpy(), rtol=0,
                                   atol=_param_atol(len(batches)), err_msg=name)


# -- rescales across meshes through exit 75 and a relaunch ---------------------


def _launch(server, admin, tmp_path, names, **knobs):
    """One launcher a name, all at once; returns them and, once every rank
    is up, {rank: name}."""
    procs = {name: _spawn(server, name, tmp_path, launcher=True, **knobs) for name in names}
    files = {name: tmp_path / f"{name}.jsonl.rank" for name in names}
    for name in names:
        _until(files[name].exists, procs[name], f"{name} never formed the group")
    return procs, {int(files[name].read_text()): name for name in names}


def _check_relaunch(tmp_path, kw, n_shards, survivors, leavers, final_world, final_mesh,
                    exact):
    """The survivors exited 75 once and came back at ``final_world`` with
    ``final_mesh``; the leavers exited 0 once; the relaunch restored a
    checkpoint bit for bit and trained exactly the shards it lacked; its
    run matches the one-device Trainer restored from that checkpoint."""
    runs = _runs(tmp_path, survivors + leavers)
    for name in survivors:
        assert [r["exit"] for r in runs[name]] == [75, 0], name
        assert runs[name][1]["world"] == final_world and runs[name][1]["mesh"] == final_mesh
    for name in leavers:
        assert [r["exit"] for r in runs[name]] == [0], name
    final = runs[survivors[0]][1]
    assert all(runs[n][1]["losses"] == final["losses"] for n in survivors)
    (rec,) = _restores(tmp_path)
    assert rec["mesh"] == final_mesh
    _assert_whole_equal(rec["restored"], rec["saved"])
    restored_step = rec["step"]
    steps = int(final["metrics"]["steps"])
    assert _checkpoint(tmp_path)["step"] == restored_step + steps
    # the restored checkpoint covered the first rounds' shards of every data
    # index; the relaunch read each of the others once, and only those
    covered = {s for n in survivors + leavers
               for s in runs[n][0]["reads"][:restored_step // BPS]}
    assert covered and not covered & set(final["reads"])
    assert len(final["reads"]) == len(set(final["reads"])) == n_shards - len(covered) > 0
    assert steps == len(final["reads"]) * BPS
    # the whole checkpoint into one device, and the run after the rescale
    trainer, state = _one_device(kw, saved=rec["saved"])
    _assert_whole_equal(trainer.full_state(state), rec["saved"])
    source = SyntheticShardSource(torch_tf.make_model(torch_tf.TransformerConfig(**LM)),
                                  batch_size=BATCH, batches_per_shard=BPS)
    losses = []
    for b in _global_batches(source, [final["reads"]]):
        state, loss = trainer.train_step(state, trainer.place_batch(b))
        losses.append(float(loss))
    end = _checkpoint(tmp_path)["module"]
    if exact:
        assert final["losses"] == losses
        for name, p in state.params.state_dict().items():
            assert torch.equal(end[name], p), name
    else:
        np.testing.assert_allclose(final["losses"], losses, rtol=LOSS_RTOL_ONE_DEVICE)
        for name, p in state.params.state_dict().items():
            np.testing.assert_allclose(end[name].numpy(), p.numpy(), rtol=0,
                                       atol=_param_atol(steps), err_msg=name)
    return covered


def test_rescale_four_to_two_ranks_on_a_pipe_mesh_through_a_relaunch(tmp_path):
    """``{"pipe": 2}`` fixed, interleaved (v 2), ZeRO-1: four ranks train as
    ``{"data": 2, "pipe": 2}``; both launchers of data index 1 get SIGTERM,
    leave at a round boundary and exit 0; ranks 0 and 1 exit 75, are
    relaunched at world 2 as ``{"data": 1, "pipe": 2}``, restore the world-4
    checkpoint (ZeRO-1 moments regrouped from two data shards to one) and
    drain the queue."""
    ensure_built()
    kw, n = dict(LM, **INTERLEAVED), 10
    with CoordinatorServer(task_lease_sec=60.0, heartbeat_ttl_sec=30.0) as server:
        admin = server.client("admin")
        admin.add_tasks([f"mp/part-{i:05d}" for i in range(n)])
        admin.kv_put("edl/expected_world", "4")
        admin.kv_put("test/hold", "1")
        knobs = _knobs(kw, {"shard_opt_state": True}, 4, AXES=json.dumps({"pipe": 2}),
                       CKPT_INTERVAL=BPS, HOLD_AFTER=2 * BPS,
                       RESTORES=tmp_path / "restores")
        procs, ranks = _launch(server, admin, tmp_path, ["w0", "w1", "w2", "w3"], **knobs)
        _until(lambda: int(admin.status()["done"]) >= 2, procs[ranks[0]], "no progress")
        admin.kv_put("edl/expected_world", "2")
        for r in (2, 3):  # data index 1 of {"data": 2, "pipe": 2}
            procs[ranks[r]].send_signal(signal.SIGTERM)
        admin.kv_put("test/hold", "0")
        order = [ranks[r] for r in (2, 3, 0, 1)]
        outs = _wait([procs[k] for k in order], 180)
        st = admin.status()
    for out, name in zip(outs, order):
        assert procs[name].returncode == 0, out[-4000:]
    assert int(st["done"]) == n and int(st["queued"]) == 0
    covered = _check_relaunch(tmp_path, kw, n, [ranks[0], ranks[1]], [ranks[2], ranks[3]],
                              2, {"data": 1, "pipe": 2}, exact=False)
    assert len(covered) >= 2 and len(covered) % 2 == 0  # two shards a world-4 round


def test_rescale_two_to_one_re_cuts_a_pipe_split_checkpoint_through_a_relaunch(tmp_path):
    """A stub ``layout_planner``: ``{"pipe": 2}`` at two ranks (interleaved,
    v 2), ``{"data": 1}`` at one. Rank 1's launcher gets SIGTERM; rank 0
    exits 75, is relaunched at world 1, plans the whole model, restores the
    pipe-split checkpoint into it bit for bit and trains on exactly as the
    one-device Trainer restored from that checkpoint does."""
    ensure_built()
    kw, n = dict(LM, **INTERLEAVED), 6
    with CoordinatorServer(task_lease_sec=60.0, heartbeat_ttl_sec=30.0) as server:
        admin = server.client("admin")
        admin.add_tasks([f"mp/part-{i:05d}" for i in range(n)])
        admin.kv_put("edl/expected_world", "2")
        admin.kv_put("test/hold", "1")
        knobs = _knobs(kw, {}, 2, PLANNER="stub", CKPT_INTERVAL=BPS, HOLD_AFTER=2 * BPS,
                       RESTORES=tmp_path / "restores")
        procs, ranks = _launch(server, admin, tmp_path, ["w0", "w1"], **knobs)
        # one data index: a checkpoint covering a round completes one shard
        _until(lambda: int(admin.status()["done"]) >= 1, procs[ranks[0]], "no progress")
        admin.kv_put("edl/expected_world", "1")
        procs[ranks[1]].send_signal(signal.SIGTERM)
        admin.kv_put("test/hold", "0")
        order = [ranks[1], ranks[0]]
        outs = _wait([procs[k] for k in order], 180)
        st = admin.status()
    for out, name in zip(outs, order):
        assert procs[name].returncode == 0, out[-4000:]
    assert int(st["done"]) == n and int(st["queued"]) == 0
    assert _runs(tmp_path, [ranks[0]])[ranks[0]][0]["mesh"] == {"pipe": 2}
    _check_relaunch(tmp_path, kw, n, [ranks[0]], [ranks[1]], 1, {"data": 1}, exact=True)


# -- the peer plane and the interleaved export on a pipe mesh ------------------


def test_peer_plane_and_the_interleaved_export_on_a_pipe_mesh(tmp_path):
    """Two ranks at ``{"pipe": 2}``, interleaved (v 2), one rank set for
    both cases.

    The checkpoint plane: each rank replicates its slice of the whole state
    through the native coordinator, the live state is dropped and a fresh
    one peer-restores: bit for bit onto the same mesh and onto one device
    (``{"data": 1}``), and the restored run's losses EQUAL the twin's.

    The export across the packages: the port writes the blocks in logical
    layer order (``blocks.i`` is layer i), the JAX package as it stores them
    on this mesh, chunk-major (storage row p is layer
    ``interleaved_layout(L, 2, 2)[p]``). So the JAX loader serves the port's
    artifact as the logical model, and the port's loader serves the JAX
    artifact with its layers in JAX's storage order, as the JAX loader
    serves it too."""
    from edl_tpu import models as jax_models
    from edl_tpu.parallel import pipeline as jax_pipeline
    from edl_tpu.runtime import export as jax_export
    from edl_tpu.runtime.export import _serving_mesh
    from edl_tpu_torch.runtime.export import load_inference_model
    from torch_dp_worker import spawn_ranks

    kw, axes = dict(LM, **INTERLEAVED), {"pipe": 2}
    jtrainer = JaxTrainer(jax_tf.make_model(jax_tf.TransformerConfig(**kw)),
                          _jax_mesh(axes), JaxConfig(**ADAM))
    jparams = jax.device_get(jtrainer.init_state(jax.random.PRNGKey(0)).params)
    perm = jax_pipeline.interleaved_layout(kw["n_layers"], 2, 2)
    assert list(perm) != sorted(perm)
    logical = params_from_jax(jparams, perm)
    source = SyntheticShardSource(torch_tf.make_model(torch_tf.TransformerConfig(**LM)),
                                  batch_size=BATCH, batches_per_shard=4)
    ensure_built()
    case = dict(model="lm", model_kwargs=kw, config=ADAM, axes=axes, params=logical,
                batches=list(source.read("plane")), kill_after=2,
                export_dir=str(tmp_path / "port-export"))
    with CoordinatorServer(task_lease_sec=60.0, heartbeat_ttl_sec=60.0) as server:
        case["coordinator"] = server.port
        results = spawn_ranks(tmp_path, 2, [("plane", case), ("export", case)],
                              script=TESTS / "torch_mp_worker.py", timeout=240)
    for res in results:
        plane = res[0]
        assert plane["source"] == "peer"
        assert plane["diff_mesh"] == [] and plane["diff_one_device"] == []
        assert plane["run"] == plane["twin"] and len(plane["twin"]) == 4

    jax_export.save_inference_model(str(tmp_path / "jax-export"), "transformer", jparams,
                                    config=kw, step=1)
    config = jax_models.resolve("transformer", kw)
    served = {}
    for name in ("port-export", "jax-export"):
        art = jax_export.load_inference_model(str(tmp_path / name),
                                              mesh=_serving_mesh(config))
        served[("jax", name)] = params_from_jax(jax.device_get(art.params))
        served[("port", name)] = load_inference_model(str(tmp_path / name),
                                                      device="cpu").module.state_dict()
    stored = {f"blocks.{p}.{leaf}": logical[f"blocks.{int(layer)}.{leaf}"]
              for p, layer in enumerate(perm) for leaf in torch_tf.DENSE_LEAVES}
    for loader in ("jax", "port"):
        for name, want in logical.items():  # the port's artifact: logical order
            assert torch.equal(served[(loader, "port-export")][name], want), (loader, name)
        for name, want in stored.items():  # JAX's: its storage order
            assert torch.equal(served[(loader, "jax-export")][name], want), (loader, name)
