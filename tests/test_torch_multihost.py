"""The port's `MultiHostWorker` (`edl_tpu_torch.runtime.multihost`): lockstep
rounds over gloo ranks on the CPU, against the native coordinator.

The JAX package's multi-process tests (``tests/test_multihost.py``) are
skipped on this image, so the multi-rank cases run the port alone, one
process a rank (`torch_mh_worker.py`, no JAX), and hold it against the
port's one-device Trainer on the same global batches: each step's global
batch is rank 0's batch then rank 1's, as the JAX package assembles
process-local data. fit_a_line trains in f32 with SGD, so the final params
agree to rel 1e-5 (the ranks' all-reduce sums in another order). The pure
round-plan cases run on both packages' workers in one process (no process
group: rank 0 of world 1, as the JAX worker runs at ``jax.process_count()
== 1``) and must publish the same plans.
"""

import importlib
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from edl_tpu_torch.coordinator import CoordinatorServer
from edl_tpu_torch.coordinator.server import ensure_built

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
PACKAGES = ("jax", "torch")
ROOTS = {"jax": "edl_tpu", "torch": "edl_tpu_torch"}


def _env(server, name, tmp_path, **extra):
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
           "EDL_COORDINATOR_ENDPOINT": server.address, "EDL_PORT": str(server.port),
           "EDL_NUM_TRAINERS": "2", "WORKER_NAME": name, "CKPT_DIR": str(tmp_path / "ck"),
           "RESULT": str(tmp_path / f"{name}.jsonl"),
           "EDL_TERMINATION_LOG": str(tmp_path / f"term-{name}")}
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _spawn(server, name, tmp_path, launcher=False, **extra):
    env = _env(server, name, tmp_path, **extra)
    worker = [sys.executable, str(TESTS / "torch_mh_worker.py")]
    if launcher:
        env["EDL_ENTRY"] = " ".join(worker)
        worker = [sys.executable, "-m", "edl_tpu_torch.launcher", "start_trainer"]
    return subprocess.Popen(worker, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(procs, timeout):
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _results(tmp_path, name):
    return [json.loads(line) for line in (tmp_path / f"{name}.jsonl").read_text().splitlines()]


def _latest_checkpoint(tmp_path):
    ck = tmp_path / "ck"
    step = max(int(n) for n in os.listdir(ck) if n.isdigit())
    return torch.load(ck / str(step) / "state.pt", weights_only=True)


# -- lockstep training on two ranks --------------------------------------------


def test_two_ranks_train_in_lockstep_as_one_device_would(tmp_path):
    """Two ranks drain five shards in lockstep (the tail round replicates
    the odd shard): equal step counts and losses on both ranks, and the
    final params equal the one-device Trainer's on the same global
    batches."""
    from edl_tpu_torch.models import fit_a_line
    from edl_tpu_torch.runtime import SyntheticShardSource, Trainer, TrainerConfig

    ensure_built()
    with CoordinatorServer(task_lease_sec=60.0, heartbeat_ttl_sec=60.0) as server:
        admin = server.client("admin")
        admin.add_tasks([f"mh/part-{i:05d}" for i in range(5)])
        procs = [_spawn(server, f"w{i}", tmp_path) for i in range(2)]
        outs = _wait(procs, 60)
        st = admin.status()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    runs = {r["rank"]: r for r in _results(tmp_path, "w0") + _results(tmp_path, "w1")}
    assert sorted(runs) == [0, 1]
    m0, m1 = runs[0]["metrics"], runs[1]["metrics"]
    assert m0["steps"] == m1["steps"] == 9.0  # 3 rounds x 3 steps
    assert m0["world"] == 2.0 and m1["rank"] == 1.0
    assert runs[0]["losses"] == runs[1]["losses"]
    assert int(st["queued"]) == 0 and int(st["done"]) == 5
    assert runs[0]["reads"][-1] == runs[1]["reads"][-1]  # the tail round

    source = SyntheticShardSource(fit_a_line.MODEL, batch_size=16, batches_per_shard=3)
    trainer = Trainer(fit_a_line.MODEL, None, TrainerConfig(optimizer="sgd",
                                                            learning_rate=0.05),
                      device="cpu")
    state = trainer.init_state()
    losses = []
    for s0, s1 in zip(runs[0]["reads"], runs[1]["reads"]):
        for b0, b1 in zip(source.read(s0), source.read(s1)):
            batch = {k: np.concatenate([b0[k], b1[k]]) for k in b0}
            state, loss = trainer.train_step(state, trainer.place_batch(batch))
            losses.append(float(loss))
    np.testing.assert_allclose(runs[0]["losses"], losses, rtol=1e-5)
    saved = _latest_checkpoint(tmp_path)
    assert saved["step"] == 9
    for name, p in state.params.named_parameters():
        np.testing.assert_allclose(saved["module"][name].numpy(), p.detach().numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_two_rank_export_gathers_sharded_tables(tmp_path):
    """The CTR tables are row-sharded over the two ranks: the export
    gathers them collectively, rank 0 writes, and the artifact serves on
    one device."""
    from edl_tpu_torch.runtime import load_inference_model

    ensure_built()
    export_dir = tmp_path / "serve"
    with CoordinatorServer(task_lease_sec=60.0, heartbeat_ttl_sec=60.0) as server:
        server.client("admin").add_tasks([f"ex/part-{i:05d}" for i in range(4)])
        procs = [_spawn(server, f"w{i}", tmp_path, MODEL="ctr_small",
                        EXPORT_DIR=export_dir, EXPORT_INTERVAL=3) for i in range(2)]
        outs = _wait(procs, 60)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    runs = {r["rank"]: r for r in _results(tmp_path, "w0") + _results(tmp_path, "w1")}
    assert runs[0]["metrics"]["steps"] == runs[1]["metrics"]["steps"] == 6.0
    assert sorted([runs[0]["metrics"]["exports"], runs[1]["metrics"]["exports"]]) == [0.0, 2.0]
    art = load_inference_model(str(export_dir), device="cpu")
    assert art.step == 6 and art.config == {"sparse_dim": 503}
    saved = _latest_checkpoint(tmp_path)
    for name, t in art.module.state_dict().items():
        assert torch.equal(t, saved["module"][name]), name
    batch = art.model.synthetic_batch(np.random.default_rng(3), 32)
    logits = art.predict({"dense": batch["dense"], "sparse": batch["sparse"]})
    assert logits.shape == (32,) and torch.isfinite(logits).all()


# -- rescale through exit 75 and the launcher's relaunch -----------------------


def test_rescale_one_to_two_processes_through_a_relaunch(tmp_path):
    """A world-1 job is joined by a second trainer: rank 0 sees the epoch
    move at a round boundary, exits 75 without saving, its launcher
    relaunches it, and both come back as one world-2 group that restores
    the last checkpoint and finishes the queue. The solo phase is held
    open (``HOLD_AFTER``) until the joiner has registered."""
    ensure_built()
    n, bps = 16, 4
    with CoordinatorServer(task_lease_sec=60.0, heartbeat_ttl_sec=30.0) as server:
        admin = server.client("admin")
        admin.add_tasks([f"mh/part-{i:05d}" for i in range(n)])
        admin.kv_put("edl/expected_world", "1")
        admin.kv_put("test/hold", "1")
        knobs = dict(EDL_NUM_TRAINERS=1, BATCHES_PER_SHARD=bps, CKPT_INTERVAL=bps)
        p0 = _spawn(server, "w0", tmp_path, launcher=True, HOLD_AFTER=3 * bps, **knobs)
        _until(lambda: int(admin.status()["done"]) >= 2, p0, "w0 made no progress")
        admin.kv_put("edl/expected_world", "2")
        p1 = _spawn(server, "w1", tmp_path, launcher=True, **knobs)
        _until(lambda: len(admin.members()) >= 2, p1, "w1 never registered")
        admin.kv_put("test/hold", "0")
        outs = _wait([p0, p1], 60)
        st = admin.status()
    for p, out in zip((p0, p1), outs):
        assert p.returncode == 0, out[-4000:]
    w0, w1 = _results(tmp_path, "w0"), _results(tmp_path, "w1")
    assert [r["exit"] for r in w0] == [75, 0] and [r["exit"] for r in w1] == [0]
    assert w0[0]["world"] == 1 and w0[1]["world"] == w1[0]["world"] == 2
    assert w0[1]["metrics"]["steps"] == w1[0]["metrics"]["steps"] > 0
    assert w0[1]["losses"] == w1[0]["losses"]
    assert int(st["queued"]) == 0 and int(st["done"]) == n


def _until(cond, proc, what, timeout=45.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline and proc.poll() is None, what
        time.sleep(0.05)


def test_rescale_two_to_one_on_sigterm_through_a_relaunch(tmp_path):
    """Scale-down: rank 1's launcher gets SIGTERM; its entry leaves at a
    round boundary (running out any plan rank 0 already published) and
    exits 0; rank 0 sees the epoch move, exits 75, is relaunched at world 1,
    restores the world-2 checkpoint and drains the queue, replaying exactly
    the shards that checkpoint did not cover."""
    ensure_built()
    n, bps = 24, 4
    with CoordinatorServer(task_lease_sec=60.0, heartbeat_ttl_sec=30.0) as server:
        admin = server.client("admin")
        admin.add_tasks([f"mh/part-{i:05d}" for i in range(n)])
        admin.kv_put("edl/expected_world", "2")
        admin.kv_put("test/hold", "1")
        knobs = dict(BATCHES_PER_SHARD=bps, CKPT_INTERVAL=bps, HOLD_AFTER=2 * bps)
        p0 = _spawn(server, "w0", tmp_path, launcher=True, **knobs)
        _until(lambda: len(admin.members()) >= 1, p0, "w0 never registered")
        p1 = _spawn(server, "w1", tmp_path, launcher=True, **knobs)  # rank 1
        _until(lambda: int(admin.status()["done"]) >= 2, p0, "no progress")
        admin.kv_put("edl/expected_world", "1")
        p1.send_signal(signal.SIGTERM)
        admin.kv_put("test/hold", "0")
        outs = _wait([p1, p0], 60)
        st = admin.status()
    for p, out in zip((p0, p1), outs):
        assert p.returncode == 0, out[-4000:]
    w0, w1 = _results(tmp_path, "w0"), _results(tmp_path, "w1")
    assert [r["rank"] for r in w0] == [0, 0] and [r["rank"] for r in w1] == [1]
    assert [r["exit"] for r in w0] == [75, 0] and [r["exit"] for r in w1] == [0]
    final = w0[1]
    assert final["world"] == 1 and final["metrics"]["world"] == 1.0
    assert int(st["queued"]) == 0 and int(st["done"]) == n
    # the world-1 incarnation trained exactly the shards the world-2
    # checkpoint it restored lacked, each once: that checkpoint's step
    # covers two shards a bps-step round
    restored_step = _latest_checkpoint(tmp_path)["step"] - int(final["metrics"]["steps"])
    assert restored_step > 0 and restored_step % bps == 0
    assert len(final["reads"]) == len(set(final["reads"])) == n - 2 * restored_step // bps
    assert final["metrics"]["steps"] == len(final["reads"]) * bps
    assert not set(final["reads"]) & set(w0[0]["reads"][:restored_step // bps])


# -- the round plan (both packages, one process) -------------------------------


def _pkg(name):
    root = ROOTS[name]
    m = lambda mod: importlib.import_module(f"{root}.{mod}")  # noqa: E731
    return m("coordinator.inprocess").InProcessCoordinator, m("runtime.multihost"), \
        m("runtime.elastic").ElasticConfig, m("runtime.data").SyntheticShardSource, \
        m("models.fit_a_line").MODEL, m("runtime.train_loop").TrainerConfig


@pytest.fixture(params=PACKAGES)
def P(request):
    return request.param


def _inproc_client(P, tasks):
    Coordinator = _pkg(P)[0]
    coord = Coordinator()
    coord.client("admin").add_tasks(tasks)
    return coord.client("w0")


def _make_worker(P, client, tmp_path, batches_per_shard=3, **cfg):
    _, mh, ElasticConfig, Source, model, TrainerConfig = _pkg(P)
    kw = {"device": "cpu"} if P == "torch" else {}
    return mh.MultiHostWorker(
        model, client, Source(model, batch_size=8, batches_per_shard=batches_per_shard),
        ElasticConfig(checkpoint_dir=str(tmp_path / f"ck-{P}"),
                      trainer=TrainerConfig(optimizer="sgd", learning_rate=0.05), **cfg),
        **kw)


def test_round_plan_gc_waits_for_collective(P, tmp_path):
    client = _inproc_client(P, ["s0", "s1", "s2", "s3"])
    ep = int(client.register()["epoch"])
    w = _make_worker(P, client, tmp_path)

    def key(r):
        return f"edl/mh_round/{ep}/{r}"

    assert "tasks" in w._publish_round(epoch=ep, rnd=0, world=2)
    w._publish_round(epoch=ep, rnd=1, world=2)
    assert client.kv_get(key(0)) and client.kv_get(key(1))
    w._collective_hwm = 1
    w._publish_round(epoch=ep, rnd=2, world=2)
    assert client.kv_get(key(0)) is None and client.kv_get(key(1)) is None
    assert client.kv_get(key(2))


def test_round_plan_includes_lockstep_steps(P, tmp_path):
    client = _inproc_client(P, ["a", "b"])
    ep = int(client.register()["epoch"])
    w = _make_worker(P, client, tmp_path, batches_per_shard=4)
    msg = w._publish_round(epoch=ep, rnd=0, world=2)
    assert sorted(msg["tasks"]) == ["a", "b"] and msg["steps"] == 4
    assert json.loads(client.kv_get(f"edl/mh_round/{ep}/0"))["steps"] == 4


class _UnevenSource:
    """batch_count metadata with per-shard counts; read honors the counts
    except for shards listed in `lying` (metadata says n>0, read yields 0)."""

    def __init__(self, counts, lying=()):
        self.counts = counts
        self.lying = set(lying)

    def batch_count(self, shard):
        return self.counts[shard]

    def read(self, shard):
        if shard in self.lying:
            return
        for i in range(self.counts[shard]):
            yield {"x": shard, "i": i}


def test_publish_filters_empty_shards(P, tmp_path):
    client = _inproc_client(P, ["e0", "full", "e1", "also"])
    ep = int(client.register()["epoch"])
    w = _make_worker(P, client, tmp_path)
    w.source = _UnevenSource({"e0": 0, "full": 3, "e1": 0, "also": 2})
    msg = w._publish_round(epoch=ep, rnd=0, world=4)
    assert sorted(msg["tasks"]) == ["also", "full"] and msg["steps"] == 3
    assert int(client.status()["done"]) == 2


def test_round_plans_are_the_jax_packages(tmp_path):
    """The same queue, batch counts and world through both packages' rank
    0: the same plans round by round, tail, checkpoint and stop included."""
    plans = []
    for P in PACKAGES:
        client = _inproc_client(P, [f"s{i}" for i in range(7)])
        ep = int(client.register()["epoch"])
        w = _make_worker(P, client, tmp_path)
        w.source = _UnevenSource({f"s{i}": i % 3 for i in range(7)})
        got = []
        for rnd in range(6):
            msg = w._publish_round(epoch=ep, rnd=rnd, world=3)
            got.append(msg)
            if "tasks" in msg:
                w._uncommitted.extend(msg["tasks"])
                w._collective_hwm = rnd
            elif msg.get("ckpt"):
                for t in w._uncommitted:
                    client.complete_task(t)
                w._uncommitted.clear()
        plans.append(got)
    assert plans[0] == plans[1]
    assert any(m.get("ckpt") for m in plans[1]) and plans[1][-1] == {"stop": "exhausted"}


def _mesh_of(axes, rank):
    """A `Mesh` of ``axes`` seen from ``rank``, without a process group (the
    round plan issues no collective)."""
    from edl_tpu_torch.parallel.mesh import Mesh, MeshSpec

    spec = MeshSpec(dict(axes))
    names = spec.ordered_axes()
    return Mesh(names, [spec.axis(n) for n in names], rank, spec.size())


@pytest.mark.parametrize("axes", [{"data": 4}, {"pipe": 2, "data": 2},
                                  {"data": 2, "model": 2}, {"seq": 2, "data": 2}],
                         ids=["data", "pipe", "model", "seq"])
def test_round_plans_lease_one_shard_a_data_index(axes, tmp_path):
    """Rank 0 leases one shard for each data index (the batch axes' size),
    and every rank of an index trains the same shard; at a ``data``-only
    mesh that is one shard a rank, and the plans are the JAX worker's for
    the same world."""
    from edl_tpu_torch.runtime.multihost import data_indices

    world = 4
    shares = [data_indices(_mesh_of(axes, r), "data") for r in range(world)]
    n_data = shares[0][0]
    assert {n for n, _ in shares} == {axes["data"]}
    plans = {}
    for P, n in (("jax", world), ("torch", n_data)):
        client = _inproc_client(P, [f"s{i}" for i in range(5)])
        ep = int(client.register()["epoch"])
        w = _make_worker(P, client, tmp_path / P)
        plans[P] = []
        for rnd in range(3):
            msg = w._publish_round(epoch=ep, rnd=rnd, world=n)
            plans[P].append(msg)
            w._uncommitted.extend(msg.get("tasks", []))
    got = plans["torch"]
    assert [len(m["tasks"]) for m in got[:2]] == [n_data, min(n_data, 5 - n_data)]
    for msg in got[:2]:
        shard = [msg["tasks"][i % len(msg["tasks"])] for _, i in shares]
        for r in range(world):  # the ranks of one data index read one shard
            same = [q for q in range(world) if shares[q][1] == shares[r][1]]
            assert {shard[q] for q in same} == {shard[r]}
        assert len(set(shard)) == len(msg["tasks"])
    if n_data == world:
        assert got == plans["jax"]


def test_a_rank_keeps_its_part_of_its_data_index_batch(tmp_path):
    """On ``{"data": 2, "seq": 2}`` each rank of a data index keeps its
    sequence chunk of the shard's whole batch (the data axis chose the
    shard, so no rows are cut); on ``{"data": 2, "pipe": 2}`` it keeps it
    all."""
    from edl_tpu_torch.models import transformer
    from edl_tpu_torch.runtime import ElasticConfig, MultiHostWorker

    model = transformer.make_model(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                                   d_ff=64, seq_len=16)
    worker = MultiHostWorker(model, _inproc_client("torch", []), None,
                             ElasticConfig(checkpoint_dir=str(tmp_path / "ck")), device="cpu")
    batch = model.synthetic_batch(np.random.default_rng(0), 4)
    for r in range(4):
        mesh = _mesh_of({"data": 2, "seq": 2}, r)
        got = worker._rank_part(mesh, ("data",))(batch)
        j = mesh.coords()["seq"]
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(got[k], batch[k][:, j * 8:(j + 1) * 8])
        whole = worker._rank_part(_mesh_of({"data": 2, "pipe": 2}, r), ("data",))(batch)
        assert all(np.array_equal(whole[k], batch[k]) for k in batch)


def test_padded_batches_cycles_short_shard(P, tmp_path):
    w = _make_worker(P, _inproc_client(P, []), tmp_path)
    w.source = _UnevenSource({"short": 2, "long": 5})
    got = list(w._padded_batches("short", ["short", "long"], steps=5))
    assert [b["i"] for b in got] == [0, 1, 0, 1, 0]


def test_padded_batches_falls_back_to_peer_shard(P, tmp_path):
    w = _make_worker(P, _inproc_client(P, []), tmp_path)
    w.source = _UnevenSource({"bad": 3, "good": 3}, lying={"bad"})
    got = list(w._padded_batches("bad", ["bad", "good"], steps=3))
    assert len(got) == 3 and all(b["x"] == "good" for b in got)


def test_padded_batches_exits_when_all_shards_unreadable(P, tmp_path):
    w = _make_worker(P, _inproc_client(P, []), tmp_path)
    w.source = _UnevenSource({"a": 2, "b": 2}, lying={"a", "b"})
    with pytest.raises(SystemExit) as ei:
        list(w._padded_batches("a", ["a", "b"], steps=2))
    assert ei.value.code == 75


class _NoMetaSource:
    """No batch_count attribute: forces the no-metadata lockstep path."""

    def __init__(self, model, counts):
        self.model = model
        self.counts = counts

    def read(self, shard):
        rng = np.random.default_rng(0)
        for _ in range(self.counts[shard]):
            yield self.model.synthetic_batch(rng, 8)


def test_zero_step_round_requeues_before_completing(tmp_path):
    """The port's worker without a process group (rank 0 of world 1): a
    zero-step round requeues its shard once, a second one completes it."""
    client = _inproc_client("torch", ["empty", "full"])
    w = _make_worker("torch", client, tmp_path)
    w.source = _NoMetaSource(w.model, {"empty": 0, "full": 2})
    fails = []
    orig_fail = w.client.fail_task  # the worker's outbox facade
    w.client.fail_task = lambda t: (fails.append(t), orig_fail(t))[1]
    metrics = w.run()
    assert fails == ["empty"]
    st = client.status()
    assert int(st["done"]) == 2 and int(st["queued"]) == 0
    assert metrics["steps"] == 2.0 and metrics["world"] == 1.0


def test_prefetch_config_trains_identically(tmp_path):
    results = {}
    for tag, kw in (("sync", dict(pipeline_depth=0)),
                    ("prefetch", dict(pipeline_depth=0, prefetch=True)),
                    ("pump", dict(pipeline_depth=2))):
        client = _inproc_client("torch", ["p0", "p1", "p2"])
        w = _make_worker("torch", client, tmp_path / tag, **kw)
        m = w.run()
        st = client.status()
        results[tag] = (m["steps"], m["final_loss"], st["done"], st["queued"])
    assert results["sync"] == results["prefetch"] == results["pump"]
    assert results["sync"][2] == 3


@pytest.mark.parametrize("stretch", ["restore", "checkpoint"])
def test_a_restore_or_save_past_the_heartbeat_ttl_keeps_the_member(stretch, tmp_path):
    """A rank's restore (an incarnation's model build and load) and its
    checkpoint saves make no coordinator call and grow with the model.
    Held past the coordinator's heartbeat TTL, a worker that beats only
    between rounds expires, the epoch moves and it exits 75 into the same
    restore again (the LM at full width looped so on the card). The worker
    beats on a thread through both: here each takes 3 TTLs of 0.5 s, and
    the world-1 worker still drains its queue with no epoch move."""
    from edl_tpu_torch.coordinator.inprocess import InProcessCoordinator

    coord = InProcessCoordinator(task_lease_sec=60.0, heartbeat_ttl_sec=0.5)
    coord.client("admin").add_tasks(["k0", "k1", "k2"])
    client = coord.client("w0")
    worker = _make_worker("torch", client, tmp_path, pipeline_depth=0,
                          checkpoint_interval=3, heartbeat_interval=0.1)
    slow = worker._restore_or_init if stretch == "restore" else worker.ckpt.save

    def held(*args, **kw):
        time.sleep(1.5)
        return slow(*args, **kw)

    if stretch == "restore":
        worker._restore_or_init = held
    else:
        worker.ckpt.save = held
    epoch = coord.client("probe").epoch()
    metrics = worker.run()
    assert metrics["steps"] == 9.0 and metrics["world"] == 1.0
    st = client.status()
    assert (int(st["done"]), int(st["queued"]), int(st["epoch"])) == (3, 0, epoch + 1)


# -- graceful leave ------------------------------------------------------------


class _FlakyDrainClient:
    """fail_task fails per script; records the attempted tasks."""

    worker = "wflaky"

    def __init__(self, outcomes):
        self.outcomes = list(outcomes)
        self.attempted = []
        self.left = False

    def fail_task(self, task):
        self.attempted.append(task)
        out = self.outcomes.pop(0) if self.outcomes else True
        if isinstance(out, Exception):
            raise out

    def leave(self):
        self.left = True


def _drain_worker(tmp_path, client, shards):
    from edl_tpu_torch.models import fit_a_line
    from edl_tpu_torch.runtime import ElasticConfig, MultiHostWorker

    w = MultiHostWorker(fit_a_line.MODEL, client, None,
                        ElasticConfig(checkpoint_dir=str(tmp_path / "ck")), device="cpu")
    # the drain loop itself, against the raw client: the worker's outbox
    # facade would buffer the failures instead of raising them
    w.client = client
    w._uncommitted = list(shards)
    return w


def test_graceful_leave_continues_past_transient_failure(tmp_path):
    from edl_tpu_torch.coordinator import CoordinatorError

    client = _FlakyDrainClient([True, CoordinatorError("blip"), True, True])
    w = _drain_worker(tmp_path, client, ["s0", "s1", "s2", "s3"])
    with pytest.raises(SystemExit) as ei:
        w._graceful_leave()
    assert ei.value.code == 0
    assert client.attempted == ["s0", "s1", "s2", "s3"]
    assert client.left and w._uncommitted == []


def test_graceful_leave_stops_when_coordinator_gone(tmp_path):
    from edl_tpu_torch.coordinator import CoordinatorError

    client = _FlakyDrainClient([CoordinatorError("down"), CoordinatorError("down"), True])
    w = _drain_worker(tmp_path, client, ["s0", "s1", "s2", "s3"])
    with pytest.raises(SystemExit):
        w._graceful_leave()
    assert client.attempted == ["s0", "s1"]


def test_a_leaving_rank_waits_for_the_plan_not_its_own_epoch_move(tmp_path):
    """A rank > 0 that left on SIGTERM polls the next round with the watch
    off: the epoch move its own leave caused is not a stop, the plan rank
    0 publishes is (here: a plan with tasks, which the rank must run)."""
    from edl_tpu_torch.coordinator import InProcessCoordinator

    coord = InProcessCoordinator()
    w1 = coord.client("w1")
    ep = int(w1.register()["epoch"])
    w = _make_worker("torch", w1, tmp_path)
    w._epoch = ep
    w._watch_moved = True  # the push of this rank's own leave
    assert w._poll_round(ep, 0, timeout=0.3) == {"stop": "rescale"}
    coord.client("w0").kv_put(f"edl/mh_round/{ep}/1", json.dumps({"tasks": ["a"]}))
    assert w._poll_round(ep, 1, timeout=5.0, watch=False) == {"tasks": ["a"]}
    assert w._poll_round(ep, 2, timeout=0.3, watch=False) == {"stop": "rescale"}
