"""The port's `ElasticWorker` (`edl_tpu_torch.runtime.elastic`) against the
JAX package's.

Both workers train the same shard queue under the same deterministic
membership script, driven from ``step_callback`` rather than wall-clock
sleeps: after step 10 a second member registers and follows the
rendezvous, after step 30 it leaves. The JAX worker runs on its 8-device
CPU mesh at every world size (``device_planner=lambda w: jax.devices()``),
the port's on its one device (the CPU) with a world-1 local mesh; the
global batch, and so the math, is the same. Placement is synchronous
(``pipeline_depth=0``) on both, so each interrupt falls after the same
step. They must agree on the rescale sequence (from, to, at step), the
shards read and replayed, the step count, the metric keys of ``run()``,
the span names under each rescale trace id (all eight `RESCALE_PHASES`),
and the losses:

- fit_a_line (SGD, f32): rel 1e-4 (the JAX worker sums its gradients over
  8 devices; measured at most 1.2e-5 over the 54 steps);
- CTR at sparse dim 1000, batch 64 (adagrad, bf16 MLP matmuls, each side
  rounding its activations at its own places, as `test_torch_ctr.py`
  describes): rel 2e-2 (measured at most 3.7e-4 over the 54 steps).

The port's restored state is held bit for bit against the state saved at
each rescale barrier. The ported cases of ``tests/test_elastic.py`` (kill
-9 replays exactly the uncommitted shards, a wire overflow exits 75, the
epoch-discovery knob and the watch) and the preempt drain of
``tests/test_preempt.py`` follow.
"""

import json
import os
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from edl_tpu.coordinator import InProcessCoordinator as JaxCoordinator
from edl_tpu.models import ctr as jax_ctr
from edl_tpu.models import fit_a_line as jax_fit
from edl_tpu.obs.tracing import Tracer as JaxTracer
from edl_tpu.parallel import MeshSpec as JaxMeshSpec
from edl_tpu.parallel import build_mesh as jax_build_mesh
from edl_tpu.runtime import Trainer as JaxTrainer, TrainerConfig as JaxConfig
from edl_tpu.runtime import elastic as jax_elastic
from edl_tpu.runtime.data import SyntheticShardSource as JaxSource
from edl_tpu_torch.coordinator import InProcessCoordinator
from edl_tpu_torch.models import ctr, fit_a_line
from edl_tpu_torch.models.convert import tree_params_from_jax
from edl_tpu_torch.obs.tracing import RESCALE_PHASES, Tracer, rescale_timeline
from edl_tpu_torch.runtime import elastic
from edl_tpu_torch.runtime.data import SyntheticShardSource, shard_names
from edl_tpu_torch.runtime.elastic import ElasticConfig, ElasticWorker
from edl_tpu_torch.runtime.train_loop import Trainer, TrainerConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_AT, LEAVE_AT = 10, 30
CASES = {
    # model, optimizer kwargs, batch, batches a shard, loss rtol
    "fit_a_line": (lambda: jax_fit.MODEL, lambda: fit_a_line.MODEL,
                   dict(optimizer="sgd", learning_rate=0.05), 32, 8, 1e-4),
    "ctr": (lambda: jax_ctr.make_model(sparse_dim=1000),
            lambda: ctr.make_model(sparse_dim=1000),
            dict(optimizer="adagrad", learning_rate=0.05), 64, 8, 2e-2),
}


class Membership:
    """The membership script, as a step_callback: a second member joins
    after step ``JOIN_AT`` (registering bumps the epoch; a thread follows
    the rendezvous as a real trainer would) and leaves after ``LEAVE_AT``."""

    def __init__(self, coord):
        self.coord = coord
        self.stop = threading.Event()
        self.thread = None
        self.client = None
        self.fired = set()

    def _follow(self, epoch):
        c = self.client
        while not self.stop.is_set():
            reply = c.sync(epoch, timeout=5.0)
            if reply.get("ok"):
                break
            epoch = reply.get("epoch", epoch)
        while not self.stop.is_set():
            hb = c.heartbeat()
            if hb.get("ok") and hb["epoch"] != epoch:
                epoch = hb["epoch"]
                c.sync(epoch, timeout=5.0)
            time.sleep(0.02)

    def __call__(self, step, state):
        if step == JOIN_AT and "join" not in self.fired:
            self.fired.add("join")
            self.client = self.coord.client("trainer-1")
            info = self.client.register()
            self.thread = threading.Thread(target=self._follow, args=(info["epoch"],),
                                           daemon=True)
            self.thread.start()
        elif step == LEAVE_AT and "leave" not in self.fired:
            self.fired.add("leave")
            self.stop.set()
            self.thread.join(timeout=30)
            self.client.leave()

    def close(self):
        self.stop.set()
        if self.thread is not None:
            self.thread.join(timeout=30)


class Recording:
    """A shard source that records every shard read (a replay reads twice)."""

    def __init__(self, inner):
        self.inner, self.reads = inner, []

    def read(self, shard):
        self.reads.append(shard)
        return self.inner.read(shard)

    def batch_count(self, shard):
        return self.inner.batch_count(shard)


def _summary(worker, metrics, source, tracer, admin):
    timeline = rescale_timeline(json.loads(line) for line in tracer.to_jsonl().splitlines())
    return {
        "rescales": [(r.from_world, r.to_world, r.at_step) for r in worker.rescales],
        "warmed": [r.compile_seconds > 0 for r in worker.rescales],
        "reads": source.reads,
        "replayed": sorted({s for s in source.reads if source.reads.count(s) > 1}),
        "steps": worker.steps_done,
        "keys": set(metrics),
        "phases": {tid: set(t["phases"]) for tid, t in timeline.items()},
        "losses": np.asarray(worker.losses, np.float64),
        "status": {k: admin.status()[k] for k in ("done", "queued", "leased")},
    }


def _run_jax(case, tmp_path):
    jmodel, _, opt, batch, bps, _ = CASES[case]
    model = jmodel()
    coord = JaxCoordinator(task_lease_sec=60.0, heartbeat_ttl_sec=60.0)
    admin = coord.client("admin")
    admin.add_tasks(shard_names("el", 6))
    script = Membership(coord)
    source = Recording(JaxSource(model, batch_size=batch, batches_per_shard=bps))
    tracer = JaxTracer()
    cfg = jax_elastic.ElasticConfig(
        checkpoint_dir=str(tmp_path / "jax-ck"), checkpoint_interval=5,
        heartbeat_interval=0.0, rescale_barrier_timeout=30.0, pipeline_depth=0,
        step_callback=script, trainer=JaxConfig(**opt))
    worker = jax_elastic.ElasticWorker(model, coord.client("trainer-0"), source, cfg,
                                       device_planner=lambda w: jax.devices(),
                                       tracer=tracer)
    try:
        metrics = worker.run()
    finally:
        script.close()
    return _summary(worker, metrics, source, tracer, admin)


def _jax_init(case):
    jmodel, _, opt, _, _, _ = CASES[case]
    mesh = jax_build_mesh(JaxMeshSpec({"data": 1}), jax.devices()[:1])
    state = JaxTrainer(jmodel(), mesh, JaxConfig(**opt)).init_state()
    return tree_params_from_jax(jax.device_get(state.params))


def _run_port(case, tmp_path, monkeypatch):
    _, tmodel, opt, batch, bps, _ = CASES[case]
    init = _jax_init(case)
    orig = Trainer.init_state

    def init_from_jax(self, generator=None):
        state = orig(self, generator)
        state.params.load_state_dict(init)  # the JAX package's initial params
        return state

    monkeypatch.setattr(Trainer, "init_state", init_from_jax)
    model = tmodel()
    coord = InProcessCoordinator(task_lease_sec=60.0, heartbeat_ttl_sec=60.0)
    admin = coord.client("admin")
    admin.add_tasks(shard_names("el", 6))
    script = Membership(coord)
    source = Recording(SyntheticShardSource(model, batch_size=batch, batches_per_shard=bps))
    tracer = Tracer()
    cfg = ElasticConfig(
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_interval=5,
        heartbeat_interval=0.0, rescale_barrier_timeout=30.0, pipeline_depth=0,
        step_callback=script, trainer=TrainerConfig(**opt))
    worker = ElasticWorker(model, coord.client("trainer-0"), source, cfg, device="cpu",
                           tracer=tracer)
    # the state saved at every blocking save, and the state right after
    # every restore: a rescale must restore what its barrier saved
    saved, restored = {}, []
    orig_ckpt, orig_restore = worker._checkpoint, worker._restore_or_init

    def checkpoint(state, block=False):
        orig_ckpt(state, block=block)
        if block:
            saved[int(state.step)] = worker._trainer.full_state(state)

    def restore(trainer, fresh):
        state = orig_restore(trainer, fresh)
        restored.append(trainer.full_state(state))
        return state

    worker._checkpoint, worker._restore_or_init = checkpoint, restore
    try:
        metrics = worker.run()
    finally:
        script.close()
    return _summary(worker, metrics, source, tracer, admin), saved, restored


def _assert_full_equal(a, b):
    assert a["step"] == b["step"]
    for k in a["module"]:
        assert torch.equal(a["module"][k], b["module"][k]), k
    for i, per in a["optimizer"]["state"].items():
        for k, v in per.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k]), (i, k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_port_rescales_as_the_jax_worker_does(case, tmp_path, monkeypatch):
    want = _run_jax(case, tmp_path)
    got, saved, restored = _run_port(case, tmp_path, monkeypatch)
    bps = CASES[case][4]

    # two rescales, 1 -> 2 and 2 -> 1, after the same steps
    assert got["rescales"] == want["rescales"]
    assert got["warmed"] == want["warmed"] == [True, True]  # warm-up beside each restore
    assert [(f, t) for f, t, _ in got["rescales"]] == [(1, 2), (2, 1)]
    assert got["reads"] == want["reads"]
    assert got["replayed"] == want["replayed"] and len(got["replayed"]) == 2
    assert got["steps"] == want["steps"] > 6 * bps  # the interrupted shards replay
    assert got["keys"] == want["keys"]
    assert got["phases"] == want["phases"]
    rescale_ids = [tid for tid, names in got["phases"].items() if "drain" in names]
    assert len(rescale_ids) == 2
    for tid in rescale_ids:
        assert set(RESCALE_PHASES) <= got["phases"][tid], tid
    assert got["status"] == want["status"] == {"done": 6, "queued": 0, "leased": 0}
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=CASES[case][5])
    assert np.isfinite(got["losses"]).all()
    assert got["losses"][-bps:].mean() < got["losses"][:bps].mean()
    # the cold start restores nothing; each rescale restores its barrier's save
    assert len(restored) == 3 and restored[0]["step"] == 0
    for full in restored[1:]:
        _assert_full_equal(full, saved[full["step"]])


def test_the_port_reports_rescale_events_with_jax_fields():
    import dataclasses

    assert [f.name for f in dataclasses.fields(elastic.RescaleEvent)] == \
        [f.name for f in dataclasses.fields(jax_elastic.RescaleEvent)]
    assert [f.name for f in dataclasses.fields(ElasticConfig)] == \
        [f.name for f in dataclasses.fields(jax_elastic.ElasticConfig)]
    for name in ("w0", "trainer-7"):
        assert elastic.heartbeat_schedule(name, 1.0, 0.2, 16) == \
            jax_elastic.heartbeat_schedule(name, 1.0, 0.2, 16)


def _one_device_plan(n, devices):
    """A planner's plan for ``n`` devices of one node (`plan_layout` with the
    port's H100 defaults)."""
    from edl_tpu_torch.parallel import ModelProfile, Topology, plan_layout

    return plan_layout(n, Topology(slices=(n,)), ModelProfile(param_bytes=1e6), 8,
                       schedules=())


def _fit_source(pkg_source, model, bps=4):
    return pkg_source(model, batch_size=32, batches_per_shard=bps)


def _profiled_runs(tmp_path):
    """fit_a_line over 2 shards x 4 batches with a `StepProfiler`: the JAX
    `ElasticWorker`'s metrics, and both port workers' (the
    `MultiHostWorker` as rank 0 of world 1, no process group)."""
    from edl_tpu.tools.profiler import StepProfiler as JaxStepProfiler
    from edl_tpu_torch.runtime.multihost import MultiHostWorker
    from edl_tpu_torch.tools import StepProfiler

    opt = dict(optimizer="sgd", learning_rate=0.05)
    jcoord = JaxCoordinator(task_lease_sec=60.0, heartbeat_ttl_sec=60.0)
    jcoord.client("admin").add_tasks(shard_names("pf", 2))
    jax_worker = jax_elastic.ElasticWorker(
        jax_fit.MODEL, jcoord.client("w"), _fit_source(JaxSource, jax_fit.MODEL),
        jax_elastic.ElasticConfig(checkpoint_dir=str(tmp_path / "jax-ck"),
                                  heartbeat_interval=0.0, trainer=JaxConfig(**opt)),
        device_planner=lambda w: jax.devices()[:1], profiler=JaxStepProfiler(warmup=1))
    runs = {"jax": jax_worker.run()}
    for cls in (ElasticWorker, MultiHostWorker):
        coord = InProcessCoordinator(task_lease_sec=60.0, heartbeat_ttl_sec=60.0)
        coord.client("admin").add_tasks(shard_names("pf", 2))
        worker = cls(fit_a_line.MODEL, coord.client("w"),
                     _fit_source(SyntheticShardSource, fit_a_line.MODEL),
                     ElasticConfig(checkpoint_dir=str(tmp_path / cls.__name__),
                                   heartbeat_interval=0.0, trainer=TrainerConfig(**opt)),
                     device="cpu", profiler=StepProfiler(warmup=1))
        runs[cls.__name__] = worker.run()
    return runs


def _uncached_runs(tmp_path):
    """``compile_cache_dir`` set: the port's `ElasticWorker` through a
    rescale (a second member joins after step 10) and its
    `MultiHostWorker`; the JAX `ElasticWorker` without a cache through the
    same rescale. Returns (the port's rescale events, the JAX worker's,
    the port's warm-up spans' ``cache``, the `MultiHostWorker`'s Trainer)."""
    from edl_tpu_torch.runtime.multihost import MultiHostWorker

    opt = dict(optimizer="sgd", learning_rate=0.05)
    cache = str(tmp_path / "cache")
    jcoord = JaxCoordinator(task_lease_sec=60.0, heartbeat_ttl_sec=60.0)
    jcoord.client("admin").add_tasks(shard_names("cc", 2))
    jscript = Membership(jcoord)
    jax_worker = jax_elastic.ElasticWorker(
        jax_fit.MODEL, jcoord.client("trainer-0"), _fit_source(JaxSource, jax_fit.MODEL, 8),
        jax_elastic.ElasticConfig(checkpoint_dir=str(tmp_path / "jax-ck"),
                                  checkpoint_interval=5, heartbeat_interval=0.0,
                                  pipeline_depth=0, step_callback=jscript,
                                  trainer=JaxConfig(**opt)),
        device_planner=lambda w: jax.devices()[:1])
    try:
        jax_worker.run()
    finally:
        jscript.close()
    coord = InProcessCoordinator(task_lease_sec=60.0, heartbeat_ttl_sec=60.0)
    coord.client("admin").add_tasks(shard_names("cc", 2))
    script, tracer = Membership(coord), Tracer()
    worker = ElasticWorker(
        fit_a_line.MODEL, coord.client("trainer-0"),
        _fit_source(SyntheticShardSource, fit_a_line.MODEL, 8),
        ElasticConfig(checkpoint_dir=str(tmp_path / "ck"), checkpoint_interval=5,
                      heartbeat_interval=0.0, pipeline_depth=0, step_callback=script,
                      compile_cache_dir=cache, trainer=TrainerConfig(**opt)),
        device="cpu", tracer=tracer)
    try:
        worker.run()
    finally:
        script.close()
    spans = [json.loads(line) for line in tracer.to_jsonl().splitlines()]
    warm = [sp["attrs"].get("cache") for sp in spans if sp["name"] == "warm_compile"]
    coord = InProcessCoordinator(task_lease_sec=60.0, heartbeat_ttl_sec=60.0)
    coord.client("admin").add_tasks(shard_names("cc", 2))
    mh = MultiHostWorker(fit_a_line.MODEL, coord.client("w"),
                         _fit_source(SyntheticShardSource, fit_a_line.MODEL),
                         ElasticConfig(checkpoint_dir=str(tmp_path / "mh-ck"),
                                       heartbeat_interval=0.0, compile_cache_dir=cache,
                                       trainer=TrainerConfig(**opt)),
                         device="cpu")
    assert mh.run()["steps"] == 8.0
    assert not os.path.exists(cache)  # accepted, and nothing written
    return worker.rescales, jax_worker.rescales, warm, mh.ckpt.trainer


@pytest.mark.parametrize("kw", [dict(layout_planner=_one_device_plan),
                                dict(profiler=True),
                                dict(mesh_axes={"model": 2}),
                                dict(mesh_axes={"seq": 2, "data": 4}),
                                dict(compile_cache_dir=True)],
                         ids=["layout_planner", "profiler", "model_axis", "seq_axis",
                              "compile_cache_dir"])
def test_what_is_not_ported_raises_naming_the_roadmap_item(kw, tmp_path):
    """What ROADMAP.md queue A item 4 left out is ported now: no worker
    raises for want of a port. ``profiler``: both port workers run
    fit_a_line with a `StepProfiler` and report the JAX `ElasticWorker`'s
    ``profile_*`` keys with its step counts (a cold start's first step is
    warm-up). ``compile_cache_dir``: accepted and unused by both workers;
    the `ElasticWorker`'s rescale and its warm-up span report
    ``compile_cache`` "off", as the JAX worker without a cache reports it
    through the same rescale, and the `MultiHostWorker`'s Trainer reads
    "off". The layout cases hold the JAX workers' behaviour: a fixed axis
    that one device does not divide raises the JAX ``ValueError`` with its
    message (the JAX `ElasticWorker` given one device, and the port's
    `MultiHostWorker` without a process group, one rank), and a
    ``layout_planner`` is accepted and its plan built."""
    from edl_tpu_torch.runtime.multihost import MultiHostWorker

    cfg = ElasticConfig(checkpoint_dir=str(tmp_path / "ck"))
    coord = InProcessCoordinator()
    workers = (ElasticWorker, MultiHostWorker)
    if "mesh_axes" in kw:
        jax_worker = jax_elastic.ElasticWorker(
            jax_fit.MODEL, JaxCoordinator().client("w"), None,
            jax_elastic.ElasticConfig(checkpoint_dir=str(tmp_path / "jax-ck")),
            device_planner=lambda w: jax.devices()[:1], **kw)
        with pytest.raises(ValueError) as want:
            jax_worker._build_mesh(1)
        assert "devices not divisible by fixed axes" in str(want.value)
        for cls in workers:
            worker = cls(fit_a_line.MODEL, coord.client("w"), None, cfg, device="cpu", **kw)
            with pytest.raises(ValueError) as got:
                worker._build_mesh(1)
            assert str(got.value) == str(want.value), cls
    elif "layout_planner" in kw:
        for cls in workers:
            worker = cls(fit_a_line.MODEL, coord.client("w"), None, cfg, device="cpu", **kw)
            assert worker._build_mesh(1).shape == {"data": 1}
            assert worker.last_plan.mesh_axes == (("data", 1),)
            assert worker._trainer_config() is cfg.trainer  # batch axis "data" kept
    elif "profiler" in kw:
        runs = _profiled_runs(tmp_path)
        want = {k: v for k, v in runs.pop("jax").items() if k.startswith("profile_")}
        assert want["profile_steps"] == 8.0 and want["profile_steady_steps"] == 7.0
        for name, metrics in runs.items():
            got = {k: v for k, v in metrics.items() if k.startswith("profile_")}
            assert set(got) == set(want), name
            for key in ("profile_steps", "profile_steady_steps"):
                assert got[key] == want[key], (name, key)
            assert metrics["steps"] == 8.0, name
            assert all(np.isfinite(v) and v >= 0 for v in got.values()), name
    else:
        events, jax_events, warm, mh_trainer = _uncached_runs(tmp_path)
        assert [(e.from_world, e.to_world) for e in events] == \
            [(e.from_world, e.to_world) for e in jax_events] == [(1, 2)]
        assert [e.compile_cache for e in events] == \
            [e.compile_cache for e in jax_events] == ["off"]
        assert warm == ["off"]
        assert mh_trainer.last_compile_cache == "off"
    # a size-1 axis is no parallelism: accepted
    worker = ElasticWorker(fit_a_line.MODEL, coord.client("w"), None,
                           ElasticConfig(checkpoint_dir=str(tmp_path / "ck")), device="cpu",
                           mesh_axes={"model": 1})
    assert worker._build_mesh(1).shape == {"model": 1, "data": 1}


def test_a_static_and_a_searched_layout_together_raise_as_jax_does(tmp_path):
    from edl_tpu_torch.runtime.multihost import MultiHostWorker
    from edl_tpu.runtime.multihost import MultiHostWorker as JaxMultiHostWorker

    kw = dict(mesh_axes={"pipe": 2}, layout_planner=_one_device_plan)
    messages = set()
    for cls, extra, coord in ((jax_elastic.ElasticWorker, {}, JaxCoordinator()),
                              (JaxMultiHostWorker, {}, JaxCoordinator()),
                              (ElasticWorker, {"device": "cpu"}, InProcessCoordinator()),
                              (MultiHostWorker, {"device": "cpu"}, InProcessCoordinator())):
        cfg = (jax_elastic.ElasticConfig if cls.__module__.startswith("edl_tpu.")
               else ElasticConfig)(checkpoint_dir=str(tmp_path / cls.__module__))
        with pytest.raises(ValueError) as e:
            cls(fit_a_line.MODEL, coord.client("w"), None, cfg, **extra, **kw)
        messages.add(str(e.value))
    assert len(messages) == 1, messages


def _planned_run(pkg, tmp_path):
    """One short queue through ``pkg``'s `ElasticWorker` with a planner on
    one device: the ``replan`` spans' attributes."""
    if pkg == "jax":
        from edl_tpu.parallel import ModelProfile, Topology, plan_layout

        coord, model, tracer = JaxCoordinator(), jax_fit.MODEL, JaxTracer()
        source = JaxSource(model, batch_size=8, batches_per_shard=2)
        cfg = jax_elastic.ElasticConfig(checkpoint_dir=str(tmp_path / pkg),
                                        heartbeat_interval=0.0, pipeline_depth=0,
                                        trainer=JaxConfig(optimizer="sgd"))
        kw = dict(device_planner=lambda w: jax.devices()[:1])
        cls = jax_elastic.ElasticWorker
    else:
        from edl_tpu_torch.parallel import ModelProfile, Topology, plan_layout

        coord, model, tracer = InProcessCoordinator(), fit_a_line.MODEL, Tracer()
        source = SyntheticShardSource(model, batch_size=8, batches_per_shard=2)
        cfg = ElasticConfig(checkpoint_dir=str(tmp_path / pkg), heartbeat_interval=0.0,
                            pipeline_depth=0, trainer=TrainerConfig(optimizer="sgd"))
        kw = dict(device="cpu")
        cls = ElasticWorker
    topo = Topology(slices=(1,), chip_flops=1e12, hbm_bytes=16 * 2**30, ici_bps=4.5e11,
                    dcn_bps=5e10)
    profile = ModelProfile(param_bytes=56.0, n_layers=1, flops_per_sample=78.0)

    def planner(n, devices):
        return plan_layout(n, topo, profile, 8, schedules=())

    coord.client("admin").add_tasks(shard_names("plan", 2))
    worker = cls(model, coord.client("w0"), source, cfg, tracer=tracer,
                 layout_planner=planner, **kw)
    worker.run()
    spans = [json.loads(line) for line in tracer.to_jsonl().splitlines()]
    return [sp["attrs"] for sp in spans if sp["name"] == "replan"]


def test_a_planner_run_records_the_replan_attributes_jax_does(tmp_path):
    want, got = _planned_run("jax", tmp_path), _planned_run("torch", tmp_path)
    assert len(got) == len(want) == 1
    strip = ("trace_id", "component")
    assert {k: v for k, v in got[0].items() if k not in strip} == \
        {k: v for k, v in want[0].items() if k not in strip}
    assert got[0]["planned"] is True and got[0]["schedule"] == "none"
    assert got[0]["modeled_step_seconds"] > 0


def test_the_worker_raises_without_cuda_unless_the_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default device is real")
    cfg = ElasticConfig(checkpoint_dir=str(tmp_path / "ck"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ElasticWorker(fit_a_line.MODEL, InProcessCoordinator().client("w"), None, cfg)


# -- completion lag: at-least-once across hard crashes -------------------------


WORKER_CRASH_SRC = """
import json, os, sys, time
import torch
torch.set_num_threads(1)
from edl_tpu_torch.coordinator.client import CoordinatorClient
from edl_tpu_torch.models import fit_a_line
from edl_tpu_torch.runtime import ElasticConfig, ElasticWorker, SyntheticShardSource
from edl_tpu_torch.runtime.train_loop import TrainerConfig


class SlowSource(SyntheticShardSource):
    def read(self, shard):
        for b in super().read(shard):
            time.sleep(0.05)  # give the parent a window to SIGKILL mid-run
            yield b


client = CoordinatorClient(port=int(os.environ["PORT"]), worker=os.environ["NAME"])
source = SlowSource(fit_a_line.MODEL, batch_size=8, batches_per_shard=6)
cfg = ElasticConfig(checkpoint_dir=os.environ["CKPT"], checkpoint_interval=6,
                    heartbeat_interval=0.0,
                    trainer=TrainerConfig(optimizer="sgd", learning_rate=0.05))
worker = ElasticWorker(fit_a_line.MODEL, client, source, cfg, device="cpu")
print("METRICS " + json.dumps(worker.run()))
"""


def test_kill9_replays_exactly_uncommitted_shards(tmp_path):
    """SIGKILL a worker mid-run and restart it: completed shards are not
    retrained (their covering checkpoint restores) and every shard not
    completed replays — exactly its batches, no more."""
    from edl_tpu_torch.coordinator import CoordinatorServer

    n_shards, batches_per_shard = 6, 6
    with CoordinatorServer(task_lease_sec=60.0, heartbeat_ttl_sec=60.0) as server:
        admin = server.client("admin")
        admin.add_tasks(shard_names("crash", n_shards))

        def spawn(name):
            env = {**os.environ, "PORT": str(server.port), "NAME": name,
                   "CKPT": str(tmp_path / "ck"), "PYTHONPATH": ROOT,
                   "OMP_NUM_THREADS": "1"}
            return subprocess.Popen([sys.executable, "-c", WORKER_CRASH_SRC], env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)

        p1 = spawn("w0")
        deadline = time.time() + 50
        while time.time() < deadline:
            if int(admin.status().get("done", 0)) >= 2:
                break
            if p1.poll() is not None:
                pytest.fail(f"worker finished before kill:\n{p1.communicate()[1][-2000:]}")
            time.sleep(0.02)
        else:
            p1.kill()
            pytest.fail("worker never committed 2 shards")
        p1.kill()
        p1.wait()
        done_at_kill = int(admin.status()["done"])
        server.client("w0").leave()  # in lieu of waiting out the heartbeat TTL

        p2 = spawn("w1")
        out, err = p2.communicate(timeout=50)
        assert p2.returncode == 0, f"restarted worker failed:\n{err[-3000:]}"
        metrics = json.loads([l for l in out.splitlines()
                              if l.startswith("METRICS ")][0][len("METRICS "):])
        st = admin.status()
    assert int(st["done"]) == n_shards and int(st["queued"]) == 0
    assert metrics["steps"] == float((n_shards - done_at_kill) * batches_per_shard), (
        metrics, done_at_kill)


def test_wire_overflow_exits_for_warm_restart(tmp_path, monkeypatch):
    """A WireRestartRequired mid-run takes the gang warm-restart exit after
    flushing durable state."""
    from edl_tpu_torch.launcher.launch import RESCALE_EXIT_CODE
    from edl_tpu_torch.runtime.wire import WireRestartRequired

    coord = InProcessCoordinator(task_lease_sec=60.0, heartbeat_ttl_sec=60.0)
    client = coord.client("w0")
    client.register()
    client.add_tasks(shard_names("ov", 2))
    model = fit_a_line.MODEL
    worker = ElasticWorker(
        model, client, SyntheticShardSource(model, batch_size=8, batches_per_shard=2),
        ElasticConfig(checkpoint_dir=str(tmp_path / "ck"),
                      trainer=TrainerConfig(optimizer="sgd")), device="cpu")
    orig = Trainer.place_batch
    calls = [0]

    def overflow_on_third(self, batch):
        calls[0] += 1
        if calls[0] == 3:  # mid-second-shard: consumed + in-flight state
            raise WireRestartRequired("sparse")
        return orig(self, batch)

    monkeypatch.setattr(Trainer, "place_batch", overflow_on_third)
    with pytest.raises(SystemExit) as ei:
        worker.run()
    assert ei.value.code == RESCALE_EXIT_CODE
    assert int(client.status()["done"]) == 1


# -- push-based epoch discovery ------------------------------------------------


def _watch_worker(tmp_path, coord, **cfg_kw):
    model = fit_a_line.MODEL
    cfg = ElasticConfig(checkpoint_dir=str(tmp_path / "ck"), heartbeat_interval=30.0,
                        **cfg_kw)
    source = SyntheticShardSource(model, batch_size=8, batches_per_shard=2)
    return ElasticWorker(model, coord.client("trainer-0"), source, cfg, device="cpu")


def test_epoch_discovery_pull_disables_the_watch(tmp_path):
    coord = InProcessCoordinator(task_lease_sec=60.0, heartbeat_ttl_sec=60.0)
    assert _watch_worker(tmp_path, coord, epoch_discovery="pull")._watch is None


def test_watch_interrupts_inside_the_heartbeat_interval(tmp_path):
    coord = InProcessCoordinator(task_lease_sec=60.0, heartbeat_ttl_sec=60.0)
    worker = _watch_worker(tmp_path, coord)
    worker._sync_membership()
    assert worker._watch is not None and worker._watch.connected
    assert worker._epoch_changed() is False
    coord.bump_epoch()
    t0 = time.monotonic()
    assert worker._epoch_changed() is True
    assert time.monotonic() - t0 < 1.0
    assert worker._watch.notifies_total >= 1


def test_watch_dead_subscription_degrades_to_pull(tmp_path):
    coord = InProcessCoordinator(task_lease_sec=60.0, heartbeat_ttl_sec=60.0)
    worker = _watch_worker(tmp_path, coord)
    worker._sync_membership()

    class DeadWatch:
        connected = False
        last_epoch = -1

        def poll(self, timeout=0.0):
            return []

        def subscribe(self, timeout=5.0):
            return False

        def close(self):
            pass

    worker._watch = DeadWatch()
    coord.bump_epoch()
    assert worker._epoch_changed(force=True) is True


# -- advance-notice revocation: zero steps lost --------------------------------


def test_elastic_worker_drains_on_notice_with_zero_steps_lost(tmp_path):
    """trainer-0 trains under world 2, the scheduler revokes it with 30 s of
    notice, the policy picks drain-and-shrink, the worker finishes its
    in-flight shard, evacuates, leaves, and a survivor drains the rest —
    exact step accounting, nothing lost, nothing replayed."""
    model = fit_a_line.MODEL
    n_shards, bps, batch = 6, 6, 16
    coord = InProcessCoordinator(task_lease_sec=60.0, heartbeat_ttl_sec=60.0)
    admin = coord.client("admin")
    admin.add_tasks(shard_names("spot", n_shards))

    def make_worker(name, **cfg):
        return ElasticWorker(
            model, coord.client(name),
            SyntheticShardSource(model, batch_size=batch, batches_per_shard=bps),
            ElasticConfig(checkpoint_dir=str(tmp_path / "ck"), checkpoint_interval=50,
                          heartbeat_interval=0.0, rescale_barrier_timeout=30.0,
                          peer_replicas=1, **cfg), device="cpu")

    def revoke(step, state):
        if step == 3 and not notices:
            notices.append(admin.preempt_notice(["trainer-0"], notice_s=30.0,
                                                reason="spot-reclaim"))

    notices = []
    worker = make_worker("trainer-0", step_callback=revoke)
    stop = threading.Event()

    def follow():
        j = coord.client("trainer-1")
        epoch = j.register()["epoch"]
        while not stop.is_set():
            reply = j.sync(epoch, timeout=5.0)
            if reply.get("ok"):
                break
            epoch = reply.get("epoch", epoch)
        while not stop.is_set():
            hb = j.heartbeat()
            if hb.get("ok") and hb["epoch"] != epoch:
                epoch = hb["epoch"]
                j.sync(epoch, timeout=5.0)
            time.sleep(0.02)

    follower = threading.Thread(target=follow, daemon=True)
    follower.start()
    notices0 = worker.preempt_obs.notices.value(reason="spot-reclaim")
    evict0 = worker.preempt_obs.evictions.value(trigger="revocation")
    doomed = worker.run()
    assert notices == [["trainer-0"]]
    assert doomed["preempted"] == 1.0
    assert doomed["steps_lost"] == 0.0
    assert doomed["preempt_deadline_met"] == 1.0
    assert doomed["notice_to_drained_seconds"] < 30.0
    assert worker.preempt_obs.notices.value(reason="spot-reclaim") == notices0 + 1
    assert worker.preempt_obs.evictions.value(trigger="revocation") == evict0 + 1

    survivor = make_worker("trainer-2")
    try:
        rest = survivor.run()
    finally:
        stop.set()
        follower.join(timeout=10)
    assert doomed["steps"] + rest["steps"] == n_shards * bps
    assert survivor._last_restore["source"] in ("peer", "blob")


# -- the entries ---------------------------------------------------------------

ENTRY_ARGS = {
    "ctr": ["--sparse-feature-dim", "1000", "--batch-size", "64",
            "--batches-per-shard", "2"],
    "lm": ["--vocab-size", "64", "--d-model", "32", "--n-layers", "2", "--n-heads", "2",
           "--d-ff", "64", "--seq-len", "16", "--batch-size", "4", "--shards", "2",
           "--batches-per-shard", "2"],
}


@pytest.mark.parametrize("name", sorted(ENTRY_ARGS))
def test_the_entries_train_locally_as_the_jax_entries_do(name, tmp_path, monkeypatch,
                                                         capsys):
    """Local mode (no coordinator endpoint): each entry trains the whole
    queue with an `ElasticWorker`, and prints the JAX entry's metric keys,
    step count, world and passes (the port on the CPU, asked for)."""
    import importlib
    import runpy

    monkeypatch.delenv("EDL_COORDINATOR_ENDPOINT", raising=False)
    monkeypatch.setenv("EDL_CHECKPOINT_DIR", str(tmp_path / "jax-ck"))
    monkeypatch.setattr(sys, "argv", [name, *ENTRY_ARGS[name]])
    runpy.run_path(os.path.join(ROOT, "examples", name, "train.py"))["main"]()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setenv("EDL_CHECKPOINT_DIR", str(tmp_path / "ck"))
    entry = importlib.import_module(f"edl_tpu_torch.examples.{name}.train")
    entry.main([*ENTRY_ARGS[name], "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    for key in ("steps", "world", "passes_trained", "rescales"):
        assert got[key] == want[key], key
    assert np.isfinite(got["final_loss"])


def test_the_ctr_entry_prepares_trains_from_files_exports_and_infers(tmp_path, monkeypatch,
                                                                      capsys):
    from edl_tpu_torch.examples.ctr import train

    monkeypatch.delenv("EDL_COORDINATOR_ENDPOINT", raising=False)
    monkeypatch.setenv("EDL_CHECKPOINT_DIR", str(tmp_path / "ck"))
    data, export = str(tmp_path / "data"), str(tmp_path / "export")
    common = ["--sparse-feature-dim", "1000", "--batch-size", "64", "--device", "cpu"]
    train.main(["--prepare", "3", "--data-dir", data, "--even", *common])
    prepared = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert prepared["prepared"] == 3 and set(prepared["rows"].values()) == {256}
    train.main(["--data-dir", data, "--export-dir", export, "--export-interval", "4",
                "--zero1", *common])
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["steps"] == 12.0 and metrics["exports"] == 3.0
    train.main(["--infer", "--export-dir", export, *common])
    scored = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert scored["step"] == 12 and scored["examples"] == 64
    assert np.isfinite(scored["logloss"])


@pytest.mark.parametrize("stretch", ["restore", "checkpoint"])
def test_a_restore_or_save_past_the_heartbeat_ttl_keeps_the_member(stretch, tmp_path):
    """The `ElasticWorker`'s restore and its checkpoint saves make no
    coordinator call and grow with the model. Held past the heartbeat TTL, a
    worker that beats only between steps expires, the epoch moves and it
    rescales into the same restore again. It beats on a thread through both
    (`elastic.beating`, shared with the `MultiHostWorker`): here each takes
    3 TTLs of 0.5 s, and the world-1 worker keeps its rank and drains its
    queue with the one epoch move of its own join."""
    coord = InProcessCoordinator(task_lease_sec=60.0, heartbeat_ttl_sec=0.5)
    coord.client("admin").add_tasks(shard_names("ttl", 3))
    client = coord.client("w0")
    worker = ElasticWorker(
        fit_a_line.MODEL, client, _fit_source(SyntheticShardSource, fit_a_line.MODEL, bps=3),
        ElasticConfig(checkpoint_dir=str(tmp_path / "ck"), checkpoint_interval=3,
                      heartbeat_interval=0.1,
                      trainer=TrainerConfig(optimizer="sgd", learning_rate=0.05)),
        device="cpu")
    restore, save = worker._restore_or_init, worker.ckpt.save
    restores = []

    def held(fn):
        def call(*args, **kw):
            time.sleep(1.5)
            return fn(*args, **kw)
        return call

    def counted(*args, **kw):
        # an expired member comes back through another restore, and with
        # a stretch past the TTL it would loop so for ever
        restores.append(time.monotonic())
        if len(restores) > 1:
            raise RuntimeError("the member expired and restored again")
        return (held(restore) if stretch == "restore" else restore)(*args, **kw)

    worker._restore_or_init = counted
    if stretch == "checkpoint":
        worker.ckpt.save = held(save)
    epoch = coord.client("probe").epoch()
    metrics = worker.run()
    assert len(restores) == 1
    assert metrics["steps"] == 9.0 and metrics["world"] == 1.0
    assert metrics["rescales"] == 0.0
