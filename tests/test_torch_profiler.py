"""The step profiler, trace capture, memory stats, MFU accounting, the
coordinator status bridge and the obs smoke of the port (`tools.profiler`,
`tools.mfu`, `obs.bridge`, `obs.__main__`) against the JAX package's.

Both profilers read ``time.perf_counter`` through the ``time`` module, so
one scripted clock patched there drives both; their summaries must be
equal dicts, float for float (the arithmetic is the same Python)."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from edl_tpu import models as jax_models
from edl_tpu.models import fit_a_line as jax_fit
from edl_tpu.obs.bridge import CoordinatorStatusBridge as JaxBridge
from edl_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from edl_tpu.parallel import MeshSpec as JaxMeshSpec
from edl_tpu.parallel import build_mesh as jax_build_mesh
from edl_tpu.runtime import Trainer as JaxTrainer, TrainerConfig as JaxConfig
from edl_tpu.tools import mfu as jax_mfu
from edl_tpu.tools import profiler as jax_profiler
from edl_tpu_torch import models as torch_models
from edl_tpu_torch.models import fit_a_line
from edl_tpu_torch.obs.bridge import CoordinatorStatusBridge
from edl_tpu_torch.obs.metrics import MetricsRegistry
from edl_tpu_torch.runtime import Trainer, TrainerConfig
from edl_tpu_torch.tools import mfu, profiler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Clock:
    """``time.perf_counter`` replaced by a scripted sequence of readings."""

    def __init__(self, readings):
        self.readings, self.i = list(readings), 0

    def __call__(self):
        value = self.readings[self.i]
        self.i += 1
        return value


def _stream(n, seed):
    """``n`` steps: host readings (a start, then one a step), samples,
    losses, place and collective seconds, from a seed."""
    rng = np.random.default_rng(seed)
    marks = np.cumsum(rng.uniform(1e-3, 5e-2, n + 1)).tolist()
    return {"marks": marks,
            "samples": rng.integers(1, 512, n).tolist(),
            "loss": rng.uniform(0.1, 3.0, n).tolist(),
            "place": rng.uniform(1e-5, 1e-3, n).tolist(),
            "coll": [2.5e-4] * n}


#: name -> (profiler kwargs, steps, mark_warmup calls {step index: n}, feed
#: place/collective seconds, set model, set data_plane)
SUMMARY_CASES = {
    "empty": (dict(warmup=1), 0, {}, False, False, False),
    "all_warmup": (dict(warmup=3), 2, {}, False, False, False),
    "warmup": (dict(warmup=2), 12, {5: 2, 9: 1}, False, False, False),
    "window": (dict(warmup=1, window=5), 12, {}, False, False, False),
    "place_and_collective": (dict(warmup=1), 9, {4: 1}, True, False, False),
    "model_and_data_plane": (dict(warmup=1), 8, {}, True, True, True),
    "n_chips_4": (dict(warmup=1, n_chips=4), 8, {}, False, True, False),
}


def _feed(module, case, models, sink):
    kw, n, warmups, timings, with_model, with_plane = SUMMARY_CASES[case]
    s = _stream(n, seed=len(case))
    prof = module.StepProfiler(sink=sink, **kw)
    if with_model:
        prof.model = models["fit_a_line"]
    if with_plane:
        prof.data_plane = {"grad_bytes_per_step": 4096, "bytes_per_step": 8192}
    clock = Clock(s["marks"])
    orig = module.time.perf_counter
    module.time.perf_counter = clock
    try:
        prof.start()
        for i in range(n):
            if i in warmups:
                prof.mark_warmup(warmups[i])
            prof.step(s["samples"][i], loss=s["loss"][i],
                      place_seconds=s["place"][i] if timings else None,
                      collective_seconds=s["coll"][i] if timings else None)
    finally:
        module.time.perf_counter = orig
    return prof


@pytest.mark.parametrize("case", sorted(SUMMARY_CASES))
def test_the_step_profiler_summarises_as_jax_does(case, tmp_path):
    """The same step stream (host readings, samples, losses, warm-up marks,
    placement and collective seconds) into both profilers: equal
    summaries, records and JSONL sink lines, the empty summary's keys
    included, and the window bounding the records."""
    sinks = {name: open(tmp_path / f"{name}.jsonl", "w") for name in ("jax", "port")}
    want = _feed(jax_profiler, case, {"fit_a_line": jax_fit.MODEL}, sinks["jax"])
    got = _feed(profiler, case, {"fit_a_line": fit_a_line.MODEL}, sinks["port"])
    for f in sinks.values():
        f.close()
    assert got.summary() == want.summary()
    assert [r.to_dict() for r in got.records] == [r.to_dict() for r in want.records]
    assert [r.warmup for r in got.records] == [r.warmup for r in want.records]
    assert (tmp_path / "port.jsonl").read_text() == (tmp_path / "jax.jsonl").read_text()
    summary = got.summary()
    if case == "window":
        assert len(got.records) == 5 and summary["steps"] == 12.0
    if case in ("empty", "all_warmup"):
        assert summary["steady_steps"] == 0.0
        assert all(v == 0.0 for k, v in summary.items() if k not in ("steps",))
    if case in ("model_and_data_plane", "n_chips_4"):
        assert summary["tflops_per_sec"] > 0 and "mfu" not in summary  # no peak off the card


def test_trainer_run_fills_the_profiler_as_jax_does():
    """``Trainer.run(profiler=...)`` on fit_a_line in both packages: the
    same summary keys (model, data plane and MFU fields filled from the
    Trainer), the same step counts and the same ``grad_bytes_per_step``."""
    batches = [fit_a_line.MODEL.synthetic_batch(np.random.default_rng(i), 32)
               for i in range(6)]
    mesh = jax_build_mesh(JaxMeshSpec({"data": 1}), jax.devices()[:1])
    jax_trainer = JaxTrainer(jax_fit.MODEL, mesh, JaxConfig(optimizer="sgd",
                                                           learning_rate=0.05))
    jprof = jax_profiler.StepProfiler(warmup=1)
    _, jmetrics = jax_trainer.run(jax_trainer.init_state(), iter(batches), profiler=jprof)
    trainer = Trainer(fit_a_line.MODEL, device="cpu",
                      config=TrainerConfig(optimizer="sgd", learning_rate=0.05))
    prof = profiler.StepProfiler(warmup=1)
    _, metrics = trainer.run(trainer.init_state(), iter(batches), profiler=prof)
    want, got = jprof.summary(), prof.summary()
    assert set(got) == set(want)
    for key in ("steps", "steady_steps", "grad_bytes_per_step", "data_plane_bytes_per_step",
                "collective_time_est_mean_s"):
        assert got[key] == want[key], key
    assert got["steps"] == metrics["steps"] == jmetrics["steps"] == 6.0
    assert prof.model is fit_a_line.MODEL and prof.n_chips == 1
    assert prof.device == torch.device("cpu")
    assert prof.data_plane["grad_bytes_per_step"] == metrics["grad_bytes_per_step"]
    # an explicit value is never overwritten
    other = torch_models.get("word2vec")
    kept = profiler.StepProfiler(n_chips=4, model=other)
    trainer.run(trainer.init_state(), iter(batches[:2]), profiler=kept)
    assert kept.n_chips == 4 and kept.model is other


def test_trace_writes_a_trace_and_a_running_profiler_makes_it_a_no_op(tmp_path, caplog):
    """`trace` writes a TensorBoard-loadable trace on the CPU, holding the
    step and annotation ranges; inside a running profiler it logs a
    warning and writes nothing, as the JAX guard degrades."""
    logdir = tmp_path / "trace"
    with profiler.trace(str(logdir)):
        with profiler.annotate_step(3), profiler.annotation("place_batch"):
            (torch.randn(16, 16) @ torch.randn(16, 16)).sum()
    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    names = {e.get("name") for e in json.load(open(logdir / files[0]))["traceEvents"]}
    assert {"train#3", "place_batch", "aten::mm"} <= names
    nested = tmp_path / "nested"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with caplog.at_level("WARNING", logger="edl_tpu_torch.tools.profiler"):
            with profiler.trace(str(nested)):
                torch.ones(4).sum()
    assert not nested.exists()
    assert "a profiler is already running" in caplog.text
    with pytest.raises(ValueError, match="from the block"):  # the block's errors propagate
        with profiler.trace(str(tmp_path / "raising")):
            raise ValueError("from the block")


def test_device_memory_stats_report_nothing_on_the_cpu_as_jax_does():
    assert profiler.device_memory_stats() == jax_profiler.device_memory_stats() == {}


MFU_MODELS = ("fit_a_line", "word2vec", "mnist", "ctr", "resnet50")


@pytest.mark.parametrize("n_chips", [1, 4])
@pytest.mark.parametrize("name", MFU_MODELS)
def test_mfu_fields_round_as_jax_does(name, n_chips, monkeypatch):
    """`mfu_fields` at 1 and 4 chips against the JAX version, exactly:
    achieved TFLOP/s a chip over ``n_chips``, rounded to 3 decimals but
    never a positive rate to 0, MFU to 4 decimals. Off the card both have
    no peak; with the port on an H100 (989 TFLOP/s) and the JAX version
    told that peak through its ``EDL_TPU_PEAK_TFLOPS`` override, the MFU
    too. Rates from a tiny one (a rate that rounds to 0) to a large one."""
    model, jmodel = torch_models.get(name), jax_models.get(name)
    cpu = jax.devices("cpu")[0]
    for rate in (1e-3, 0.37, 100.0, 25_000.0):
        for batch in (1, 64):
            want = jax_mfu.mfu_fields(jmodel, batch, rate, n_chips=n_chips, device=cpu)
            got = mfu.mfu_fields(model, batch, rate, n_chips=n_chips, device="cpu")
            assert got == want, (rate, batch)
    assert jax_mfu.mfu_fields(jmodel, 1, 1e-3, n_chips=n_chips, device=cpu)[
        "tflops_per_sec"] > 0
    monkeypatch.setenv("EDL_TPU_PEAK_TFLOPS", "989")
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    for rate in (0.37, 100.0, 25_000.0):
        want = jax_mfu.mfu_fields(jmodel, 64, rate, n_chips=n_chips, device=cpu)
        got = mfu.mfu_fields(model, 64, rate, n_chips=n_chips, device="cuda:0")
        assert got == want and got["mfu"] is not None, rate


class StubStatus:
    """A coordinator client whose ``call("status")`` returns scripted
    replies (an exception to raise stands for an unreachable one)."""

    def __init__(self, replies):
        self.replies = list(replies)

    def call(self, op, timeout=None):
        assert op == "status"
        reply = self.replies.pop(0)
        if isinstance(reply, Exception):
            raise reply
        return dict(reply)


STATUS = {"ok": True, "epoch": 7, "world": 2, "queued": 3, "leased": 2, "done": 11,
          "ops": 4242, "batch_frames": 17, "batch_subops": 90, "fsyncs": 5,
          "snapshots": 1, "journal_records": 310, "turns": 9000, "uptime_seconds": 12.5,
          "lease_holders": ["trainer-0=1", "trainer-1=1", "bad", "trainer-2=x"],
          "members": ["trainer-0", "trainer-1"]}


def _coordinator_lines(registry) -> list:
    return [line for line in registry.render_prometheus().splitlines()
            if "edl_coordinator_" in line]


def test_the_status_bridge_renders_what_the_jax_bridge_renders():
    """Both bridges read the same status replies from a stub client: a
    full reply, one where a lease holder dropped out (its series set to 0),
    an unreachable coordinator (``up`` 0, last values kept) and a refused
    reply. After each scrape the ``edl_coordinator_*`` samples are the
    same lines."""
    dropped = dict(STATUS, lease_holders=["trainer-0=2"], ops=4300)
    replies = [STATUS, dropped, ConnectionError("down"), {"ok": False}, STATUS]
    jreg, reg = JaxRegistry(), MetricsRegistry()
    jbridge = JaxBridge(StubStatus(replies), registry=jreg).register()
    bridge = CoordinatorStatusBridge(StubStatus(replies), registry=reg).register()
    scrapes = []
    for _ in replies:
        want, got = _coordinator_lines(jreg), _coordinator_lines(reg)
        assert got == want
        scrapes.append("\n".join(got))
    assert "edl_coordinator_up 1" in scrapes[0] and "edl_coordinator_ops 4242" in scrapes[0]
    assert 'edl_coordinator_worker_leases{worker="trainer-1"} 0' in scrapes[1]
    assert "edl_coordinator_up 0" in scrapes[2] and "edl_coordinator_ops 4300" in scrapes[2]
    assert "edl_coordinator_up 0" in scrapes[3]
    bridge.unregister()
    jbridge.unregister()
    assert _coordinator_lines(reg) == _coordinator_lines(jreg)


def test_the_obs_smoke_scrapes_every_required_family():
    """``python -m edl_tpu_torch.obs --device cpu``: the native coordinator,
    an `ElasticWorker` with a `StepProfiler` and ``metrics_port=0``, scraped
    over HTTP while it trains; the JAX smoke's required families."""
    from edl_tpu.obs.__main__ import REQUIRED_FAMILIES as JAX_FAMILIES
    from edl_tpu_torch.obs.__main__ import REQUIRED_FAMILIES

    assert REQUIRED_FAMILIES == JAX_FAMILIES
    out = subprocess.run([sys.executable, "-m", "edl_tpu_torch.obs", "--device", "cpu"],
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT},
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "obs-smoke: OK" in out.stdout and "16 steps trained on cpu" in out.stdout
