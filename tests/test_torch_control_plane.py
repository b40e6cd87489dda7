"""The port's copies of the control plane against the JAX package's tests.

The copies (`edl_tpu_torch.coordinator.watch`, `.outbox`,
`edl_tpu_torch.runtime.signals`, `edl_tpu_torch.obs.logs`,
`edl_tpu_torch.launcher` and `edl_tpu_torch.api`) run no device work; they
are held by the JAX package's own tests mirrored onto them:
`tests/test_watch_chaos.py` for `EpochWatch`, the outbox cases of
`tests/test_coordinator_outage.py`, `tests/test_api_types.py`, and the
parts of `tests/test_launcher.py` that need no controller. Where the copy
must read its input as the JAX package does (the ``EDL_*`` env protocol,
exit-code reasons, the job-spec round trip), the test compares the two on
the same input. The port's own `ChaosProxy` (`edl_tpu_torch.testing`) is
the fault fixture here.
Every wait has a deadline of its own (at most 10 s a drain, 30 s a join);
semantics are exact.
"""

import dataclasses
import io
import json
import logging
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from edl_tpu.api import TrainingJob as JaxTrainingJob
from edl_tpu.api.validation import normalize as jax_normalize
from edl_tpu.launcher.launch import LaunchContext as JaxLaunchContext
from edl_tpu.launcher.launch import map_exit_code as jax_map_exit_code
from edl_tpu.obs.logs import configure_logging as jax_configure_logging
from edl_tpu_torch.api import (JobPhase, ResourceList, TrainingJob, ValidationError,
                               parse_quantity, set_defaults, validate)
from edl_tpu_torch.api.validation import normalize
from edl_tpu_torch.coordinator import (CoordinatorServer, CoordinatorUnreachable,
                                       InProcessCoordinator, Outbox, OutboxClient,
                                       RetryPolicy)
from edl_tpu_torch.coordinator.client import CoordinatorClient
from edl_tpu_torch.coordinator.server import ShardedCoordinator, free_port
from edl_tpu_torch.coordinator.watch import EpochWatch
from edl_tpu_torch.launcher import launch
from edl_tpu_torch.launcher.launch import (FAILED_COUNT_KEY, LaunchContext,
                                           check_failed_count, map_exit_code,
                                           start_coordinator, start_trainer)
from edl_tpu_torch.obs.logs import configure_logging
from edl_tpu_torch.runtime.data import pass_tasks
from edl_tpu_torch.testing import ChaosProxy

from tests.test_torch_coordinator import has_toolchain


ROOT = str(Path(__file__).resolve().parents[1])
DRAIN_S = 10.0
JOIN_S = 30.0


@pytest.fixture
def native():
    """Skips the test where the native coordinator cannot be built."""
    if not has_toolchain():
        pytest.skip("native toolchain unavailable")


# -- EpochWatch: tests/test_watch_chaos.py ------------------------------------


def _drain(watch, want, deadline_s=DRAIN_S):
    """Poll until ``want`` distinct epochs arrived or the deadline passes."""
    got = []
    deadline = time.monotonic() + deadline_s
    while len(got) < want and time.monotonic() < deadline:
        got += [e for e, _ in watch.poll(timeout=0.2)]
    return got


@pytest.mark.usefixtures("native")
def test_watch_resume_cursor_replays_missed_epochs_across_kill_restart(tmp_path):
    """SIGKILL the coordinator while epochs keep moving: on reconnect the
    subscribe cursor replays exactly the missed window."""
    server = CoordinatorServer(task_lease_sec=60.0, heartbeat_ttl_sec=60.0,
                               state_file=str(tmp_path / "coord-state.jsonl"),
                               run_id="watchkill")
    server.start()
    try:
        ctl = server.client("admin")
        e0 = ctl.epoch()
        watch = EpochWatch(port=server.port, worker="w0")
        watch.last_epoch = e0
        assert watch.subscribe()
        assert ctl.bump_epoch() == e0 + 1
        assert ctl.bump_epoch() == e0 + 2
        assert _drain(watch, 2) == [e0 + 1, e0 + 2]
        ctl.close()

        server.kill()
        assert watch.poll(timeout=0.3) == []
        assert not watch.connected

        server.restart()
        ctl = server.client("admin")
        assert ctl.epoch() > e0 + 2
        e_final = ctl.bump_epoch()
        missed = _drain(watch, e_final - (e0 + 2))
        assert missed == list(range(e0 + 3, e_final + 1)), missed
        assert watch.last_epoch == e_final and watch.resubscribes >= 1
        assert watch.poll(timeout=0.2) == []
        ctl.close()
    finally:
        server.stop()


@pytest.mark.usefixtures("native")
def test_watch_partition_degrades_to_pull_without_stall():
    """A blackholed stream costs each poll a bounded stall while the pull
    path sees the new epoch; heal delivers it exactly once."""
    with CoordinatorServer(task_lease_sec=60.0, heartbeat_ttl_sec=60.0) as server:
        with ChaosProxy(server.port, seed=7) as proxy:
            watch = EpochWatch(port=proxy.port, worker="w0")
            ctl = server.client("admin")
            watch.last_epoch = ctl.epoch()
            assert watch.subscribe()
            proxy.partition()
            e1 = ctl.bump_epoch()
            stalls = []
            for _ in range(6):
                t0 = time.monotonic()
                assert watch.poll() == []
                stalls.append(time.monotonic() - t0)
                time.sleep(0.25)
            assert max(stalls) < 2.0, stalls
            assert not watch.connected
            assert ctl.epoch() == e1
            proxy.heal()
            assert _drain(watch, 1) == [e1]
            assert watch.connected and watch.resubscribes >= 1
            assert watch.poll(timeout=0.2) == []
            ctl.close()


@pytest.mark.usefixtures("native")
def test_watch_notify_hammer_concurrent_bumps_and_subscription_churn():
    """One thread bumps epochs while watcher connections subscribe, poll and
    tear down: every stable watcher sees each epoch once, in order."""
    with CoordinatorServer(task_lease_sec=60.0, heartbeat_ttl_sec=60.0) as server:
        ctl = server.client("admin")
        e0 = ctl.epoch()
        bumps = 30
        stop = threading.Event()

        def bumper():
            for _ in range(bumps):
                ctl.bump_epoch()
                time.sleep(0.002)
            stop.set()

        def churner():
            while not stop.is_set():
                w = EpochWatch(port=server.port, worker="churn")
                if w.subscribe(timeout=1.0):
                    w.poll()
                w.close()
                time.sleep(0.005)

        stable = []
        for i in range(3):
            w = EpochWatch(port=server.port, worker=f"stable{i}")
            w.last_epoch = e0
            assert w.subscribe()
            stable.append(w)
        threads = [threading.Thread(target=bumper), threading.Thread(target=churner)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
        assert stop.is_set() and not any(t.is_alive() for t in threads)
        e_final = ctl.epoch()
        assert e_final == e0 + bumps
        for w in stable:
            got = _drain(w, bumps)
            assert got == list(range(e0 + 1, e_final + 1)), got[:5]
            w.close()
        ctl.close()


@pytest.mark.usefixtures("native")
def test_watch_on_sharded_root_delivers_through_redirect_topology():
    with ShardedCoordinator(num_shards=2, task_lease_sec=60.0,
                            heartbeat_ttl_sec=60.0) as sc:
        c = sc.client("w0")
        c.register()
        c.kv_put("alpha", "1")
        assert c.kv_get("alpha") == "1"
        watch = EpochWatch(port=sc.port, worker="w0")
        watch.last_epoch = c.epoch()
        assert watch.subscribe()
        e1 = c.bump_epoch()
        assert _drain(watch, 1) == [e1]
        watch.close()
        c.close()


# -- the outbox: tests/test_coordinator_outage.py ------------------------------


@pytest.mark.usefixtures("native")
def test_partition_buffers_mutations_then_replays():
    """Mutations during a partition buffer, heal replays them in order, and
    the replayed completion is recorded exactly once."""
    with CoordinatorServer(task_lease_sec=60.0, heartbeat_ttl_sec=60.0) as server:
        with ChaosProxy(server.port, seed=1) as proxy:
            raw = CoordinatorClient(port=proxy.port, worker="w0",
                                    retry=RetryPolicy(deadline=1.0, seed=1))
            c = OutboxClient(raw)
            c.register()
            c.add_tasks(["s0", "s1"])
            assert c.acquire_task() == "s0"

            proxy.partition()
            assert c.complete_task("s0").get("buffered") is True
            c.kv_put("during-outage", "x")
            assert len(c.outbox) == 2
            assert c.unreachable and c.outage_seconds() >= 0.0
            soft = c.acquire()
            assert soft.get("task") is None and soft.get("unreachable")

            proxy.heal()
            deadline = time.monotonic() + DRAIN_S
            while len(c.outbox) and time.monotonic() < deadline:
                c.heartbeat()
                time.sleep(0.05)
            assert len(c.outbox) == 0 and not c.unreachable
            assert int(c.status()["done"]) == 1
            assert c.kv_get("during-outage") == "x"
            again = c.complete_task("s0")
            assert again.get("ok") and again.get("duplicate")
            assert int(c.status()["done"]) == 1
            summ = c.summary()
            assert summ["outages"] >= 1.0 and summ["replayed_ops"] >= 2.0
            raw.close()


def test_outbox_replay_stops_on_transport_failure():
    """A mid-replay outage keeps the tail buffered (nothing lost)."""

    class Flaky:
        def __init__(self):
            self.calls = 0

        def call(self, op, **fields):
            self.calls += 1
            if self.calls > 1:
                raise CoordinatorUnreachable("mid-replay outage")
            return {"ok": True}

    ob = Outbox()
    ob.add("complete_task", task="a")
    ob.add("complete_task", task="b")
    ob.add("kv_put", key="k", value="v")
    assert ob.replay(Flaky()) == 1
    assert len(ob) == 2
    assert ob.pending()[0] == ("complete_task", {"task": "b"})


def test_outbox_client_over_inprocess_coordinator():
    c = OutboxClient(InProcessCoordinator(task_lease_sec=30.0).client("w0"))
    c.register()
    c.add_tasks(["x"])
    assert c.acquire_task() == "x"
    assert c.complete_task("x").get("ok")
    dup = c.complete_task("x")
    assert dup.get("ok") and dup.get("duplicate")
    assert c.summary()["outages"] == 0.0


# -- the job-spec types: tests/test_api_types.py -------------------------------

EXAMPLE_YAML = """
metadata:
  name: example
  namespace: default
spec:
  image: "edl-tpu/job:latest"
  port: 7164
  fault_tolerant: true
  passes: 2
  tpu:
    accelerator_type: v5e
    chips_per_trainer: 4
  trainer:
    entrypoint: "python train.py"
    workspace: "/workspace"
    min_instance: 2
    max_instance: 10
    resources:
      requests: {cpu: "500m", memory: "600Mi"}
      limits: {cpu: "1", memory: "1Gi"}
  coordinator:
    resources:
      requests: {cpu: "100m", memory: "256Mi"}
"""


def test_parse_quantity():
    assert parse_quantity("500m") == 0.5
    assert parse_quantity("1") == 1.0
    assert parse_quantity("30Gi") == 30 * 1024**3
    assert parse_quantity("2k") == 2000.0
    assert parse_quantity(4) == 4.0
    with pytest.raises(ValueError):
        parse_quantity("abc")


def test_resource_list_math():
    a = ResourceList.make({"cpu": "1", "memory": "1Gi"})
    b = ResourceList.make({"cpu": "500m", "memory": "1Gi", "tpu": 4})
    a.add(b)
    assert a["cpu"] == 1.5
    assert a["memory"] == 2 * 1024**3
    assert a["tpu"] == 4.0
    assert b.fits_within({"cpu": 1.0, "memory": 2**31, "tpu": 8.0})
    assert not b.fits_within({"cpu": 0.25, "memory": 2**31, "tpu": 8.0})


def test_from_yaml_and_predicates():
    job = TrainingJob.from_yaml(EXAMPLE_YAML)
    assert job.name == "example"
    assert job.spec.trainer.min_instance == 2 and job.spec.trainer.max_instance == 10
    assert job.elastic() and job.need_tpu()
    req = job.trainer_request()
    assert req["tpu"] == 4.0 and req["cpu"] == 0.5


def test_not_elastic_when_range_collapsed():
    job = TrainingJob.from_yaml(EXAMPLE_YAML)
    job.spec.trainer.max_instance = job.spec.trainer.min_instance
    assert not job.elastic()


def test_defaults_force_fault_tolerant_for_elastic():
    job = TrainingJob.from_yaml(EXAMPLE_YAML)
    job.spec.fault_tolerant = False
    set_defaults(job)
    assert job.spec.fault_tolerant
    assert job.spec.trainer.image == "edl-tpu/job:latest"
    assert job.spec.parallelism == {"data": 4}


def test_validate_rejects_bad_ranges():
    job = TrainingJob.from_yaml(EXAMPLE_YAML)
    job.spec.trainer.min_instance = 5
    job.spec.trainer.max_instance = 2
    with pytest.raises(ValidationError):
        validate(job)


def test_validate_rejects_incompatible_mesh():
    job = TrainingJob.from_yaml(EXAMPLE_YAML)
    set_defaults(job)
    job.spec.parallelism = {"data": 3}
    with pytest.raises(ValidationError):
        validate(job)


def test_normalize_roundtrip_and_equals_the_jax_package():
    job = normalize(TrainingJob.from_yaml(EXAMPLE_YAML))
    again = TrainingJob.from_dict(job.to_dict())
    assert again.spec.to_dict() == job.spec.to_dict()
    assert job.status.phase == JobPhase.NONE
    assert job.to_dict() == jax_normalize(JaxTrainingJob.from_yaml(EXAMPLE_YAML)).to_dict()


# -- the launcher: tests/test_launcher.py --------------------------------------

ENVS = {
    "set": {
        "EDL_JOB_NAME": "ctr", "EDL_NAMESPACE": "team", "EDL_ROLE": "trainer",
        "EDL_COORDINATOR_ENDPOINT": "ctr-coordinator.default:7164", "EDL_PORT": "7200",
        "EDL_NUM_TRAINERS": "4", "EDL_MAX_TRAINERS": "10", "EDL_FAULT_TOLERANT": "1",
        "EDL_PASSES": "3", "EDL_ENTRY": "python train.py", "EDL_WORKSPACE": "/ws",
        "EDL_MESH_AXES": json.dumps({"data": 4, "expert": 2}), "EDL_TPU_CHIPS": "4",
        "EDL_DATA_SHARDS": json.dumps(["s0", "s1"]), "EDL_CHECKPOINT_DIR": "/ck",
        "EDL_CHECKPOINT_INTERVAL": "50", "EDL_TERMINATION_LOG": "/tmp/term",
        "EDL_STATE_FILE": "/ws/state.jsonl", "EDL_RUN_ID": "uid-1",
    },
    "defaults": {},
    "strict": {"EDL_FAULT_TOLERANT": "0", "EDL_NUM_TRAINERS": "2", "EDL_MAX_TRAINERS": "5"},
}


@pytest.mark.parametrize("env", sorted(ENVS))
def test_launch_context_from_env_equals_the_jax_launchers(env):
    ctx = LaunchContext.from_env(ENVS[env])
    want = JaxLaunchContext.from_env(ENVS[env])
    assert dataclasses.asdict(ctx) == dataclasses.asdict(want)
    assert ctx.failure_threshold == want.failure_threshold


def test_from_env_roundtrip():
    ctx = LaunchContext.from_env(ENVS["set"])
    assert ctx.job_name == "ctr" and ctx.num_trainers == 4
    assert ctx.mesh_axes == {"data": 4, "expert": 2}
    assert ctx.data_shards == ["s0", "s1"]
    assert ctx.failure_threshold == 10  # FT budget: the largest trainer count
    ctx.fault_tolerant = False
    assert ctx.failure_threshold == 0


def test_exit_code_mapping_equals_the_jax_launchers():
    assert "Floating point" in map_exit_code(136)
    assert "Segmentation" in map_exit_code(139) and "Segmentation" in map_exit_code(-11)
    assert "Abort" in map_exit_code(134) and "Abort" in map_exit_code(-6)
    assert map_exit_code(0) == "Succeeded"
    assert "3" in map_exit_code(3)
    for code in range(-16, 160):
        assert map_exit_code(code) == jax_map_exit_code(code), code


def test_failure_budget_gate():
    client = InProcessCoordinator().client("w0")
    assert check_failed_count(client, threshold=0) == 0
    client.kv_put(FAILED_COUNT_KEY, "1")
    with pytest.raises(RuntimeError, match="budget exhausted"):
        check_failed_count(client, threshold=0)
    assert check_failed_count(client, threshold=4) == 1


@pytest.fixture(params=["inprocess", "native"])
def coordinator(request, monkeypatch):
    """Yields (endpoint for the launcher, a client to inspect the state)."""
    if request.param == "native":
        if not has_toolchain():
            pytest.skip("native toolchain unavailable")
        with CoordinatorServer() as server:
            with server.client("check") as check:
                yield server.address, check
        return
    coord = InProcessCoordinator()
    monkeypatch.setattr(launch, "wait_coordinator", lambda endpoint: coord.client("trainer"))
    yield "inprocess:0", coord.client("check")


def test_start_trainer_runs_entry_and_accounts_failure(coordinator, tmp_path):
    """The entry runs, its exit is written to the termination log, a failure
    bumps the job-wide counter, and a strict job then refuses to start."""
    endpoint, check = coordinator
    term, ok = tmp_path / "term.log", tmp_path / "ok.txt"
    ctx = LaunchContext(job_name="t", coordinator_endpoint=endpoint,
                        entry=f"{sys.executable} -c \"open(r'{ok}','w').write('hi')\"",
                        termination_log=str(term))
    assert start_trainer(ctx) == 0
    assert ok.read_text() == "hi" and term.read_text() == "Succeeded"

    fail = dataclasses.replace(ctx, entry=f"{sys.executable} -c 'raise SystemExit(3)'")
    assert start_trainer(fail) == 3
    assert "3" in term.read_text()
    assert check.kv_get(FAILED_COUNT_KEY) == "1"

    assert start_trainer(ctx) == 1  # budget 0: exhausted
    assert "budget exhausted" in term.read_text()


def test_start_trainer_passes_the_environment_through(coordinator, tmp_path, monkeypatch):
    """The entry sees the launcher's environment and ``extra_env``, and no
    XLA compilation cache is pointed at (the port's one difference)."""
    endpoint, _ = coordinator
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    out = tmp_path / "env.json"
    entry = (f"{sys.executable} -c \"import json, os; json.dump({{k: os.environ.get(k) "
             f"for k in ('EXTRA', 'JAX_COMPILATION_CACHE_DIR')}}, open(r'{out}', 'w'))\"")
    ctx = LaunchContext(job_name="envjob", coordinator_endpoint=endpoint, entry=entry,
                        workspace=str(tmp_path), termination_log=str(tmp_path / "term"))
    assert start_trainer(ctx, extra_env={"EXTRA": "1"}) == 0
    assert json.loads(out.read_text()) == {"EXTRA": "1", "JAX_COMPILATION_CACHE_DIR": None}


@pytest.mark.usefixtures("native")
def test_start_coordinator_restart_resumes_queue(tmp_path):
    """A coordinator role restarted in the same workspace restores its queue
    and done set, and seeding again adds nothing."""
    ctx = LaunchContext(job_name="j", workspace=str(tmp_path), port=free_port(),
                        data_shards=[f"s{i}" for i in range(4)])
    server = start_coordinator(ctx, block=False)
    try:
        w = server.client("w")
        w.register()
        w.complete_task(w.acquire_task())
        time.sleep(0.3)  # the event loop's save point
    finally:
        server.kill()
    server2 = start_coordinator(ctx, block=False)
    try:
        st = server2.client("probe").status()
        assert int(st["done"]) == 1 and int(st["queued"]) == 3
    finally:
        server2.stop()


@pytest.mark.usefixtures("native")
def test_start_coordinator_seeds_every_pass_of_every_shard(tmp_path):
    shards = [f"mp/part-{i:05d}" for i in range(3)]
    ctx = LaunchContext(job_name="multipass", workspace=str(tmp_path), port=free_port(),
                        data_shards=shards, passes=2)
    server = start_coordinator(ctx, block=False)
    try:
        c = server.client("w0")
        c.register()
        assert int(c.status()["queued"]) == 6
        got = [c.acquire_task() for _ in range(6)]
        assert got == pass_tasks(shards, 2)  # pass-major order
    finally:
        server.stop()


def test_launcher_module_entry_point_parses_its_roles():
    out = subprocess.run([sys.executable, "-m", "edl_tpu_torch.launcher", "--help"],
                         capture_output=True, text=True, timeout=60,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert "start_coordinator" in out.stdout and "start_trainer" in out.stdout


# -- configure_logging: tests/test_obs.py ---------------------------------------


@pytest.mark.parametrize("fmt", ["json", "text"])
def test_configure_logging_writes_what_the_jax_packages_writes(fmt):
    root = logging.getLogger()
    saved_handlers, saved_level = list(root.handlers), root.level
    lines = []
    try:
        for configure in (configure_logging, jax_configure_logging):
            stream = io.StringIO()
            configure(level="warning", fmt=fmt, stream=stream)
            log = logging.getLogger("edl.control_plane.test")
            log.info("dropped below the level")
            log.warning("structured %d", 7, extra={"mesh": (2, 4)})
            lines.append(stream.getvalue().strip())
        if fmt == "json":
            port, jax = (json.loads(line) for line in lines)
            assert port["msg"] == "structured 7" and port["logger"] == "edl.control_plane.test"
            assert port["mesh"] == [2, 4]
            port.pop("ts"), jax.pop("ts")
            assert port == jax
        else:
            assert "structured 7" in lines[0] and "dropped" not in lines[0]
            strip = [line.split(" ", 2)[-1] for line in lines]  # past the time stamp
            assert strip[0] == strip[1]
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
        for h in saved_handlers:
            root.addHandler(h)
        root.setLevel(saved_level)


# -- main_thread_signal --------------------------------------------------------

SIGNAL_SRC = """
import os, signal, threading
from edl_tpu_torch.runtime.signals import main_thread_signal

hits = []
prev = signal.getsignal(signal.SIGUSR1)
with main_thread_signal(signal.SIGUSR1, lambda s, f: hits.append(s)) as on_main:
    os.kill(os.getpid(), signal.SIGUSR1)
restored = signal.getsignal(signal.SIGUSR1) is prev

off = []
def worker():
    with main_thread_signal(signal.SIGUSR1, lambda s, f: None) as installed:
        off.append((installed, signal.getsignal(signal.SIGUSR1) is prev))
t = threading.Thread(target=worker)
t.start()
t.join(timeout=10)
print(on_main, hits == [signal.SIGUSR1], restored, off == [(False, True)])
"""


def test_main_thread_signal_on_and_off_the_main_thread():
    """On the main thread the handler is installed for the block and the
    previous one restored after; off it, nothing is installed. Run in a
    subprocess, whose main thread the test owns."""
    out = subprocess.run([sys.executable, "-c", SIGNAL_SRC], capture_output=True, text=True,
                         timeout=60, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True"] * 4, out.stdout
