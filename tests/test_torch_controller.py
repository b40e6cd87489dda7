"""The port's control plane (`edl_tpu_torch.controller`, `tools.collector`)
against the JAX package's.

Three kinds of case, each with a deadline of its own (``DEADLINE`` for a
controller loop to settle, ``LIVE_S`` for a live loop):

- parity: the same inputs through both packages, with equal results. About
  200 random clusters and job sets (seeded with numpy) through
  `fulfillment`, `sorted_jobs_by_fulfillment`, `scale_all_dry_run` and
  `make_room_dry_run`; random `FakeCluster` states through
  `Autoscaler.step()` called directly (diffs, `ScaleRecord`s, pods); the
  env protocol, `parse_job` and `Controller.submit` through the updater on
  the same YAML. The random dry runs also carry the JAX package's own
  invariant checks (`tests/test_autoscaler.py`) on the port's results.
- the cases of `tests/test_autoscaler.py` and `tests/test_controller.py`,
  mirrored onto the port (a JAX test that repeats with only an input
  changed is one parametrised test here), and the unit cases of
  `tests/test_actuation.py`;
- the live loops, which the JAX package skips on this image
  (`multiprocess_on_cpu`): the port's `ProcessCluster` runs the port's
  launcher over `tests/torch_mh_worker.py` (fit_a_line, gloo, the CPU)
  against the native coordinator, and the autoscaler alone decides: a
  two-rank job grown to three, and a job shrunk to admit a pending one.

Semantics are exact: no tolerance anywhere in this file.
"""

import importlib
import json
import os
import random
import socket
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from edl_tpu_torch.api import ResourceList, TrainingJob
from edl_tpu_torch.api.types import JobPhase
from edl_tpu_torch.api.validation import normalize
from edl_tpu_torch.controller import (
    Autoscaler,
    AutoscalerConfig,
    Controller,
    FakeCluster,
    FuncWatcher,
    JobState,
    JobStore,
    NodeInfo,
    ROLE_COORDINATOR,
    ROLE_TRAINER,
    UpdaterConfig,
    fulfillment,
    make_env,
    parse_job,
    scale_all_dry_run,
    scale_dry_run,
    sorted_jobs_by_fulfillment,
)
from edl_tpu_torch.controller.actuation import EXPECTED_WORLD_KEY, CoordinatorActuator
from edl_tpu_torch.controller.cluster import inquire_resource
from edl_tpu_torch.controller.jobparser import parse_to_trainer
from edl_tpu_torch.controller.process_cluster import ProcessCluster
from edl_tpu_torch.coordinator import CoordinatorServer
from edl_tpu_torch.coordinator.server import ensure_built

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
PKG = {"jax": "edl_tpu", "torch": "edl_tpu_torch"}
#: how long a controller loop may take to reach the state a case waits for
DEADLINE = 8.0
#: a live loop's own deadline, bring-up to drained queue
LIVE_S = 120.0
FAST = UpdaterConfig(convert_seconds=0.05, poll_seconds=0.02, create_timeout=5.0)


def mod(side: str, name: str):
    """Module ``name`` of the JAX package (``side="jax"``) or the port's."""
    return importlib.import_module(f"{PKG[side]}.{name}")


def wait_until(pred, timeout=DEADLINE, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


# -- fixtures shared with the JAX package's tests --------------------------------


def make_job(name, min_i=2, max_i=10, chips=4, cpu="1", mem="1Gi", cur=2):
    """`tests/test_autoscaler.py`'s job factory, on the port."""
    job = TrainingJob.from_dict({
        "metadata": {"name": name},
        "spec": {
            "tpu": {"chips_per_trainer": chips},
            "trainer": {
                "min_instance": min_i, "max_instance": max_i,
                "resources": {"requests": {"cpu": cpu, "memory": mem},
                              "limits": {"cpu": cpu, "memory": mem}},
            },
        },
    })
    return JobState(job=normalize(job), current=cur)


def tpu_cluster(n_hosts=4, chips_per_host=4, cpu=16, mem_gi=64):
    return [NodeInfo(name=f"host{i}", allocatable=ResourceList.make(
        {"cpu": cpu, "memory": f"{mem_gi}Gi", "tpu": chips_per_host}))
        for i in range(n_hosts)]


def snapshot(nodes, pods=()):
    return inquire_resource(list(nodes), list(pods))


def make_job_dict(name, min_i=1, max_i=1, chips=0, cpu="1", mem="1Gi",
                  fault_tolerant=False):
    """`tests/test_controller.py`'s job dict."""
    return {
        "metadata": {"name": name},
        "spec": {
            "image": "edl-tpu:test",
            "fault_tolerant": fault_tolerant,
            "tpu": {"chips_per_trainer": chips},
            "trainer": {
                "entrypoint": "python train.py",
                "min_instance": min_i, "max_instance": max_i,
                "resources": {"requests": {"cpu": cpu, "memory": mem},
                              "limits": {"cpu": cpu, "memory": mem}},
            },
        },
    }


def nodes(n=2, cpu=8, mem_gi=32, tpu=8):
    return [NodeInfo(name=f"host{i}", allocatable=ResourceList.make(
        {"cpu": cpu, "memory": f"{mem_gi}Gi", "tpu": tpu})) for i in range(n)]


@pytest.fixture
def controller():
    cluster = FakeCluster(nodes())
    ctl = Controller(cluster, store=JobStore(),
                     autoscaler_config=AutoscalerConfig(loop_seconds=0.05,
                                                        max_load_desired=0.97),
                     updater_config=FAST)
    ctl.start()
    yield ctl
    ctl.stop()


# -- parity: the dry runs on random clusters -------------------------------------


def _random_case(rng):
    """A package-free description of one random cluster, its elastic jobs
    and a pending set, drawn as `tests/test_autoscaler.py`'s property tests
    draw theirs."""
    node_specs = [{"name": f"n{i}", "cpu": float(rng.choice([8, 16, 32])),
                   "memory": float(rng.choice([2, 4, 8])) * 2**30,
                   "tpu": float(rng.choice([0, 4, 4, 8]))}
                  for i in range(int(rng.integers(1, 6)))]
    jobs = []
    for i in range(int(rng.integers(1, 5))):
        lo = int(rng.integers(1, 4))
        hi = lo + int(rng.integers(0, 8))
        jobs.append({"name": f"j{i}", "lo": lo, "hi": hi,
                     "chips": int(rng.choice([0, 4, 4, 8])),
                     "cpu": str(int(rng.integers(1, 4))),
                     "mem": f"{int(rng.integers(1, 3))}Gi",
                     "current": int(rng.integers(lo, hi + 1)),
                     "pending_ok": bool(rng.random() < 0.4)})
    pending = [{"cpu": str(int(rng.integers(1, 8))), "tpu": float(rng.choice([0, 4, 8]))}
               for _ in range(int(rng.integers(1, 4)))]
    diff = {j["name"]: int(rng.integers(-2, 3)) for j in jobs}
    return node_specs, jobs, pending, diff


def _dry_runs(side, case):
    """Run one random case through ``side``'s dry-run core; returns every
    result in plain Python types, and the port's objects for the invariant
    checks."""
    node_specs, jobs, pending, diff = case
    api = mod(side, "api")
    cluster = mod(side, "controller.cluster")
    auto = mod(side, "controller.autoscaler")
    resource = cluster.inquire_resource([
        cluster.NodeInfo(name=n["name"], allocatable=api.ResourceList.make(
            {"cpu": n["cpu"], "memory": n["memory"], "tpu": n["tpu"]}))
        for n in node_specs], [])
    states = []
    for j in jobs:
        job = api.TrainingJob.from_dict({
            "metadata": {"name": j["name"]},
            "spec": {"tpu": {"chips_per_trainer": j["chips"]},
                     "trainer": {"min_instance": j["lo"], "max_instance": j["hi"],
                                 "resources": {"requests": {"cpu": j["cpu"],
                                                            "memory": j["mem"]}}}},
        })
        s = auto.JobState(job=job, current=j["current"])
        # place the initial replicas as inquire would count them: on a node
        # where they fit, else (sometimes) as PENDING pods that hold no node
        placed = 0
        for _ in range(s.current):
            node = resource.search_assignable_node(s.request())
            if node is None:
                if j["pending_ok"]:
                    resource.requested.add(s.request())
                    placed += 1
                continue
            resource.assign(node, s.request())
            placed += 1
        s.current = placed
        if placed:
            states.append(s)
    pending_reqs = [api.ResourceList.make(p) for p in pending]
    out = {
        "snapshot": (dict(resource.total), dict(resource.requested),
                     {k: dict(v) for k, v in resource.node_idle.items()}),
        "fulfillment": [auto.fulfillment(s, diff[s.name]) for s in states],
        "sorted": [s.name for s in auto.sorted_jobs_by_fulfillment(states, diff)],
        "scale_all": auto.scale_all_dry_run(resource.copy(), states, 0.9),
        "make_room": auto.make_room_dry_run(resource.copy(), states, pending_reqs),
    }
    return out, resource, states


@pytest.mark.parametrize("seed", range(4))
def test_dry_runs_equal_the_jax_package_on_random_clusters(seed):
    """50 random cases a seed (200 in all): both packages' snapshots,
    fulfillment, sort order, fixed point and make-room plan are equal; the
    port's plans also hold the JAX property tests' invariants (deterministic,
    within [min(current, floor), max], no chip over-commit from a feasible
    start, make-room only shrinks and never below a floor)."""
    rng = np.random.default_rng(1000 + seed)
    cases = shrinks = 0
    for trial in range(50):
        case = _random_case(rng)
        want, _, _ = _dry_runs("jax", case)
        got, resource, states = _dry_runs("torch", case)
        assert got == want, (seed, trial)
        if not states:
            continue
        cases += 1
        diff = got["scale_all"]
        assert scale_all_dry_run(resource.copy(), states, 0.9) == diff
        shrinks += sum(1 for v in diff.values() if v < 0)
        tpu_before = resource.requested.get_q("tpu")
        tpu_after = tpu_before
        for s in states:
            final = s.current + diff[s.name]
            assert min(s.current, s.min_instance()) <= final <= s.max_instance()
            tpu_after += diff[s.name] * s.request().get_q("tpu")
            room = got["make_room"][s.name]
            assert room <= 0 and s.current + room >= min(s.current, s.min_instance())
        assert tpu_after <= max(tpu_before, resource.total.get_q("tpu")) + 1e-9
    assert cases >= 40 and shrinks > 0  # the population reaches the scale-down arm


# -- parity: Autoscaler.step on random FakeCluster states -------------------------


def _signal(side, breached: bool):
    sig = mod(side, "serving.autoscale").ServeSignal
    if breached:
        return sig(latency_buckets=[(0.1, 0.0), (5.0, 1000.0), (float("inf"), 1000.0)],
                   latency_count=1000.0, queue_depth=50.0)
    return sig(latency_buckets=[(0.005, 1000.0), (float("inf"), 1000.0)],
               latency_count=1000.0, queue_depth=0.0)


def _random_fleet(rng):
    hosts = int(rng.integers(2, 6))
    node_specs = [{"cpu": float(rng.choice([8, 16])), "tpu": int(rng.choice([4, 8]))}
                  for _ in range(hosts)]
    jobs = []
    for i in range(int(rng.integers(1, 5))):
        lo = int(rng.integers(1, 3))
        hi = lo + int(rng.integers(0, 5))
        jobs.append({"name": f"j{i}", "lo": lo, "hi": hi, "chips": int(rng.choice([4, 4, 8])),
                     "cpu": str(int(rng.integers(1, 3))),
                     "start": int(rng.integers(lo, hi + 1)),
                     "serving": bool(rng.random() < 0.25),
                     "breached": bool(rng.random() < 0.5)})
    return node_specs, jobs


def _run_autoscaler(side, fleet, passes=3):
    """Create each job's trainers on a FakeCluster (later jobs may pend),
    hand the jobs to an Autoscaler and call ``step()`` ``passes`` times.
    Returns each pass's diff, the ScaleRecords, the parallelism and the
    pods, in plain types."""
    node_specs, jobs = fleet
    api = mod(side, "api")
    ctl = mod(side, "controller")
    normalize_ = mod(side, "api.validation").normalize
    cluster = ctl.FakeCluster([
        ctl.NodeInfo(name=f"h{i}", allocatable=api.ResourceList.make(
            {"cpu": n["cpu"], "memory": "64Gi", "tpu": n["tpu"]}))
        for i, n in enumerate(node_specs)])
    scaler = ctl.Autoscaler(cluster, ctl.AutoscalerConfig(loop_seconds=0.01,
                                                          max_load_desired=0.9))
    records = []
    scaler.on_scaled = lambda name, r: records.append(
        (name, r.from_replicas, r.to_replicas, r.reason))
    signals = {}
    for j in jobs:
        spec = {"tpu": {"chips_per_trainer": j["chips"]},
                "trainer": {"min_instance": j["lo"], "max_instance": j["hi"],
                            "resources": {"requests": {"cpu": j["cpu"], "memory": "1Gi"},
                                          "limits": {"cpu": j["cpu"], "memory": "1Gi"}}}}
        if j["serving"]:
            spec["serving"] = {"model_dir": "/srv/model", "slo_p99_seconds": 0.25,
                               "max_queue_per_replica": 8.0}
        job = normalize_(api.TrainingJob.from_dict({"metadata": {"name": j["name"]},
                                                    "spec": spec}))
        cluster.create_role(j["name"], "trainer", j["start"], job.trainer_request(),
                            job.trainer_limit())
        scaler.on_add(job)
        if j["serving"]:
            scaler.register_serving_endpoints(j["name"], [f"http://{j['name']}:0"])
            signals[f"http://{j['name']}:0"] = _signal(side, j["breached"])
    scaler.serve_scrape = signals.get
    while not scaler._events.empty():
        scaler._apply_event(scaler._events.get_nowait())
    diffs = [scaler.step() for _ in range(passes)]
    return {
        "diffs": diffs, "records": records,
        "parallelism": {j["name"]: cluster.get_trainer_parallelism(j["name"]) for j in jobs},
        "pods": [(p.name, p.job_name, p.phase, p.node) for p in cluster.pods],
    }


@pytest.mark.parametrize("seed", range(2))
def test_autoscaler_step_equals_the_jax_package(seed):
    """20 random fleets a seed: training and serving jobs, some created with
    more replicas than fit (pending pods: the make-room pass), through three
    direct ``step()`` calls in each package: equal diffs, ScaleRecords
    (from, to, reason), parallelism and pods."""
    rng = np.random.default_rng(2000 + seed)
    moved = 0
    for trial in range(20):
        fleet = _random_fleet(rng)
        want = _run_autoscaler("jax", fleet)
        got = _run_autoscaler("torch", fleet)
        assert got == want, (seed, trial)
        moved += len(got["records"])
    assert moved > 0


# -- parity: the env protocol, the workloads, and submit through the updater -------

JOB_YAMLS = {
    "elastic": """
metadata: {name: demo, namespace: default}
spec:
  image: edl-tpu:latest
  fault_tolerant: true
  tpu: {accelerator_type: v5e, chips_per_trainer: 4}
  trainer:
    entrypoint: "python -m edl_tpu.launcher start_trainer"
    min_instance: 2
    max_instance: 4
    resources:
      requests: {cpu: 1, memory: 1Gi}
      limits: {cpu: 2, memory: 2Gi}
  data_shards: [s0, s1, s2, s3]
""",
    "strict": """
metadata: {name: strict, namespace: team-a}
spec:
  image: edl-tpu:v2
  port: 7300
  passes: 3
  checkpoint_dir: /ckpt
  checkpoint_interval: 50
  parallelism: {data: 2, model: 2}
  tpu: {accelerator_type: v5p, chips_per_trainer: 8, topology: {data: 2, model: 4}}
  coordinator:
    workspace: /state
    state_pvc: strict-state
    resources:
      requests: {cpu: 500m, memory: 256Mi}
  trainer:
    entrypoint: "python train.py --flag"
    workspace: /work
    min_instance: 2
    max_instance: 2
    env: {EDL_PASSES: "9", CUSTOM: x}
    resources:
      requests: {cpu: 4, memory: 8Gi}
""",
    "serving": """
metadata: {name: serve}
spec:
  tpu: {chips_per_trainer: 1}
  trainer:
    min_instance: 1
    max_instance: 3
  serving: {model_dir: /srv/model, buckets: [1, 8], slo_p99_seconds: 0.5}
""",
}


def _workload(w) -> dict:
    return {"job_name": w.job_name, "role": w.role, "replicas": w.replicas,
            "image": w.image, "entrypoint": w.entrypoint, "requests": dict(w.requests),
            "limits": dict(w.limits), "env": dict(w.env), "labels": dict(w.labels),
            "state_pvc": w.state_pvc}


@pytest.mark.parametrize("name", sorted(JOB_YAMLS))
def test_env_protocol_and_workloads_equal_the_jax_package(name):
    """``make_env`` for both roles and ``parse_job``'s workloads from the
    same YAML (a fixed auth token stamped in both) are equal."""
    out = {}
    for side in PKG:
        job = mod(side, "api.validation").normalize(
            mod(side, "api").TrainingJob.from_yaml(JOB_YAMLS[name]))
        job.spec.auth_token = "0" * 32
        parser = mod(side, "controller.jobparser")
        out[side] = ({role: parser.make_env(job, role)
                      for role in (parser.ROLE_COORDINATOR, parser.ROLE_TRAINER)},
                     [_workload(w) for w in parser.parse_job(job)],
                     parser.coordinator_endpoint(job))
    assert out["torch"] == out["jax"]


def _submit_and_settle(side, text, want_parallelism):
    api = mod(side, "api")
    ctl = mod(side, "controller")
    cluster = ctl.FakeCluster([
        ctl.NodeInfo(name=f"host{i}", allocatable=api.ResourceList.make(
            {"cpu": 16, "memory": "64Gi", "tpu": 8})) for i in range(2)])
    controller = ctl.Controller(
        cluster, autoscaler_config=ctl.AutoscalerConfig(loop_seconds=0.05),
        updater_config=ctl.UpdaterConfig(convert_seconds=0.05, poll_seconds=0.02,
                                         create_timeout=5.0)).start()
    try:
        job = controller.submit(api.TrainingJob.from_yaml(text))

        def settled():
            st = controller.job_status(job.name, job.namespace).status
            return (st.phase.value == "Running" and st.parallelism == want_parallelism
                    and len(st.scale_history) == (want_parallelism != st_min(text)))

        assert wait_until(settled), side
        final = controller.job_status(job.name, job.namespace).to_dict()
        token = final["spec"].pop("auth_token")
        assert len(token) == 32 and int(token, 16) >= 0
        for record in final["status"].pop("scale_history"):
            record.pop("timestamp")
            # the autoscaler's first pass races the updater's creation of
            # the trainers (in either package): it reads 0 or min_instance
            assert record.pop("from_replicas") in (0, st_min(text))
            final["status"].setdefault("scales", []).append(record)
        pods = [(p.name, p.role, p.phase, p.node, dict(p.requests), dict(p.limits))
                for p in cluster.pods]
        return final, pods
    finally:
        controller.stop()


def st_min(text):
    return TrainingJob.from_yaml(text).spec.trainer.min_instance


@pytest.mark.parametrize("name,parallelism", [("elastic", 4), ("strict", 2)])
def test_submit_through_the_updater_equals_the_jax_package(name, parallelism):
    """``Controller.submit`` on the same YAML drives each package's updater
    and autoscaler to the same stored job (spec, status, scale records but
    their times and the replica count they start from, which the
    autoscaler's first pass reads while the updater may still be creating
    the trainers; the minted auth token is random in both) and the same pods:
    the elastic job grows to its max of 4 four-chip trainers on 2 x 8
    chips, the strict one stays at 2."""
    assert _submit_and_settle("torch", JOB_YAMLS[name], parallelism) == \
        _submit_and_settle("jax", JOB_YAMLS[name], parallelism)


# -- tests/test_autoscaler.py, mirrored ------------------------------------------


def test_fulfillment_math():
    assert fulfillment(make_job("a", min_i=2, max_i=10, cur=2)) == 0.0
    assert fulfillment(make_job("a", min_i=2, max_i=10, cur=10)) == 1.0
    assert fulfillment(make_job("a", min_i=2, max_i=6, cur=4)) == 0.5
    assert fulfillment(make_job("a", min_i=3, max_i=3, cur=3)) == 1.0


def test_sort_order_starved_first_with_hunger_tiebreak():
    starved = make_job("starved", min_i=2, max_i=10, cur=2)
    happy = make_job("happy", min_i=2, max_i=10, cur=10)
    mid_small = make_job("mid-small", min_i=2, max_i=6, cur=4, chips=4)
    mid_big = make_job("mid-big", min_i=2, max_i=6, cur=4, chips=8)
    order = [s.name for s in sorted_jobs_by_fulfillment([happy, mid_small, mid_big, starved])]
    assert order == ["starved", "mid-big", "mid-small", "happy"]


def test_scale_up_when_chips_free():
    r = snapshot(tpu_cluster(n_hosts=4))
    s = make_job("j", cur=2)
    r.assign("host0", s.request())
    r.assign("host1", s.request())
    assert scale_dry_run(r, s, 0, 0.97, scale_down=False) == 1
    assert r.requested["tpu"] == 12.0


def _exhausted():
    r = snapshot(tpu_cluster(n_hosts=2))  # 8 chips, all taken
    s = make_job("j", cur=2)
    r.assign("host0", s.request())
    r.assign("host1", s.request())
    return r, s


def _fragmented():
    """6 chips free cluster-wide but only 2 a host: a 4-chip granule must
    not fit."""
    r = snapshot(tpu_cluster(n_hosts=3, chips_per_host=4))
    for h in ("host0", "host1", "host2"):
        r.assign(h, ResourceList.make({"tpu": 2}))
    return r, make_job("j", chips=4, cur=0)


def _memory_short():
    return (snapshot(tpu_cluster(n_hosts=1, chips_per_host=16, mem_gi=2)),
            make_job("j", mem="3Gi", cur=0))


@pytest.mark.parametrize("case", [_exhausted, _fragmented, _memory_short],
                         ids=["chip_exhaustion", "fragmentation", "memory"])
def test_scale_up_blocked(case):
    r, s = case()
    assert scale_dry_run(r, s, 0, 0.97, scale_down=False) == 0


def test_scale_up_blocked_by_cpu_ceiling():
    r = snapshot(tpu_cluster(n_hosts=1, chips_per_host=16, cpu=10))
    s = make_job("j", cpu="4", cur=0)
    assert scale_dry_run(r, s, 0, 0.97, scale_down=False) == 1
    assert scale_dry_run(r, s, 1, 0.97, scale_down=False) == 1
    assert scale_dry_run(r, s, 2, 0.97, scale_down=False) == 0  # 12 > 0.97 x 10


def test_scale_down_on_overcommit():
    r = snapshot(tpu_cluster(n_hosts=1, chips_per_host=8))
    s = make_job("j", cur=3)
    r.requested.add(ResourceList.make({"tpu": 12, "cpu": 3, "memory": "3Gi"}))
    assert scale_dry_run(r, s, 0, 0.97, scale_down=True) == -1
    assert r.requested["tpu"] == 8.0


def test_scale_down_respects_min_instance():
    r = snapshot(tpu_cluster(n_hosts=1, chips_per_host=4))
    s = make_job("j", min_i=2, cur=2)
    r.requested.add(ResourceList.make({"tpu": 8}))
    assert scale_dry_run(r, s, 0, 0.97, scale_down=True) == 0


def test_fixed_point_fills_cluster():
    r = snapshot(tpu_cluster(n_hosts=4, chips_per_host=4))
    a = make_job("a", min_i=1, max_i=10, cur=1)
    b = make_job("b", min_i=1, max_i=10, cur=1)
    r.assign("host0", a.request())
    r.assign("host1", b.request())
    diff = scale_all_dry_run(r, [a, b], 0.97)
    assert diff["a"] + diff["b"] == 2
    assert abs(diff["a"] - diff["b"]) <= 1


def test_fixed_point_favors_starved_job():
    r = snapshot(tpu_cluster(n_hosts=4, chips_per_host=4))
    rich = make_job("rich", min_i=1, max_i=4, cur=3)
    poor = make_job("poor", min_i=1, max_i=4, cur=1)
    for h in ("host0", "host1", "host2"):
        r.assign(h, rich.request())
    r.assign("host3", poor.request())
    diff = scale_all_dry_run(r, [rich, poor], 0.97)
    assert diff == {"rich": 0, "poor": 0} or diff["poor"] >= diff["rich"]


def _scaler(cluster, *jobs):
    scaler = Autoscaler(cluster, AutoscalerConfig(loop_seconds=0.01))
    for job in jobs:
        scaler.on_add(job)
    for _ in jobs:
        scaler._apply_event(scaler._events.get_nowait())
    return scaler


def test_autoscaler_end_to_end_with_fake_cluster():
    cluster = FakeCluster(tpu_cluster(n_hosts=4, chips_per_host=4))
    job = make_job("grow", min_i=1, max_i=10, cur=1).job
    cluster.create_role("grow", "trainer", 1, job.trainer_request(), job.trainer_limit())
    scaler = _scaler(cluster, job)
    assert scaler.step()["grow"] == 4
    assert cluster.get_trainer_parallelism("grow") == 4
    assert len([p for p in cluster.pods if p.phase == "Running"]) == 4
    assert scaler.step() == {}
    assert job.status.scale_history[-1].to_replicas == 4


def test_make_room_for_pending_job():
    cluster = FakeCluster(tpu_cluster(n_hosts=4, chips_per_host=4))
    hog = make_job("hog", min_i=1, max_i=4, cur=4).job
    cluster.create_role("hog", "trainer", 4, hog.trainer_request(), hog.trainer_limit())
    newbie = make_job("newbie", min_i=1, max_i=4, cur=1).job
    cluster.create_role("newbie", "trainer", 1, newbie.trainer_request(),
                        newbie.trainer_limit())
    assert all(p.phase == "Pending" for p in cluster.job_pods("newbie"))
    scaler = _scaler(cluster, hog, newbie)
    for _ in range(5):
        scaler.step()
    assert cluster.get_trainer_parallelism("hog") < 4
    assert all(p.phase == "Running" for p in cluster.job_pods("newbie"))


def make_serving_job(name, min_i=1, max_i=6, chips=4, p99=0.25, max_queue=8.0):
    return normalize(TrainingJob.from_dict({
        "metadata": {"name": name},
        "spec": {
            "tpu": {"chips_per_trainer": chips},
            "trainer": {"min_instance": min_i, "max_instance": max_i,
                        "resources": {"requests": {"cpu": "1", "memory": "1Gi"},
                                      "limits": {"cpu": "1", "memory": "1Gi"}}},
            "serving": {"model_dir": "/srv/model", "buckets": [1, 8, 32],
                        "slo_p99_seconds": p99, "max_queue_per_replica": max_queue},
        },
    }))


def serving_scaler(job, cur, n_hosts=4, signal=None):
    cluster = FakeCluster(tpu_cluster(n_hosts=n_hosts, chips_per_host=4))
    cluster.create_role(job.name, "trainer", cur, job.trainer_request(), job.trainer_limit())
    scaler = _scaler(cluster, job)
    scaler.register_serving_endpoints(job.name, ["http://replica:0"])
    scaler.serve_scrape = lambda url: signal
    return scaler, cluster


@pytest.mark.parametrize("breached,cur,min_i,max_i,hosts,want", [
    (True, 2, 1, 6, 4, [3, 4]),   # grows one replica a pass on a breached SLO
    (False, 3, 1, 6, 4, [2]),     # shrinks under a comfortable SLO
    (True, 2, 1, 2, 4, [2]),      # at max_instance: holds
    (True, 2, 1, 6, 2, [2]),      # chips exhausted: the grow finds no node
    (False, 2, 2, 6, 4, [2]),     # at min_instance: holds
    (None, 2, 1, 6, 4, [2]),      # nothing scraped: holds, never flaps blind
], ids=["grows", "shrinks", "max", "node_fit", "min", "no_scrapes"])
def test_serving_pass(breached, cur, min_i, max_i, hosts, want):
    """The serving SLO pass of `tests/test_autoscaler.py` (its grow,
    shrink, hold-without-scrapes, max/node-fit and min cases), one case a
    row: the replica count after each pass."""
    job = make_serving_job("serve", min_i=min_i, max_i=max_i)
    signal = None if breached is None else _signal("torch", breached)
    scaler, cluster = serving_scaler(job, cur, n_hosts=hosts, signal=signal)
    for parallelism in want:
        scaler.step()
        assert cluster.get_trainer_parallelism("serve") == parallelism
    if want[0] != cur:
        assert job.status.scale_history[-1].reason == "serving-slo"
    if breached is None:  # endpoints never registered at all: the same hold
        scaler._serve_endpoints.clear()
        assert scaler.step() == {}


def test_serving_spend_is_visible_to_training_fixed_point():
    cluster = FakeCluster(tpu_cluster(n_hosts=5, chips_per_host=4))
    serve = make_serving_job("serve")
    train = make_job("train", min_i=1, max_i=10, cur=1).job
    cluster.create_role("serve", "trainer", 2, serve.trainer_request(), serve.trainer_limit())
    cluster.create_role("train", "trainer", 1, train.trainer_request(), train.trainer_limit())
    scaler = _scaler(cluster, serve, train)
    scaler.register_serving_endpoints("serve", ["http://replica:0"])
    scaler.serve_scrape = lambda url: _signal("torch", True)
    target = scaler.step()
    assert target["serve"] == 3
    assert target["train"] == 2  # not 3: serving's grow ate a granule
    assert cluster.get_trainer_parallelism("serve") == 3
    assert cluster.get_trainer_parallelism("train") == 2


def test_make_room_shrinks_serving_above_floor():
    cluster = FakeCluster(tpu_cluster(n_hosts=4, chips_per_host=4))
    serve = make_serving_job("serve", min_i=1, max_i=4)
    cluster.create_role("serve", "trainer", 4, serve.trainer_request(), serve.trainer_limit())
    newbie = make_job("newbie", min_i=1, max_i=4, cur=1).job
    cluster.create_role("newbie", "trainer", 1, newbie.trainer_request(),
                        newbie.trainer_limit())
    scaler = _scaler(cluster, serve, newbie)
    for _ in range(5):
        scaler.step()
    assert cluster.get_trainer_parallelism("serve") < 4
    assert all(p.phase == "Running" for p in cluster.job_pods("newbie"))
    assert {r.reason for r in serve.status.scale_history} == {"make-room"}


# -- tests/test_controller.py, mirrored ------------------------------------------


class TestJobStore:
    def test_crud_and_watch_replay(self):
        store = JobStore()
        job = TrainingJob.from_dict(make_job_dict("a"))
        store.create(job)
        assert store.get("a").name == "a"
        with pytest.raises(KeyError):
            store.create(job)
        seen = []
        store.watch(FuncWatcher(on_add=lambda j: seen.append(j.name)), replay=True)
        assert seen == ["a"]
        store.delete("a")
        assert store.list() == []
        with pytest.raises(KeyError):
            store.get("a")

    def test_status_is_a_subresource(self):
        store = JobStore()
        store.create(TrainingJob.from_dict(make_job_dict("a")))
        st = store.get("a").status
        st.phase = JobPhase.RUNNING
        store.update_status("a", st)
        newer = store.get("a")
        newer.status.phase = JobPhase.NONE
        newer.spec.passes = 7
        store.update(newer)
        got = store.get("a")
        assert got.spec.passes == 7
        assert got.status.phase == JobPhase.RUNNING

    def test_copies_are_isolated(self):
        store = JobStore()
        store.create(TrainingJob.from_dict(make_job_dict("a")))
        store.get("a").spec.image = "mutated"
        assert store.get("a").spec.image == "edl-tpu:test"


class TestJobParser:
    def test_creation_order_and_env(self):
        job = normalize(TrainingJob.from_dict(make_job_dict("ctr", min_i=2, max_i=4, chips=4)))
        workloads = parse_job(job)
        assert [w.role for w in workloads] == [ROLE_COORDINATOR, ROLE_TRAINER]
        assert workloads[1].replicas == 2
        assert workloads[1].requests.get_q("tpu") == 4.0
        env = make_env(job, ROLE_TRAINER)
        assert env["EDL_JOB_NAME"] == "ctr"
        assert env["EDL_COORDINATOR_ENDPOINT"] == "ctr-coordinator.default:7164"
        assert env["EDL_FAULT_TOLERANT"] == "1"
        assert env["EDL_ENTRY"] == "python train.py"
        assert not any(k.endswith("TRAINER_ID") for k in env)

    def test_user_env_wins(self):
        d = make_job_dict("a")
        d["spec"]["trainer"]["env"] = {"EDL_PASSES": "99", "CUSTOM": "x"}
        env = make_env(normalize(TrainingJob.from_dict(d)), ROLE_TRAINER)
        assert env["EDL_PASSES"] == "99"
        assert env["CUSTOM"] == "x"


def _phase(controller, name):
    return controller.job_status(name).status.phase


def _running(controller, name, **kw):
    controller.submit(TrainingJob.from_dict(make_job_dict(name, **kw)))
    assert wait_until(lambda: _phase(controller, name) == JobPhase.RUNNING)


class TestLifecycle:
    def test_submit_materializes_and_runs(self, controller):
        _running(controller, "j1", min_i=2, max_i=2)
        assert len(controller.cluster.job_pods("j1", ROLE_COORDINATOR)) == 1
        assert len(controller.cluster.job_pods("j1", ROLE_TRAINER)) == 2

    def test_success_releases_coordinator(self, controller):
        _running(controller, "j1", min_i=2, max_i=2)
        for p in controller.cluster.job_pods("j1", ROLE_TRAINER):
            p.phase = "Succeeded"
        assert wait_until(lambda: _phase(controller, "j1") == JobPhase.SUCCEEDED)
        assert controller.cluster.job_pods("j1", ROLE_COORDINATOR) == []
        assert len(controller.cluster.job_pods("j1", ROLE_TRAINER)) == 2
        status = controller.job_status("j1").status
        assert set(status.replica_statuses.values()) == {"Succeeded"}

    def test_strict_job_fails_on_any_trainer_failure(self, controller):
        _running(controller, "j1", min_i=3, max_i=3)
        controller.cluster.job_pods("j1", ROLE_TRAINER)[0].phase = "Failed"
        assert wait_until(lambda: _phase(controller, "j1") == JobPhase.FAILED)
        assert "1/3" in controller.job_status("j1").status.reason

    def test_fault_tolerant_job_survives_partial_failure(self, controller):
        _running(controller, "j1", min_i=3, max_i=3, fault_tolerant=True)
        pods = controller.cluster.job_pods("j1", ROLE_TRAINER)
        pods[0].phase = "Failed"
        time.sleep(0.2)  # several convert ticks
        assert _phase(controller, "j1") == JobPhase.RUNNING
        for p in pods:
            p.phase = "Failed"
        assert wait_until(lambda: _phase(controller, "j1") == JobPhase.FAILED)
        assert controller.job_status("j1").status.reason == "all trainers failed"

    def test_admission_rejection_sets_failed_status(self, controller):
        controller.submit(TrainingJob.from_dict(make_job_dict("bad", min_i=3, max_i=1)))
        assert wait_until(lambda: _phase(controller, "bad") == JobPhase.FAILED)
        assert "admission" in controller.job_status("bad").status.reason
        assert controller.cluster.job_pods("bad", ROLE_TRAINER) == []

    def test_delete_gcs_all_roles(self, controller):
        _running(controller, "j1", min_i=2, max_i=2)
        controller.delete("j1")
        assert wait_until(lambda: controller.cluster.job_pods("j1", ROLE_TRAINER) == []
                          and controller.cluster.job_pods("j1", ROLE_COORDINATOR) == [])


def test_replay_adopts_running_and_skips_terminal():
    """A restarted controller replays the store: running jobs are adopted
    (no duplicate pods), terminal jobs are left alone."""
    cluster = FakeCluster(nodes())
    store = JobStore()
    config = AutoscalerConfig(loop_seconds=0.05)
    c1 = Controller(cluster, store=store, autoscaler_config=config,
                    updater_config=FAST).start()
    _running(c1, "run", min_i=2, max_i=2)
    _running(c1, "done", min_i=1, max_i=1)
    for p in cluster.job_pods("done", ROLE_TRAINER):
        p.phase = "Succeeded"
    assert wait_until(lambda: _phase(c1, "done") == JobPhase.SUCCEEDED)
    c1.stop()
    c2 = Controller(cluster, store=store, autoscaler_config=config,
                    updater_config=FAST).start()
    try:
        assert wait_until(lambda: _phase(c2, "run") == JobPhase.RUNNING)
        assert len(cluster.job_pods("run", ROLE_TRAINER)) == 2
        assert len(cluster.job_pods("run", ROLE_COORDINATOR)) == 1
        time.sleep(0.2)
        assert _phase(c2, "done") == JobPhase.SUCCEEDED
        assert cluster.job_pods("done", ROLE_COORDINATOR) == []
    finally:
        c2.stop()


def test_elastic_job_scales_to_capacity(controller):
    """2 hosts x 8 chips, 4 a trainer: the elastic job grows from 1 to 4."""
    _running(controller, "e1", min_i=1, max_i=8, chips=4)
    assert wait_until(lambda: controller.cluster.get_trainer_parallelism("e1") == 4)
    assert wait_until(lambda: controller.job_status("e1").status.scale_history
                      and controller.job_status("e1").status.scale_history[-1].to_replicas
                      == 4)


def test_two_jobs_share_chips(controller):
    controller.submit(TrainingJob.from_dict(make_job_dict("e1", min_i=1, max_i=8, chips=4)))
    _running(controller, "e2", min_i=1, max_i=8, chips=4)

    def settled():
        p1 = controller.cluster.get_trainer_parallelism("e1")
        p2 = controller.cluster.get_trainer_parallelism("e2")
        return p1 + p2 == 4 and p1 >= 1 and p2 >= 1

    assert wait_until(settled)


# -- the collector ---------------------------------------------------------------


def test_collector_samples_equal_the_jax_package():
    """The same store and cluster state sampled by both packages'
    collectors: equal records but the timestamp, and equal JSONL keys."""
    import io

    out = {}
    for side in PKG:
        api = mod(side, "api")
        ctl = mod(side, "controller")
        cluster = ctl.FakeCluster([ctl.NodeInfo(name=f"h{i}", allocatable=api.ResourceList.make(
            {"cpu": 16, "memory": "64Gi", "tpu": 4})) for i in range(3)])
        store = ctl.JobStore()
        for name, (lo, hi, cur) in {"a": (1, 4, 3), "b": (1, 1, 1), "c": (2, 2, 2)}.items():
            job = mod(side, "api.validation").normalize(api.TrainingJob.from_dict({
                "metadata": {"name": name},
                "spec": {"tpu": {"chips_per_trainer": 1},
                         "trainer": {"min_instance": lo, "max_instance": hi}}}))
            store.create(job)
            cluster.create_role(name, "trainer", cur, job.trainer_request(),
                                job.trainer_limit())
        sink = io.StringIO()
        collector = mod(side, "tools.collector").Collector(store, cluster, sink=sink)
        sample = collector.sample().to_dict()
        sample.pop("timestamp")
        line = json.loads(sink.getvalue().splitlines()[-1])
        out[side] = (sample, sorted(line), collector.peak_tpu_utilization())
    assert out["torch"] == out["jax"]
    assert out["torch"][0]["tpu_utilization"] == 0.5  # 6 one-chip trainers on 12 chips


# -- tests/test_actuation.py's unit cases, mirrored --------------------------------


@pytest.fixture(scope="module")
def coordinator_binary():
    try:
        return ensure_built()
    except Exception as e:  # no toolchain: the native cases cannot run
        pytest.skip(f"native coordinator does not build here: {e}")


def test_actuator_publishes_world_and_nudges_epoch(coordinator_binary):
    with CoordinatorServer() as server:
        actuator = CoordinatorActuator()
        actuator.set_endpoint("job", "127.0.0.1", server.port)
        assert actuator.publish_expected_world("job", 3)
        probe = server.client("probe")
        assert probe.kv_get(EXPECTED_WORLD_KEY) == "3"
        before = probe.epoch()
        assert actuator.nudge("job")
        assert probe.epoch() == before + 1
        assert actuator.publish_and_nudge("job", 2)
        assert probe.kv_get(EXPECTED_WORLD_KEY) == "2"
        assert probe.epoch() == before + 2
        assert not actuator.publish_expected_world("ghost", 2)
        assert not actuator.nudge("ghost")


def test_actuator_tracks_endpoint_from_spec():
    job = normalize(TrainingJob.from_dict({
        "metadata": {"name": "j1", "namespace": "ns"},
        "spec": {"port": 7200, "trainer": {"min_instance": 1, "max_instance": 2}},
    }))
    actuator = CoordinatorActuator()
    actuator.track(job)
    assert actuator._endpoints["j1"] == ("j1-coordinator.ns", 7200)
    explicit = CoordinatorActuator()
    explicit.set_endpoint("j1", "127.0.0.1", 9999)
    explicit.track(job)
    assert explicit._endpoints["j1"] == ("127.0.0.1", 9999)


# -- ProcessCluster --------------------------------------------------------------

#: a pod whose leader dies on SIGTERM at once, leaving a child behind in its
#: group, as the coordinator pod's launcher leaves its native server
ORPHANING_POD = ("{py} -c \"import subprocess, sys, time; "
                 "p = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(60)']); "
                 "open({marker!r}, 'w').write(str(p.pid)); time.sleep(60)\"")


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    with open(f"/proc/{pid}/stat") as f:  # a zombie awaiting its reaper is gone too
        return f.read().split()[2] != "Z"


def test_process_cluster_pod_teardown_takes_the_whole_group(tmp_path):
    """Deleting a role kills every process of each of its pods, as a
    container's processes die with its PID 1: the leader exits on SIGTERM
    at once and its child (the coordinator launcher's native server, in a
    real pod) must not outlive it. The JAX package's `ProcessCluster`
    leaves the child running."""
    from edl_tpu_torch.controller.jobparser import RoleWorkload

    marker = tmp_path / "child.pid"
    cluster = ProcessCluster(tpu_cluster(n_hosts=1))
    workload = RoleWorkload(job_name="j", role="coordinator", replicas=1, image="",
                            entrypoint=ORPHANING_POD.format(py=sys.executable,
                                                            marker=str(marker)),
                            requests=ResourceList(), limits=ResourceList())
    cluster.create_role("j", "coordinator", 1, ResourceList(), ResourceList(), workload)
    try:
        assert wait_until(marker.exists, timeout=30.0)
        child = int(wait_until(marker.read_text, timeout=5.0) and marker.read_text())
        assert _alive(child)
        cluster.delete_role("j", "coordinator")
        assert wait_until(lambda: not _alive(child), timeout=5.0)
        assert cluster.job_pods("j", "coordinator") == []
    finally:
        cluster.shutdown(grace=1.0)


# -- the live loops --------------------------------------------------------------


def _group_port():
    """A job port whose next port (where the ranks' process group listens,
    ``EDL_PORT`` + 1) is free and lies below the host's ephemeral range.

    Every pod of a `ProcessCluster` shares the host's ports. An ephemeral
    port (the coordinator server's own, or the local end of any outgoing
    connection on a loaded host) plus one may be held by some connection
    when the ranks bind it: rank 0's store then fails with EADDRINUSE and
    the pod fails. Ports below the ephemeral range are never handed out by
    the kernel, so only an explicit bind can take one."""
    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        low = int(f.read().split()[0])
    rng = random.Random()
    for _ in range(200):
        port = rng.randrange(max(1024, low - 12000), low - 2)
        with socket.socket() as probe:
            try:
                probe.bind(("0.0.0.0", port + 1))
            except OSError:
                continue
        return port
    raise RuntimeError("no free process-group port below the ephemeral range")


def _live_job(name, min_i, max_i, server, tmp_path, **env):
    """A fit_a_line job of `tests/torch_mh_worker.py` ranks under the port's
    launcher, against ``server``; the ranks' process group listens on the
    job's port plus one (``EDL_PORT`` + 1), from `_group_port`."""
    return normalize(TrainingJob.from_dict({
        "metadata": {"name": name},
        "spec": {
            "fault_tolerant": True,
            "port": _group_port(),
            "tpu": {"chips_per_trainer": 4},
            "trainer": {
                "min_instance": min_i, "max_instance": max_i,
                "entrypoint": f"{sys.executable} -m edl_tpu_torch.launcher start_trainer",
                "resources": {"requests": {"cpu": 1}},
                "env": {"EDL_COORDINATOR_ENDPOINT": server.address,
                        "EDL_ENTRY": f"{sys.executable} {TESTS / 'torch_mh_worker.py'}",
                        "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
                        "PYTHONUNBUFFERED": "1",
                        "CKPT_DIR": str(tmp_path / f"ck-{name}"),
                        "RESULT": str(tmp_path / f"{name}.jsonl"),
                        "EDL_TERMINATION_LOG": str(tmp_path / f"term-{name}"),
                        **{k: str(v) for k, v in env.items()}},
            },
        },
    }))


def _until(cond, deadline, what, cluster):
    while not cond():
        if time.monotonic() > deadline:
            logs = {p.info.name: Path(p.log_path).read_text()[-1500:]
                    for p in cluster.pods if p.log_path and os.path.exists(p.log_path)}
            pytest.fail(f"{what}; pods {[(p.info.name, p.info.phase) for p in cluster.pods]}"
                        f"\n{json.dumps(logs, indent=1)}")
        time.sleep(0.1)


def _finals(path):
    """Each worker's last incarnation's summary line."""
    finals = {}
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        finals[rec["worker"]] = rec
    return finals


def _wait_drained(cluster, deadline, what):
    _until(lambda: all(p.proc is None or p.proc.poll() is not None for p in cluster.pods),
           deadline, what, cluster)


def test_autoscaler_rescales_live_two_process_job_to_three(coordinator_binary, tmp_path):
    """The port of `tests/test_actuation.py`'s live loop: a `ProcessCluster`
    runs 2 trainer pods (launcher + fit_a_line rank over gloo) against the
    native coordinator; once world 2 has committed shards, an Autoscaler
    sees a free granule, decides 2 -> 3, publishes ``edl/expected_world``,
    spawns the third pod and nudges the epoch; both ranks exit 75, are
    relaunched, and all three drain the queue at world 3."""
    deadline = time.monotonic() + LIVE_S
    records = []
    with CoordinatorServer(task_lease_sec=60.0, heartbeat_ttl_sec=30.0) as server:
        admin = server.client("admin")
        admin.add_tasks([f"mh/part-{i:05d}" for i in range(60)])
        admin.kv_put(EXPECTED_WORLD_KEY, "2")
        job = _live_job("asjob", 2, 3, server, tmp_path, BATCHES_PER_SHARD=3,
                        BATCH_SLEEP=0.02, CKPT_INTERVAL=3)
        # 3 hosts x 4 chips: room for exactly 3 trainers
        cluster = ProcessCluster([NodeInfo(name=f"h{i}", allocatable=ResourceList.make(
            {"cpu": 16, "tpu": 4})) for i in range(3)], log_dir=str(tmp_path / "logs"))
        trainer = parse_to_trainer(job)
        try:
            cluster.create_role(job.name, "trainer", 2, trainer.requests, trainer.limits,
                                workload=trainer)
            _until(lambda: int(admin.status().get("done", 0)) >= 2, deadline,
                   "the world-2 job never committed a shard", cluster)
            actuator = CoordinatorActuator()
            actuator.set_endpoint(job.name, "127.0.0.1", server.port)
            scaler = Autoscaler(cluster, AutoscalerConfig(loop_seconds=0.5))
            scaler.actuator = actuator
            scaler.on_scaled = lambda name, rec: records.append((name, rec))
            scaler.on_add(job)
            scaler.start()
            try:
                _until(lambda: records, deadline, "the autoscaler never actuated", cluster)
            finally:
                scaler.stop()
            name, record = records[0]
            assert (name, record.from_replicas, record.to_replicas, record.reason) == \
                ("asjob", 2, 3, "autoscale")
            assert admin.kv_get(EXPECTED_WORLD_KEY) == "3"
            _wait_drained(cluster, deadline, "the world-3 job never drained")
            pods = cluster.job_pods(job.name, "trainer")
            assert [p.phase for p in pods] == ["Succeeded"] * 3
            st = admin.status()
            assert (int(st["queued"]), int(st["leased"]), int(st["done"])) == (0, 0, 60)
        finally:
            cluster.shutdown(grace=2.0)
    finals = _finals(tmp_path / "asjob.jsonl")
    assert len(finals) == 3, finals.keys()
    assert all(m["world"] == 3 and m["exit"] == 0 for m in finals.values()), finals


def test_make_room_shrinks_a_live_job_to_admit_a_pending_one(coordinator_binary, tmp_path):
    """The port of `tests/test_multijob.py`'s shrink-to-admit: job A trains
    at world 2 on both hosts; job B (min = max = 1) arrives with nowhere to
    go and its pod pends; the autoscaler's make-room pass shrinks A 2 -> 1
    (the newest pod gets SIGTERM and leaves at a round boundary, the other
    exits 75 and comes back at world 1), B's pod is placed and trains, and
    both queues drain."""
    deadline = time.monotonic() + LIVE_S
    records = []
    with CoordinatorServer(task_lease_sec=60.0, heartbeat_ttl_sec=30.0) as a_server, \
            CoordinatorServer(task_lease_sec=60.0, heartbeat_ttl_sec=30.0) as b_server:
        a_admin, b_admin = a_server.client("admin"), b_server.client("admin")
        a_admin.add_tasks([f"a/part-{i:05d}" for i in range(30)])
        a_admin.kv_put(EXPECTED_WORLD_KEY, "2")
        b_admin.add_tasks([f"b/part-{i:05d}" for i in range(2)])
        a_job = _live_job("ajob", 1, 2, a_server, tmp_path, BATCHES_PER_SHARD=3,
                          BATCH_SLEEP=0.02, CKPT_INTERVAL=3)
        b_job = _live_job("bjob", 1, 1, b_server, tmp_path, BATCHES_PER_SHARD=2)
        # 2 hosts x 4 chips: room for exactly 2 trainers
        cluster = ProcessCluster([NodeInfo(name=f"h{i}", allocatable=ResourceList.make(
            {"cpu": 16, "tpu": 4})) for i in range(2)], log_dir=str(tmp_path / "logs"))
        try:
            a_trainer = parse_to_trainer(a_job)
            cluster.create_role("ajob", "trainer", 2, a_trainer.requests, a_trainer.limits,
                                workload=a_trainer)
            _until(lambda: int(a_admin.status().get("done", 0)) >= 2, deadline,
                   "job A never committed a shard at world 2", cluster)
            b_trainer = parse_to_trainer(b_job)
            cluster.create_role("bjob", "trainer", 1, b_trainer.requests, b_trainer.limits,
                                workload=b_trainer)
            assert [p.phase for p in cluster.job_pods("bjob", "trainer")] == ["Pending"]
            actuator = CoordinatorActuator()
            actuator.set_endpoint("ajob", "127.0.0.1", a_server.port)
            actuator.set_endpoint("bjob", "127.0.0.1", b_server.port)
            scaler = Autoscaler(cluster, AutoscalerConfig(loop_seconds=0.5))
            scaler.actuator = actuator
            scaler.on_scaled = lambda name, rec: records.append((name, rec))
            scaler.on_add(a_job)
            scaler.on_add(b_job)
            scaler.start()
            try:
                _until(lambda: all(p.phase == "Running"
                                   for p in cluster.job_pods("bjob", "trainer")),
                       deadline, "job B's pod was never placed", cluster)
            finally:
                scaler.stop()
            assert [(n, r.from_replicas, r.to_replicas, r.reason) for n, r in records] == \
                [("ajob", 2, 1, "make-room")]
            assert a_admin.kv_get(EXPECTED_WORLD_KEY) == "1"
            _wait_drained(cluster, deadline, "the jobs never drained")
            assert [p.phase for p in cluster.job_pods("bjob", "trainer")] == ["Succeeded"]
            assert [p.phase for p in cluster.job_pods("ajob", "trainer")] == ["Succeeded"]
            for admin, n in ((a_admin, 30), (b_admin, 2)):
                st = admin.status()
                assert (int(st["queued"]), int(st["leased"]), int(st["done"])) == (0, 0, n)
        finally:
            cluster.shutdown(grace=2.0)
    a_finals = _finals(tmp_path / "ajob.jsonl")
    b_finals = _finals(tmp_path / "bjob.jsonl")
    survivor = [m for m in a_finals.values() if m["world"] == 1]
    assert len(survivor) == 1 and survivor[0]["exit"] == 0 and \
        survivor[0]["metrics"]["steps"] > 0, a_finals
    assert len(b_finals) == 1
    (b,) = b_finals.values()
    assert b["world"] == 1 and b["exit"] == 0 and b["metrics"]["steps"] == 4.0  # 2 x 2
