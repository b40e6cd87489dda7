"""The port's CLI (``python -m edl_tpu_torch``, `edl_tpu_torch.cli`) and
elastic demo against the JAX package's.

Both CLIs run in this process on the same inputs, every flag whose default
differs between them (the port's defaults are an H100's) passed
explicitly: ``validate``, ``run`` on the FakeCluster, ``plan --json`` and
``status --json`` against one coordinator print equal JSON (the
coordinator counters that count the calls themselves aside). ``train --device cpu`` prints the JAX CLI's metric
keys. The two elastic demos run side by side as subprocesses and print the
same stage and summary lines. No tolerance: the outputs are equal.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

JOB = """
metadata: {name: demo}
spec:
  image: edl-tpu:test
  tpu: {chips_per_trainer: 4}
  trainer:
    entrypoint: python train.py
    min_instance: 2
    max_instance: 2
    resources:
      requests: {cpu: 1, memory: 1Gi}
"""
BAD = "metadata: {name: x}\nspec:\n  trainer: {min_instance: 5, max_instance: 1}\n"
#: the fake cluster's shape, passed to both CLIs (their defaults differ)
NODES = ["--hosts", "2", "--chips-per-host", "4", "--cpu-per-host", "16",
         "--memory-per-host", "64Gi"]
PLAN = ["plan", "--json", "--slices", "4,4", "--chips", "8", "--global-batch", "512",
        "--param-mb", "900", "--replicated-mb", "10", "--layers", "12",
        "--flops-per-sample", "7.3e11", "--activation-mb", "24",
        "--chip-flops", "1e12", "--hbm-gib", "16"]
#: status counters that count the requests themselves, or the clock
VOLATILE = ("ops", "turns", "uptime_seconds", "batch_frames", "batch_subops")


def _both(capsys, argv):
    """(rc, stdout) of each package's ``main(argv)``, JAX's first."""
    from edl_tpu.cli import main as jax_main
    from edl_tpu_torch.cli import main as port_main

    out = {}
    for side, main in (("jax", jax_main), ("torch", port_main)):
        rc = main(list(argv))
        out[side] = (rc, capsys.readouterr().out)
    return out


@pytest.mark.parametrize("text,rc", [(JOB, 0), (BAD, 1)], ids=["valid", "invalid"])
def test_validate_equals_the_jax_cli(tmp_path, capsys, text, rc):
    path = tmp_path / "job.yaml"
    path.write_text(text)
    out = _both(capsys, ["validate", "-f", str(path)])
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == rc
    if rc == 0:
        assert json.loads(out["torch"][1])["spec"]["port"] == 7164  # defaulted


def test_run_on_the_fake_cluster_equals_the_jax_cli(tmp_path, capsys):
    """Two trainers of 4 chips on 2 x 4 chips: both control planes run the
    job and report the same status when ``run``'s timeout ends the wait
    (the fake cluster's pods never finish: exit 2)."""
    path = tmp_path / "job.yaml"
    path.write_text(JOB)
    out = _both(capsys, ["run", "-f", str(path), "--timeout", "2", "--collect-period",
                         "60", "--max-load-desired", "0.97", *NODES])
    assert out["torch"] == out["jax"]
    rc, text = out["torch"]
    st = json.loads(text)
    assert rc == 2 and st["phase"] == "Running" and st["parallelism"] == 2
    assert sorted(st["replica_statuses"].values()) == ["Running", "Running"]


def test_plan_json_equals_the_jax_cli(capsys, monkeypatch):
    """Every flag passed; the fabric's link rates, which the CLI takes no
    flag for (the port's are NVLink's and InfiniBand's), set to the JAX
    package's."""
    import functools

    import edl_tpu.parallel.planner as jax_planner
    import edl_tpu_torch.parallel as port_parallel

    monkeypatch.setattr(port_parallel, "Topology", functools.partial(
        port_parallel.Topology, ici_bps=jax_planner.ICI_BYTES_PER_SEC,
        dcn_bps=jax_planner.DCN_BYTES_PER_SEC))
    out = _both(capsys, PLAN)
    assert out["torch"][0] == out["jax"][0] == 0
    assert json.loads(out["torch"][1]) == json.loads(out["jax"][1])


def test_plan_defaults_are_the_cards(capsys, monkeypatch):
    """Without the flags the port plans for H100s: 989 TFLOP/s bf16 and 80
    GiB a card, two nodes of 8."""
    import edl_tpu_torch.parallel as port_parallel
    from edl_tpu_torch.cli import main

    seen = []
    plan_layout = port_parallel.plan_layout
    monkeypatch.setattr(port_parallel, "plan_layout",
                        lambda chips, topology, *a, **kw: seen.append(topology)
                        or plan_layout(chips, topology, *a, **kw))
    assert main(["plan", "--json", "--param-mb", "400"]) == 0
    assert json.loads(capsys.readouterr().out)["chips"] == 16
    (topology,) = seen
    assert topology.slices == (8, 8)
    assert topology.chip_flops == 989e12 and topology.hbm_bytes == 80 * 2**30
    assert topology == port_parallel.Topology(slices=(8, 8))


def test_status_json_equals_the_jax_cli(capsys):
    from edl_tpu_torch.coordinator import CoordinatorServer
    from edl_tpu_torch.runtime.data import shard_names

    with CoordinatorServer() as server:
        w = server.client("trainer-0")
        w.register()
        w.add_tasks(shard_names("cli", 3))
        assert w.acquire_task() is not None
        w.kv_put("edl/ft_policy/trainer-0", json.dumps({"policy": "adaptive", "mode": "park"}))
        out = _both(capsys, ["status", "--port", str(server.port), "--json"])
    status = {}
    for side, (rc, text) in out.items():
        st = json.loads(text)
        assert all(k in st for k in VOLATILE)
        status[side] = (rc, {k: v for k, v in st.items() if k not in VOLATILE})
    assert status["torch"] == status["jax"]
    rc, st = status["torch"]
    assert rc == 0 and st["leased"] == 1 and st["lease_holders"] == ["trainer-0=1"]
    assert st["ft_policy"]["trainer-0"]["mode"] == "park"


def test_status_unreachable_coordinator(capsys):
    from edl_tpu_torch.cli import main

    assert main(["status", "--port", "1", "--timeout", "0.5"]) == 1
    assert "ERROR" in capsys.readouterr().err


def test_train_on_the_cpu_gives_the_jax_cli_keys(capsys):
    from edl_tpu.cli import main as jax_main
    from edl_tpu_torch.cli import main as port_main

    argv = ["train", "--model", "fit_a_line", "--steps", "5", "--batch-size", "64"]
    assert jax_main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert port_main([*argv, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert sorted(got) == sorted(want)
    assert got["steps"] == want["steps"] == 5


def test_train_without_a_card_raises_unless_the_cpu_is_asked_for():
    import torch

    from edl_tpu_torch.cli import main

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default device is real")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["train", "--model", "fit_a_line", "--steps", "1"])


def test_elastic_demo_prints_the_jax_demos_lines():
    """The two demos side by side: 10 hosts x 4 chips, job1 grows to 10
    trainers, job2 takes 2 of them (job1 -> 8), job3 takes 4 more (job1 ->
    4), nothing pending; every stage line and the summary equal."""
    env = {**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu"}
    procs = [subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in ([sys.executable, "examples/elastic_demo.py"],
                         [sys.executable, "-m", "edl_tpu_torch.examples.elastic_demo"])]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    lines = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        lines.append([json.loads(line) for line in out.splitlines()])
    jax_lines, port_lines = lines
    assert port_lines == jax_lines
    assert [s["stage"] for s in port_lines[:4]] == [
        "idle", "job1-scaled", "job2-admitted", "job3-rebalanced"]
    assert [s["running_trainers"] for s in port_lines[1:4]] == [
        {"job1": 10}, {"job1": 8, "job2": 2}, {"job1": 4, "job2": 2, "job3": 4}]
    assert port_lines[-1]["ok"] is True
    assert port_lines[-1]["trajectory"] == [0.0, 1.0, 1.0, 1.0]
    assert all(s["pending_jobs"] == 0 for s in port_lines[:4])
