"""The port's deployment files: the images under ``deploy/torch/``, the job
manifests beside the port's entries, the Make targets, and the stager
`chip_smoke.py`'s deploy phase runs them with.

The port's control plane must run in the controller image, which holds
pyyaml and no torch or numpy: its CLI runs here in processes where both
fail to import (`_blocked`). Each port manifest is the JAX package's with
the image, the accelerator and the trainer entry changed, and nothing else.
"""

import ast
import importlib
import importlib.util
import json
import os
import re
import shlex
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import yaml

import chip_smoke
from edl_tpu_torch.api.types import TrainingJob
from edl_tpu_torch.api.validation import normalize
from edl_tpu_torch.cli import build_parser
from edl_tpu_torch.controller.jobparser import ROLE_TRAINER, parse_job

ROOT = Path(__file__).resolve().parents[1]
DEPLOY = ROOT / "deploy" / "torch"
DOCKERFILES = ("Dockerfile.trainer", "Dockerfile.controller")
#: example -> its trainer entry's file, as the JAX package keeps them
EXAMPLES = {"fit_a_line": "train_elastic", "ctr": "train", "word2vec": "train_ft",
            "mnist": "train", "lm": "train", "resnet": "train"}
#: the Make targets the port added
TARGETS = ("analyze-torch", "test-torch", "obs-smoke-torch", "serve-smoke-torch",
           "serve-lm-smoke-torch", "ckpt-plane-smoke-torch", "modelcheck-torch", "chip-smoke",
           "images-torch", "verify-torch")
#: how long a CLI subprocess may take
TIMEOUT = 120

#: runs ``python -m edl_tpu_torch ARGS`` where torch and numpy cannot be
#: imported, as in the controller image
_BLOCKED = textwrap.dedent("""
    import importlib.abc, runpy, sys

    class NotInTheImage(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.partition(".")[0] in ("torch", "numpy"):
                raise ImportError(f"{name} is not in the controller image")

    sys.meta_path.insert(0, NotInTheImage())
    sys.argv = ["edl_tpu_torch", *sys.argv[1:]]
    runpy.run_module("edl_tpu_torch", run_name="__main__", alter_sys=True)
""")


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT)}


def _blocked(*args, **kw) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", _BLOCKED, *args], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=TIMEOUT, **kw)


def _manifest(example: str) -> Path:
    return ROOT / "edl_tpu_torch" / "examples" / example / "job.yaml"


def _modules(command: list) -> list:
    """The modules ``command`` runs with ``python -m``."""
    return [command[i + 1] for i, word in enumerate(command[:-1]) if word == "-m"]


# -- the images ----------------------------------------------------------------


@pytest.mark.parametrize("name", DOCKERFILES)
def test_dockerfile_runs_port_modules_and_copies_what_exists(name):
    """Each ``python -m X`` of the image's ENTRYPOINT and CMD (and of the
    ``edl-launch`` shim the trainer image installs) names a module of the
    port, and each COPY source exists in the repo."""
    lines = chip_smoke.parse_dockerfile(str(DEPLOY / name))
    exec_forms = {i: json.loads(a) for _, i, a in lines if i in ("ENTRYPOINT", "CMD")}
    commands = [exec_forms["ENTRYPOINT"] + exec_forms["CMD"]]
    copies = [shlex.split(a)[:-1] for _, i, a in lines if i == "COPY"]
    if name == "Dockerfile.trainer":
        shim = (DEPLOY / "edl-launch").read_text().splitlines()
        assert shim[0] == "#!/bin/sh" and os.access(DEPLOY / "edl-launch", os.X_OK)
        commands.append(shlex.split(shim[1]))
    modules = [m for c in commands for m in _modules(c)]
    assert modules and all(m.split(".")[0] == "edl_tpu_torch" for m in modules)
    assert all(importlib.util.find_spec(m) is not None for m in modules), modules
    sources = [s for c in copies for s in c]
    assert "edl_tpu_torch/" in sources
    assert all((ROOT / s).exists() for s in sources), sources


def test_trainer_image_builds_the_coordinator_and_bakes_the_kernels():
    """One stage (make's mtimes see no binary from elsewhere): the
    coordinator built from its copied sources, the kernels baked once the
    package is in, ``edl-launch`` installed, the launcher the entrypoint."""
    lines = chip_smoke.parse_dockerfile(str(DEPLOY / "Dockerfile.trainer"))
    assert [a for _, i, a in lines if i == "FROM"] == ["nvidia/cuda:12.8.1-devel-ubuntu24.04"]
    order = [(i, a) for _, i, a in lines if i in ("COPY", "RUN")]
    make = order.index(("RUN", "make -C native/coordinator"))
    bake = order.index(("RUN", 'python -c "from edl_tpu_torch.ops._build import build; '
                               'build()"'))
    assert order.index(("COPY", "native/coordinator/coordinator.cc native/coordinator/Makefile "
                                "native/coordinator/")) < make
    assert order.index(("COPY", "edl_tpu_torch/ edl_tpu_torch/")) < bake
    assert ("COPY", "deploy/torch/edl-launch /usr/local/bin/edl-launch") in order
    assert not any("--from" in a for i, a in order if i == "COPY")


def _third_party_imports() -> set:
    """The top-level modules outside the standard library that
    ``edl_tpu_torch/`` imports, by AST."""
    found = set()
    for path in (ROOT / "edl_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            found |= {n.split(".")[0] for n in names}
    return found - set(sys.stdlib_module_names) - {"edl_tpu_torch"}


def test_pip_lines_cover_every_third_party_import():
    """The trainer image's pip lines install every third-party module the
    port imports; the controller image's, every one its control plane
    needs (pyyaml: the job YAML and kubeconfig)."""
    installed = {}
    for name in DOCKERFILES:
        for _, instruction, args in chip_smoke.parse_dockerfile(str(DEPLOY / name)):
            if instruction == "RUN" and args.startswith("pip"):
                _, packages = chip_smoke._packages(args)
                installed.setdefault(name, set()).update(
                    chip_smoke.PIP_MODULES[p.split("==")[0]] for p in packages)
    assert _third_party_imports() == installed["Dockerfile.trainer"] == {"numpy", "torch",
                                                                          "yaml"}
    assert installed["Dockerfile.controller"] == {"yaml"}


def test_controller_manifest_runs_the_port_cli():
    """The Deployment's command parses with the port's CLI as the
    ``controller`` subcommand, in the cluster, at the reference's 0.9; it
    runs the controller image under the shared RBAC's service account."""
    deployment = yaml.safe_load((DEPLOY / "controller.yaml").read_text())
    rbac = list(yaml.safe_load_all((ROOT / "deploy" / "rbac.yaml").read_text()))
    pod = deployment["spec"]["template"]["spec"]
    container = pod["containers"][0]
    command = container["command"]
    assert deployment["metadata"]["name"] == "edl-tpu-torch-controller"
    assert container["image"] == "edl-tpu-torch-controller:latest"
    assert command[:3] == ["python", "-m", "edl_tpu_torch"]
    args = build_parser().parse_args(command[3:])
    assert (args.command, args.in_cluster, args.max_load_desired, args.log_level) == (
        "controller", True, 0.9, "info")
    account = next(d for d in rbac if d["kind"] == "ServiceAccount")["metadata"]["name"]
    assert pod["serviceAccountName"] == account
    image = {i: json.loads(a) for _, i, a in chip_smoke.parse_dockerfile(
        str(DEPLOY / "Dockerfile.controller")) if i in ("ENTRYPOINT", "CMD")}
    args = build_parser().parse_args(image["ENTRYPOINT"][3:] + image["CMD"])
    assert (args.command, args.max_load_desired) == ("controller", 0.9)
    text = (DEPLOY / "Dockerfile.trainer").read_text() + (DEPLOY / "build.sh").read_text()
    assert "edl-tpu-torch:${TAG}" in text and "edl-tpu-torch-controller:${TAG}" in text


# -- the staged image ------------------------------------------------------------


def test_staged_layout_is_where_the_package_resolves_its_native_parts(tmp_path, monkeypatch):
    """The trainer image staged (its RUN lines recorded, not run: the bake
    needs nvcc): ``native/coordinator`` and ``build/kernels`` lie where
    ``coordinator/server.py`` and ``ops/_build.py`` resolve them for the
    package in the image, ``edl-launch`` is first on the image's PATH, and
    the image's PYTHONPATH is its WORKDIR."""
    runs = []

    def record(command, cwd, env):
        runs.append((command, sorted(os.listdir(cwd))))
        return {"run": command, "seconds": 0.0}

    monkeypatch.setattr(chip_smoke, "stage_run", record)
    root = tmp_path.resolve()
    image = chip_smoke.stage_image(str(DEPLOY / "Dockerfile.trainer"), str(ROOT), str(root))
    workdir = Path(image["workdir"])
    assert workdir == root / "opt" / "edl"
    assert image["entrypoint"] + image["cmd"] == ["python", "-m", "edl_tpu_torch.launcher",
                                                  "start_trainer"]
    assert image["env"]["PYTHONPATH"] == str(workdir)
    assert image["env"]["PATH"].split(os.pathsep)[0] == str(root / "usr" / "local" / "bin")
    assert os.access(root / "usr" / "local" / "bin" / "edl-launch", os.X_OK)
    assert sorted(os.listdir(workdir / "native" / "coordinator")) == ["Makefile",
                                                                      "coordinator.cc"]
    commands = [c for c, _ in runs]
    assert commands[-2:] == ["make -C native/coordinator",
                             'python -c "from edl_tpu_torch.ops._build import build; build()"']
    assert "native" in runs[-2][1] and "edl_tpu_torch" in runs[-1][1]
    probe = ("import json, edl_tpu_torch.coordinator.server as s, edl_tpu_torch.ops._build as b\n"
             "print(json.dumps([s.NATIVE_DIR, str(b.BUILD_DIR), s.__file__]))")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=workdir, env=image["env"],
                          capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr
    native, kernels, module = json.loads(proc.stdout)
    assert Path(native) == workdir / "native" / "coordinator"
    assert Path(kernels) == workdir / "build" / "kernels"
    assert Path(module).is_relative_to(workdir)


def test_stager_stages_a_tree_and_runs_its_lines(tmp_path):
    """A small Dockerfile staged for real: WORKDIR, ENV (an absolute value
    under the root), COPY into the WORKDIR and to a directory outside it
    (first on PATH), a RUN line that sees all of it, a pip line checked on
    the host, CMD recorded."""
    ctx = tmp_path / "ctx"
    (ctx / "pkg").mkdir(parents=True)
    (ctx / "pkg" / "a.txt").write_text("a")
    (ctx / "tool").write_text("#!/bin/sh\necho tool\n")
    (ctx / "tool").chmod(0o755)
    dockerfile = tmp_path / "Dockerfile"
    dockerfile.write_text(textwrap.dedent("""\
        # a comment
        FROM base:1
        WORKDIR /app
        ENV PYTHONPATH=/app MODE=x
        COPY pkg/ pkg/
        COPY tool /usr/local/bin/tool
        RUN pip install --no-cache-dir \\
            numpy
        RUN echo "$PYTHONPATH $MODE $(tool) $(cat pkg/a.txt)" > seen
        CMD ["python", "-m", "pkg"]
    """))
    root = tmp_path / "root"
    image = chip_smoke.stage_image(str(dockerfile), str(ctx), str(root))
    assert image["from"] == "base:1" and image["cmd"] == ["python", "-m", "pkg"]
    assert (root / "app" / "seen").read_text().split() == [str(root / "app"), "x", "tool", "a"]
    assert [s["run"].split()[0] for s in image["steps"]] == ["pip", "echo"]
    assert list(image["steps"][0]["checked"]) == ["numpy"]


@pytest.mark.parametrize("line", ["ADD pkg/ pkg/", "USER nobody", "ARG X=1"])
def test_stager_rejects_an_instruction_it_does_not_know(tmp_path, line):
    dockerfile = tmp_path / "Dockerfile"
    dockerfile.write_text(f"FROM base:1\n{line}\nCMD [\"true\"]\n")
    with pytest.raises(ValueError, match=line.split()[0]):
        chip_smoke.stage_image(str(dockerfile), str(tmp_path), str(tmp_path / "root"))


def test_stager_refuses_a_package_it_cannot_check(tmp_path):
    dockerfile = tmp_path / "Dockerfile"
    dockerfile.write_text("FROM base:1\nRUN apt-get install -y curl\n")
    with pytest.raises(chip_smoke.SmokeFailure, match="curl"):
        chip_smoke.stage_image(str(dockerfile), str(tmp_path), str(tmp_path / "root"))


def test_process_start_is_read_from_proc():
    """`_proc_started` gives a process's start on the wall clock, to the
    kernel's 10 ms tick, as the deploy phase times a pod from it."""
    t0 = time.time()
    proc = subprocess.Popen(["sleep", "5"])
    try:
        started = chip_smoke._proc_started(proc.pid)
    finally:
        proc.kill()
        proc.wait()
    assert t0 - 0.05 <= started <= time.time() + 0.05


def test_lm_entry_reports_its_first_step_and_flash_launches(tmp_path):
    """The LM entry, trained by a worker, prints before its metrics line the
    wall time its first step's loss came back and the flash launches by
    variant, which the deploy phase holds against steps x layers: none on
    the CPU, where the wrappers run the plain versions."""
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, "-m", "edl_tpu_torch.examples.lm.train", "--device", "cpu",
         "--vocab-size", "64", "--d-model", "32", "--n-layers", "2", "--n-heads", "4",
         "--d-ff", "64", "--seq-len", "32", "--batch-size", "2", "--batches-per-shard", "2",
         "--shards", "2"],
        cwd=tmp_path, env={**_env(), "OMP_NUM_THREADS": "1"}, capture_output=True,
        text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    launched, metrics = map(json.loads, out.stdout.strip().splitlines()[-2:])
    assert metrics["steps"] == 4 and launched["flash_launches"] == []
    assert t0 < launched["first_step_at"] < time.time()


# -- the job manifests -------------------------------------------------------------


@pytest.mark.parametrize("example", EXAMPLES)
def test_port_job_manifest(example):
    """``validate -f`` accepts the manifest where torch cannot be imported;
    it parses into the port's workloads; its trainer entry's own parser
    accepts its arguments; and it is the JAX package's manifest with only
    the image, the accelerator and the entry's module changed."""
    path = _manifest(example)
    proc = _blocked("validate", "-f", str(path))
    assert proc.returncode == 0, proc.stderr
    job = normalize(TrainingJob.from_yaml(path.read_text()))
    workloads = {w.role: w for w in parse_job(job)}
    trainer = workloads[ROLE_TRAINER]
    entry = shlex.split(trainer.entrypoint)
    module = f"edl_tpu_torch.examples.{example}.{EXAMPLES[example]}"
    assert entry[:3] == ["python", "-m", module] and trainer.image == "edl-tpu-torch:latest"
    importlib.import_module(module).parse_args(entry[3:])
    want = TrainingJob.from_yaml((ROOT / "examples" / example / "job.yaml").read_text())
    jax_entry = shlex.split(want.spec.trainer.entrypoint)
    assert jax_entry[:2] == ["python", f"examples/{example}/{EXAMPLES[example]}.py"]
    assert entry[3:] == jax_entry[2:]
    assert job.spec.tpu.accelerator_type == "nvidia-h100-80gb"
    got = TrainingJob.from_yaml(path.read_text()).to_dict()
    want = want.to_dict()
    for d in (got, want):
        d["spec"].pop("image")
        d["spec"]["tpu"].pop("accelerator_type")
        d["spec"]["trainer"].pop("entrypoint")
    assert got == want


# -- the Make targets --------------------------------------------------------------


@pytest.mark.parametrize("target", TARGETS)
def test_make_target_names_only_the_port(target):
    """``make -n`` of each target the port added runs only the port: every
    module and path it names is ``edl_tpu_torch``'s, ``chip_smoke.py``,
    ``deploy/torch``'s or a port test file."""
    proc = subprocess.run(["make", "-n", target], cwd=ROOT, capture_output=True, text=True,
                          timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr
    words = [w for w in shlex.split(proc.stdout) if re.search(r"[/.]|edl_tpu", w)]
    assert words
    port = ("edl_tpu_torch", "chip_smoke.py", "deploy/torch/", "tests/test_torch_")
    assert all(w.startswith(port) for w in words), words
    if target == "analyze-torch":  # the analysis test's repo gate
        assert words == ["edl_tpu_torch.analysis", "edl_tpu_torch",
                         "edl_tpu_torch/analysis/baseline.json"]


# -- the CLI without torch -----------------------------------------------------------


def test_cli_import_leaves_torch_and_numpy_out():
    code = ("import sys, edl_tpu_torch.cli, edl_tpu_torch.tools\n"
            "print(json.dumps(sorted({'torch', 'numpy'} & set(sys.modules))))")
    proc = subprocess.run([sys.executable, "-c", f"import json\n{code}"], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == []


def test_tools_names_resolve_at_first_use():
    """Every name of ``edl_tpu_torch.tools.__all__`` resolves, the
    profiler's (and torch) only once asked for; an unknown name raises
    AttributeError."""
    code = textwrap.dedent("""
        import json, sys
        import edl_tpu_torch.tools as tools
        before = "torch" in sys.modules
        from edl_tpu_torch.tools import StepProfiler, trace, mfu
        names = [n for n in tools.__all__ if getattr(tools, n) is None]
        try:
            tools.no_such_name
            missing = False
        except AttributeError:
            missing = True
        print(json.dumps([before, "torch" in sys.modules, names, missing,
                          StepProfiler.__module__, mfu.H100_PEAK_BF16_TFLOPS]))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == [False, True, [], True,
                                       "edl_tpu_torch.tools.profiler", 989.0]


def test_controller_help_without_torch():
    proc = _blocked("controller", "--help")
    assert proc.returncode == 0, proc.stderr
    assert "--max-load-desired" in proc.stdout


def test_controller_runs_without_torch():
    """The controller subcommand (the in-memory backend) runs its loops
    where torch and numpy cannot be imported: it logs that it runs, its
    collector prints a sample, and it exits 0 on SIGINT; with
    ``--in-cluster`` and no service account it fails on its config, not on
    an import."""
    proc = subprocess.Popen([sys.executable, "-c", _BLOCKED, "controller", "--collect-period",
                             "0.2", "--metrics-port", "0"], cwd=ROOT, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        seen = []
        while not seen or "controller running" not in seen[-1]:
            seen.append(proc.stderr.readline())
            assert seen[-1], "".join(seen)
        # the collector's second sample, a period after its first: the main
        # thread is in its loop by then, where SIGINT ends it cleanly
        sample = [json.loads(proc.stdout.readline()) for _ in range(2)][-1]
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=TIMEOUT) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()
    assert "tpu_utilization" in sample
    failed = _blocked("controller", "--in-cluster")
    assert failed.returncode == 1 and "ERROR:" in failed.stderr, failed.stderr
    assert "not in the controller image" not in failed.stderr
