"""Tests for the port's static-analysis suite, `edl_tpu_torch.analysis`.

The suite is a copy of `edl_tpu.analysis` with its imports rewritten; its
trace, axis-name and determinism rules (EDL002, EDL003, EDL008) read the
port's terms (CUDA-graph capture and `torch.compile` bodies, the port's
mesh and collective API, torch RNG). These are `tests/test_analysis.py`'s
cases on the port, plus:

- the JAX suite's own fixtures for EDL001, 004, 005, 006 and 007, and its
  EDL009/010 runs, through both analyzers: the same (rule, line, col,
  symbol) and the same message once the package names are substituted;
- PyTorch fixture pairs for EDL002, 003 and 008;
- the repo gate on the port's own baseline.

Four layers, as in the JAX suite:

- per-rule fixture pairs: every EDL rule has at least one snippet that
  triggers it and one that must NOT (the false-positive guard matters as
  much as the detection — a noisy checker gets noqa'd into oblivion);
- mechanism tests: suppression comments, baseline round-trip + ratchet,
  CLI exit codes;
- the repo gate: the committed tree must be clean against the committed
  baseline. This is the tier-1 teeth of the whole suite.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from edl_tpu_torch.analysis import (
    analyze,
    apply_baseline,
    fingerprint,
    load_baseline,
    write_baseline,
)
from edl_tpu_torch.analysis.cli import main as cli_main

REPO_ROOT = Path(__file__).resolve().parents[1]


def check(tmp_path, source, rules, name="snippet.py", config=None):
    """Analyze one dedented snippet with a rule subset; return the Report."""
    p = tmp_path / name
    p.write_text(textwrap.dedent(source))
    return analyze([str(p)], root=str(tmp_path), rules=rules, config=config)


def rules_of(report):
    return [f.rule for f in report.findings]


# -- EDL001: lock discipline ---------------------------------------------------


def test_edl001_flags_unlocked_write(tmp_path):
    report = check(
        tmp_path,
        """
        import threading

        class Counter:
            def __init__(self):
                self._lock = threading.Lock()
                self.value = 0

            def bump(self):
                self.value += 1
        """,
        ["EDL001"],
    )
    assert rules_of(report) == ["EDL001"]
    (f,) = report.findings
    assert "value" in f.message and f.symbol.endswith("bump")


def test_edl001_accepts_locked_write_and_locked_helper(tmp_path):
    """Writes under `with self._lock` pass — including writes in a private
    helper only ever called while the lock is held (call-graph, not just
    lexical scope)."""
    report = check(
        tmp_path,
        """
        import threading

        class Counter:
            def __init__(self):
                self._lock = threading.Lock()
                self.value = 0

            def bump(self):
                with self._lock:
                    self._bump_locked()

            def _bump_locked(self):
                self.value += 1
        """,
        ["EDL001"],
    )
    assert report.findings == []


def test_edl001_thread_target_escape_makes_private_method_an_entry(tmp_path):
    """`Thread(target=self._run)` publishes _run to another thread: its
    writes need the lock even though no public method calls it."""
    report = check(
        tmp_path,
        """
        import threading

        class Worker:
            def __init__(self):
                self._lock = threading.Lock()
                self.ticks = 0

            def start(self):
                threading.Thread(target=self._run).start()

            def _run(self):
                self.ticks += 1
        """,
        ["EDL001"],
    )
    assert rules_of(report) == ["EDL001"]
    assert report.findings[0].symbol.endswith("_run")


def test_edl001_ignores_lockless_classes(tmp_path):
    report = check(
        tmp_path,
        """
        class Plain:
            def __init__(self):
                self.value = 0

            def bump(self):
                self.value += 1
        """,
        ["EDL001"],
    )
    assert report.findings == []


# -- EDL002: trace hygiene -----------------------------------------------------


def test_edl002_flags_host_clock_in_cuda_graph_capture(tmp_path):
    report = check(
        tmp_path,
        """
        import time
        import torch

        def capture(step, x):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                y = step(x) * time.time()
            return g, y
        """,
        ["EDL002"],
    )
    assert rules_of(report) == ["EDL002"]
    (f,) = report.findings
    assert "time.time" in f.message and "torch.cuda.graph" in f.message


def test_edl002_flags_branch_and_item_on_a_compiled_parameter(tmp_path):
    report = check(
        tmp_path,
        """
        import torch

        @torch.compile
        def relu_ish(x):
            if x > 0:
                return x
            return -x * x.item()
        """,
        ["EDL002"],
    )
    assert rules_of(report) == ["EDL002", "EDL002"]
    assert "`if`" in report.findings[0].message
    assert ".item()" in report.findings[1].message


def test_edl002_allows_static_shape_branch_and_host_code(tmp_path):
    """Branching on .shape/.ndim is static (kept by a replay); host-side
    time.time() outside any captured body is the normal case."""
    report = check(
        tmp_path,
        """
        import time
        import torch

        @torch.compile(fullgraph=True)
        def maybe_sum(x):
            if x.ndim > 1:
                return x.sum()
            return x

        def host_timer(step, x):
            t0 = time.time()
            step(x)
            torch.cuda.synchronize()
            return time.time() - t0
        """,
        ["EDL002"],
    )
    assert report.findings == []


@pytest.mark.parametrize("capturer", ["torch.compile", "torch.jit.script",
                                      "torch.jit.trace",
                                      "torch.cuda.make_graphed_callables"])
def test_edl002_finds_fn_passed_to_a_capturer(tmp_path, capturer):
    """A capturer used as a call, not a decorator, marks the function."""
    report = check(
        tmp_path,
        f"""
        import numpy as np
        import torch

        def step(x):
            return x + np.random.rand()

        fast_step = {capturer}(step)
        """,
        ["EDL002"],
    )
    assert rules_of(report) == ["EDL002"]
    assert "np.random" in report.findings[0].message


# -- EDL003: sharding consistency ---------------------------------------------

_EDL003_CONFIG = {
    "sharding_axes": ["data", "model"],
    "sharding_all_files": True,
}


def test_edl003_flags_undeclared_axis(tmp_path):
    report = check(
        tmp_path,
        """
        from edl_tpu_torch.parallel.collective import ppermute

        def shift(xs, mesh):
            return ppermute(xs, mesh, "modle")
        """,
        ["EDL003"],
        config=_EDL003_CONFIG,
    )
    assert rules_of(report) == ["EDL003"]
    assert "'modle'" in report.findings[0].message


def test_edl003_accepts_declared_axes_and_axis_keywords(tmp_path):
    report = check(
        tmp_path,
        """
        from edl_tpu_torch.models.base import Shard
        from edl_tpu_torch.parallel.collective import ppermute, psum, zero_shard_spec
        from edl_tpu_torch.parallel.mesh import MeshSpec, local_mesh

        SPEC = Shard("model", 1)
        LAYOUT = MeshSpec({"data": 2, "model": 2})

        def reduce_loss(loss, mesh, batch_axis: str = "data"):
            ranks = mesh.slice_ranks(("data", "model"))
            ppermute([loss], mesh, axis="model")
            zero_shard_spec(loss.shape, mesh, batch_axis)
            return psum(loss, mesh.group(batch_axis)), ranks

        def one(axes=None):
            return local_mesh({"data": 1})
        """,
        ["EDL003"],
        config=_EDL003_CONFIG,
    )
    assert report.findings == []


@pytest.mark.parametrize("source, bad", [
    ('def shard(x, shard_axis: str = "experts"):\n    return x\n', "experts"),
    ('PIPE_AXIS = "pipes"\n', "pipes"),
    ('def group(mesh):\n    return mesh.group("dat")\n', "dat"),
    ('from edl_tpu_torch.parallel.mesh import MeshSpec\nM = MeshSpec({"tensor": 2})\n',
     "tensor"),
    ('def run(worker, x):\n    return worker(x, mesh_axes={"sequence": 2})\n', "sequence"),
    ('from edl_tpu_torch.models.base import Shard\nS = Shard("modle", 0)\n', "modle"),
])
def test_edl003_flags_every_kind_of_axis_name(tmp_path, source, bad):
    report = check(tmp_path, source, ["EDL003"], config=_EDL003_CONFIG)
    assert rules_of(report) == ["EDL003"]
    assert f"'{bad}'" in report.findings[0].message


def test_edl003_leaves_non_mesh_lookups_alone(tmp_path):
    """``group``/``axis`` are mesh lookups only on a receiver named as a
    mesh: a regex match's ``group("name")`` is not an axis."""
    report = check(
        tmp_path,
        """
        import re

        def parse(line, spec):
            return re.match(r"(?P<name>\\w+)", line).group("name"), spec.axis("x")
        """,
        ["EDL003"],
        config=_EDL003_CONFIG,
    )
    assert report.findings == []


def test_edl003_scope_is_parallel_models_and_runtime_by_default(tmp_path):
    """Without the all-files override, only parallel/, models/ and runtime/
    paths are in scope — examples and tests may name foreign axes freely."""
    (tmp_path / "examples").mkdir()
    (tmp_path / "examples" / "demo.py").write_text(
        'from edl_tpu_torch.models.base import Shard\nS = Shard("zzz", 0)\n'
    )
    report = analyze(
        [str(tmp_path / "examples")],
        root=str(tmp_path),
        rules=["EDL003"],
        config={"sharding_axes": ["data"]},
    )
    assert report.findings == []


def test_edl003_reads_the_universe_from_the_ports_axis_order():
    """The port's `parallel/`, `models/` and `runtime/` name only the axes
    `AXIS_ORDER` declares, read from `edl_tpu_torch/parallel/mesh.py`."""
    from edl_tpu_torch.parallel.mesh import AXIS_ORDER

    pkg = REPO_ROOT / "edl_tpu_torch"
    report = analyze([str(pkg / d) for d in ("parallel", "models", "runtime")],
                     root=str(REPO_ROOT), rules=["EDL003"])
    assert report.parse_errors == []
    assert report.findings == []
    # the transformer names every model axis: take one out of the universe
    planted = analyze([str(pkg / "models" / "transformer.py")], root=str(REPO_ROOT),
                      rules=["EDL003"],
                      config={"sharding_axes": [a for a in AXIS_ORDER if a != "model"]})
    assert {f.message.split("'")[1] for f in planted.findings} == {"model"}


def test_edl003_flags_typoed_axis_in_collective_style_helper(tmp_path):
    """A zero_shard_spec-style helper with a misspelled axis under parallel/
    is in the default scope and gets flagged — no sharding_all_files needed."""
    pkg = tmp_path / "parallel"
    pkg.mkdir()
    (pkg / "collective.py").write_text(
        textwrap.dedent(
            """
            def zero_shard_spec(shape, mesh, batch_axis: str = "dada"):
                return mesh.axis_size(batch_axis), shape
            """
        )
    )
    report = analyze(
        [str(pkg)],
        root=str(tmp_path),
        rules=["EDL003"],
        config={"sharding_axes": ["data", "dcn"]},
    )
    assert rules_of(report) == ["EDL003"]
    assert "'dada'" in report.findings[0].message


# -- EDL004: blocking while holding a lock ------------------------------------


def test_edl004_flags_sleep_under_lock(tmp_path):
    report = check(
        tmp_path,
        """
        import threading
        import time

        class Server:
            def __init__(self):
                self._lock = threading.Lock()

            def handle(self):
                with self._lock:
                    time.sleep(0.1)
        """,
        ["EDL004"],
    )
    assert rules_of(report) == ["EDL004"]
    assert "time.sleep" in report.findings[0].message


def test_edl004_allows_sleep_outside_lock(tmp_path):
    report = check(
        tmp_path,
        """
        import threading
        import time

        class Server:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0

            def handle(self):
                with self._lock:
                    self.n += 1
                time.sleep(0.1)
        """,
        ["EDL004"],
    )
    assert report.findings == []


def test_edl004_flags_subprocess_under_module_lock(tmp_path):
    report = check(
        tmp_path,
        """
        import subprocess
        import threading

        _cache_lock = threading.Lock()

        def refresh():
            with _cache_lock:
                subprocess.run(["kubectl", "get", "pods"])
        """,
        ["EDL004"],
    )
    assert rules_of(report) == ["EDL004"]


# -- EDL005: exception hygiene -------------------------------------------------


def test_edl005_flags_silent_broad_except(tmp_path):
    report = check(
        tmp_path,
        """
        def load():
            try:
                risky()
            except Exception:
                pass
        """,
        ["EDL005"],
    )
    assert rules_of(report) == ["EDL005"]


def test_edl005_accepts_logged_reraised_or_narrow(tmp_path):
    report = check(
        tmp_path,
        """
        import logging

        log = logging.getLogger(__name__)

        def logged():
            try:
                risky()
            except Exception:
                log.exception("risky failed")

        def reraised():
            try:
                risky()
            except Exception as e:
                raise RuntimeError("wrapped") from e

        def narrow():
            try:
                risky()
            except ValueError:
                pass

        def delegated(e=None):
            try:
                risky()
            except Exception as e:
                _warn_failure(e)
        """,
        ["EDL005"],
    )
    assert report.findings == []


# -- suppression comments ------------------------------------------------------


def test_noqa_suppresses_exact_rule_on_exact_line(tmp_path):
    report = check(
        tmp_path,
        """
        def load():
            try:
                risky()
            except Exception:  # edl: noqa[EDL005] probe result is optional
                pass
        """,
        ["EDL005"],
    )
    assert report.findings == []
    assert rules_of(report) == [] and len(report.suppressed) == 1
    assert report.suppressed[0].rule == "EDL005"


def test_noqa_for_wrong_rule_does_not_suppress(tmp_path):
    report = check(
        tmp_path,
        """
        def load():
            try:
                risky()
            except Exception:  # edl: noqa[EDL001] wrong rule entirely
                pass
        """,
        ["EDL005"],
    )
    assert rules_of(report) == ["EDL005"]


def test_blanket_noqa_suppresses_any_rule(tmp_path):
    report = check(
        tmp_path,
        """
        def load():
            try:
                risky()
            except Exception:  # edl: noqa
                pass
        """,
        ["EDL005"],
    )
    assert report.findings == [] and len(report.suppressed) == 1


# -- baseline round-trip and ratchet ------------------------------------------

_BAD_EDL005 = """
def load():
    try:
        risky()
    except Exception:
        pass
"""


def test_baseline_round_trip_accepts_then_goes_stale(tmp_path):
    report = check(tmp_path, _BAD_EDL005, ["EDL005"])
    assert len(report.findings) == 1

    bpath = tmp_path / "baseline.json"
    write_baseline(str(bpath), report.findings)
    baseline = load_baseline(str(bpath))
    assert baseline.total() == 1

    # same tree: the finding is accepted, nothing new, nothing stale
    new, accepted, stale = apply_baseline(report.findings, baseline)
    assert (new, stale) == ([], []) and len(accepted) == 1

    # debt fixed: the entry turns stale (which also fails the run — the
    # ratchet only ever tightens)
    fixed = check(tmp_path, "def load():\n    return risky()\n", ["EDL005"])
    new, accepted, stale = apply_baseline(fixed.findings, baseline)
    assert new == [] and accepted == []
    assert len(stale) == 1 and stale[0]["rule"] == "EDL005"


def test_baseline_count_caps_identical_findings(tmp_path):
    """Two identical findings in one symbol share a fingerprint; the count
    caps acceptance, so a third occurrence is new debt."""
    one = check(tmp_path, _BAD_EDL005, ["EDL005"])
    baseline = load_baseline(
        str(write_baseline_to(tmp_path, one.findings))
    )
    doubled = check(
        tmp_path,
        """
        def load():
            try:
                risky()
        """
        + "    except Exception:\n        pass\n" * 0
        + """
            except Exception:
                pass
            try:
                risky()
            except Exception:
                pass
        """,
        ["EDL005"],
    )
    assert len(doubled.findings) == 2
    assert fingerprint(doubled.findings[0]) == fingerprint(doubled.findings[1])
    new, accepted, stale = apply_baseline(doubled.findings, baseline)
    assert len(accepted) == 1 and len(new) == 1 and stale == []


def write_baseline_to(tmp_path, findings):
    bpath = tmp_path / "baseline.json"
    write_baseline(str(bpath), findings)
    return bpath


def test_baseline_rejects_unknown_version(tmp_path):
    bpath = tmp_path / "baseline.json"
    bpath.write_text(json.dumps({"version": 99, "findings": {}}))
    with pytest.raises(ValueError):
        load_baseline(str(bpath))


# -- CLI -----------------------------------------------------------------------


def test_cli_exit_codes_and_json_shape(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(_BAD_EDL005))

    rc = cli_main([str(bad), "--format", "json", "--baseline", "none"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert payload["summary"]["new"] == 1
    assert payload["findings"][0]["rule"] == "EDL005"
    assert payload["findings"][0]["baselined"] is False

    # baseline it: same tree now exits 0 and reports it as baselined
    bpath = tmp_path / "baseline.json"
    rc = cli_main([str(bad), "--baseline", str(bpath), "--write-baseline"])
    capsys.readouterr()
    assert rc == 0
    rc = cli_main([str(bad), "--format", "json", "--baseline", str(bpath)])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert payload["summary"] == dict(
        payload["summary"], new=0, baselined=1
    )


def test_cli_clean_tree_exits_zero(tmp_path, capsys):
    good = tmp_path / "good.py"
    good.write_text("def f():\n    return 1\n")
    rc = cli_main([str(good), "--baseline", "none"])
    capsys.readouterr()
    assert rc == 0


def test_cli_parse_error_exits_two(tmp_path, capsys):
    broken = tmp_path / "broken.py"
    broken.write_text("def f(:\n")
    rc = cli_main([str(broken), "--baseline", "none"])
    capsys.readouterr()
    assert rc == 2


def test_cli_list_rules_names_all_ten(capsys):
    rc = cli_main(["--list-rules"])
    out = capsys.readouterr().out
    assert rc == 0
    for rule in ("EDL001", "EDL002", "EDL003", "EDL004", "EDL005",
                 "EDL006", "EDL007", "EDL008", "EDL009", "EDL010"):
        assert rule in out


def test_module_entrypoint_runs():
    """`python -m edl_tpu_torch.analysis --list-rules` — the CI/pre-commit form."""
    proc = subprocess.run(
        [sys.executable, "-m", "edl_tpu_torch.analysis", "--list-rules"],
        cwd=str(REPO_ROOT),
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "EDL001" in proc.stdout


# -- the repo gate -------------------------------------------------------------


def test_repo_tree_is_clean_against_committed_baseline():
    """Tier-1 teeth: the committed tree carries zero non-baselined findings
    and zero stale baseline entries. New debt → fix it, noqa it with a
    justification, or consciously --write-baseline."""
    report = analyze([str(REPO_ROOT / "edl_tpu_torch")], root=str(REPO_ROOT))
    assert report.parse_errors == [], report.parse_errors
    baseline = load_baseline(
        str(REPO_ROOT / "edl_tpu_torch" / "analysis" / "baseline.json"))
    new, _accepted, stale = apply_baseline(report.findings, baseline)
    assert new == [], "new findings:\n" + "\n".join(
        f"{f.location()}: {f.rule} {f.message}" for f in new
    )
    assert stale == [], "stale baseline entries (run --write-baseline):\n" + "\n".join(
        f"{e['rule']} {e['path']} '{e['symbol']}'" for e in stale
    )
    # the accepted debt is the JAX package's own: the updater's 7 EDL001s
    entries = list(baseline.entries.values())
    assert {(e["rule"], e["path"]) for e in entries} == {
        ("EDL001", "edl_tpu_torch/controller/updater.py")}
    assert sum(int(e["count"]) for e in entries) == 7


# -- EDL006: cross-root lockset races -----------------------------------------



def test_edl006_flags_attr_written_from_two_roots_without_lock(tmp_path):
    report = check(
        tmp_path,
        """
        import threading

        class Worker:
            def __init__(self):
                self.count = 0

            def start(self):
                threading.Thread(target=self._run).start()

            def _run(self):
                self.count += 1

            def bump(self):
                self.count += 1
        """,
        ["EDL006"],
    )
    assert rules_of(report) == ["EDL006"]
    assert "Worker.count" in report.findings[0].message
    assert "no common lock" in report.findings[0].message


def test_edl006_accepts_common_lock_on_both_roots(tmp_path):
    report = check(
        tmp_path,
        """
        import threading

        class Worker:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0

            def start(self):
                threading.Thread(target=self._run).start()

            def _run(self):
                with self._lock:
                    self.count += 1

            def bump(self):
                with self._lock:
                    self.count += 1
        """,
        ["EDL006"],
    )
    assert report.findings == []


def test_edl006_single_root_and_init_writes_are_clean(tmp_path):
    # __init__ publishes before the thread starts; only one root writes after.
    report = check(
        tmp_path,
        """
        import threading

        class Worker:
            def __init__(self):
                self.count = 0

            def start(self):
                threading.Thread(target=self._run).start()

            def _run(self):
                self.count += 1

            def read(self):
                return 1
        """,
        ["EDL006"],
    )
    assert report.findings == []


def test_edl006_condition_aliases_its_wrapped_lock(tmp_path):
    # Condition(self._lock) and self._lock are the SAME mutex: one root
    # holding the condition and the other the raw lock is race-free.
    report = check(
        tmp_path,
        """
        import threading

        class Worker:
            def __init__(self):
                self._lock = threading.Lock()
                self._cv = threading.Condition(self._lock)
                self.count = 0

            def start(self):
                threading.Thread(target=self._run).start()

            def _run(self):
                with self._cv:
                    self.count += 1

            def bump(self):
                with self._lock:
                    self.count += 1
        """,
        ["EDL006"],
    )
    assert report.findings == []


def test_edl006_lockset_propagates_through_call_chain(tmp_path):
    # Both roots take the lock BEFORE calling the shared helper: the helper's
    # entry lockset (meet over callers) carries the guard to the write.
    report = check(
        tmp_path,
        """
        import threading

        class Worker:
            def __init__(self):
                self._lock = threading.Lock()
                self.x = 0

            def start(self):
                threading.Thread(target=self.run).start()

            def run(self):
                with self._lock:
                    self._bump()

            def grow(self):
                with self._lock:
                    self._bump()

            def _bump(self):
                self.x += 1
        """,
        ["EDL006"],
    )
    assert report.findings == []


def test_edl006_unlocked_caller_poisons_helper_lockset(tmp_path):
    # One caller forgets the lock: the meet at _bump's entry goes empty and
    # the write is flagged even though the OTHER root locked correctly.
    report = check(
        tmp_path,
        """
        import threading

        class Worker:
            def __init__(self):
                self._lock = threading.Lock()
                self.x = 0

            def start(self):
                threading.Thread(target=self.run).start()

            def run(self):
                with self._lock:
                    self._bump()

            def grow(self):
                self._bump()

            def _bump(self):
                self.x += 1
        """,
        ["EDL006"],
    )
    assert rules_of(report) == ["EDL006"]


def test_edl006_http_handler_methods_are_thread_roots(tmp_path):
    report = check(
        tmp_path,
        """
        from http.server import BaseHTTPRequestHandler

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                self.hits = self.hits + 1

            def reset(self):
                self.hits = 0
        """,
        ["EDL006"],
    )
    assert rules_of(report) == ["EDL006"]
    assert "Handler.hits" in report.findings[0].message


def test_edl006_collector_callback_is_a_thread_root(tmp_path):
    report = check(
        tmp_path,
        """
        class Probe:
            def __init__(self):
                self.last = None

            def attach(self, reg):
                reg.register_collector(self._collect)

            def _collect(self):
                self.last = 1

            def poll(self):
                self.last = 2
        """,
        ["EDL006"],
    )
    assert rules_of(report) == ["EDL006"]


def test_edl006_noqa_on_anchor_line_suppresses(tmp_path):
    report = check(
        tmp_path,
        """
        import threading

        class Worker:
            def __init__(self):
                self.count = 0

            def start(self):
                threading.Thread(target=self._run).start()

            def _run(self):
                self.count += 1  # edl: noqa[EDL006] GIL-atomic int bump, drift tolerated

            def bump(self):
                self.count += 1
        """,
        ["EDL006"],
    )
    assert report.findings == []
    assert len(report.suppressed) == 1 and report.suppressed[0].rule == "EDL006"


# -- EDL007: wire-protocol conformance ----------------------------------------

from edl_tpu_torch.analysis.checkers.wire_protocol import (  # noqa: E402
    extract_native_schema,
)

_TOY_CC = """
// Toy coordinator: dispatch table + handlers, for EDL007 fixtures.

Json Coordinator::membership_reply() {
  Json r;
  r.field("ok");
  r.field("rank");
  return r;
}

Json Coordinator::op_join(const Json& req) {
  get_str(req, "name");
  return membership_reply();
}

Json Coordinator::op_put(const Json& req) {
  get_str(req, "key");
  get_str(req, "value");
  Json r;
  r.field("ok");
  return r;
}

Json Coordinator::dispatch(const Json& req) {
  std::string op = get_str(req, "op");
  if (op == "join") return op_join(req);
  if (op == "put") return op_put(req);
  if (op == "ping") return Json().field("ok", true);
  return err();
}

Json Coordinator::handle(const Json& req) {
  Json reply = dispatch(req);
  stamp_epoch(dispatch, reply);
  return reply;
}
"""

_EDL007_CONFIG = {
    "edl007_native_source": "coord.cc",
    "edl007_schema": "schema.json",
    "edl007_prefixes": [""],  # every analyzed .py speaks the protocol
}


def _toy_schema():
    return extract_native_schema(textwrap.dedent(_TOY_CC), "coord.cc")


def wire_check(tmp_path, py_files, cc=_TOY_CC, schema="fresh"):
    """Analyze a toy cross-language pair: ``coord.cc`` + python files, with
    the committed-schema artifact either up to date ('fresh'), absent
    (None), or an explicit dict."""
    (tmp_path / "coord.cc").write_text(textwrap.dedent(cc))
    if schema == "fresh":
        schema = extract_native_schema(textwrap.dedent(cc), "coord.cc")
    if schema is not None:
        (tmp_path / "schema.json").write_text(json.dumps(schema))
    paths = []
    for name, src in py_files.items():
        p = tmp_path / name
        p.write_text(textwrap.dedent(src))
        paths.append(str(p))
    return analyze(
        paths, root=str(tmp_path), rules=["EDL007"], config=_EDL007_CONFIG
    )


def test_edl007_extracts_dispatch_table_from_cc():
    schema = _toy_schema()
    assert set(schema["ops"]) == {"join", "put", "ping"}
    assert schema["epoch_stamped"] is True
    assert schema["unstamped_deferred_ops"] == []
    # helper expansion (membership_reply) + the implicit epoch stamp
    assert schema["ops"]["join"]["request"] == ["name"]
    assert schema["ops"]["join"]["reply"] == ["epoch", "ok", "rank"]
    assert schema["ops"]["put"]["request"] == ["key", "value"]
    # inline arm (ping): no handler function, fields from the return stmt
    assert schema["ops"]["ping"]["reply"] == ["epoch", "ok"]


def test_edl007_comments_do_not_leak_into_schema():
    cc = _TOY_CC + """
// if (op == "ghost") return op_ghost(req);
/* r.field("phantom"); deferred_ */
"""
    schema = extract_native_schema(textwrap.dedent(cc), "coord.cc")
    assert "ghost" not in schema["ops"]
    assert all("phantom" not in s["reply"] for s in schema["ops"].values())


def test_edl007_conformant_pair_is_clean(tmp_path):
    report = wire_check(
        tmp_path,
        {
            "client.py": """
            class Client:
                def join(self):
                    return self._t.call("join", name="w0")

                def put(self):
                    return self._t.call("put", key="k", value="v")
            """,
        },
    )
    assert report.findings == []


def test_edl007_flags_unknown_op_and_unread_field(tmp_path):
    report = wire_check(
        tmp_path,
        {
            "client.py": """
            class Client:
                def join(self):
                    return self._t.call("jion", name="w0")

                def put(self):
                    return self._t.call("put", key="k", value="v", mode="fast")
            """,
        },
    )
    msgs = sorted(f.message for f in report.findings)
    assert len(msgs) == 2
    assert "call('jion') is not in the native dispatch table" in msgs[0]
    assert "never reads: mode" in msgs[1]


def test_edl007_missing_schema_artifact_is_a_finding(tmp_path):
    report = wire_check(
        tmp_path, {"client.py": "X = 1\n"}, schema=None
    )
    assert len(report.findings) == 1
    assert "run --write-protocol" in report.findings[0].message


def test_edl007_schema_drift_is_ratcheted(tmp_path):
    stale = _toy_schema()
    del stale["ops"]["put"]
    report = wire_check(tmp_path, {"client.py": "X = 1\n"}, schema=stale)
    assert len(report.findings) == 1
    f = report.findings[0]
    assert "op 'put' is in the dispatch table but not in" in f.message
    assert "run --write-protocol" in f.message and f.symbol == "put"


def test_edl007_deferred_reply_must_carry_epoch():
    cc = _TOY_CC.replace(
        'if (op == "join")',
        'if (op == "wait") { op_wait(req, fd); return Json(); }\n'
        '  if (op == "join")',
    ).replace(
        "Json Coordinator::dispatch",
        """void Coordinator::op_wait(const Json& req, int fd) {
  deferred_.push_back(fd);
}

Json Coordinator::dispatch""",
    )
    schema = extract_native_schema(textwrap.dedent(cc), "coord.cc")
    assert schema["ops"]["wait"]["deferred"] is True
    assert schema["unstamped_deferred_ops"] == ["wait"]


def test_edl007_shim_missing_op_and_reply_drift(tmp_path):
    report = wire_check(
        tmp_path,
        {
            "inproc.py": """
            class InProcessClient:
                def call(self, op, timeout=None, **fields):
                    if op == "ping":
                        return self._stamp({"ok": True})
                    if op == "join":
                        return self._stamp({"ok": True})
                    raise ValueError(op)
            """,
        },
    )
    msgs = sorted(f.message for f in report.findings)
    assert len(msgs) == 2
    assert "does not handle op 'put'" in msgs[0]
    assert "in-process reply for 'join' diverges" in msgs[1]
    assert "missing: rank" in msgs[1]


def test_edl007_shim_covering_all_ops_is_clean(tmp_path):
    report = wire_check(
        tmp_path,
        {
            "inproc.py": """
            class InProcessClient:
                def call(self, op, timeout=None, **fields):
                    if op == "ping":
                        return self._stamp({"ok": True})
                    if op == "join":
                        return self._stamp({"ok": True, "rank": 0})
                    if op == "put":
                        return self._stamp({"ok": True})
                    raise ValueError(op)
            """,
        },
    )
    assert report.findings == []


@pytest.mark.parametrize("args", [["--write-protocol"], []])
def test_the_cli_reads_the_protocol_schema_and_never_writes_it(tmp_path, monkeypatch,
                                                               capsys, args):
    """The root ``protocol_schema.json`` is the JAX package's artifact (its
    analyzer's ``--write-protocol`` extracts it): the port's CLI has no such
    option, and a run over a tree leaves the file byte for byte."""
    native = tmp_path / "native" / "coordinator"
    native.mkdir(parents=True)
    (native / "coordinator.cc").write_text(textwrap.dedent(_TOY_CC))
    (tmp_path / "client.py").write_text("X = 1\n")
    schema = tmp_path / "protocol_schema.json"
    raw = json.dumps({"ops": {"stale": {}}, "state_effects": {}})
    schema.write_text(raw)
    monkeypatch.chdir(tmp_path)
    if args:
        with pytest.raises(SystemExit) as exc:
            cli_main([*args, "client.py"])
        assert exc.value.code == 2
    else:
        assert cli_main(["--baseline", "none", "--rules", "EDL007", "client.py"]) == 1
    capsys.readouterr()
    assert schema.read_text() == raw


def test_repo_protocol_schema_matches_native_source():
    """The committed artifact IS the extraction of the committed .cc — the
    ratchet's premise. Fails whenever one is edited without the other.
    ``state_effects`` is the hand-authored EDL009 behavioral annotation,
    not part of the extraction; it must exist and cover the op set."""
    cc = (REPO_ROOT / "native" / "coordinator" / "coordinator.cc").read_text()
    committed = json.loads((REPO_ROOT / "protocol_schema.json").read_text())
    effects = committed.pop("state_effects")
    assert committed == extract_native_schema(
        cc, "native/coordinator/coordinator.cc"
    )
    assert len(committed["ops"]) >= 18
    assert committed["epoch_stamped"] is True
    assert set(effects) == set(committed["ops"])


# -- parallel engine -----------------------------------------------------------


def test_parallel_jobs_produce_identical_findings(tmp_path):
    for i in range(3):
        (tmp_path / f"mod{i}.py").write_text(textwrap.dedent(_BAD_EDL005))
    serial = analyze([str(tmp_path)], root=str(tmp_path), jobs=1)
    forked = analyze([str(tmp_path)], root=str(tmp_path), jobs=2)
    as_tuples = lambda r: [  # noqa: E731
        (f.path, f.line, f.col, f.rule, f.message) for f in r.findings
    ]
    assert as_tuples(serial) == as_tuples(forked)
    assert serial.jobs == 1 and forked.jobs == 2


def test_report_carries_per_rule_timings(tmp_path):
    (tmp_path / "m.py").write_text("def f():\n    return 1\n")
    report = analyze([str(tmp_path)], root=str(tmp_path), rules=["EDL005"])
    assert "EDL005" in report.timings
    assert report.timings["EDL005"] >= 0.0


# -- EDL008: elastic determinism -----------------------------------------------

_EDL008_CONFIG = {"edl008_all_files": True}


@pytest.mark.parametrize("seed, source", [
    ("torch.distributed.get_rank()", "torch.distributed.get_rank()"),
    ('int(os.environ["RANK"])', "RANK environment"),
    ('int(os.environ.get("LOCAL_RANK", 0))', "LOCAL_RANK environment"),
    ('int(os.getenv("RANK", "0")) + 17', "RANK environment"),
])
def test_edl008_flags_rng_seeded_from_the_rank(tmp_path, seed, source):
    report = check(
        tmp_path,
        f"""
        import os
        import torch

        def make_generator():
            return torch.Generator().manual_seed({seed})
        """,
        ["EDL008"],
        config=_EDL008_CONFIG,
    )
    assert rules_of(report) == ["EDL008"]
    (f,) = report.findings
    assert source in f.message and f.symbol.endswith("make_generator")


def test_edl008_flags_torch_manual_seed_from_a_tainted_name(tmp_path):
    report = check(
        tmp_path,
        """
        import torch
        import torch.distributed as dist

        def seed_everything(base):
            rank = dist.get_rank()
            torch.manual_seed(base + rank)
        """,
        ["EDL008"],
        config=_EDL008_CONFIG,
    )
    assert rules_of(report) == ["EDL008"]
    assert "get_rank" in report.findings[0].message


def test_edl008_flags_draws_from_the_default_generator(tmp_path):
    report = check(
        tmp_path,
        """
        import torch

        def init(shape, w):
            noise = torch.randn(shape)
            w.normal_(0.0, 0.02)
            return noise, torch.randperm(shape[0])
        """,
        ["EDL008"],
        config=_EDL008_CONFIG,
    )
    assert rules_of(report) == ["EDL008"] * 3
    assert all("default torch generator" in f.message for f in report.findings)
    assert "torch.randn()" in report.findings[0].message


def test_edl008_tracks_taint_through_assignment_and_fstring(tmp_path):
    """The live-tree shape: identity -> f-string -> seed string -> RNG."""
    report = check(
        tmp_path,
        """
        import random
        import socket

        def make_rng():
            host = socket.gethostname()
            seed_str = f"trainer:{host}"
            return random.Random(seed_str)
        """,
        ["EDL008"],
        config=_EDL008_CONFIG,
    )
    assert rules_of(report) == ["EDL008"]
    assert "gethostname" in report.findings[0].message


def test_edl008_flags_worker_identity_attribute(tmp_path):
    report = check(
        tmp_path,
        """
        import random

        class Loader:
            def __init__(self, client):
                self.rng = random.Random(f"shuffle:{client.worker}")
        """,
        ["EDL008"],
        config=_EDL008_CONFIG,
    )
    assert rules_of(report) == ["EDL008"]
    assert "'worker'" in report.findings[0].message


def test_edl008_accepts_logical_seed_derivation(tmp_path):
    """Seeds from config values, shard indices, and step counters are the
    sanctioned pattern and must not fire."""
    report = check(
        tmp_path,
        """
        import random

        import numpy as np
        import torch

        def make_keys(config, shard_index, step, w):
            g = torch.Generator().manual_seed(config.seed * 1000 + step)
            noise = torch.randn((4, 4), generator=g)
            w.normal_(0.0, 0.02, generator=g)
            rng = np.random.default_rng((config.seed ^ shard_index) & 0xFF)
            shuffle = random.Random(config.shuffle_seed + shard_index)
            return noise, rng, shuffle
        """,
        ["EDL008"],
        config=_EDL008_CONFIG,
    )
    assert report.findings == []


def test_edl008_flags_accumulation_over_set_iteration(tmp_path):
    report = check(
        tmp_path,
        """
        def total_loss(losses):
            pending = set(losses)
            total = 0.0
            for item in pending:
                total += item.loss
            return total
        """,
        ["EDL008"],
        config=_EDL008_CONFIG,
    )
    assert rules_of(report) == ["EDL008"]
    assert "order varies" in report.findings[0].message
    assert "'total'" in report.findings[0].message


def test_edl008_flags_accumulation_over_membership_values(tmp_path):
    report = check(
        tmp_path,
        """
        class Aggregator:
            def grad_norm(self):
                norm = 0.0
                for shard in self._members.values():
                    norm = norm + shard.sq()
                return norm
        """,
        ["EDL008"],
        config=_EDL008_CONFIG,
    )
    assert rules_of(report) == ["EDL008"]
    assert "_members.values()" in report.findings[0].message


def test_edl008_accepts_sorted_and_list_iteration(tmp_path):
    report = check(
        tmp_path,
        """
        def totals(shards, members):
            total = 0.0
            for s in sorted(set(shards)):
                total += s.loss
            for name in sorted(members.values()):
                total += len(name)
            for s in shards:
                total += s.weight
            return total
        """,
        ["EDL008"],
        config=_EDL008_CONFIG,
    )
    assert report.findings == []


def test_edl008_scope_defaults_to_training_surface(tmp_path):
    """Outside runtime//parallel//models/ the rule is silent without the
    edl008_all_files override."""
    bad = """
    import torch

    def make_generator():
        return torch.Generator().manual_seed(torch.distributed.get_rank())
    """
    silent = check(tmp_path, bad, ["EDL008"], name="tools.py")
    assert silent.findings == []
    (tmp_path / "edl_tpu_torch" / "runtime").mkdir(parents=True)
    scoped = check(
        tmp_path, bad, ["EDL008"], name="edl_tpu_torch/runtime/loader.py"
    )
    assert rules_of(scoped) == ["EDL008"]


def test_edl008_respects_line_noqa(tmp_path):
    report = check(
        tmp_path,
        """
        import random

        def jitter(worker):
            return random.Random(f"hb:{worker}")  # edl: noqa[EDL008] heartbeat jitter, not training state
        """,
        ["EDL008"],
        config=_EDL008_CONFIG,
    )
    assert report.findings == []
    assert [f.rule for f in report.suppressed] == ["EDL008"]


# -- EDL009: protocol model check ----------------------------------------------


def test_edl009_green_on_the_real_coordinator():
    report = analyze(
        [str(REPO_ROOT / "edl_tpu_torch" / "coordinator" / "inprocess.py")],
        root=str(REPO_ROOT),
        rules=["EDL009"],
    )
    assert report.findings == []


def test_edl009_skips_trees_without_the_oracle_module(tmp_path):
    """Fixture trees never pay the exploration cost: no target file, no
    reduce work, no findings."""
    report = check(tmp_path, "x = 1\n", ["EDL009"])
    assert report.findings == []


def test_edl009_reports_state_effects_coverage_drift(tmp_path):
    """An op in the dispatch table without a state_effects entry (and vice
    versa) is a finding on the schema artifact."""
    target = tmp_path / "edl_tpu_torch" / "coordinator"
    target.mkdir(parents=True)
    (target / "inprocess.py").write_text("x = 1\n")
    (tmp_path / "protocol_schema.json").write_text(json.dumps({
        "ops": {"ping": {}, "register": {}},
        "state_effects": {"ping": {}, "vanished_op": {}},
    }))
    report = analyze(
        [str(target / "inprocess.py")], root=str(tmp_path), rules=["EDL009"]
    )
    messages = sorted(f.message for f in report.findings)
    assert len(messages) == 2
    assert "register" in messages[0] and "no state_effects entry" in messages[0]
    assert "vanished_op" in messages[1] and "stale" in messages[1]
    assert all(f.path == "protocol_schema.json" for f in report.findings)


def test_edl009_reports_missing_state_effects_block(tmp_path):
    target = tmp_path / "edl_tpu_torch" / "coordinator"
    target.mkdir(parents=True)
    (target / "inprocess.py").write_text("x = 1\n")
    (tmp_path / "protocol_schema.json").write_text(json.dumps({"ops": {}}))
    report = analyze(
        [str(target / "inprocess.py")], root=str(tmp_path), rules=["EDL009"]
    )
    (f,) = report.findings
    assert "state_effects" in f.message


# -- EDL010: durability model check ---------------------------------------------


def test_edl010_green_on_the_real_coordinator():
    """The committed twin + schema pass the crash-recovery exploration:
    all six durability schedules, zero findings."""
    report = analyze(
        [str(REPO_ROOT / "edl_tpu_torch" / "coordinator" / "inprocess.py")],
        root=str(REPO_ROOT),
        rules=["EDL010"],
    )
    assert report.findings == []


def test_edl010_skips_trees_without_the_twin_module(tmp_path):
    report = check(tmp_path, "x = 1\n", ["EDL010"])
    assert report.findings == []


def test_edl010_reports_malformed_durability_tags(tmp_path):
    """An untagged op and a tag naming an unknown journal record kind are
    findings on the schema artifact, and block exploration (a spec the
    model cannot read proves nothing)."""
    target = tmp_path / "edl_tpu_torch" / "coordinator"
    target.mkdir(parents=True)
    (target / "inprocess.py").write_text("x = 1\n")
    (tmp_path / "protocol_schema.json").write_text(json.dumps({
        "ops": {"ping": {}, "register": {}, "kv_put": {}},
        "state_effects": {
            "ping": {"durability": "none"},
            "register": {},  # untagged
            "kv_put": {"durability": "journal:blob"},  # unknown kind
        },
    }))
    report = analyze(
        [str(target / "inprocess.py")], root=str(tmp_path), rules=["EDL010"]
    )
    messages = sorted(f.message for f in report.findings)
    assert len(messages) == 2
    assert "kv_put" in messages[0] and "unknown record kind" in messages[0]
    assert "register" in messages[1] and "missing" in messages[1]
    assert all(f.path == "protocol_schema.json" for f in report.findings)


def test_validate_durability_tag_vocabulary():
    from edl_tpu_torch.analysis.checkers.durability import validate_durability_tag

    assert validate_durability_tag("none") is None
    assert validate_durability_tag("volatile") is None
    assert validate_durability_tag("composite") is None
    assert validate_durability_tag("journal:kv") is None
    assert validate_durability_tag("journal:meta,lease") is None
    assert validate_durability_tag(None) is not None
    assert validate_durability_tag("") is not None
    assert validate_durability_tag("journal:") is not None
    assert validate_durability_tag("journal:quantum") is not None
    assert validate_durability_tag("durable-ish") is not None


# -- SARIF output ---------------------------------------------------------------


def test_sarif_round_trip_on_known_findings(tmp_path):
    from edl_tpu_torch.analysis.sarif import from_sarif, to_sarif

    report = check(
        tmp_path,
        """
        import torch

        def make_generator():
            return torch.Generator().manual_seed(torch.distributed.get_rank())
        """,
        ["EDL008"],
        config=_EDL008_CONFIG,
    )
    assert report.findings
    doc = to_sarif(report.findings, baselined=[])
    assert doc["version"] == "2.1.0"
    run = doc["runs"][0]
    assert any(r["id"] == "EDL009" for r in run["tool"]["driver"]["rules"])
    new, baselined = from_sarif(json.loads(json.dumps(doc)))
    assert baselined == []
    assert new == report.findings


def test_sarif_marks_baselined_findings_as_suppressed(tmp_path):
    from edl_tpu_torch.analysis.sarif import from_sarif, to_sarif

    report = check(
        tmp_path,
        """
        def total(pending):
            total = 0.0
            for item in set(pending):
                total += item
            return total
        """,
        ["EDL008"],
        config=_EDL008_CONFIG,
    )
    doc = to_sarif([], baselined=report.findings)
    result = doc["runs"][0]["results"][0]
    assert result["suppressions"][0]["kind"] == "external"
    assert result["partialFingerprints"]["edlFingerprint/v1"] == fingerprint(
        report.findings[0]
    )
    new, baselined = from_sarif(doc)
    assert new == [] and baselined == report.findings


def test_cli_format_sarif(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("def f():\n    return 1\n")
    rc = cli_main(["--format", "sarif", "--baseline", "none", str(clean)])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert doc["version"] == "2.1.0"
    assert doc["runs"][0]["results"] == []


# -- parallel parity / reduce timings for the new program rules -----------------


def test_new_program_rules_jobs_parity(tmp_path):
    """EDL008 map/reduce across a process pool produces byte-identical
    findings to the serial path (EDL009 has no target file here and must
    stay silent in both)."""
    bad = textwrap.dedent(
        """
        import torch

        def make_generator():
            return torch.Generator().manual_seed(torch.distributed.get_rank())
        """
    )
    for i in range(4):
        (tmp_path / f"mod{i}.py").write_text(bad)
    kw = dict(
        root=str(tmp_path),
        rules=["EDL008", "EDL009"],
        config=_EDL008_CONFIG,
    )
    serial = analyze([str(tmp_path)], jobs=1, **kw)
    forked = analyze([str(tmp_path)], jobs=2, **kw)
    as_tuples = lambda r: [  # noqa: E731
        (f.path, f.line, f.col, f.rule, f.message) for f in r.findings
    ]
    assert as_tuples(serial) == as_tuples(forked)
    assert len(serial.findings) == 4
    assert serial.jobs == 1 and forked.jobs == 2


def test_edl009_jobs_parity_on_the_real_tree():
    coord = str(REPO_ROOT / "edl_tpu_torch" / "coordinator")
    kw = dict(root=str(REPO_ROOT), rules=["EDL009"])
    serial = analyze([coord], jobs=1, **kw)
    forked = analyze([coord], jobs=2, **kw)
    assert serial.findings == forked.findings == []


def test_report_splits_reduce_timings_from_map_timings(tmp_path):
    (tmp_path / "m.py").write_text("x = 1\n")
    report = analyze(
        [str(tmp_path)], root=str(tmp_path), rules=["EDL005", "EDL008"]
    )
    assert "EDL005" in report.timings
    assert "EDL005" not in report.reduce_timings  # file rules never reduce
    assert "EDL008" in report.reduce_timings
    assert report.reduce_timings["EDL008"] >= 0.0


# -- the two analyzers on the JAX suite's own fixtures ---------------------------

#: the rules whose checkers are copies (imports rewritten): their fixtures
#: in the JAX suite must read the same through both analyzers
_SHARED_RULES = {"EDL001", "EDL004", "EDL005", "EDL006", "EDL007"}


def _jax_fixtures():
    """Every ``check(tmp_path, SOURCE, RULES, ...)`` and ``wire_check(tmp_path,
    FILES, ...)`` call with literal arguments in `tests/test_analysis.py`,
    for the shared rules, as (id, kind, arguments). Module constants the
    calls name (``_BAD_EDL005``, ``_EDL007_CONFIG``, ``_TOY_CC``) are
    resolved; calls with computed arguments are left out."""
    import ast

    tree = ast.parse((REPO_ROOT / "tests" / "test_analysis.py").read_text())
    consts = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            try:
                consts[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass

    def value(node):
        if isinstance(node, ast.Name) and node.id in consts:
            return consts[node.id]
        return ast.literal_eval(node)

    cases = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef) or not fn.name.startswith("test_"):
            continue
        calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Name) and n.func.id in ("check", "wire_check")]
        for i, call in enumerate(sorted(calls, key=lambda c: (c.lineno, c.col_offset))):
            try:
                args = [value(a) for a in call.args[1:]]
                kw = {k.arg: value(k.value) for k in call.keywords}
            except (ValueError, KeyError, SyntaxError):
                continue  # a computed argument
            if call.func.id == "check":
                if not set(args[1]) <= _SHARED_RULES:
                    continue
            cases.append(pytest.param(call.func.id, args, kw, id=f"{fn.name}-{i}"))
    return cases


def _run_fixture(pkg, tmp_path, kind, args, kw):
    import importlib

    analysis = importlib.import_module(f"{pkg}.analysis")
    wire = importlib.import_module(f"{pkg}.analysis.checkers.wire_protocol")
    tmp_path.mkdir()
    if kind == "check":
        source, rules = args[0], args[1]
        p = tmp_path / kw.get("name", "snippet.py")
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(source))
        report = analysis.analyze([str(p)], root=str(tmp_path), rules=rules,
                                  config=kw.get("config"))
    else:
        files = args[0]
        cc = textwrap.dedent(kw.get("cc", _TOY_CC))
        (tmp_path / "coord.cc").write_text(cc)
        schema = kw.get("schema", "fresh")
        if schema == "fresh":
            schema = wire.extract_native_schema(cc, "coord.cc")
        if schema is not None:
            (tmp_path / "schema.json").write_text(json.dumps(schema))
        paths = []
        for name, src in files.items():
            (tmp_path / name).write_text(textwrap.dedent(src))
            paths.append(str(tmp_path / name))
        report = analysis.analyze(paths, root=str(tmp_path), rules=["EDL007"],
                                  config=_EDL007_CONFIG)
    return ([(f.rule, f.path, f.line, f.col, f.symbol,
              f.message.replace("edl_tpu_torch", "edl_tpu")) for f in report.findings],
            [(f.rule, f.line) for f in report.suppressed])


@pytest.mark.parametrize("kind, args, kw", _jax_fixtures())
def test_both_analyzers_agree_on_the_jax_fixtures(tmp_path, kind, args, kw):
    """The JAX suite's fixture, as its test wrote it, through the JAX
    analyzer and the port's: the same findings (rule, file, line, column,
    symbol) with the same message once the package names are substituted,
    and the same suppressions."""
    jax_side = _run_fixture("edl_tpu", tmp_path / "jax", kind, args, kw)
    port_side = _run_fixture("edl_tpu_torch", tmp_path / "port", kind, args, kw)
    assert port_side == jax_side


def test_the_harvest_covers_every_shared_rule():
    """Each shared rule has a firing and a silent JAX fixture in the harvest."""
    seen = {}
    for case in _jax_fixtures():
        kind, args, _ = case.values
        rules = args[1] if kind == "check" else ["EDL007"]
        for rule in rules:
            seen.setdefault(rule, set()).add(case.id)
    assert set(seen) == _SHARED_RULES
    assert all(len(ids) >= 2 for ids in seen.values()), seen
