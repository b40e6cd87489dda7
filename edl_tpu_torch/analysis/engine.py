"""Analysis engine: walk files, run checkers, apply suppressions.

Two checker scopes:

- **file** (the default): ``check(sf, ctx)`` sees one parsed ``SourceFile``
  at a time. EDL001-EDL005.
- **program**: map/reduce over the whole tree. ``summarize(sf, ctx)``
  extracts a small picklable summary per file (runs wherever the file is
  parsed — possibly a pool worker); ``reduce(summaries, ctx)`` sees every
  summary at once and emits the cross-file findings. EDL006 builds its
  repo-wide call graph this way; EDL007 joins the Python summaries against
  the C++ dispatch table it parses itself in ``reduce``.

Per-file work (parse + file checkers + summaries) fans out across a process
pool when ``jobs > 1``; the reduce phase is always in-process. The summary
design is what makes the pool safe: ASTs never cross process boundaries,
only plain dict/tuple summaries and ``Finding`` dataclasses do.

Baseline handling lives in ``baseline.py``; output formatting in ``cli.py``.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

from edl_tpu_torch.analysis.core import Finding, SourceFile

_SKIP_DIRS = {
    "__pycache__",
    ".git",
    ".hg",
    "node_modules",
    "native",
    ".venv",
    "venv",
    ".eggs",
    "build",
    "dist",
}


@dataclass
class AnalysisContext:
    """Shared state handed to every checker.

    ``root`` anchors cross-file lookups (EDL003 reads ``parallel/mesh.py``
    relative to it, EDL007 the native coordinator source); ``config`` carries
    per-run overrides (fixture axis universes, scope widening, fixture
    protocol files); ``cache`` is scratch space checkers use to avoid
    re-parsing shared inputs.
    """

    root: str
    config: Dict[str, Any] = field(default_factory=dict)
    cache: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Report:
    findings: List[Finding]
    suppressed: List[Finding]
    files_checked: int
    parse_errors: List[Tuple[str, str]] = field(default_factory=list)
    #: rule id -> cumulative seconds in the per-file (map) phase: file
    #: checkers sum ``check`` across files; program checkers sum
    #: ``summarize``. With ``--jobs`` this is CPU time across the pool,
    #: not wall clock.
    timings: Dict[str, float] = field(default_factory=dict)
    #: rule id -> seconds in the in-parent reduce phase (program checkers
    #: only). Kept separate from ``timings`` because reduce is serial wall
    #: clock — a slow reduce can't be bought back with more jobs.
    reduce_timings: Dict[str, float] = field(default_factory=dict)
    #: worker processes used for the per-file phase (1 = in-process serial).
    jobs: int = 1

    def by_rule(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out


def iter_python_files(paths: Sequence[str]) -> Iterator[str]:
    """Yield .py files under ``paths`` (files given directly always yield)."""
    seen = set()
    for path in paths:
        path = os.path.abspath(path)
        if os.path.isfile(path):
            if path not in seen:
                seen.add(path)
                yield path
            continue
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = sorted(
                d for d in dirnames
                if d not in _SKIP_DIRS and not d.startswith(".")
            )
            for name in sorted(filenames):
                if name.endswith(".py"):
                    full = os.path.join(dirpath, name)
                    if full not in seen:
                        seen.add(full)
                        yield full


def detect_root(paths: Sequence[str]) -> str:
    """Repo root: nearest ancestor of the first path that contains the
    ``edl_tpu_torch`` package (so EDL003 can find ``parallel/mesh.py``); falls
    back to the CWD."""
    for path in paths:
        probe = os.path.abspath(path)
        if os.path.isfile(probe):
            probe = os.path.dirname(probe)
        while True:
            if os.path.isfile(
                os.path.join(probe, "edl_tpu_torch", "parallel", "mesh.py")
            ):
                return probe
            parent = os.path.dirname(probe)
            if parent == probe:
                break
            probe = parent
    return os.getcwd()


def default_jobs(n_files: int) -> int:
    """Pool width: EDL_ANALYZE_JOBS wins; otherwise one worker per core
    (capped), and serial when the tree is too small to amortize fork+pickle."""
    env = os.environ.get("EDL_ANALYZE_JOBS", "").strip()
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    if n_files < 24:
        return 1
    return max(1, min(os.cpu_count() or 1, 8))


def _split_checkers(rules: Optional[Iterable[str]]):
    from edl_tpu_torch.analysis.checkers import ALL_CHECKERS

    wanted = {r.upper() for r in rules} if rules is not None else None
    file_rules: List[str] = []
    program_rules: List[str] = []
    for cls in ALL_CHECKERS:
        if wanted is not None and cls.rule not in wanted:
            continue
        if getattr(cls, "scope", "file") == "program":
            program_rules.append(cls.rule)
        else:
            file_rules.append(cls.rule)
    return file_rules, program_rules


def _checkers_by_rule(rule_ids: Sequence[str]):
    from edl_tpu_torch.analysis.checkers import RULES

    return [RULES[r]() for r in rule_ids]


def _analyze_one(
    path: str,
    root: str,
    file_rules: Sequence[str],
    program_rules: Sequence[str],
    config: Dict[str, Any],
) -> Dict[str, Any]:
    """Per-file unit of work — module-level so a process pool can pickle it.

    Everything returned is plain data: findings (dataclasses), the file's
    noqa/symbol index (so program-checker findings can be suppressed and
    symbol-tagged without re-parsing in the parent), per-rule seconds, and
    each program checker's summary.
    """
    relpath = os.path.relpath(path, root).replace(os.sep, "/")
    out: Dict[str, Any] = {
        "relpath": relpath,
        "findings": [],
        "suppressed": [],
        "error": None,
        "summaries": {},
        "timings": {},
        "index": None,
    }
    ctx = AnalysisContext(root=root, config=dict(config))
    try:
        with open(path, "r", encoding="utf-8") as f:
            sf = SourceFile(path, relpath, f.read())
    except (SyntaxError, UnicodeDecodeError, OSError) as e:
        out["error"] = f"{type(e).__name__}: {e}"
        return out

    for checker in _checkers_by_rule(file_rules):
        t0 = time.perf_counter()
        for finding in checker.check(sf, ctx):
            if not finding.symbol:
                finding = Finding(
                    rule=finding.rule,
                    path=finding.path,
                    line=finding.line,
                    col=finding.col,
                    message=finding.message,
                    symbol=sf.symbol_at(finding.line),
                )
            if sf.is_suppressed(finding):
                out["suppressed"].append(finding)
            else:
                out["findings"].append(finding)
        out["timings"][checker.rule] = (
            out["timings"].get(checker.rule, 0.0) + time.perf_counter() - t0
        )

    for checker in _checkers_by_rule(program_rules):
        t0 = time.perf_counter()
        out["summaries"][checker.rule] = checker.summarize(sf, ctx)
        out["timings"][checker.rule] = (
            out["timings"].get(checker.rule, 0.0) + time.perf_counter() - t0
        )

    # Noqa table + symbol intervals: the parent applies suppression to
    # program-checker findings against this, without holding the AST.
    out["index"] = {
        "noqa": {
            line: (None if rules is None else sorted(rules))
            for line, rules in sf.noqa.items()
        },
        "symbols": list(sf.symbols),
    }
    return out


def _symbol_at(symbols: List[Tuple[int, int, str]], line: int) -> str:
    best, best_span = "", None
    for start, end, qual in symbols:
        if start <= line <= end:
            span = end - start
            if best_span is None or span <= best_span:
                best, best_span = qual, span
    return best


def _is_suppressed(index: Optional[Dict], finding: Finding) -> bool:
    if not index:
        return False
    rules = index["noqa"].get(finding.line, ())
    if rules == ():
        return False
    return rules is None or finding.rule.upper() in rules


def analyze(
    paths: Sequence[str],
    root: Optional[str] = None,
    rules: Optional[Iterable[str]] = None,
    config: Optional[Dict[str, Any]] = None,
    jobs: Optional[int] = None,
) -> Report:
    """Run the checker suite over ``paths``.

    ``rules`` filters to a subset of rule ids (default: all). ``jobs``
    widens the per-file phase across a process pool (default: auto —
    EDL_ANALYZE_JOBS, else cores, serial for small trees). Findings on
    ``# edl: noqa`` lines land in ``report.suppressed``; everything else in
    ``report.findings`` (baseline application is the caller's business).
    """
    root = os.path.abspath(root or detect_root(paths))
    config = dict(config or {})
    file_rules, program_rules = _split_checkers(rules)

    files = list(iter_python_files(paths))
    n_jobs = jobs if jobs is not None else default_jobs(len(files))

    results: List[Dict[str, Any]] = []
    if n_jobs > 1 and len(files) > 1:
        import concurrent.futures

        try:
            with concurrent.futures.ProcessPoolExecutor(
                max_workers=n_jobs
            ) as pool:
                results = list(
                    pool.map(
                        _analyze_one,
                        files,
                        [root] * len(files),
                        [file_rules] * len(files),
                        [program_rules] * len(files),
                        [config] * len(files),
                        chunksize=max(1, len(files) // (n_jobs * 4)),
                    )
                )
        except (OSError, ValueError):
            # Pool unavailable (sandboxed fork, fd limits): fall back rather
            # than fail the lint — serial produces identical findings.
            n_jobs = 1
            results = []
    if not results:
        n_jobs = 1
        results = [
            _analyze_one(p, root, file_rules, program_rules, config)
            for p in files
        ]

    findings: List[Finding] = []
    suppressed: List[Finding] = []
    errors: List[Tuple[str, str]] = []
    timings: Dict[str, float] = {}
    indexes: Dict[str, Dict] = {}
    summaries: Dict[str, List[Tuple[str, Any]]] = {r: [] for r in program_rules}
    n_files = 0
    for res in results:
        if res["error"] is not None:
            errors.append((res["relpath"], res["error"]))
            continue
        n_files += 1
        findings.extend(res["findings"])
        suppressed.extend(res["suppressed"])
        indexes[res["relpath"]] = res["index"]
        for rule, summary in res["summaries"].items():
            summaries[rule].append((res["relpath"], summary))
        for rule, sec in res["timings"].items():
            timings[rule] = timings.get(rule, 0.0) + sec

    ctx = AnalysisContext(root=root, config=config)
    reduce_timings: Dict[str, float] = {}
    for checker in _checkers_by_rule(program_rules):
        t0 = time.perf_counter()
        for finding in checker.reduce(summaries[checker.rule], ctx):
            index = indexes.get(finding.path)
            if not finding.symbol and index:
                finding = Finding(
                    rule=finding.rule,
                    path=finding.path,
                    line=finding.line,
                    col=finding.col,
                    message=finding.message,
                    symbol=_symbol_at(index["symbols"], finding.line),
                )
            if _is_suppressed(index, finding):
                suppressed.append(finding)
            else:
                findings.append(finding)
        reduce_timings[checker.rule] = (
            reduce_timings.get(checker.rule, 0.0) + time.perf_counter() - t0
        )

    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    suppressed.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return Report(
        findings=findings,
        suppressed=suppressed,
        files_checked=n_files,
        parse_errors=errors,
        timings=timings,
        reduce_timings=reduce_timings,
        jobs=n_jobs,
    )
