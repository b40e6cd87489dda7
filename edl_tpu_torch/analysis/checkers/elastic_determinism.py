"""EDL008 — elastic determinism: training state must not depend on who is
running it.

Accuracy-consistent elasticity (the EasyScale deliverable in ROADMAP.md)
requires that the loss curve be a function of the *logical* schedule —
global step, logical batch index, shard index — never of the physical
membership that happens to execute it. Two bug classes break that and
survive every unit test, because single-host test runs have a stable
identity and a stable iteration order:

- **A. host-identity RNG** (``rng-host-identity``): an RNG constructed or
  seeded from ``torch.distributed.get_rank()``, the ``RANK``/``LOCAL_RANK``
  environment, the hostname, the PID, a wall clock, or a worker-name
  string. Rescale the job and every worker re-derives
  different randomness for the *same* logical batch — dropout masks,
  shuffles, and augmentations silently change with membership history.
- **B. unordered accumulation** (``unordered-accumulation``): a numeric
  reduction driven by iteration over a ``set`` (or the views of a
  membership dict). Set iteration order is hash-seed and insertion-history
  dependent, so float accumulation order — and therefore the rounded
  result — varies across hosts and across rescales.
- **C. the global RNG stream** (``rng-global-stream``): ``torch.rand*``,
  ``randn*``, ``randint``, ``randperm``, ``bernoulli``, ``multinomial`` or
  an in-place ``normal_``/``uniform_`` with no explicit ``generator=``. They
  draw from the process's default generator, whose position is whatever
  ran before in this process — that is, the membership history.

The rule is scoped to the training-state surface (``runtime/``,
``parallel/``, ``models/`` by default). Control-plane timing code — e.g.
heartbeat jitter that *should* decorrelate per worker — is exactly what
line-level ``# edl: noqa[EDL008] <why>`` is for.

Detection is a per-function (plus module-level) forward taint pass:
identity/clock *sources* propagate through assignments, f-strings, and
arithmetic to RNG-constructor/seeder *sinks*. It runs as a program-scope
rule purely so the per-file pass rides the map phase's process pool; the
reduce phase only re-emits the per-file candidates (no cross-file state).

Config overrides: ``edl008_prefixes`` (iterable of relpath prefixes),
``edl008_all_files`` (bool: lint every analyzed file — fixtures use this).
"""

from __future__ import annotations

import ast
from typing import Any, Dict, Iterator, List, Optional, Tuple

from edl_tpu_torch.analysis.core import Finding, RuleInfo, SourceFile, dotted_name

DEFAULT_PREFIXES = (
    "edl_tpu_torch/runtime/",
    "edl_tpu_torch/parallel/",
    "edl_tpu_torch/models/",
)

#: dotted-name *tails* that read host identity / process identity / entropy.
#: Matched against the last component of the called name, so they survive
#: ``import socket`` vs ``from socket import gethostname`` equally.
_SOURCE_CALL_TAILS = {
    "get_rank",
    "get_world_size",
    "get_node_local_rank",
    "gethostname",
    "getfqdn",
    "getpid",
    "getppid",
    "urandom",
    "uuid1",
    "uuid4",
    "time_ns",
    "monotonic",
    "monotonic_ns",
    "perf_counter",
    "perf_counter_ns",
}

#: full dotted names whose tail alone is too generic to match ("time",
#: "node" would fire on every ast.walk visitor).
_SOURCE_CALL_EXACT = {
    "time.time",
    "platform.node",
    "datetime.now",
    "datetime.datetime.now",
    "datetime.utcnow",
    "datetime.datetime.utcnow",
}

#: bare names / attribute tails that carry a worker's identity by
#: convention in this codebase (coordinator clients expose ``.worker``,
#: configs expose ``host_id``).
_IDENTITY_NAME_TAILS = {
    "worker",
    "worker_name",
    "worker_id",
    "hostname",
    "host_name",
    "host_id",
    "local_rank",
    "nodename",
    "pod_name",
}

#: environment variables the launchers set per process
_IDENTITY_ENV = {"RANK", "LOCAL_RANK", "GROUP_RANK", "NODE_RANK",
                 "HOSTNAME", "EDL_POD_NAME"}

#: call tails that construct or (re)seed an RNG — the sinks.
_RNG_SINK_TAILS = {
    "manual_seed",      # torch.manual_seed, Generator().manual_seed
    "manual_seed_all",  # torch.cuda.manual_seed_all
    "Generator",
    "default_rng",
    "Random",
    "RandomState",
    "SeedSequence",
    "seed",
}

#: ``.seed(...)`` shares its tail with unrelated APIs; require the
#: owner/base to look RNG-ish for the ambiguous ones.
_AMBIGUOUS_SINK_TAILS = {"seed"}
_RNG_BASE_HINTS = ("random", "rng", "torch", "generator")

#: torch functions that draw from the default generator unless given
#: ``generator=`` (sub-rule C), and the in-place tensor methods that do
_GLOBAL_STREAM_FUNCS = {
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "bernoulli", "multinomial", "normal", "poisson",
}
_GLOBAL_STREAM_METHODS = {"normal_", "uniform_", "bernoulli_", "random_",
                          "exponential_", "geometric_", "cauchy_",
                          "log_normal_"}

_NUMERIC_AUG_OPS = (ast.Add, ast.Sub, ast.Mult)


def _call_tail(node: ast.Call) -> str:
    name = dotted_name(node.func) or ""
    return name.rsplit(".", 1)[-1] if name else ""


def _is_source_call(node: ast.Call) -> Optional[str]:
    name = dotted_name(node.func) or ""
    if not name:
        return None
    tail = name.rsplit(".", 1)[-1]
    if tail in _SOURCE_CALL_TAILS:
        return name
    for exact in _SOURCE_CALL_EXACT:
        if name == exact or name.endswith("." + exact):
            return name
    return None


def _identity_tail(node: ast.AST) -> Optional[str]:
    """``worker`` / ``self.client.worker`` / ``cfg.host_id`` -> the tail."""
    if isinstance(node, ast.Name) and node.id in _IDENTITY_NAME_TAILS:
        return node.id
    if isinstance(node, ast.Attribute) and node.attr in _IDENTITY_NAME_TAILS:
        return node.attr
    return None


def _identity_env(node: ast.AST) -> Optional[str]:
    """``os.environ["RANK"]`` / ``os.environ.get("RANK")`` /
    ``os.getenv("LOCAL_RANK")`` -> the variable's name."""
    key: Optional[ast.AST] = None
    if isinstance(node, ast.Subscript) and (
        dotted_name(node.value) or ""
    ).endswith("environ"):
        key = node.slice
    elif isinstance(node, ast.Call) and node.args:
        name = dotted_name(node.func) or ""
        if name.endswith(("environ.get", "getenv")):
            key = node.args[0]
    if (isinstance(key, ast.Constant) and isinstance(key.value, str)
            and key.value in _IDENTITY_ENV):
        return key.value
    return None


def _global_stream_draw(node: ast.Call) -> Optional[str]:
    """The dotted name of a draw from the default torch generator, or None
    when the call names its ``generator=`` (or is no such draw)."""
    if any(kw.arg == "generator" for kw in node.keywords):
        return None
    name = _callee_name(node.func) or ""
    tail = name.rsplit(".", 1)[-1]
    if tail in _GLOBAL_STREAM_FUNCS and name.startswith("torch."):
        return name
    if tail in _GLOBAL_STREAM_METHODS and isinstance(node.func, ast.Attribute):
        return name or f"<tensor>.{tail}"
    return None


def _expr_taint(node: ast.AST, tainted: Dict[str, str]) -> Optional[str]:
    """First identity/clock source reachable inside ``node``, else None.

    Walking the whole expression covers f-strings (FormattedValue values),
    arithmetic on sources, and tuple/list packing in one pass.
    """
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            src = _is_source_call(sub)
            if src is not None:
                return f"{src}()"
        env = _identity_env(sub)
        if env is not None:
            return f"the {env} environment"
        ident = _identity_tail(sub)
        if ident is not None:
            return f"'{ident}'"
        if isinstance(sub, ast.Name) and sub.id in tainted:
            return tainted[sub.id]
    return None


def _callee_name(func: ast.AST) -> Optional[str]:
    """``dotted_name``, and through a call chain: the callee of
    ``torch.Generator().manual_seed(...)`` reads
    ``torch.Generator().manual_seed``."""
    name = dotted_name(func)
    if name is None and isinstance(func, ast.Attribute) and isinstance(
        func.value, ast.Call
    ):
        return f"{_callee_name(func.value.func) or '<call>'}().{func.attr}"
    return name


def _is_rng_sink(node: ast.Call) -> bool:
    name = _callee_name(node.func) or ""
    if not name:
        return False
    tail = name.rsplit(".", 1)[-1]
    if tail not in _RNG_SINK_TAILS:
        return False
    if tail in _AMBIGUOUS_SINK_TAILS:
        base = name[: -(len(tail) + 1)].lower()
        return any(h in base for h in _RNG_BASE_HINTS)
    return True


def _scope_bodies(tree: ast.Module):
    """Yield (body, is_module) for the module and every function, without
    descending into nested scopes twice."""
    yield tree.body, True
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.body, False


_SCOPE_BARRIERS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def _iter_stmts(body: List[ast.stmt]):
    """Statements of a scope, recursing into compound statements (if/for/
    try/with) but never across a def/class boundary — nested scopes get
    their own pass via ``_scope_bodies``."""
    for stmt in body:
        yield stmt
        if isinstance(stmt, _SCOPE_BARRIERS):
            continue
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.stmt):
                yield from _iter_stmts([child])
            elif isinstance(child, ast.excepthandler):
                yield from _iter_stmts(child.body)


def _walk_scope(node: ast.AST):
    """``ast.walk`` pruned at def/class/lambda boundaries."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child, _SCOPE_BARRIERS + (ast.Lambda,)):
                continue
            stack.append(child)


class _ScopeLint:
    """One taint + iteration-order pass over a single scope's statements."""

    def __init__(self) -> None:
        self.tainted: Dict[str, str] = {}   # var name -> source description
        self.set_vars: Dict[str, int] = {}  # var name -> def line (set-typed)
        self.out: List[Dict[str, Any]] = []

    # -- sub-rule A: host-identity RNG ------------------------------------

    def _propagate(self, stmts: List[ast.stmt]) -> None:
        # Two fixpoint passes over straight-line assignments are enough for
        # the chains this codebase writes (src -> name -> f-string -> seed).
        for _ in range(2):
            changed = False
            for stmt in stmts:
                targets: List[str] = []
                value: Optional[ast.AST] = None
                if isinstance(stmt, ast.Assign):
                    value = stmt.value
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            targets.append(t.id)
                elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                    value = stmt.value
                    if isinstance(stmt.target, ast.Name):
                        targets.append(stmt.target.id)
                elif isinstance(stmt, ast.AugAssign):
                    value = stmt.value
                    if isinstance(stmt.target, ast.Name):
                        targets.append(stmt.target.id)
                if value is None or not targets:
                    continue
                src = _expr_taint(value, self.tainted)
                if src is not None:
                    for name in targets:
                        if name not in self.tainted:
                            self.tainted[name] = src
                            changed = True
                # Track set-typed definitions for sub-rule B.
                if _is_set_expr(value):
                    for name in targets:
                        self.set_vars.setdefault(name, stmt.lineno)
            if not changed:
                break

    def _check_sinks(self, stmts: List[ast.stmt]) -> None:
        seen_lines = set()
        for stmt in stmts:
            if isinstance(stmt, _SCOPE_BARRIERS):
                continue
            for node in _walk_scope(stmt):
                if not isinstance(node, ast.Call) or not _is_rng_sink(node):
                    continue
                args: List[ast.AST] = list(node.args)
                args.extend(kw.value for kw in node.keywords)
                src = None
                for arg in args:
                    src = _expr_taint(arg, self.tainted)
                    if src is not None:
                        break
                if src is None or node.lineno in seen_lines:
                    continue
                seen_lines.add(node.lineno)
                sink = _callee_name(node.func) or "rng"
                self.out.append({
                    "line": node.lineno,
                    "col": node.col_offset,
                    "kind": "rng-host-identity",
                    "message": (
                        f"RNG seed for {sink}() derives from host identity "
                        f"or wall clock ({src}) — training randomness must "
                        "be a function of the logical batch/shard index so "
                        "it survives rescaling"
                    ),
                })

    # -- sub-rule C: draws from the default generator ---------------------

    def _check_global_stream(self, stmts: List[ast.stmt]) -> None:
        seen_lines = set()
        for stmt in stmts:
            if isinstance(stmt, _SCOPE_BARRIERS):
                continue
            for node in _walk_scope(stmt):
                if not isinstance(node, ast.Call):
                    continue
                draw = _global_stream_draw(node)
                if draw is None or node.lineno in seen_lines:
                    continue
                seen_lines.add(node.lineno)
                self.out.append({
                    "line": node.lineno,
                    "col": node.col_offset,
                    "kind": "rng-global-stream",
                    "message": (
                        f"{draw}() draws from the default torch generator, "
                        "whose position depends on what ran before in this "
                        "process — pass generator= seeded from the logical "
                        "step/shard so the draw survives rescaling"
                    ),
                })

    # -- sub-rule B: unordered iteration feeding accumulation -------------

    def _check_loops(self, stmts: List[ast.stmt]) -> None:
        for stmt in stmts:
            if not isinstance(stmt, (ast.For, ast.AsyncFor)):
                continue
            why = _unordered_iter(stmt.iter, self.set_vars)
            if why is None:
                continue
            acc = _find_accumulation(stmt.body)
            if acc is None:
                continue
            self.out.append({
                "line": stmt.lineno,
                "col": stmt.col_offset,
                "kind": "unordered-accumulation",
                "message": (
                    f"numeric accumulation into '{acc}' is driven by "
                    f"iteration over {why} — set/dict order varies across "
                    "hosts and rescales; iterate a sorted() or logically "
                    "indexed sequence instead"
                ),
            })

    def run(self, body: List[ast.stmt]) -> List[Dict[str, Any]]:
        stmts = list(_iter_stmts(body))
        self._propagate(stmts)
        self._check_sinks(stmts)
        self._check_global_stream(stmts)
        self._check_loops(stmts)
        return self.out


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        tail = _call_tail(node)
        if tail in ("set", "frozenset"):
            return True
        # set arithmetic keeps set-ness: a | b via ``set(...).union(...)``
        if tail in ("union", "intersection", "difference"):
            return isinstance(node.func, ast.Attribute) and _is_set_expr(
                node.func.value
            )
    if isinstance(node, ast.BinOp) and isinstance(
        node.op, (ast.BitOr, ast.BitAnd, ast.Sub)
    ):
        return _is_set_expr(node.left) or _is_set_expr(node.right)
    return False


def _membership_dict_base(node: ast.AST) -> Optional[str]:
    """``self._members.values()`` -> "members" when base smells like a
    membership map (named *members*/*workers*/*hosts*)."""
    name = dotted_name(node) or ""
    tail = name.rsplit(".", 1)[-1].lstrip("_").lower()
    for hint in ("members", "workers", "hosts", "peers"):
        if hint in tail:
            return name
    return None


def _unordered_iter(
    iter_node: ast.AST, set_vars: Dict[str, int]
) -> Optional[str]:
    if _is_set_expr(iter_node):
        return "a set expression"
    if isinstance(iter_node, ast.Name) and iter_node.id in set_vars:
        return f"the set '{iter_node.id}'"
    if isinstance(iter_node, ast.Call) and isinstance(
        iter_node.func, ast.Attribute
    ):
        if iter_node.func.attr in ("values", "items", "keys"):
            base = _membership_dict_base(iter_node.func.value)
            if base is not None:
                return f"unordered membership view {base}.{iter_node.func.attr}()"
            if _is_set_expr(iter_node.func.value):
                return "a set expression"
    return None


def _find_accumulation(body: List[ast.stmt]) -> Optional[str]:
    """First arithmetic accumulation target in the loop body
    (``acc += x`` / ``acc = acc + x``), or None."""
    for stmt in _iter_stmts(body):
        if isinstance(stmt, ast.AugAssign) and isinstance(
            stmt.op, _NUMERIC_AUG_OPS
        ):
            name = dotted_name(stmt.target)
            if name:
                return name
        if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.BinOp):
            if not isinstance(stmt.value.op, _NUMERIC_AUG_OPS):
                continue
            for t in stmt.targets:
                tname = dotted_name(t)
                if tname and any(
                    dotted_name(sub) == tname
                    for sub in ast.walk(stmt.value)
                    if isinstance(sub, (ast.Name, ast.Attribute))
                ):
                    return tname
    return None


class ElasticDeterminismChecker:
    rule = "EDL008"
    name = "elastic-determinism"
    scope = "program"
    info = RuleInfo(
        rule="EDL008",
        name="elastic-determinism",
        description=(
            "training-state computation in runtime//parallel//models/ must "
            "not depend on host identity, world size, wall clocks, the "
            "default torch generator's position, or unordered set/dict "
            "iteration — RNG seeds and accumulation order must be "
            "functions of the logical schedule"
        ),
    )

    # -- map phase --------------------------------------------------------

    def _applies(self, sf: SourceFile, ctx) -> bool:
        if ctx.config.get("edl008_all_files"):
            return True
        prefixes = tuple(
            ctx.config.get("edl008_prefixes", DEFAULT_PREFIXES)
        )
        return any(sf.relpath.startswith(p) for p in prefixes)

    def summarize(
        self, sf: SourceFile, ctx
    ) -> Optional[List[Dict[str, Any]]]:
        if not self._applies(sf, ctx):
            return None
        candidates: List[Dict[str, Any]] = []
        for body, _is_module in _scope_bodies(sf.tree):
            candidates.extend(_ScopeLint().run(body))
        return candidates or None

    # -- reduce phase ------------------------------------------------------

    def reduce(
        self,
        summaries: List[Tuple[str, Optional[List[Dict[str, Any]]]]],
        ctx,
    ) -> Iterator[Finding]:
        for relpath, candidates in summaries:
            for c in candidates or ():
                yield Finding(
                    rule=self.rule,
                    path=relpath,
                    line=c["line"],
                    col=c["col"],
                    message=c["message"],
                    symbol="",
                )
