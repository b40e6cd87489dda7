"""EDL002 — trace-hygiene inside bodies that are captured once and replayed.

A CUDA graph, ``torch.compile`` and TorchScript all record a body once and
replay what they recorded: anything host-side in it either bakes a stale
value into the replay (``time.time()``, ``np.random``), forces a device
sync, or (under ``torch.compile``) silently breaks the graph and
recompiles. This checker catches them at review time.

Captured bodies are found per file:

- ``with torch.cuda.graph(...):`` blocks (the block's statements);
- functions decorated ``@torch.compile`` / ``@torch.compile(...)`` /
  ``@torch.jit.script``, or ``@partial(torch.compile, ...)``;
- local functions or lambdas passed to ``torch.compile(...)``,
  ``torch.jit.script(...)``, ``torch.jit.trace(...)`` or
  ``torch.cuda.make_graphed_callables(...)`` anywhere in the file.

Inside a captured body (nested defs included) it flags:

- host clocks: ``time.time/perf_counter/monotonic/process_time/sleep``;
- host RNG: ``np.random.*`` / ``numpy.random.*`` / stdlib ``random.*``
  (``torch`` RNG is fine — a graph replays it from its generator state);
- host calls: ``print``/``input``/``breakpoint``;
- value-dependent Python control flow: ``if``/``while`` tests that use a
  parameter directly (``.shape``/``.ndim``/``.dtype`` accesses and
  ``len``/``isinstance`` are static and allowed), ``float()/int()/bool()``
  on a parameter, and ``.item()``/``.tolist()``/``.numpy()`` on one (each
  forces a blocking device sync, which a capture cannot hold).

The parameters of a ``with torch.cuda.graph`` block are those of the
function the block sits in. The parameter check is name-based and local —
values laundered through assignments are not chased. That keeps every
report actionable.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Set

from edl_tpu_torch.analysis.core import Finding, RuleInfo, SourceFile, dotted_name

#: callables that capture the function they are given (or decorate)
_CAPTURERS = {
    "torch.compile",
    "torch.jit.script",
    "torch.jit.trace",
    "jit.script",
    "jit.trace",
    "torch.cuda.make_graphed_callables",
    "cuda.make_graphed_callables",
    "make_graphed_callables",
}

#: context managers whose block is captured
_CAPTURE_BLOCKS = {"torch.cuda.graph", "cuda.graph"}

_HOST_CLOCKS = {
    "time.time",
    "time.perf_counter",
    "time.monotonic",
    "time.process_time",
    "time.sleep",
}

_SYNC_METHODS = {"item", "tolist", "numpy"}

_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "device"}
_STATIC_FUNCS = {"len", "isinstance", "getattr", "hasattr", "type"}


def _is_capturer(func: ast.AST) -> bool:
    return dotted_name(func) in _CAPTURERS


def _partial_of_capturer(call: ast.Call) -> bool:
    name = dotted_name(call.func)
    if name is None or name.split(".")[-1] != "partial":
        return False
    return bool(call.args) and _is_capturer(call.args[0])


class TraceHygieneChecker:
    rule = "EDL002"
    name = "trace-hygiene"
    info = RuleInfo(
        rule="EDL002",
        name="trace-hygiene",
        description=(
            "no host clocks, host RNG, host calls, device syncs or "
            "value-dependent Python branching inside a body captured once "
            "and replayed (torch.cuda.graph, torch.compile, TorchScript)"
        ),
    )

    def check(self, sf: SourceFile, ctx) -> Iterator[Finding]:
        for fn, body, params, how in self._captured_bodies(sf.tree):
            for node in body:
                yield from self._walk(sf, node, fn, how, params)

    # -- discovery -------------------------------------------------------------

    def _captured_bodies(self, tree: ast.AST):
        """Yield (name, statements, parameter names, how) per captured body."""
        defs = {}  # name -> innermost def seen (good enough per file)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs[node.name] = node

        seen: Set[int] = set()

        def mark(fn: ast.AST, how: str):
            if id(fn) not in seen:
                seen.add(id(fn))
                body = fn.body if isinstance(fn.body, list) else [fn.body]
                yield (getattr(fn, "name", "<lambda>"), body,
                       self._param_names(fn), how)

        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    if _is_capturer(dec) or (
                        isinstance(dec, ast.Call)
                        and (_is_capturer(dec.func) or _partial_of_capturer(dec))
                    ):
                        yield from mark(node, f"@{dotted_name(dec) or 'compile'}")
                for inner in ast.walk(node):
                    if isinstance(inner, (ast.With, ast.AsyncWith)) and any(
                        isinstance(item.context_expr, ast.Call)
                        and dotted_name(item.context_expr.func) in _CAPTURE_BLOCKS
                        for item in inner.items
                    ) and id(inner) not in seen:
                        seen.add(id(inner))
                        yield (node.name, inner.body, self._param_names(node),
                               "torch.cuda.graph")
            elif isinstance(node, ast.Call) and _is_capturer(node.func):
                if not node.args:
                    continue
                target = node.args[0]
                capturer = dotted_name(node.func) or "compile"
                if isinstance(target, ast.Lambda):
                    yield from mark(target, f"{capturer}(<lambda>)")
                elif isinstance(target, ast.Name) and target.id in defs:
                    yield from mark(defs[target.id], f"{capturer}({target.id})")

    @staticmethod
    def _param_names(fn: ast.AST) -> Set[str]:
        args = fn.args
        names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
        if args.vararg:
            names.append(args.vararg.arg)
        if args.kwarg:
            names.append(args.kwarg.arg)
        return {n for n in names if n != "self"}

    # -- body checks -----------------------------------------------------------

    def _walk(
        self,
        sf: SourceFile,
        node: ast.AST,
        fn_name: str,
        how: str,
        params: Set[str],
    ) -> Iterator[Finding]:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # Nested helpers are captured too; their params join the set.
            inner = params | self._param_names(node)
            for child in node.body:
                yield from self._walk(sf, child, fn_name, how, inner)
            return

        if isinstance(node, ast.Call):
            finding = self._check_call(sf, node, fn_name, how, params)
            if finding is not None:
                yield finding

        if isinstance(node, (ast.If, ast.While)):
            traced = self._traced_names_in(node.test, params)
            if traced:
                names = ", ".join(sorted(traced))
                kind = "if" if isinstance(node, ast.If) else "while"
                yield Finding(
                    rule=self.rule,
                    path=sf.relpath,
                    line=node.test.lineno,
                    col=node.test.col_offset,
                    message=(
                        f"Python `{kind}` on captured value(s) {names} inside "
                        f"{how}-captured '{fn_name}' — the replay keeps the "
                        "branch taken at capture; use torch.where or hoist "
                        "the branch out of the captured body"
                    ),
                )

        for child in ast.iter_child_nodes(node):
            yield from self._walk(sf, child, fn_name, how, params)

    def _check_call(
        self,
        sf: SourceFile,
        node: ast.Call,
        fn_name: str,
        how: str,
        params: Set[str],
    ) -> Optional[Finding]:
        name = dotted_name(node.func)

        def finding(msg: str) -> Finding:
            return Finding(
                rule=self.rule,
                path=sf.relpath,
                line=node.lineno,
                col=node.col_offset,
                message=msg + f" inside {how}-captured '{fn_name}'",
            )

        if name in _HOST_CLOCKS:
            return finding(
                f"host clock `{name}()` — its value is baked in at capture "
                "time (and never updates across replays)"
            )
        if name is not None and name.startswith(
            ("np.random.", "numpy.random.", "random.")
        ):
            return finding(
                f"host RNG `{name}()` — draws once at capture time; use "
                "torch RNG with an explicit generator"
            )
        if isinstance(node.func, ast.Name):
            if node.func.id in {"print", "input", "breakpoint"}:
                return finding(
                    f"host call `{node.func.id}(...)` — it runs at capture, "
                    "never on replay"
                )
            if node.func.id in {"float", "int", "bool"} and any(
                isinstance(a, ast.Name) and a.id in params for a in node.args
            ):
                return finding(
                    f"`{node.func.id}()` on a captured parameter forces a "
                    "blocking device sync"
                )
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _SYNC_METHODS
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id in params
        ):
            return finding(
                f"`.{node.func.attr}()` on a captured parameter forces a "
                "blocking device sync"
            )
        return None

    def _traced_names_in(self, test: ast.AST, params: Set[str]) -> Set[str]:
        """Param names used by value (not just statically) in a test expr."""
        traced: Set[str] = set()

        def visit(node: ast.AST) -> None:
            if isinstance(node, ast.Attribute):
                if node.attr in _STATIC_ATTRS:
                    return  # x.shape / x.ndim / x.dtype are static
                visit(node.value)
                return
            if isinstance(node, ast.Call):
                name = dotted_name(node.func)
                base = name.split(".")[-1] if name else ""
                if base in _STATIC_FUNCS:
                    return  # len(x), isinstance(x, T) are static
                for child in ast.iter_child_nodes(node):
                    visit(child)
                return
            if isinstance(node, ast.Name) and node.id in params:
                traced.add(node.id)
                return
            for child in ast.iter_child_nodes(node):
                visit(child)

        visit(test)
        return traced
