"""EDL006 — whole-program lockset race detection across thread roots.

EDL001 polices lock discipline *inside one class*: if the class owns a lock,
writes need it. What it cannot see is the question that actually decides
whether the runtime survives a rescale: which **threads** reach a write.
The codebase now runs a small fleet of them — the prefetch pump, the outbox
replayer, the coordinator supervisor, the MetricsServer's per-request
handler threads, registry collector callbacks, the autoscaler/updater/
collector loops — and a write is only a race if two of those roots can
reach it without a common lock.

Analysis (interprocedural, flow-insensitive inside a statement, lockset
dataflow across calls):

1. **Summarize** (per file, pool-safe): every function/method's writes to
   ``self.<attr>`` with the lexically-held locks, every resolvable call
   with the locks held at the call site, lock attribute tables (``Lock``/
   ``RLock``/``Condition``; a ``Condition(self.x)`` aliases its wrapped
   lock), and thread-root registrations: ``threading.Thread(target=...)``
   / ``Timer``, ``register_collector(fn)`` callbacks, and
   ``BaseHTTPRequestHandler`` subclasses (each ``do_*`` runs on a
   per-request server thread).
2. **Reduce** (whole program): link calls across modules via the import
   table, then run one lockset fixpoint per root (meet = set intersection,
   so a lock only counts if it is held on *every* path from that root).
   The main thread is itself a root whose entries are all public
   functions/methods.
3. A ``Class.attr`` written from >= 2 distinct roots whose write sites
   share no common lock is a finding, anchored at the least-guarded write.

Known limits (by design, to stay precise): calls through object attributes
(``self.worker.step()``), dynamic dispatch, and lock aliasing through
locals are not modeled — such edges are dropped, which can only lose
findings, never invent them. ``__init__``-time writes are exempt
(construction happens-before publication); GIL-atomic telemetry should be
``# edl: noqa[EDL006]``'d with a justification, same contract as EDL001.
"""

from __future__ import annotations

import ast
from typing import Any, Dict, FrozenSet, Iterator, List, Optional, Set, Tuple

from edl_tpu_torch.analysis.core import (
    Finding,
    RuleInfo,
    SourceFile,
    dotted_name,
    is_self_attr,
    self_attr_root,
)

LOCK_FACTORIES = {"Lock", "RLock", "Condition"}

_CONSTRUCTION = {"__init__", "__new__", "__post_init__", "__init_subclass__"}

#: call-able factories that hand their target to a fresh thread
_THREAD_FACTORIES = {"Thread", "Timer"}


def _module_of(relpath: str) -> str:
    mod = relpath[:-3] if relpath.endswith(".py") else relpath
    mod = mod.replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod


def _callable_ref(node: ast.AST) -> Optional[Tuple[str, str]]:
    """(kind, name) for a reference that may denote a function: ``self.m``
    -> ("self", "m"), bare ``f`` -> ("local", "f"), ``a.b`` -> ("dotted",
    "a.b"). None for lambdas/calls/anything dynamic."""
    attr = is_self_attr(node)
    if attr is not None:
        return ("self", attr)
    if isinstance(node, ast.Name):
        return ("local", node.id)
    dn = dotted_name(node)
    if dn is not None:
        return ("dotted", dn)
    return None


class ThreadRaceChecker:
    rule = "EDL006"
    name = "thread-races"
    scope = "program"
    info = RuleInfo(
        rule="EDL006",
        name="thread-races",
        description=(
            "attributes written from >= 2 thread roots (Thread targets, "
            "HTTP handler threads, collector callbacks, the main thread) "
            "must share a common lock on every write path"
        ),
    )

    # -- map phase -------------------------------------------------------------

    def summarize(self, sf: SourceFile, ctx) -> Dict[str, Any]:
        module = _module_of(sf.relpath)
        summary: Dict[str, Any] = {
            "module": module,
            "imports": {},
            "classes": {},
            "functions": {},
            "roots": [],
        }
        self._scan_imports(sf.tree, summary["imports"])
        module_locks = self._module_locks(sf.tree, module)

        for node in sf.tree.body:
            if isinstance(node, ast.ClassDef):
                self._scan_class(node, module, module_locks, summary)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_function(
                    node, node.name, None, {}, module_locks, summary
                )
        return summary

    @staticmethod
    def _scan_imports(tree: ast.Module, out: Dict[str, str]) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    out[alias.asname or alias.name.split(".")[0]] = alias.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    out[alias.asname or alias.name] = (
                        f"{node.module}.{alias.name}"
                    )

    @staticmethod
    def _lock_call_name(call: ast.Call) -> Optional[str]:
        func = call.func
        fname = (
            func.attr
            if isinstance(func, ast.Attribute)
            else func.id if isinstance(func, ast.Name) else None
        )
        return fname if fname in LOCK_FACTORIES else None

    def _module_locks(self, tree: ast.Module, module: str) -> Dict[str, List[str]]:
        """Module-global ``X = threading.Lock()`` -> {local name: lock ids}."""
        raw: Dict[str, Tuple[str, Optional[str]]] = {}
        for node in tree.body:
            if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)):
                continue
            fname = self._lock_call_name(node.value)
            if fname is None:
                continue
            wrapped = None
            if fname == "Condition" and node.value.args:
                arg = node.value.args[0]
                if isinstance(arg, ast.Name):
                    wrapped = arg.id
            for target in node.targets:
                if isinstance(target, ast.Name):
                    raw[target.id] = (fname, wrapped)
        out: Dict[str, List[str]] = {}
        for name, (_, wrapped) in raw.items():
            ids = [f"{module}.{name}"]
            if wrapped and wrapped in raw:
                ids.append(f"{module}.{wrapped}")
            out[name] = ids
        return out

    def _class_locks(self, cls: ast.ClassDef, module: str) -> Dict[str, List[str]]:
        """``self.X = threading.Lock()`` attrs -> lock ids; a Condition built
        over ``self.Y`` counts as holding both X and Y."""
        raw: Dict[str, Optional[str]] = {}
        for node in ast.walk(cls):
            if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)):
                continue
            fname = self._lock_call_name(node.value)
            if fname is None:
                continue
            wrapped = None
            if fname == "Condition" and node.value.args:
                wrapped = is_self_attr(node.value.args[0])
            for target in node.targets:
                attr = is_self_attr(target)
                if attr:
                    raw[attr] = wrapped
        out: Dict[str, List[str]] = {}
        for attr, wrapped in raw.items():
            ids = [f"{module}.{cls.name}.{attr}"]
            if wrapped and wrapped in raw:
                ids.append(f"{module}.{cls.name}.{wrapped}")
            out[attr] = ids
        return out

    def _scan_class(
        self,
        cls: ast.ClassDef,
        module: str,
        module_locks: Dict[str, List[str]],
        summary: Dict[str, Any],
    ) -> None:
        locks = self._class_locks(cls, module)
        methods = [
            n.name
            for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        summary["classes"][cls.name] = {
            "bases": [dotted_name(b) for b in cls.bases if dotted_name(b)],
            "locks": locks,
            "methods": methods,
        }
        for n in cls.body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_function(
                    n, f"{cls.name}.{n.name}", cls.name, locks,
                    module_locks, summary,
                )

    def _scan_function(
        self,
        fn: ast.AST,
        qual: str,
        cls_name: Optional[str],
        class_locks: Dict[str, List[str]],
        module_locks: Dict[str, List[str]],
        summary: Dict[str, Any],
    ) -> None:
        writes: List[Tuple[str, int, int, List[str]]] = []
        calls: List[Tuple[str, str, List[str], int]] = []

        def lock_ids(expr: ast.AST) -> List[str]:
            attr = is_self_attr(expr)
            if attr is not None and attr in class_locks:
                return class_locks[attr]
            if isinstance(expr, ast.Name) and expr.id in module_locks:
                return module_locks[expr.id]
            return []

        def note_root(call: ast.Call, kind: str, line: int) -> None:
            target = None
            for kw in call.keywords:
                if kw.arg == "target":
                    target = kw.value
            if target is None and kind == "collector" and call.args:
                target = call.args[0]
            if target is None and kind == "thread":
                return
            ref = _callable_ref(target) if target is not None else None
            if ref is not None:
                summary["roots"].append(
                    (kind, ref[0], ref[1], cls_name, qual, line)
                )

        def visit(node: ast.AST, held: FrozenSet[str]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # Nested function: its body runs when called, under whatever
                # the *caller* holds — record it as its own function with a
                # scoped qualname; lexical locks at the def site don't apply.
                self._scan_function(
                    node, f"{qual}.{node.name}", cls_name, class_locks,
                    module_locks, summary,
                )
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                acquired: Set[str] = set(held)
                for item in node.items:
                    acquired.update(lock_ids(item.context_expr))
                    visit(item.context_expr, held)
                for stmt in node.body:
                    visit(stmt, frozenset(acquired))
                return
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign) else [node.target]
                )
                for target in targets:
                    for t in self._flatten(target):
                        attr = self_attr_root(t)
                        if attr:
                            writes.append(
                                (attr, t.lineno, t.col_offset, sorted(held))
                            )
                value = getattr(node, "value", None)
                if value is not None:
                    visit(value, held)
                return
            if isinstance(node, ast.Delete):
                for t in node.targets:
                    attr = self_attr_root(t)
                    if attr:
                        writes.append(
                            (attr, t.lineno, t.col_offset, sorted(held))
                        )
                return
            if isinstance(node, ast.Call):
                fname = (
                    node.func.attr
                    if isinstance(node.func, ast.Attribute)
                    else node.func.id if isinstance(node.func, ast.Name) else None
                )
                if fname in _THREAD_FACTORIES:
                    note_root(node, "thread", node.lineno)
                elif fname == "register_collector":
                    note_root(node, "collector", node.lineno)
                ref = _callable_ref(node.func)
                if ref is not None:
                    calls.append((ref[0], ref[1], sorted(held), node.lineno))
                for child in ast.iter_child_nodes(node):
                    visit(child, held)
                return
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in fn.body:
            visit(stmt, frozenset())

        name = qual.rsplit(".", 1)[-1]
        public = not name.startswith("_") or (
            name.startswith("__") and name.endswith("__")
            and name not in _CONSTRUCTION
        )
        summary["functions"][qual] = {
            "cls": cls_name,
            "writes": writes,
            "calls": calls,
            "public": public,
            "construction": name in _CONSTRUCTION,
        }

    @staticmethod
    def _flatten(target: ast.AST) -> Iterator[ast.AST]:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                yield from ThreadRaceChecker._flatten(elt)
        else:
            yield target

    # -- reduce phase ----------------------------------------------------------

    def reduce(
        self, summaries: List[Tuple[str, Dict[str, Any]]], ctx
    ) -> Iterator[Finding]:
        # Global tables keyed "module:qual".
        funcs: Dict[str, Dict[str, Any]] = {}
        classes: Dict[str, Dict[str, Any]] = {}
        imports: Dict[str, Dict[str, str]] = {}
        relpath_of: Dict[str, str] = {}
        for relpath, s in summaries:
            mod = s["module"]
            relpath_of[mod] = relpath
            imports[mod] = s["imports"]
            for qual, info in s["functions"].items():
                funcs[f"{mod}:{qual}"] = info
            for cname, cinfo in s["classes"].items():
                classes[f"{mod}:{cname}"] = cinfo

        def resolve(mod: str, caller_qual: str, kind: str, name: str,
                    cls: Optional[str]) -> Optional[str]:
            if kind == "self":
                if cls is not None and f"{mod}:{cls}.{name}" in funcs:
                    return f"{mod}:{cls}.{name}"
                return None
            if kind == "local":
                # Nested function in the caller's scope wins, then the
                # enclosing class's namespace-free module scope, then imports.
                scoped = f"{mod}:{caller_qual}.{name}"
                if scoped in funcs:
                    return scoped
                if f"{mod}:{name}" in funcs:
                    return f"{mod}:{name}"
                target = imports.get(mod, {}).get(name)
                if target and ":" not in target:
                    head, _, sym = target.rpartition(".")
                    if head and f"{head}:{sym}" in funcs:
                        return f"{head}:{sym}"
                return None
            # dotted: resolve the head through imports -> module function.
            head, _, rest = name.partition(".")
            target_mod = imports.get(mod, {}).get(head)
            if target_mod and rest and f"{target_mod}:{rest}" in funcs:
                return f"{target_mod}:{rest}"
            return None

        # Thread roots: (label, entry fkeys)
        roots: List[Tuple[str, List[str]]] = []
        for relpath, s in summaries:
            mod = s["module"]
            for kind, rkind, rname, cls, in_qual, _line in s["roots"]:
                fkey = resolve(mod, in_qual, rkind, rname, cls)
                if fkey is None:
                    continue
                label = {
                    "thread": "Thread",
                    "collector": "collector-callback",
                }.get(kind, kind)
                roots.append((f"{label}({fkey.split(':', 1)[1]})", [fkey]))
            # HTTP handler classes: each do_* method runs on a per-request
            # server thread (ThreadingHTTPServer), so each is a root.
            for cname, cinfo in s["classes"].items():
                if not self._is_http_handler(mod, cname, classes, imports):
                    continue
                for m in cinfo["methods"]:
                    if m.startswith("do_"):
                        roots.append(
                            (f"http-handler({cname}.{m})", [f"{mod}:{cname}.{m}"])
                        )

        # The main thread is a root too: every public function/method —
        # except functions that ARE a thread root's entry (a public loop like
        # run_forever is either called inline on the main thread or handed to
        # Thread(), never both; main can still reach it through a real call
        # edge, which the propagation models).
        threaded_entries = {fkey for _label, entries in roots for fkey in entries}
        main_entries = [
            fkey for fkey, info in funcs.items()
            if info["public"]
            and not info["construction"]
            and fkey not in threaded_entries
        ]
        roots.append(("main", main_entries))

        # Dedup root labels (two Thread() sites on one target are one root).
        merged: Dict[str, Set[str]] = {}
        for label, entries in roots:
            merged.setdefault(label, set()).update(entries)

        all_locks: FrozenSet[str] = frozenset(
            lid
            for cinfo in classes.values()
            for ids in cinfo["locks"].values()
            for lid in ids
        ) | frozenset(
            lid
            for _relpath, s in summaries
            for info in s["functions"].values()
            for _a, _l, _c, held in info["writes"]
            for lid in held
        )

        # attr key -> {root label -> guard-set intersection}, and write sites.
        attr_guards: Dict[str, Dict[str, FrozenSet[str]]] = {}
        attr_sites: Dict[str, List[Tuple[str, int, int, int]]] = {}

        for label in sorted(merged):
            entry_locks = self._fixpoint(
                funcs, merged[label], all_locks,
                lambda mod, q, k, n, c: resolve(mod, q, k, n, c),
            )
            for fkey, held_at_entry in entry_locks.items():
                info = funcs[fkey]
                if info["construction"]:
                    continue
                mod, qual = fkey.split(":", 1)
                cls = info["cls"]
                if cls is None:
                    continue  # only self-attribute state is modeled
                cinfo = classes.get(f"{mod}:{cls}", {})
                lock_attrs = set(cinfo.get("locks", {}))
                for attr, line, col, lex in info["writes"]:
                    if attr in lock_attrs:
                        continue
                    akey = f"{mod}:{cls}.{attr}"
                    eff = held_at_entry | frozenset(lex)
                    guards = attr_guards.setdefault(akey, {})
                    guards[label] = guards.get(label, all_locks) & eff
                    attr_sites.setdefault(akey, []).append(
                        (relpath_of[mod], line, col, len(eff))
                    )

        for akey in sorted(attr_guards):
            guards = attr_guards[akey]
            if len(guards) < 2:
                continue
            common = all_locks
            for g in guards.values():
                common &= g
            if common:
                continue
            _mod, cls_attr = akey.split(":", 1)
            root_list = ", ".join(sorted(guards))
            # Anchor at the least-guarded (then earliest) write site.
            path, line, col, _n = min(
                attr_sites[akey], key=lambda s: (s[3], s[1], s[2])
            )
            yield Finding(
                rule=self.rule,
                path=path,
                line=line,
                col=col,
                message=(
                    f"'{cls_attr}' is written from {len(guards)} thread "
                    f"roots ({root_list}) with no common lock"
                ),
            )

    @staticmethod
    def _is_http_handler(
        mod: str,
        cname: str,
        classes: Dict[str, Dict[str, Any]],
        imports: Dict[str, Dict[str, str]],
        _depth: int = 0,
    ) -> bool:
        if _depth > 8:
            return False
        cinfo = classes.get(f"{mod}:{cname}")
        if cinfo is None:
            return False
        for base in cinfo["bases"]:
            if base.rsplit(".", 1)[-1] == "BaseHTTPRequestHandler":
                return True
            # Base defined in this module, or imported from another.
            if ThreadRaceChecker._is_http_handler(
                mod, base, classes, imports, _depth + 1
            ):
                return True
            target = imports.get(mod, {}).get(base)
            if target:
                bmod, _, bcls = target.rpartition(".")
                if bmod and ThreadRaceChecker._is_http_handler(
                    bmod, bcls, classes, imports, _depth + 1
                ):
                    return True
        return False

    @staticmethod
    def _fixpoint(
        funcs: Dict[str, Dict[str, Any]],
        entries: Set[str],
        all_locks: FrozenSet[str],
        resolve,
    ) -> Dict[str, FrozenSet[str]]:
        """Per-root dataflow: fkey -> locks held on EVERY path from the root
        to that function's entry (meet = intersection). Only reachable
        functions appear in the result."""
        state: Dict[str, FrozenSet[str]] = {
            e: frozenset() for e in entries if e in funcs
        }
        work = list(state)
        while work:
            fkey = work.pop()
            info = funcs[fkey]
            held = state[fkey]
            mod, qual = fkey.split(":", 1)
            for kind, name, lex, _line in info["calls"]:
                callee = resolve(mod, qual, kind, name, info["cls"])
                if callee is None or callee not in funcs:
                    continue
                at_call = held | frozenset(lex)
                prev = state.get(callee)
                new = at_call if prev is None else (prev & at_call)
                if prev is None or new != prev:
                    state[callee] = new
                    work.append(callee)
        return state
