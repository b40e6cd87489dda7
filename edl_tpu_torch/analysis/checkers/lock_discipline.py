"""EDL001 — lock-discipline for classes that own a threading lock.

The elastic control plane (coordinator, job store, controller) is a set of
classes that own a ``threading.Lock``/``RLock``/``Condition`` and are hit
concurrently by handler threads, informer threads, and the autoscaler loop.
The invariant: every write to shared ``self`` state must happen while the
class's lock is held. A write that races a rescale corrupts membership or
job state silently — exactly the bug class generic linters cannot see.

Analysis (class-local, flow-insensitive but call-graph-aware):

1. A class "owns a lock" if any method assigns ``self.X = threading.Lock()``
   (or RLock/Condition). A ``Condition`` wraps the lock, so holding either
   counts as holding the guard.
2. Per method, record every write to ``self.<attr>`` (plain, augmented,
   subscript — mutating ``self._cache[k]`` is a write to ``_cache``) along
   with whether it is lexically inside ``with self.<lock>``.
3. Compute which methods can run WITHOUT the lock: public methods are entry
   points; a private method joins the set when a lock-free-reachable method
   calls it outside a ``with self.<lock>`` block, or when it escapes as a
   callback (``threading.Thread(target=self._run)``).
4. Unguarded writes in lock-free-reachable methods are violations.
   ``__init__`` is exempt (construction happens-before publication).

Known limits (by design, to stay precise): aliasing the lock through a
local, releasing via ``acquire``/``release`` pairs, and cross-class locking
are not modeled — use ``# edl: noqa[EDL001]`` with a justification there.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Set, Tuple

from edl_tpu_torch.analysis.core import (
    Finding,
    RuleInfo,
    SourceFile,
    is_self_attr,
    self_attr_root,
)

LOCK_FACTORIES = {"Lock", "RLock", "Condition"}

#: Dunders that run before the object is shared (or are init-adjacent).
_CONSTRUCTION = {"__init__", "__new__", "__post_init__", "__init_subclass__"}


@dataclass
class _MethodScan:
    #: (attr, node, locked) for writes to self state
    writes: List[Tuple[str, ast.AST, bool]] = field(default_factory=list)
    #: (callee, locked) for self.method(...) calls
    calls: List[Tuple[str, bool]] = field(default_factory=list)
    #: method names referenced without being called (escaping callbacks)
    escapes: Set[str] = field(default_factory=set)


class LockDisciplineChecker:
    rule = "EDL001"
    name = "lock-discipline"
    info = RuleInfo(
        rule="EDL001",
        name="lock-discipline",
        description=(
            "attributes of a class that owns a threading.Lock/RLock/"
            "Condition must only be written under `with self.<lock>`"
        ),
    )

    def check(self, sf: SourceFile, ctx) -> Iterator[Finding]:
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                yield from self._check_class(sf, node)

    # -- per class -------------------------------------------------------------

    def _check_class(self, sf: SourceFile, cls: ast.ClassDef) -> Iterator[Finding]:
        methods: Dict[str, ast.FunctionDef] = {
            n.name: n
            for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        lock_attrs = self._lock_attrs(methods.values())
        if not lock_attrs:
            return

        scans = {
            name: self._scan_method(fn, lock_attrs)
            for name, fn in methods.items()
        }

        unlocked = self._reachable_unlocked(methods, scans)
        guard = "/".join(sorted(lock_attrs))
        for name in sorted(unlocked):
            if name in _CONSTRUCTION:
                continue
            for attr, node, locked in scans[name].writes:
                if locked or attr in lock_attrs:
                    continue
                yield Finding(
                    rule=self.rule,
                    path=sf.relpath,
                    line=node.lineno,
                    col=node.col_offset,
                    message=(
                        f"'{cls.name}.{name}' writes 'self.{attr}' without "
                        f"holding 'self.{guard}' ({cls.name} owns a "
                        "threading lock)"
                    ),
                )

    @staticmethod
    def _lock_attrs(methods) -> Set[str]:
        attrs: Set[str] = set()
        for fn in methods:
            for node in ast.walk(fn):
                if not (
                    isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                ):
                    continue
                func = node.value.func
                fname = (
                    func.attr
                    if isinstance(func, ast.Attribute)
                    else func.id if isinstance(func, ast.Name) else None
                )
                if fname in LOCK_FACTORIES:
                    for target in node.targets:
                        attr = is_self_attr(target)
                        if attr:
                            attrs.add(attr)
        return attrs

    # -- per method ------------------------------------------------------------

    def _scan_method(self, fn: ast.AST, lock_attrs: Set[str]) -> _MethodScan:
        scan = _MethodScan()
        #: Attribute nodes that are the func of a Call (so not escapes)
        call_funcs: Set[int] = set()

        def is_lock_item(expr: ast.AST) -> bool:
            attr = is_self_attr(expr)
            return attr is not None and attr in lock_attrs

        def visit(node: ast.AST, locked: bool) -> None:
            if isinstance(node, (ast.With, ast.AsyncWith)):
                now_locked = locked or any(
                    is_lock_item(item.context_expr) for item in node.items
                )
                for item in node.items:
                    visit(item.context_expr, locked)
                for stmt in node.body:
                    visit(stmt, now_locked)
                return
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for target in targets:
                    for t in self._flatten_targets(target):
                        attr = self_attr_root(t)
                        if attr:
                            scan.writes.append((attr, node, locked))
                value = getattr(node, "value", None)
                if value is not None:
                    visit(value, locked)
                return
            if isinstance(node, ast.Delete):
                for t in node.targets:
                    attr = self_attr_root(t)
                    if attr:
                        scan.writes.append((attr, node, locked))
                return
            if isinstance(node, ast.Call):
                attr = is_self_attr(node.func)
                if attr is not None:
                    call_funcs.add(id(node.func))
                    scan.calls.append((attr, locked))
                for child in ast.iter_child_nodes(node):
                    visit(child, locked)
                return
            if isinstance(node, ast.Attribute):
                attr = is_self_attr(node)
                if attr is not None and id(node) not in call_funcs:
                    scan.escapes.add(attr)
                for child in ast.iter_child_nodes(node):
                    visit(child, locked)
                return
            for child in ast.iter_child_nodes(node):
                visit(child, locked)

        for stmt in fn.body:
            visit(stmt, False)
        return scan

    @staticmethod
    def _flatten_targets(target: ast.AST) -> Iterator[ast.AST]:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                yield from LockDisciplineChecker._flatten_targets(elt)
        else:
            yield target

    # -- reachability ----------------------------------------------------------

    @staticmethod
    def _reachable_unlocked(
        methods: Dict[str, ast.FunctionDef], scans: Dict[str, _MethodScan]
    ) -> Set[str]:
        def is_entry(name: str) -> bool:
            if name in _CONSTRUCTION:
                return False
            if not name.startswith("_"):
                return True
            # Public dunders (__enter__, __call__, ...) are entry points too.
            return name.startswith("__") and name.endswith("__")

        unlocked = {n for n in methods if is_entry(n)}
        # Methods that escape as callbacks run on foreign threads, lock-free.
        for scan in scans.values():
            unlocked |= {m for m in scan.escapes if m in methods}
        changed = True
        while changed:
            changed = False
            for name in list(unlocked):
                for callee, locked in scans[name].calls:
                    if not locked and callee in methods and callee not in unlocked:
                        unlocked.add(callee)
                        changed = True
        return unlocked
