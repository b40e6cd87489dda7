"""EDL004 — no blocking calls while holding a service lock.

Coordinator handlers (and every informer/store callback) serialize on the
class lock. A ``time.sleep`` or subprocess/socket round-trip executed
inside ``with self._lock`` parks every other handler — heartbeats miss,
leases expire, and a 50 ms backoff becomes a cluster-wide stall. The fix is
always the same: sleep outside the lock, or use ``Condition.wait`` (which
releases the lock while parked, and is therefore allowed).

Detection: lexically inside a ``with`` on a lock-like guard — an attribute
the class assigned from ``threading.Lock/RLock/Condition`` (same discovery
as EDL001), or any name matching ``*lock*``/``*cv*``/``*cond*``/``*mutex*``
— flag calls to ``time.sleep``, ``subprocess.run/call/check_call/
check_output/Popen``, ``os.system``, ``select.select``, and socket
``accept/recv/recvfrom/connect/sendall`` methods.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Optional, Set

from edl_tpu_torch.analysis.core import (
    Finding,
    RuleInfo,
    SourceFile,
    dotted_name,
    is_self_attr,
)
from edl_tpu_torch.analysis.checkers.lock_discipline import LOCK_FACTORIES

_BLOCKING_DOTTED = {
    "time.sleep",
    "subprocess.run",
    "subprocess.call",
    "subprocess.check_call",
    "subprocess.check_output",
    "subprocess.Popen",
    "os.system",
    "select.select",
}

_BLOCKING_SOCKET_METHODS = {"accept", "recv", "recvfrom", "connect", "sendall"}

_LOCKISH_NAME = re.compile(r"(?:^|_)(?:lock|cv|cond|mutex)", re.IGNORECASE)


class BlockingInLockChecker:
    rule = "EDL004"
    name = "blocking-in-event-loop"
    info = RuleInfo(
        rule="EDL004",
        name="blocking-in-event-loop",
        description=(
            "no time.sleep / subprocess / blocking socket calls while "
            "holding a lock — coordinator handler paths serialize on it"
        ),
    )

    def check(self, sf: SourceFile, ctx) -> Iterator[Finding]:
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                lock_attrs = self._class_lock_attrs(node)
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        yield from self._scan(sf, item, lock_attrs, None)
        # Module-level functions can hold module-level locks too.
        for node in sf.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._scan(sf, node, set(), None)

    @staticmethod
    def _class_lock_attrs(cls: ast.ClassDef) -> Set[str]:
        attrs: Set[str] = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
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

    def _guard_name(self, expr: ast.AST, lock_attrs: Set[str]) -> Optional[str]:
        attr = is_self_attr(expr)
        if attr is not None:
            if attr in lock_attrs or _LOCKISH_NAME.search(attr):
                return f"self.{attr}"
            return None
        if isinstance(expr, ast.Name) and _LOCKISH_NAME.search(expr.id):
            return expr.id
        return None

    def _scan(
        self,
        sf: SourceFile,
        node: ast.AST,
        lock_attrs: Set[str],
        held: Optional[str],
    ) -> Iterator[Finding]:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            guard = held
            for item in node.items:
                g = self._guard_name(item.context_expr, lock_attrs)
                if g is not None:
                    guard = g
            for stmt in node.body:
                yield from self._scan(sf, stmt, lock_attrs, guard)
            return

        if isinstance(node, ast.Call) and held is not None:
            finding = self._blocking_call(sf, node, held)
            if finding is not None:
                yield finding

        for child in ast.iter_child_nodes(node):
            yield from self._scan(sf, child, lock_attrs, held)

    def _blocking_call(
        self, sf: SourceFile, node: ast.Call, held: str
    ) -> Optional[Finding]:
        name = dotted_name(node.func)

        def finding(what: str) -> Finding:
            return Finding(
                rule=self.rule,
                path=sf.relpath,
                line=node.lineno,
                col=node.col_offset,
                message=(
                    f"blocking call {what} while holding '{held}' — every "
                    "other handler serialized on that lock stalls; move it "
                    "outside the lock or use Condition.wait"
                ),
            )

        if name in _BLOCKING_DOTTED:
            return finding(f"`{name}(...)`")
        if isinstance(node.func, ast.Attribute):
            method = node.func.attr
            base = dotted_name(node.func.value) or ""
            if method in _BLOCKING_SOCKET_METHODS and re.search(
                r"(?:^|[._])(sock|socket|conn|client)", base, re.IGNORECASE
            ):
                return finding(f"`{base}.{method}(...)`")
        return None
