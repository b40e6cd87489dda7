"""Core types for the analysis engine: findings, parsed files, suppression.

A ``SourceFile`` is one parsed Python file plus the derived indexes every
checker needs: raw lines (for ``# edl: noqa`` scanning) and a line->symbol
interval map (so findings carry a stable ``Class.method`` symbol instead of
a line number in their identity — see ``baseline.fingerprint``).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

#: ``# edl: noqa`` suppresses every rule on its line; ``# edl: noqa[EDL001]``
#: (comma-separated for several) suppresses just those. Anything after the
#: bracket is the human justification — encouraged, not parsed.
_NOQA_RE = re.compile(
    r"#\s*edl:\s*noqa(?:\[\s*([A-Za-z0-9_,\s]+?)\s*\])?", re.IGNORECASE
)


@dataclass(frozen=True)
class Finding:
    """One rule violation at a specific site."""

    rule: str  # "EDL001"
    path: str  # repo-relative posix path
    line: int  # 1-based
    col: int  # 0-based
    message: str  # stable text: no line numbers, no volatile state
    symbol: str = ""  # innermost enclosing "Class.method" (or "" at module level)

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col + 1}"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "symbol": self.symbol,
        }


class SourceFile:
    """A parsed source file with the indexes checkers share."""

    def __init__(self, path: str, relpath: str, text: str):
        self.path = path
        self.relpath = relpath.replace("\\", "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        self._noqa: Optional[Dict[int, Optional[Set[str]]]] = None
        self._symbols: Optional[List[Tuple[int, int, str]]] = None

    # -- suppression -----------------------------------------------------------

    @property
    def noqa(self) -> Dict[int, Optional[Set[str]]]:
        """line -> None (blanket) or set of uppercased rule ids."""
        if self._noqa is None:
            table: Dict[int, Optional[Set[str]]] = {}
            for i, line in enumerate(self.lines, start=1):
                if "edl" not in line:  # cheap pre-filter
                    continue
                m = _NOQA_RE.search(line)
                if not m:
                    continue
                if m.group(1) is None:
                    table[i] = None
                else:
                    rules = {
                        r.strip().upper()
                        for r in m.group(1).split(",")
                        if r.strip()
                    }
                    # Merge with an earlier marker on the same line.
                    prev = table.get(i, set())
                    table[i] = None if prev is None else (prev | rules)
            self._noqa = table
        return self._noqa

    def is_suppressed(self, finding: Finding) -> bool:
        if finding.line not in self.noqa:
            return False
        rules = self.noqa[finding.line]
        return rules is None or finding.rule.upper() in rules

    # -- symbols ---------------------------------------------------------------

    @property
    def symbols(self) -> List[Tuple[int, int, str]]:
        """(start, end, qualname) for every def/class, outermost first."""
        if self._symbols is None:
            out: List[Tuple[int, int, str]] = []

            def visit(node: ast.AST, prefix: str) -> None:
                for child in ast.iter_child_nodes(node):
                    if isinstance(
                        child,
                        (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
                    ):
                        qual = f"{prefix}.{child.name}" if prefix else child.name
                        out.append(
                            (child.lineno, child.end_lineno or child.lineno, qual)
                        )
                        visit(child, qual)
                    else:
                        visit(child, prefix)

            visit(self.tree, "")
            self._symbols = out
        return self._symbols

    def symbol_at(self, line: int) -> str:
        """Innermost def/class enclosing ``line`` ("" at module level)."""
        best = ""
        best_span = None
        for start, end, qual in self.symbols:
            if start <= line <= end:
                span = end - start
                if best_span is None or span <= best_span:
                    best, best_span = qual, span
        return best


# -- shared AST helpers --------------------------------------------------------


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain; None for anything dynamic."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def is_self_attr(node: ast.AST) -> Optional[str]:
    """Attribute name if ``node`` is ``self.<attr>``, else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def self_attr_root(node: ast.AST) -> Optional[str]:
    """Root attribute for writes through ``self``: ``self.a`` -> "a",
    ``self.a[k]`` -> "a", ``self.a[k].b`` -> "a" (mutation of shared
    containers counts as a write to the owning attribute)."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        attr = is_self_attr(node)
        if attr is not None:
            return attr
        node = node.value
    return None


@dataclass
class RuleInfo:
    """Static metadata for --list-rules and the docs."""

    rule: str
    name: str
    description: str
    example: str = field(default="", repr=False)
