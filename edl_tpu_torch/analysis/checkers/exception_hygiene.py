"""EDL005 — broad exception handlers must re-raise, log, or justify.

An elastic system's whole job is surviving failures — which makes silent
``except Exception: pass`` the most dangerous line in the codebase: a
swallowed checkpoint error or coordinator transport failure turns a clean
rescale into silent data loss. Broad handlers are allowed, but only when
the failure leaves a trace:

- the handler re-raises (``raise`` / raise-from), or
- the handler calls a logging method (``log.exception``, ``log.warning``,
  ``warnings.warn``, ...), or
- the ``except`` line carries ``# edl: noqa[EDL005] <why swallowing is
  correct here>``.

Flagged: ``except:``, ``except Exception:``, ``except BaseException:``
(bare or inside a tuple) whose body does none of the above.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from edl_tpu_torch.analysis.core import Finding, RuleInfo, SourceFile, dotted_name

_BROAD = {"Exception", "BaseException"}

_LOGGING_METHODS = {
    "exception",
    "warning",
    "warn",
    "error",
    "critical",
    "info",
    "debug",
    "log",
}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True  # bare except
    types = (
        handler.type.elts
        if isinstance(handler.type, ast.Tuple)
        else [handler.type]
    )
    for t in types:
        name = dotted_name(t)
        if name and name.split(".")[-1] in _BROAD:
            return True
    return False


#: Helper functions that report by convention (``self._warn_unreachable``,
#: ``_log_failure``) count as leaving a trace — the handler delegates the
#: reporting, it does not swallow.
_REPORTING_NAME = re.compile(r"warn|log|report|print_exc", re.IGNORECASE)


def _leaves_a_trace(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute) and func.attr in _LOGGING_METHODS:
                return True
            name = dotted_name(func)
            base = name.split(".")[-1] if name else ""
            if _REPORTING_NAME.search(base):
                return True
    return False


class ExceptionHygieneChecker:
    rule = "EDL005"
    name = "exception-hygiene"
    info = RuleInfo(
        rule="EDL005",
        name="exception-hygiene",
        description=(
            "bare/broad `except` must re-raise, log the failure, or carry "
            "an explicit `# edl: noqa[EDL005]` justification"
        ),
    )

    def check(self, sf: SourceFile, ctx) -> Iterator[Finding]:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_broad(node) or _leaves_a_trace(node):
                continue
            caught = (
                "bare except"
                if node.type is None
                else f"except {ast.unparse(node.type)}"
            )
            yield Finding(
                rule=self.rule,
                path=sf.relpath,
                line=node.lineno,
                col=node.col_offset,
                message=(
                    f"`{caught}` swallows the failure silently in "
                    f"'{sf.symbol_at(node.lineno) or '<module>'}' — "
                    "re-raise, log it, or justify with "
                    "`# edl: noqa[EDL005] <reason>`"
                ),
            )
