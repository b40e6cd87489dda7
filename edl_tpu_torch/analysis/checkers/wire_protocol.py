"""EDL007 — wire-protocol conformance across the three coordinator
implementations.

The control-plane protocol (newline-delimited JSON over TCP) exists three
times: the C++ server's dispatch table (`native/coordinator/coordinator.cc`),
the wire client (`edl_tpu_torch/coordinator/client.py`), and the hermetic twin
(`edl_tpu_torch/coordinator/inprocess.py`). Nothing at runtime checks they agree —
a field added to one and not the others only surfaces as a recovery-path
hang weeks later. This pass makes the protocol a *checked artifact*:

1. **Native extraction** (regex over the .cc, no compiler needed): every
   ``if (op == "...")`` arm of the dispatch table, each handler's request
   fields (``get_str(req, ...)`` / ``get_num(req, ...)`` / ``req.find``) and
   reply fields (``.field(...)`` / ``.field_null(...)``), expanding helpers
   reached via ``return helper(...)`` (``membership_reply``) and — for
   fd-taking handlers — helpers that write parked/deferred replies
   (``release_sync``). ``handle()``'s ``stamp_epoch`` adds the implicit
   ``epoch`` to every non-deferred reply; deferred replies must carry it
   explicitly or that is a finding.
2. **Schema ratchet:** the extracted schema is diffed against the committed
   ``protocol_schema.json``. Any drift (op added/removed, field change,
   stamping change) is a finding until the artifact is regenerated with
   ``--write-protocol`` — so the schema diff shows up in review, like the
   baseline.
3. **Python conformance:** every literal ``client.call("op", field=...)``
   site must name a dispatch-table op and send only fields the server
   reads (plus the ``worker``/``token`` envelope); ``InProcessClient.call``
   must cover exactly the native op set and each branch's reply-dict keys
   must equal the native reply fields (resolving ``self._c.method()``
   delegation, ``_note_reply`` pass-through, and ``_stamp`` epoch
   injection).

Config overrides (all relative to the analysis root) exist so fixtures can
exercise the rule on a toy .cc/.py pair: ``edl007_native_source``,
``edl007_schema``, ``edl007_prefixes``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Iterator, List, Optional, Sequence, Set, Tuple

import ast

from edl_tpu_torch.analysis.core import Finding, RuleInfo, SourceFile

DEFAULT_NATIVE_SOURCE = "native/coordinator/coordinator.cc"
DEFAULT_SCHEMA_NAME = "protocol_schema.json"
#: python files whose .call(...) sites / shim classes speak the protocol
DEFAULT_PREFIXES = ("edl_tpu_torch/coordinator/", "edl_tpu_torch/cli.py")

#: fields every request may carry regardless of op: the client's envelope
ENVELOPE_REQUEST = ("op", "token", "worker")

#: ops the server refuses inside a batch frame (they park the connection,
#: nest framing, or — watch — bind an out-of-band push stream to the fd)
NON_BATCHABLE = ("batch", "barrier", "sync", "watch")

SCHEMA_VERSION = 1

_OP_ARM_RE = re.compile(r'if \(op == "(\w+)"\)')
_MEMBER_RE = re.compile(
    r"^[A-Za-z_][\w:<>,&* ]*\bCoordinator::(\w+)\s*\(([^)]*)\)", re.M
)
_HANDLER_CALL_RE = re.compile(r"\b(op_\w+)\s*\(")
_REQ_FIELD_RE = re.compile(
    r'(?:get_str|get_num)\(req,\s*"(\w+)"|req\.find\("(\w+)"\)'
)
_REPLY_FIELD_RE = re.compile(r'\.field(?:_null)?\("(\w+)"')
_RETURN_HELPER_RE = re.compile(r"return (\w+)\(")
_CALLED_MEMBER_RE = re.compile(r"\b(\w+)\s*\(")


def _strip_comments(cc_text: str) -> str:
    """Drop // and /* */ comments (quote-aware for //): a comment that
    mentions ``deferred_`` or ``.field("x")`` must not count as code."""
    cc_text = re.sub(r"/\*.*?\*/", " ", cc_text, flags=re.S)
    out_lines = []
    for line in cc_text.split("\n"):
        in_str = False
        i = 0
        while i < len(line) - 1:
            ch = line[i]
            if ch == '"' and (i == 0 or line[i - 1] != "\\"):
                in_str = not in_str
            elif not in_str and ch == "/" and line[i + 1] == "/":
                line = line[:i]
                break
            i += 1
        out_lines.append(line)
    return "\n".join(out_lines)


def extract_native_schema(cc_text: str, source_relpath: str) -> Dict[str, Any]:
    """Parse the dispatch table + handlers out of coordinator.cc text into
    the ``protocol_schema.json`` shape. Pure function of the source text, so
    both the checker and ``--write-protocol`` produce identical artifacts."""
    cc_text = _strip_comments(cc_text)
    # Member-function spans: text between successive `... Coordinator::name(`.
    matches = list(_MEMBER_RE.finditer(cc_text))
    spans: Dict[str, str] = {}
    params: Dict[str, str] = {}
    for i, m in enumerate(matches):
        end = matches[i + 1].start() if i + 1 < len(matches) else len(cc_text)
        # First definition wins (declarations inside the class body are not
        # matched — they lack the Coordinator:: prefix).
        spans.setdefault(m.group(1), cc_text[m.start():end])
        params.setdefault(m.group(1), m.group(2))

    stamped = "stamp_epoch(dispatch" in cc_text

    def helper_reply(name: str, seen: Set[str]) -> Set[str]:
        if name in seen or name not in spans:
            return set()
        seen.add(name)
        body = spans[name]
        out = set(_REPLY_FIELD_RE.findall(body))
        for ret in _RETURN_HELPER_RE.findall(body):
            out |= helper_reply(ret, seen)
        return out

    ops: Dict[str, Dict[str, Any]] = {}
    arms = list(_OP_ARM_RE.finditer(cc_text))
    for i, arm in enumerate(arms):
        op = arm.group(1)
        if op in ops:
            continue  # batch appears in handle() AND as a sub-op guard
        nxt = arms[i + 1].start() if i + 1 < len(arms) else len(cc_text)
        chunk = cc_text[arm.end():min(nxt, arm.end() + 600)]
        handler = _HANDLER_CALL_RE.search(chunk)
        request: Set[str] = set()
        reply: Set[str] = set()
        deferred = False
        if handler and handler.group(1) in spans:
            hname = handler.group(1)
            body = spans[hname]
            for a, b in _REQ_FIELD_RE.findall(body):
                request.add(a or b)
            reply |= set(_REPLY_FIELD_RE.findall(body))
            for ret in _RETURN_HELPER_RE.findall(body):
                reply |= helper_reply(ret, {hname})
            takes_fd = "int fd" in params.get(hname, "")
            if takes_fd:
                # A parked connection's eventual reply may be written by a
                # helper into the deferred queue (sync -> release_sync).
                for callee in set(_CALLED_MEMBER_RE.findall(body)):
                    if callee != hname and "deferred_" in spans.get(callee, ""):
                        deferred = True
                        reply |= helper_reply(callee, {hname})
                if "deferred_" in body:
                    deferred = True
        else:
            # Inline arm (ping): fields from the single return statement.
            stmt = chunk.split(";", 1)[0]
            reply |= set(_REPLY_FIELD_RE.findall(stmt))
        ops[op] = {
            "request": sorted(request),
            "reply": sorted(reply),  # effective epoch added below
            "deferred": deferred,
            "batchable": op not in NON_BATCHABLE,
        }

    # Deferred replies bypass handle()'s stamp — they must carry epoch in
    # their own fields. Record the raw miss before normalizing.
    unstamped_deferred = sorted(
        op for op, spec in ops.items()
        if spec["deferred"] and "epoch" not in spec["reply"]
    )
    if stamped:
        for spec in ops.values():
            if "epoch" not in spec["reply"]:
                spec["reply"] = sorted(spec["reply"] + ["epoch"])

    return {
        "version": SCHEMA_VERSION,
        "source": source_relpath,
        "epoch_stamped": stamped,
        "unstamped_deferred_ops": unstamped_deferred,
        "envelope": {"request": sorted(ENVELOPE_REQUEST)},
        "ops": {op: ops[op] for op in sorted(ops)},
    }


def load_native_schema(
    root: str, config: Dict[str, Any]
) -> Tuple[Optional[Dict[str, Any]], str]:
    """(extracted schema or None, native source relpath)."""
    rel = config.get("edl007_native_source", DEFAULT_NATIVE_SOURCE)
    path = os.path.join(root, rel)
    try:
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
    except OSError:
        return None, rel
    return extract_native_schema(text, rel), rel


class WireProtocolChecker:
    rule = "EDL007"
    name = "wire-protocol"
    scope = "program"
    info = RuleInfo(
        rule="EDL007",
        name="wire-protocol",
        description=(
            "the C++ dispatch table, the wire client's call() sites, the "
            "in-process twin, and the committed protocol_schema.json must "
            "agree on ops, request/reply fields, and epoch stamping"
        ),
    )

    # -- map phase -------------------------------------------------------------

    def summarize(self, sf: SourceFile, ctx) -> Optional[Dict[str, Any]]:
        prefixes = tuple(ctx.config.get("edl007_prefixes", DEFAULT_PREFIXES))
        if not any(
            sf.relpath == p or sf.relpath.startswith(p) for p in prefixes
        ):
            return None
        out: Dict[str, Any] = {"call_sites": [], "shim": None}
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call):
                site = self._call_site(node)
                if site is not None:
                    out["call_sites"].append(site)
            elif (
                isinstance(node, ast.ClassDef)
                and node.name == "InProcessClient"
            ):
                out["shim"] = self._scan_shim(sf.tree, node)
        if not out["call_sites"] and out["shim"] is None:
            return None
        return out

    @staticmethod
    def _call_site(node: ast.Call):
        """('op', sorted field kwargs, line, col) for ``<x>.call("op", ...)``
        with a literal op name; None otherwise."""
        func = node.func
        if not (isinstance(func, ast.Attribute) and func.attr == "call"):
            return None
        if not (
            node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            return None
        fields = sorted(
            kw.arg for kw in node.keywords
            if kw.arg is not None and kw.arg != "timeout"
        )
        return (node.args[0].value, fields, node.lineno, node.col_offset)

    def _scan_shim(
        self, tree: ast.Module, shim_cls: ast.ClassDef
    ) -> Dict[str, Any]:
        """Per-op reply-key sets for ``InProcessClient.call``, resolving
        delegation into the coordinator class in the same module."""
        coord_keys = self._coordinator_reply_keys(tree)

        call_fn = next(
            (
                n for n in shim_cls.body
                if isinstance(n, ast.FunctionDef) and n.name == "call"
            ),
            None,
        )
        shim: Dict[str, Any] = {
            "line": shim_cls.lineno,
            "call_line": call_fn.lineno if call_fn else shim_cls.lineno,
            "ops": {},
        }
        if call_fn is None:
            return shim

        def branch_ops(test: ast.AST) -> List[str]:
            # `op == "x"` or `op in ("x", "y")`
            if not (
                isinstance(test, ast.Compare)
                and isinstance(test.left, ast.Name)
                and test.left.id == "op"
                and len(test.comparators) == 1
            ):
                return []
            cmp = test.comparators[0]
            if isinstance(test.ops[0], ast.Eq) and isinstance(cmp, ast.Constant):
                return [cmp.value]
            if isinstance(test.ops[0], ast.In) and isinstance(
                cmp, (ast.Tuple, ast.List)
            ):
                return [
                    e.value for e in cmp.elts
                    if isinstance(e, ast.Constant) and isinstance(e.value, str)
                ]
            return []

        for node in ast.walk(call_fn):
            if not isinstance(node, ast.If):
                continue
            ops = branch_ops(node.test)
            if not ops:
                continue
            keys: Set[str] = set()
            for sub in node.body:
                for ret in ast.walk(sub):
                    if isinstance(ret, ast.Return) and ret.value is not None:
                        keys |= self._reply_keys(ret.value, coord_keys)
            for op in ops:
                spec = shim["ops"].setdefault(
                    op, {"keys": set(), "line": node.lineno}
                )
                spec["keys"] |= keys
        for spec in shim["ops"].values():
            spec["keys"] = sorted(spec["keys"])
        return shim

    def _coordinator_reply_keys(self, tree: ast.Module) -> Dict[str, Set[str]]:
        """InProcessCoordinator method -> union of returned dict keys, with
        intra-class ``return self.helper(...)`` expansion to a fixpoint."""
        coord = next(
            (
                n for n in tree.body
                if isinstance(n, ast.ClassDef)
                and n.name == "InProcessCoordinator"
            ),
            None,
        )
        if coord is None:
            return {}
        raw: Dict[str, Tuple[Set[str], Set[str]]] = {}
        for fn in coord.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            keys: Set[str] = set()
            helpers: Set[str] = set()
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Return) and node.value):
                    continue
                keys |= self._literal_keys(node.value)
                for call in ast.walk(node.value):
                    if (
                        isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Attribute)
                        and isinstance(call.func.value, ast.Name)
                        and call.func.value.id == "self"
                    ):
                        helpers.add(call.func.attr)
            raw[fn.name] = (keys, helpers)
        out = {name: set(keys) for name, (keys, _) in raw.items()}
        changed = True
        while changed:
            changed = False
            for name, (_, helpers) in raw.items():
                for h in helpers:
                    if h in out and not out[h] <= out[name]:
                        out[name] |= out[h]
                        changed = True
        return out

    def _reply_keys(
        self, expr: ast.AST, coord_keys: Dict[str, Set[str]]
    ) -> Set[str]:
        """Keys of the reply a shim branch returns: dict literals, plus
        delegation through ``self._c.method(...)``; ``self._note_reply(x)``
        is transparent and ``self._stamp(x)`` injects ``epoch``."""
        keys = self._literal_keys(expr)
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not isinstance(func, ast.Attribute):
                continue
            recv = func.value
            if isinstance(recv, ast.Name) and recv.id == "self":
                if func.attr == "_stamp":
                    keys.add("epoch")
                # _note_reply/_stamp arguments are walked anyway (ast.walk
                # descends into call args), so nothing else to do here.
            elif (
                isinstance(recv, ast.Attribute)
                and isinstance(recv.value, ast.Name)
                and recv.value.id == "self"
                and recv.attr == "_c"
                and func.attr in coord_keys
            ):
                keys |= coord_keys[func.attr]
        return keys

    @staticmethod
    def _literal_keys(expr: ast.AST) -> Set[str]:
        keys: Set[str] = set()
        for node in ast.walk(expr):
            if isinstance(node, ast.Dict):
                for k in node.keys:
                    if isinstance(k, ast.Constant) and isinstance(k.value, str):
                        keys.add(k.value)
        return keys

    # -- reduce phase ----------------------------------------------------------

    def reduce(
        self, summaries: List[Tuple[str, Optional[Dict[str, Any]]]], ctx
    ) -> Iterator[Finding]:
        schema, native_rel = load_native_schema(ctx.root, ctx.config)
        if schema is None:
            # No native source in this tree (pure-python fixture dirs):
            # nothing to conform to.
            return

        def cc_finding(message: str, symbol: str = "") -> Finding:
            return Finding(
                rule=self.rule, path=native_rel, line=1, col=0,
                message=message, symbol=symbol,
            )

        ops = schema["ops"]

        for op in schema["unstamped_deferred_ops"]:
            yield cc_finding(
                f"deferred reply for '{op}' bypasses stamp_epoch but does "
                "not carry an explicit 'epoch' field",
                symbol=op,
            )
        if not schema["epoch_stamped"]:
            yield cc_finding(
                "handle() does not stamp_epoch replies — clients cannot "
                "coalesce epoch observation"
            )

        # Ratchet: extracted schema vs the committed artifact.
        schema_rel = ctx.config.get("edl007_schema", DEFAULT_SCHEMA_NAME)
        yield from self._diff_committed(schema, schema_rel, ctx, cc_finding)

        request_ok = {
            op: set(spec["request"]) | set(ENVELOPE_REQUEST)
            for op, spec in ops.items()
        }
        for relpath, summary in sorted(summaries):
            if not summary:
                continue
            for op, fields, line, col in summary["call_sites"]:
                if op not in ops:
                    yield Finding(
                        rule=self.rule, path=relpath, line=line, col=col,
                        message=(
                            f"call('{op}') is not in the native dispatch "
                            "table"
                        ),
                    )
                    continue
                extra = sorted(set(fields) - request_ok[op])
                if extra:
                    yield Finding(
                        rule=self.rule, path=relpath, line=line, col=col,
                        message=(
                            f"call('{op}') sends field(s) the server never "
                            f"reads: {', '.join(extra)}"
                        ),
                    )
            if summary["shim"] is not None:
                yield from self._check_shim(relpath, summary["shim"], schema)

    def _diff_committed(
        self, schema: Dict[str, Any], schema_rel: str, ctx, cc_finding
    ) -> Iterator[Finding]:
        path = os.path.join(ctx.root, schema_rel)
        try:
            with open(path, "r", encoding="utf-8") as f:
                committed = json.load(f)
        except OSError:
            yield cc_finding(
                f"{schema_rel} is missing — run --write-protocol to commit "
                "the extracted schema"
            )
            return
        except json.JSONDecodeError as e:
            yield cc_finding(f"{schema_rel} is not valid JSON: {e}")
            return
        if committed == schema:
            return
        cops = committed.get("ops", {})
        for op in sorted(set(schema["ops"]) - set(cops)):
            yield cc_finding(
                f"op '{op}' is in the dispatch table but not in "
                f"{schema_rel} — run --write-protocol and review the diff",
                symbol=op,
            )
        for op in sorted(set(cops) - set(schema["ops"])):
            yield cc_finding(
                f"op '{op}' is in {schema_rel} but no longer in the "
                "dispatch table — run --write-protocol and review the diff",
                symbol=op,
            )
        for op in sorted(set(cops) & set(schema["ops"])):
            if cops[op] != schema["ops"][op]:
                yield cc_finding(
                    f"op '{op}' drifted from {schema_rel} (request/reply/"
                    "deferred changed) — run --write-protocol and review "
                    "the diff",
                    symbol=op,
                )
        if committed.get("epoch_stamped") != schema["epoch_stamped"]:
            yield cc_finding(
                f"epoch stamping changed vs {schema_rel} — run "
                "--write-protocol and review the diff"
            )

    def _check_shim(
        self, relpath: str, shim: Dict[str, Any], schema: Dict[str, Any]
    ) -> Iterator[Finding]:
        ops = schema["ops"]
        for op in sorted(set(ops) - set(shim["ops"])):
            yield Finding(
                rule=self.rule, path=relpath,
                line=shim["call_line"], col=0,
                message=(
                    f"InProcessClient.call() does not handle op '{op}' "
                    "(native dispatch does)"
                ),
            )
        for op in sorted(set(shim["ops"]) - set(ops)):
            yield Finding(
                rule=self.rule, path=relpath,
                line=shim["ops"][op]["line"], col=0,
                message=(
                    f"InProcessClient.call() handles op '{op}' which is "
                    "not in the native dispatch table"
                ),
            )
        for op in sorted(set(shim["ops"]) & set(ops)):
            have = set(shim["ops"][op]["keys"])
            want = set(ops[op]["reply"])
            if have == want:
                continue
            missing = sorted(want - have)
            extra = sorted(have - want)
            parts = []
            if missing:
                parts.append(f"missing: {', '.join(missing)}")
            if extra:
                parts.append(f"extra: {', '.join(extra)}")
            yield Finding(
                rule=self.rule, path=relpath,
                line=shim["ops"][op]["line"], col=0,
                message=(
                    f"in-process reply for '{op}' diverges from the native "
                    f"reply fields ({'; '.join(parts)})"
                ),
            )
