"""EDL010 — crash-recovery model checking of the durability plane.

EDL009 checks the protocol's live behavior; this rule checks what
survives death. ``protocol_schema.json``'s ``state_effects`` entries
carry a ``durability`` tag — ``none`` (read-only), ``volatile`` (mutates
only state a restart legitimately wipes), ``journal:<kinds>`` (the op
group-commits the named record kinds: ``meta``/``todo``/``done``/
``lease``/``kv``/``kvdel``), or ``composite`` (``batch``: the union of
its sub-ops, one frame). The reduce phase:

1. ratchets tag coverage — every dispatch-table op must carry a valid
   ``durability`` tag (an untagged op is durability the model cannot see,
   and a typo'd record kind is a spec that cannot drive replay);
2. runs the durability schedules from ``edl_tpu_torch.analysis.modelcheck``:
   crash points enumerated between persistence effects (clean / pre-ack /
   torn-tail / during-compaction), recovery replay as a first-class
   schedule step, every trace replayed against the file-backed
   ``InProcessCoordinator`` persistence twin. Invariants: acked implies
   durable, exactly-once across crash (journaled dedup), snapshot ⊕
   journal-suffix ≡ pre-crash durable state, epoch monotonicity across
   restart, and ladder honesty for the unjournaled shard store.

Findings anchor on the persistence twin (the executable durability
spec). Fixture trees never pay the exploration cost: the reduce phase is
skipped unless the target file was among the analyzed files.

Config overrides: ``edl010_target`` (relpath of the twin module),
``edl010_schema`` (schema artifact relpath), ``edl010_max_traces`` /
``edl010_fuzz`` / ``edl010_fuzz_seed`` (exploration budget; fuzz > 0
switches to the seeded random-walk mode).

The same schedules replay against the crash-armed native binary via
``make modelcheck-native`` (env-gated ``_exit(2)`` hooks in
``native/coordinator/coordinator.cc``) — that lane needs a subprocess
per trace, so it runs in CI/verify rather than inside this checker.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

from edl_tpu_torch.analysis.core import Finding, RuleInfo, SourceFile

DEFAULT_TARGET = "edl_tpu_torch/coordinator/inprocess.py"
DEFAULT_SCHEMA_NAME = "protocol_schema.json"

#: the journal's record vocabulary — a ``journal:`` tag naming anything
#: else is a spec typo, not a new record kind.
JOURNAL_KINDS = frozenset({"meta", "todo", "done", "lease", "kv", "kvdel"})

#: non-journal tag values.
SIMPLE_TAGS = frozenset({"none", "volatile", "composite"})

MAX_VIOLATION_FINDINGS = 8


def validate_durability_tag(tag: Any) -> Optional[str]:
    """None when ``tag`` is a well-formed durability tag, else the
    problem as a string."""
    if not isinstance(tag, str) or not tag:
        return "missing or non-string durability tag"
    if tag in SIMPLE_TAGS:
        return None
    if tag.startswith("journal:"):
        kinds = [k for k in tag[len("journal:"):].split(",") if k]
        if not kinds:
            return "journal: tag names no record kinds"
        bad = sorted(set(kinds) - JOURNAL_KINDS)
        if bad:
            return (f"journal: tag names unknown record kind(s) {bad} — "
                    f"known: {sorted(JOURNAL_KINDS)}")
        return None
    return (f"unknown durability tag {tag!r} — expected one of "
            f"{sorted(SIMPLE_TAGS)} or journal:<kinds>")


class DurabilityModelChecker:
    rule = "EDL010"
    name = "durability-model"
    scope = "program"
    info = RuleInfo(
        rule="EDL010",
        name="durability-model",
        description=(
            "crash-recovery model check of the journal/snapshot durability "
            "plane: per-op durability tags ratcheted over the protocol "
            "schema, then every crash point (clean, pre-ack, torn tail, "
            "during compaction) explored with recovery replay and checked "
            "against the file-backed persistence twin — acked implies "
            "durable, exactly-once across crash, snapshot+suffix "
            "equivalence, epoch monotonicity across restart"
        ),
    )

    # -- map phase -------------------------------------------------------------

    def summarize(self, sf: SourceFile, ctx) -> Optional[Dict[str, Any]]:
        target = ctx.config.get("edl010_target", DEFAULT_TARGET)
        if sf.relpath != target:
            return None
        return {"target": True, "line": 1}

    # -- reduce phase ----------------------------------------------------------

    def reduce(
        self, summaries: List[Tuple[str, Optional[Dict[str, Any]]]], ctx
    ) -> Iterator[Finding]:
        from edl_tpu_torch.analysis.modelcheck import (
            ModelCheckError,
            durability_schedules,
            explore,
            load_state_effects,
        )

        target_rel = None
        for relpath, summary in summaries:
            if summary and summary.get("target"):
                target_rel = relpath
                break
        if target_rel is None:
            # The persistence twin is not in this analysis scope (fixture
            # trees, partial runs): nothing to check.
            return

        schema_rel = ctx.config.get("edl010_schema", DEFAULT_SCHEMA_NAME)
        effects, ops, err = load_state_effects(ctx.root, schema_rel)

        def schema_finding(message: str, symbol: str = "") -> Finding:
            return Finding(
                rule=self.rule, path=schema_rel, line=1, col=0,
                message=message, symbol=symbol,
            )

        if err is not None:
            yield schema_finding(err)
            return

        # Durability-tag coverage ratchet: every op the dispatch table
        # knows must declare what it persists. Op-set drift itself is
        # EDL009's finding; this rule only judges the tags of ops that
        # have entries.
        drift = False
        for op in sorted(set(effects) & (ops or set(effects))):
            problem = validate_durability_tag(
                (effects.get(op) or {}).get("durability"))
            if problem is not None:
                drift = True
                yield schema_finding(
                    f"op '{op}': {problem} — the durability model cannot "
                    "place its crash points until the tag is fixed",
                    symbol=op,
                )
        if drift:
            return  # exploration over an untagged spec proves nothing

        fuzz = int(ctx.config.get("edl010_fuzz", 0))
        violations = []
        try:
            for sched in durability_schedules():
                result = explore(
                    sched.scripts,
                    effects,
                    coordinator_factory=sched.factory,
                    max_traces=int(
                        ctx.config.get("edl010_max_traces", 20000)),
                    max_violations=MAX_VIOLATION_FINDINGS * 4,
                    fuzz_samples=fuzz,
                    fuzz_seed=int(ctx.config.get("edl010_fuzz_seed", 0)),
                    durable=sched.durable,
                    compact_every=sched.compact_every,
                    por=sched.por,
                    name=sched.name,
                )
                violations.extend(result.violations)
        except ModelCheckError as e:
            yield schema_finding(
                f"durability tags cannot drive the model: {e}")
            return

        for v in violations[:MAX_VIOLATION_FINDINGS]:
            yield Finding(
                rule=self.rule, path=target_rel, line=1, col=0,
                message=(
                    f"durability check [{v.kind}]: {v.message} | schedule: "
                    f"{v.trace}"
                ),
                symbol=v.kind,
            )
        overflow = len(violations) - MAX_VIOLATION_FINDINGS
        if overflow > 0:
            yield Finding(
                rule=self.rule, path=target_rel, line=1, col=0,
                message=(
                    f"durability check: {overflow} further violation(s) "
                    "suppressed — run python -m edl_tpu_torch.analysis.modelcheck "
                    "--schedules durability-base,durability-dedup,"
                    "durability-torn,durability-compact,"
                    "durability-crash-compact,durability-shard for the "
                    "full list"
                ),
                symbol="overflow",
            )
