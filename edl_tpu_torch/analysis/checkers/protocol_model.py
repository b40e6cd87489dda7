"""EDL009 — protocol state-machine model checking (whole-program).

EDL007 ratchets the protocol's *shape*; this rule checks its *behavior*.
``protocol_schema.json`` carries a hand-authored ``state_effects`` block —
per-op declarations of how each op touches coordinator state (epoch bumps,
lease acquire/release, ``req_id``/``op_id`` dedup, fd-parking). The reduce
phase:

1. validates that ``state_effects`` covers exactly the extracted op set
   (an op added to the dispatch table without a behavioral annotation is a
   finding, as is a stale annotation);
2. runs the bounded explicit-state exploration from
   ``edl_tpu_torch.analysis.modelcheck``: every interleaving of the default
   2-worker scripted config (crash+restart, duplicate delivery, a ``batch``
   frame) is executed through the abstract model AND replayed against
   ``InProcessCoordinator``, checking epoch monotonicity, exactly-once
   replay, lease exclusivity, task conservation, and barrier/sync progress.

A model/oracle divergence or invariant violation is a finding anchored on
the in-process twin — the executable spec drifted from the declared
behavior. Fixture trees are exempt automatically: the reduce phase is
skipped entirely unless the target file (default
``edl_tpu_torch/coordinator/inprocess.py``) was among the analyzed files, so
per-rule fixture runs never pay the exploration cost.

Config overrides: ``edl009_target`` (relpath of the oracle module),
``edl009_schema`` (schema artifact relpath), ``edl009_max_traces`` /
``edl009_fuzz`` / ``edl009_fuzz_seed`` (exploration budget; fuzz > 0
switches the checker to the seeded random-walk mode).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

from edl_tpu_torch.analysis.core import Finding, RuleInfo, SourceFile

DEFAULT_TARGET = "edl_tpu_torch/coordinator/inprocess.py"
DEFAULT_SCHEMA_NAME = "protocol_schema.json"

#: findings beyond this are summarized into one overflow finding — a broken
#: twin fails on hundreds of interleavings but the first few name the bug.
MAX_VIOLATION_FINDINGS = 8


class ProtocolModelChecker:
    rule = "EDL009"
    name = "protocol-model"
    scope = "program"
    info = RuleInfo(
        rule="EDL009",
        name="protocol-model",
        description=(
            "bounded model check of protocol_schema.json state_effects "
            "against the in-process coordinator: every interleaving of a "
            "faulty 2-worker schedule (crash+restart, duplicate delivery) "
            "must satisfy epoch monotonicity, exactly-once replay, lease "
            "exclusivity, and progress"
        ),
    )

    # -- map phase -------------------------------------------------------------

    def summarize(self, sf: SourceFile, ctx) -> Optional[Dict[str, Any]]:
        target = ctx.config.get("edl009_target", DEFAULT_TARGET)
        if sf.relpath != target:
            return None
        return {"target": True, "line": 1}

    # -- reduce phase ----------------------------------------------------------

    def reduce(
        self, summaries: List[Tuple[str, Optional[Dict[str, Any]]]], ctx
    ) -> Iterator[Finding]:
        from edl_tpu_torch.analysis.modelcheck import (
            ModelCheckError,
            default_schedules,
            explore,
            load_state_effects,
        )

        target_rel = None
        for relpath, summary in summaries:
            if summary and summary.get("target"):
                target_rel = relpath
                break
        if target_rel is None:
            # The oracle module is not in this analysis scope (fixture
            # trees, partial runs): nothing to model-check.
            return

        schema_rel = ctx.config.get("edl009_schema", DEFAULT_SCHEMA_NAME)
        effects, ops, err = load_state_effects(ctx.root, schema_rel)

        def schema_finding(message: str, symbol: str = "") -> Finding:
            return Finding(
                rule=self.rule, path=schema_rel, line=1, col=0,
                message=message, symbol=symbol,
            )

        if err is not None:
            yield schema_finding(err)
            return

        # Coverage ratchet: the behavioral spec must track the op set.
        drift = False
        for op in sorted((ops or set()) - set(effects)):
            drift = True
            yield schema_finding(
                f"op '{op}' is in the dispatch table but has no "
                "state_effects entry — annotate its behavior before the "
                "model check can cover it",
                symbol=op,
            )
        for op in sorted(set(effects) - (ops or set())):
            drift = True
            yield schema_finding(
                f"state_effects entry '{op}' names no dispatch-table op — "
                "stale behavioral annotation",
                symbol=op,
            )
        if drift:
            return  # exploration over a drifted spec only repeats the news

        fuzz = int(ctx.config.get("edl009_fuzz", 0))
        violations = []
        try:
            # The acceptance schedules (faulty base, checkpoint plane,
            # watch/notify, redirect-during-watch) — each explored
            # separately so every schedule stays inside the interleaving
            # budget; findings merge. Durability rows belong to EDL010 and
            # are filtered out here.
            for sched in default_schedules():
                if sched.durable:
                    continue
                result = explore(
                    sched.scripts,
                    effects,
                    coordinator_factory=sched.factory,
                    max_traces=int(
                        ctx.config.get("edl009_max_traces", 20000)),
                    max_violations=MAX_VIOLATION_FINDINGS * 4,
                    fuzz_samples=fuzz,
                    fuzz_seed=int(ctx.config.get("edl009_fuzz_seed", 0)),
                    shard_endpoints=sched.shard_endpoints,
                    name=sched.name,
                )
                violations.extend(result.violations)
        except ModelCheckError as e:
            yield schema_finding(f"state_effects cannot drive the model: {e}")
            return

        for v in violations[:MAX_VIOLATION_FINDINGS]:
            yield Finding(
                rule=self.rule, path=target_rel, line=1, col=0,
                message=(
                    f"model check [{v.kind}]: {v.message} | schedule: "
                    f"{v.trace}"
                ),
                symbol=v.kind,
            )
        overflow = len(violations) - MAX_VIOLATION_FINDINGS
        if overflow > 0:
            yield Finding(
                rule=self.rule, path=target_rel, line=1, col=0,
                message=(
                    f"model check: {overflow} further violation(s) "
                    "suppressed — run python -m edl_tpu_torch.analysis.modelcheck "
                    "for the full list"
                ),
                symbol="overflow",
            )
