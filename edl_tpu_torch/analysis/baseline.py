"""Baseline: accepted debt, ratcheted down over time.

The baseline records existing findings by *fingerprint* — rule + file +
enclosing symbol + message, deliberately NOT the line number, so unrelated
edits that shift lines don't churn it. Identical findings in one symbol
(two unguarded writes to the same attribute) share a fingerprint; the
stored ``count`` caps how many occurrences stay accepted — the N+1'th is
new debt and fails the run. Entries whose finding disappeared are reported
as stale so the ratchet only ever tightens.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from edl_tpu_torch.analysis.core import Finding

BASELINE_VERSION = 1

#: relative to the analysis root (the repo); the root's
#: ``analysis_baseline.json`` is the JAX package's own
DEFAULT_BASELINE_NAME = "edl_tpu_torch/analysis/baseline.json"


def fingerprint(finding: Finding) -> str:
    raw = "|".join((finding.rule, finding.path, finding.symbol, finding.message))
    return hashlib.sha256(raw.encode("utf-8")).hexdigest()[:16]


@dataclass
class Baseline:
    #: fingerprint -> entry dict (rule/path/symbol/message/count)
    entries: Dict[str, dict] = field(default_factory=dict)

    def total(self) -> int:
        return sum(e.get("count", 1) for e in self.entries.values())


def load_baseline(path: str) -> Baseline:
    if not os.path.isfile(path):
        return Baseline()
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path} has version {data.get('version')!r}, "
            f"expected {BASELINE_VERSION}"
        )
    return Baseline(entries=dict(data.get("findings", {})))


def write_baseline(path: str, findings: List[Finding]) -> Baseline:
    entries: Dict[str, dict] = {}
    for f in findings:
        fp = fingerprint(f)
        if fp in entries:
            entries[fp]["count"] += 1
        else:
            entries[fp] = {
                "rule": f.rule,
                "path": f.path,
                "symbol": f.symbol,
                "message": f.message,
                "count": 1,
            }
    baseline = Baseline(entries=entries)
    payload = {
        "version": BASELINE_VERSION,
        "comment": (
            "Accepted static-analysis debt. Regenerate with "
            "`python -m edl_tpu_torch.analysis edl_tpu_torch --write-baseline` after "
            "fixing entries; never hand-add new ones."
        ),
        "findings": {k: entries[k] for k in sorted(entries)},
    }
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=False)
        f.write("\n")
    os.replace(tmp, path)
    return baseline


def apply_baseline(
    findings: List[Finding], baseline: Baseline
) -> Tuple[List[Finding], List[Finding], List[dict]]:
    """Split ``findings`` into (new, accepted) and report stale entries.

    Occurrences beyond an entry's ``count`` are new. Stale = baseline
    entries (or excess counts) no finding matched — fixed debt whose entry
    should be ratcheted out via ``--write-baseline``.
    """
    remaining = {
        fp: e.get("count", 1) for fp, e in baseline.entries.items()
    }
    new: List[Finding] = []
    accepted: List[Finding] = []
    for f in findings:
        fp = fingerprint(f)
        if remaining.get(fp, 0) > 0:
            remaining[fp] -= 1
            accepted.append(f)
        else:
            new.append(f)
    stale = [
        {**baseline.entries[fp], "unmatched": left}
        for fp, left in remaining.items()
        if left > 0
    ]
    return new, accepted, stale
