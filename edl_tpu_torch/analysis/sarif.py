"""SARIF 2.1.0 serialization for analysis findings.

``--format sarif`` emits one run with the full rule catalog, so CI viewers
(GitHub code scanning et al.) render findings as inline annotations with
rule help text. Two deliberate choices:

- **Baselined findings are emitted as suppressed results** (``suppressions``
  with ``kind: external``) rather than dropped: the debt stays visible in
  the SARIF view exactly like ``--show-baselined`` in text mode, without
  failing the CI gate.
- **``partialFingerprints.edlFingerprint/v1``** carries the same
  sha256-prefix fingerprint the baseline uses, so a SARIF consumer's
  dedup/tracking agrees with ``analysis_baseline.json`` about which
  findings are "the same" across commits.

``from_sarif`` inverts ``to_sarif`` for the round-trip tests — it is a
test aid, not a general SARIF reader (it assumes our own producer's
shape).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

from edl_tpu_torch.analysis.baseline import fingerprint
from edl_tpu_torch.analysis.core import Finding

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)
TOOL_NAME = "edl-analysis"


def _result(finding: Finding, baselined: bool) -> Dict[str, Any]:
    result: Dict[str, Any] = {
        "ruleId": finding.rule,
        "level": "warning",
        "message": {"text": finding.message},
        "locations": [
            {
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": finding.path,
                        "uriBaseId": "SRCROOT",
                    },
                    "region": {
                        "startLine": max(1, finding.line),
                        # SARIF columns are 1-based; Finding.col is 0-based
                        "startColumn": finding.col + 1,
                    },
                }
            }
        ],
        "partialFingerprints": {
            "edlFingerprint/v1": fingerprint(finding),
        },
    }
    if finding.symbol:
        result["properties"] = {"symbol": finding.symbol}
    if baselined:
        result["suppressions"] = [
            {"kind": "external", "justification": "accepted in analysis_baseline.json"}
        ]
    return result


def to_sarif(
    new: Sequence[Finding],
    baselined: Sequence[Finding] = (),
) -> Dict[str, Any]:
    """Build the SARIF 2.1.0 document for one analysis run."""
    from edl_tpu_torch.analysis.checkers import ALL_CHECKERS

    rules = [
        {
            "id": cls.rule,
            "name": cls.info.name,
            "shortDescription": {"text": cls.info.description},
        }
        for cls in ALL_CHECKERS
    ]
    results = [_result(f, baselined=False) for f in new]
    results.extend(_result(f, baselined=True) for f in baselined)
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": TOOL_NAME,
                        "informationUri": "doc/analysis.md",
                        "rules": rules,
                    }
                },
                "results": results,
            }
        ],
    }


def from_sarif(doc: Dict[str, Any]) -> Tuple[List[Finding], List[Finding]]:
    """Invert :func:`to_sarif`: (new, baselined) findings, in emit order."""
    new: List[Finding] = []
    baselined: List[Finding] = []
    for run in doc.get("runs", ()):
        for result in run.get("results", ()):
            loc = result["locations"][0]["physicalLocation"]
            region = loc.get("region", {})
            finding = Finding(
                rule=result["ruleId"],
                path=loc["artifactLocation"]["uri"],
                line=int(region.get("startLine", 1)),
                col=int(region.get("startColumn", 1)) - 1,
                message=result["message"]["text"],
                symbol=result.get("properties", {}).get("symbol", ""),
            )
            if result.get("suppressions"):
                baselined.append(finding)
            else:
                new.append(finding)
    return new, baselined
