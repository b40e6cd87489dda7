"""CLI: ``python -m edl_tpu_torch.analysis [paths...]``.

Exit codes: 0 = clean (every finding baselined or suppressed), 1 = new
findings (or stale baseline entries — the ratchet cuts both ways), 2 =
usage / parse errors.

The wire schema EDL007 holds the implementations to is the repo root's
``protocol_schema.json``, which the JAX package's analyzer extracts from
``native/coordinator``: this CLI reads it and never writes it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from edl_tpu_torch.analysis.baseline import (
    DEFAULT_BASELINE_NAME,
    apply_baseline,
    load_baseline,
    write_baseline,
)
from edl_tpu_torch.analysis.engine import analyze, detect_root


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m edl_tpu_torch.analysis",
        description=(
            "Domain-specific static analysis for the elastic-training "
            "codebase (lock-discipline, trace-hygiene, sharding-"
            "consistency, blocking-in-lock, exception-hygiene, "
            "thread-races, wire-protocol, elastic-determinism, "
            "protocol-model, durability-model)."
        ),
    )
    parser.add_argument(
        "paths",
        nargs="*",
        default=["edl_tpu_torch"],
        help="files or directories to analyze (default: edl_tpu_torch)",
    )
    parser.add_argument(
        "--format",
        choices=("text", "json", "sarif"),
        default="text",
        help=(
            "output format (default: text; sarif emits a SARIF 2.1.0 "
            "document for CI code annotations)"
        ),
    )
    parser.add_argument(
        "--rules",
        default=None,
        metavar="EDL001,EDL002,...",
        help="comma-separated rule subset (default: all)",
    )
    parser.add_argument(
        "--baseline",
        default=None,
        metavar="PATH",
        help=(
            f"baseline file (default: <root>/{DEFAULT_BASELINE_NAME} when "
            "present; 'none' disables)"
        ),
    )
    parser.add_argument(
        "--write-baseline",
        action="store_true",
        help="rewrite the baseline from current findings and exit 0",
    )
    parser.add_argument(
        "--show-baselined",
        action="store_true",
        help="also print findings accepted by the baseline",
    )
    parser.add_argument(
        "--list-rules",
        action="store_true",
        help="print the rule catalog and exit",
    )
    parser.add_argument(
        "--jobs",
        type=int,
        default=None,
        metavar="N",
        help=(
            "worker processes for the per-file phase (default: auto — "
            "EDL_ANALYZE_JOBS, else one per core, serial for small trees)"
        ),
    )
    parser.add_argument(
        "--timings",
        action="store_true",
        help="print per-rule wall-clock seconds after the summary",
    )
    return parser


def _list_rules() -> int:
    from edl_tpu_torch.analysis.checkers import ALL_CHECKERS

    for cls in ALL_CHECKERS:
        print(f"{cls.rule}  {cls.info.name}: {cls.info.description}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.list_rules:
        return _list_rules()

    rules = (
        [r.strip() for r in args.rules.split(",") if r.strip()]
        if args.rules
        else None
    )
    root = detect_root(args.paths)
    report = analyze(args.paths, root=root, rules=rules, jobs=args.jobs)

    baseline_path = args.baseline
    if baseline_path is None:
        candidate = os.path.join(root, DEFAULT_BASELINE_NAME)
        baseline_path = candidate if os.path.isfile(candidate) else "none"

    if args.write_baseline:
        target = (
            baseline_path
            if baseline_path != "none"
            else os.path.join(root, DEFAULT_BASELINE_NAME)
        )
        baseline = write_baseline(target, report.findings)
        print(
            f"wrote {target}: {baseline.total()} accepted finding(s) "
            f"across {len(baseline.entries)} entries"
        )
        return 0

    if baseline_path != "none":
        try:
            baseline = load_baseline(baseline_path)
        except (ValueError, json.JSONDecodeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        new, accepted, stale = apply_baseline(report.findings, baseline)
    else:
        new, accepted, stale = report.findings, [], []

    if args.format == "sarif":
        from edl_tpu_torch.analysis.sarif import to_sarif

        print(json.dumps(to_sarif(new, accepted), indent=2))
    elif args.format == "json":
        payload = {
            "version": 1,
            "findings": [
                {**f.to_dict(), "baselined": False} for f in new
            ] + [{**f.to_dict(), "baselined": True} for f in accepted],
            "stale_baseline": stale,
            "summary": {
                "new": len(new),
                "baselined": len(accepted),
                "suppressed": len(report.suppressed),
                "files": report.files_checked,
                "jobs": report.jobs,
                "timings": {
                    r: round(s, 4) for r, s in sorted(report.timings.items())
                },
                "reduce_timings": {
                    r: round(s, 4)
                    for r, s in sorted(report.reduce_timings.items())
                },
                "parse_errors": [
                    {"path": p, "error": e} for p, e in report.parse_errors
                ],
            },
        }
        print(json.dumps(payload, indent=2))
    else:
        for f in new:
            print(f"{f.location()}: {f.rule} {f.message}")
        if args.show_baselined:
            for f in accepted:
                print(f"{f.location()}: {f.rule} [baselined] {f.message}")
        for entry in stale:
            print(
                f"stale baseline entry ({entry['rule']} {entry['path']} "
                f"'{entry['symbol']}'): finding no longer occurs — run "
                "--write-baseline to ratchet it out"
            )
        for path, err in report.parse_errors:
            print(f"{path}: parse error: {err}", file=sys.stderr)
        print(
            f"{len(new)} new, {len(accepted)} baselined, "
            f"{len(report.suppressed)} suppressed finding(s) across "
            f"{report.files_checked} file(s)"
        )
        if args.timings:
            for rule, sec in sorted(report.timings.items()):
                print(f"  {rule}: {sec:.3f}s (map)")
            for rule, sec in sorted(report.reduce_timings.items()):
                print(f"  {rule}: {sec:.3f}s (reduce)")
            print(f"  jobs: {report.jobs}")

    if report.parse_errors:
        return 2
    return 1 if new or stale else 0


if __name__ == "__main__":
    sys.exit(main())
