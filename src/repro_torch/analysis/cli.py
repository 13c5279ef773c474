"""``python -m repro_torch.analysis`` — the repo's static-analysis gate.

Exit codes: 0 clean (or everything suppressed), 1 findings, 2 usage /
configuration error (unknown --select, malformed baseline).  ``--format
json`` emits a machine-readable report for tooling; CI runs the text
form over ``src/repro_torch``, ``chip_smoke.py`` and ``chip_profile.py``
with ``--baseline .analysis-baseline-torch.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis.core import all_rules, analyze_paths

DEFAULT_BASELINE = ".analysis-baseline-torch.json"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's static analyzer: capture safety "
                    "(RPT1xx), CUDA launch contracts (RPT2xx), fleet "
                    "atomic-write discipline (RPR3xx), monotonic-clock "
                    "timing (RPR4xx)")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files/directories to analyze (default: "
                         "src/repro_torch)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="suppression file; entries need a non-empty "
                         f"reason (default: {DEFAULT_BASELINE} when it "
                         "exists)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore any default baseline file")
    ap.add_argument("--write-baseline", default=None, metavar="FILE",
                    help="snapshot current findings as a baseline "
                         "skeleton (reasons seeded with a TODO) and exit")
    ap.add_argument("--select", action="append", default=None,
                    metavar="PREFIX",
                    help="run only rules matching this id prefix "
                         "(repeatable), e.g. --select RPT2")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--root", default=".",
                    help="path findings are reported relative to")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_rules:
        for r in all_rules():
            print(f"{r.id}  {r.title}")
        return 0

    try:
        findings, n_files = analyze_paths(args.paths, root=args.root,
                                          select=args.select)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        n = baseline_mod.write_baseline(args.write_baseline, findings)
        print(f"wrote {args.write_baseline}: {n} entr"
              f"{'y' if n == 1 else 'ies'} (fill in the TODO reasons "
              "before committing)")
        return 0

    baseline_path = args.baseline
    if baseline_path is None and not args.no_baseline \
            and os.path.exists(os.path.join(args.root, DEFAULT_BASELINE)):
        baseline_path = os.path.join(args.root, DEFAULT_BASELINE)

    suppressed: List = []
    stale: List = []
    if baseline_path:
        try:
            bl = baseline_mod.load_baseline(baseline_path)
        except baseline_mod.BaselineError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        findings, suppressed, stale = baseline_mod.apply_baseline(
            findings, bl)

    if args.format == "json":
        print(json.dumps({
            "files": n_files,
            "findings": [f.to_dict() for f in findings],
            "suppressed": [f.to_dict() for f in suppressed],
            "stale_baseline_keys": [list(k) for k in stale],
        }, indent=1))
    else:
        for f in findings:
            print(f.render())
        for k in stale:
            print(f"warning: stale baseline entry {k[0]} {k[1]} [{k[2]}] "
                  "matches no finding — remove it", file=sys.stderr)
        tail = f"{n_files} file(s), {len(findings)} finding(s)"
        if suppressed:
            tail += f", {len(suppressed)} suppressed by baseline"
        print(tail)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
