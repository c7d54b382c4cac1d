"""CLI: ``PYTHONPATH=src python -m repro_torch.analysis`` (default paths:
``src/repro_torch chip_smoke.py scripts``).

Exit status: 0 == clean (every finding fixed, suppressed with a reason, or
reason-baselined), 1 == new findings or baseline drift, 2 == usage error.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.baseline import diff_baseline, load_baseline, write_baseline
from repro_torch.analysis.core import all_rules, analyze_paths

DEFAULT_BASELINE = "analysis_baseline_torch.json"
DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py", "scripts")


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static analysis of the PyTorch/CUDA port "
                    "(rule catalog: repro_torch.analysis)")
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                    help="files/directories to analyze (default: "
                         f"{' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help=f"baseline file (default: {DEFAULT_BASELINE}; "
                         "missing file == empty baseline)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite --baseline from the current findings "
                         "(carries forward existing reasons) and exit 0")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--root", default=".",
                    help="root that finding paths/fingerprints are relative "
                         "to (default: cwd; CI runs from the repo root)")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, rule in all_rules().items():
            print(f"{rid}  {rule.name:22} {rule.description}")
        return 0

    rules = None
    if args.rules:
        known = all_rules()
        rules = [r.strip().upper() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rules if r not in known]
        if unknown:
            print(f"unknown rule id(s): {', '.join(unknown)}", file=sys.stderr)
            return 2

    try:
        result = analyze_paths(args.paths, root=args.root, rules=rules)
    except OSError as exc:
        print(f"repro_torch.analysis: {exc}", file=sys.stderr)
        return 2

    if args.write_baseline:
        previous = {} if args.no_baseline else load_baseline(args.baseline)
        entries = write_baseline(args.baseline, result, previous)
        print(f"wrote {args.baseline}: {len(entries)} grandfathered finding(s) "
              f"across {result.files} file(s)")
        return 0

    baseline = {} if args.no_baseline else load_baseline(args.baseline)
    new, stale = diff_baseline(result, baseline)
    n_baselined = len(result.findings) - len(new)

    if args.format == "json":
        payload = {
            "files": result.files,
            "new": [f.to_dict() for f in new],
            "baselined": n_baselined,
            "suppressed": len(result.suppressed),
            "stale_baseline": stale,
        }
        print(json.dumps(payload, indent=1))
    else:
        for f in new:
            print(f.render())
        for fp in stale:
            entry = baseline[fp]
            print(f"{entry['path']}:{entry['line']}: STALE baseline entry "
                  f"{fp} ({entry['rule']}) — the finding is gone; retire it "
                  f"with --write-baseline")
        summary = (f"repro_torch.analysis: {result.files} file(s), "
                   f"{len(new)} new finding(s), {n_baselined} baselined, "
                   f"{len(result.suppressed)} suppressed, "
                   f"{len(stale)} stale baseline entr(y/ies)")
        print(summary, file=sys.stderr if (new or stale) else sys.stdout)
    return 1 if (new or stale) else 0


if __name__ == "__main__":              # pragma: no cover
    sys.exit(main())
