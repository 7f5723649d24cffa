"""CLI entry point: ``python -m repro_torch.analysis [paths ...]``."""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .engine import analyze
from .findings import write_baseline
from .report import FORMATTERS, format_text
from .rules import RULES

# the port's own grandfathered findings; the repo root's
# analysis_baseline.json belongs to the JAX package and is never read
BASELINE = Path(__file__).resolve().parent / "baseline.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="reprolint for the PyTorch port: contract-aware "
        "static analysis")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories (default: src/repro_torch)")
    ap.add_argument("--format", choices=sorted(FORMATTERS),
                    default="text")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="grandfathered-findings file (default: the "
                    "port's src/repro_torch/analysis/baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore any baseline file")
    ap.add_argument("--write-baseline", type=Path, default=None,
                    metavar="PATH",
                    help="write current findings as the new baseline "
                    "and exit 0")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset, e.g. R002,R003")
    ap.add_argument("--fix-suggestions", action="store_true",
                    help="print nearest compliant rewrites (R003/R004)")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid in sorted(RULES):
            r = RULES[rid]
            print(f"{rid}  {r.title}\n      guards: {r.contract}")
        return 0

    paths = args.paths or (["src/repro_torch"]
                           if Path("src/repro_torch").is_dir()
                           else [str(Path(__file__).resolve().parents[1])])
    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rules if r not in RULES]
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)}",
                  file=sys.stderr)
            return 2

    baseline = None
    if not args.no_baseline and args.write_baseline is None:
        baseline = args.baseline or BASELINE

    result = analyze(paths, rules=rules, baseline_path=baseline)

    if args.write_baseline is not None:
        write_baseline(args.write_baseline,
                       [f for _, f in result.new]
                       + [f for _, f in result.baselined])
        print(f"wrote {len(result.new) + len(result.baselined)} "
              f"finding(s) to {args.write_baseline}")
        return 0

    if args.format == "text":
        print(format_text(result, fix_suggestions=args.fix_suggestions))
    else:
        print(FORMATTERS[args.format](result))
    return result.exit_code


if __name__ == "__main__":
    sys.exit(main())
