"""CLI driver: ``python -m r2d2_tpu_torch.analysis [paths...] [--json]``.

Port of ``r2d2_tpu/analysis/__main__.py``, the same options.  Exit status
0 = clean tree (suppressed findings allowed), 1 = findings or
unparseable files.  Default paths: ``r2d2_tpu_torch`` relative to the
current directory.  ``--rules a,b`` restricts the run; ``--list-rules``
prints the registry.  ``--baseline FILE`` checks the report against a
committed findings+suppressions snapshot (exit 1 with a diff on drift);
``--write-baseline FILE`` regenerates the snapshot.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    # rule registration happens in the package __init__; importing it here
    # (not at module top) keeps `python -m r2d2_tpu_torch.analysis` and
    # `from r2d2_tpu_torch.analysis import main` on one import path
    from r2d2_tpu_torch.analysis import RULES, run_analysis

    p = argparse.ArgumentParser(
        prog="r2d2_tpu_torch.analysis",
        description="graftlint: repo-native static analysis")
    p.add_argument("paths", nargs="*", default=None,
                   help="files/directories to analyze "
                        "(default: r2d2_tpu_torch)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable report on stdout")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule subset")
    p.add_argument("--root", default=None,
                   help="repo root for relative paths + docs lookup "
                        "(default: cwd)")
    p.add_argument("--list-rules", action="store_true")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help="check findings+suppressions against this "
                        "snapshot; exit 1 with a diff on drift")
    p.add_argument("--write-baseline", default=None, metavar="FILE",
                   help="write the snapshot for --baseline to check")
    args = p.parse_args(argv)

    if args.list_rules:
        for name in sorted(RULES):
            print(f"{name}: {RULES[name].doc}")
        return 0

    paths = args.paths or ["r2d2_tpu_torch"]
    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rules if r not in RULES]
        if unknown:
            p.error(f"unknown rules: {', '.join(unknown)} "
                    f"(have: {', '.join(sorted(RULES))})")
    report = run_analysis(paths, root=args.root, rules=rules)

    if args.write_baseline:
        from r2d2_tpu_torch.analysis import baseline as bl

        bl.write(args.write_baseline, report)
        print(f"graftlint: baseline written to {args.write_baseline} "
              f"({len(report.findings)} finding(s), "
              f"{len(report.suppressed)} suppression(s))")
        if report.findings:
            print("graftlint: WARNING — baselining a DIRTY tree: the "
                  "findings above are now pinned as accepted debt")
        return 0 if not report.errors else 1

    if args.baseline:
        from r2d2_tpu_torch.analysis import baseline as bl

        try:
            base = bl.load(args.baseline)
        except (OSError, ValueError, KeyError) as e:
            print(f"graftlint: cannot load baseline: {e}",
                  file=sys.stderr)
            return 1
        problems = bl.diff(base, report)
        for f in report.errors:
            print(f.format())
        for line in problems:
            print(line)
        print(f"graftlint: {len(problems)} drift line(s) vs baseline "
              f"{args.baseline}, {len(report.errors)} parse error(s) "
              f"across {report.files} files")
        return 0 if not problems and not report.errors else 1

    if args.as_json:
        print(json.dumps(report.to_dict(), indent=1))
    else:
        for f in report.errors + report.findings:
            print(f.format())
        print(f"graftlint: {len(report.findings)} finding(s), "
              f"{len(report.suppressed)} suppressed, "
              f"{len(report.errors)} parse error(s) across "
              f"{report.files} files "
              f"[rules: {', '.join(report.rules)}]")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
