"""Baseline-file mode: a versioned findings+suppressions snapshot.

``python -m r2d2_tpu_torch.analysis --baseline GRAFTLINT_TORCH_BASELINE.json``
checks the live report against the committed snapshot and exits 1 with
a diff on any drift; ``--write-baseline`` regenerates it.  The snapshot
pins, per ``(path, rule)``:

- every **suppression** in the tree with its count and the ``-- reason``
  texts (so the pinned set can only grow when a reason is recorded and
  the baseline is deliberately regenerated in the same commit), and
- every **live finding** (normally the empty list — a non-empty
  findings section means the tree was baselined dirty, which the check
  output calls out loudly).

Findings are matched on ``(path, rule, message)`` — not line numbers,
which drift with every unrelated edit; rule messages carry enough
identity (variable names, callee, finding-code prefix).  The check is
exact in both directions: a *stale* baseline entry (suppression removed
from the tree but not from the snapshot) fails too, so the committed
file can never over-claim what the tree actually suppresses.

tests/test_torch_analysis.py's gate reads this file instead of a
hand-edited literal set.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

from r2d2_tpu_torch.analysis.core import Report

BASELINE_VERSION = 1


def snapshot(report: Report) -> dict:
    sup: Dict[Tuple[str, str], dict] = {}
    for f in report.suppressed:
        e = sup.setdefault((f.path, f.rule), {"count": 0, "reasons": []})
        e["count"] += 1
        if f.reason and f.reason not in e["reasons"]:
            e["reasons"].append(f.reason)
    return {
        "version": BASELINE_VERSION,
        "findings": sorted(
            ({"path": f.path, "rule": f.rule, "message": f.message}
             for f in report.findings),
            key=lambda d: (d["path"], d["rule"], d["message"])),
        "suppressions": [
            {"path": p, "rule": r, "count": e["count"],
             "reasons": sorted(e["reasons"])}
            for (p, r), e in sorted(sup.items())],
    }


def write(path: str, report: Report) -> None:
    Path(path).write_text(json.dumps(snapshot(report), indent=1) + "\n")


def load(path: str) -> dict:
    data = json.loads(Path(path).read_text())
    ver = data.get("version")
    if ver != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path}: version {ver!r}, expected "
            f"{BASELINE_VERSION} — regenerate with --write-baseline")
    return data


def diff(baseline: dict, report: Report) -> List[str]:
    """Human-readable drift lines; empty means the tree matches."""
    problems: List[str] = []

    base_f = {(f["path"], f["rule"], f["message"])
              for f in baseline.get("findings", [])}
    live_f = {(f.path, f.rule, f.message) for f in report.findings}
    for p, r, m in sorted(live_f - base_f):
        problems.append(f"new finding not in baseline: {p}: [{r}] {m}")
    for p, r, m in sorted(base_f - live_f):
        problems.append(f"stale baseline finding (fixed in tree — "
                        f"regenerate): {p}: [{r}] {m}")

    base_s = {(s["path"], s["rule"]): s
              for s in baseline.get("suppressions", [])}
    live_s: Dict[Tuple[str, str], int] = {}
    for f in report.suppressed:
        k = (f.path, f.rule)
        live_s[k] = live_s.get(k, 0) + 1
    for k in sorted(set(live_s) - set(base_s)):
        problems.append(
            f"new suppression not in baseline: {k[0]} [{k[1]}] — record "
            f"a '-- reason' and regenerate with --write-baseline")
    for k in sorted(set(base_s) - set(live_s)):
        problems.append(
            f"stale baseline suppression (removed from tree — "
            f"regenerate): {k[0]} [{k[1]}]")
    for k in sorted(set(base_s) & set(live_s)):
        if base_s[k]["count"] != live_s[k]:
            problems.append(
                f"suppression count drift: {k[0]} [{k[1]}] baseline "
                f"{base_s[k]['count']}, tree {live_s[k]} — regenerate "
                f"with --write-baseline (reasons required)")
    return problems
