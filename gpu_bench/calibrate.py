"""Readings that the check's limits are set from: for each seed, one short
run of a cell with the check's numbers (the lower readings), the
control's — the reference in fp8 put in the port's place — and those of
two faults planted in the reference put in the port's place, a batch
with half its rows and acts whose lane 0 answers with lane 1's (upper
readings).

    python3 gpu_bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds 2

Each seed runs in a process of its own and prints one JSON line; the
last line gives, for each number, the largest reading of the port and
the smallest of the control and of each fault.  The benchmark's own runs
never run this."""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(workload: str, seed: int, seconds: float) -> int:
    sys.path.insert(0, ROOT)
    from gpu_bench import run as run_mod

    run_mod._caches()
    import torch

    from gpu_bench import cells
    from gpu_bench.harness import run_loaded

    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 2
    res = run_loaded(cells.load_cell(workload), seed, seconds, False,
                     extra=True, t_start=time.perf_counter())
    print(json.dumps(dict(seed=seed, correct=res["correct"],
                          setup_s=res["e2e"]["setup_s"],
                          forbidden=run_mod.forbidden_modules(),
                          **res["calibration"])), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    if len(seeds) == 1:
        return one(args.workload, seeds[0], args.seconds)
    rows = []
    for seed in seeds:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--workload",
             args.workload, "--seeds", str(seed), "--seconds",
             str(args.seconds)], capture_output=True, text=True)
        if out.returncode != 0:
            print(f"seed {seed}: exit {out.returncode}\n"
                  f"{out.stderr[-3000:]}", flush=True)
            continue
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        rows.append(json.loads(line))
    if not rows:
        return 1
    summary = {}
    for n in rows[0]["program"]:
        summary[n] = dict(program_max=max(r["program"][n] for r in rows))
        for side in ("control", "half_batch", "swapped_act"):
            got = [r[side][n] for r in rows if n in r[side]]
            if got:
                summary[n][side + "_min"] = min(got)
    print(json.dumps(dict(workload=args.workload, seeds=len(rows),
                          summary=summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
