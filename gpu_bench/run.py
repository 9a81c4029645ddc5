"""Run one cell of the PyTorch and CUDA port's benchmark on this machine.

    python3 gpu_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``gpu_bench/``
and the port (``r2d2_tpu_torch``).  The last line on standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` (with ``--trace 1`` also ``busy_s`` and
``window_s``), with ``--trace 1`` ``breakdown``, and last ``checks``:
every number the check compared beside its limit, which are also the
last lines on standard error.

Exits non-zero with no result when no CUDA card is visible or fewer than
the cell asks for, when the port cannot be imported, or when JAX or the
JAX package was loaded by the time the window closed.  Build and kernel
caches go to ``.bench_cache/`` in the checkout, at fixed paths."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "r2d2_tpu")


def _caches() -> None:
    os.environ["R2D2_TORCH_NATIVE_CACHE"] = os.path.join(CACHE, "native")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(cell: dict, res: dict, trace: bool) -> dict:
    from gpu_bench import cells

    if trace:
        specs = cells.metric_names(cell["bench"], "per_layer", cell["name"])
        values = res.get("per_layer", {})
    else:
        specs = cells.metric_names(cell["bench"], "end_to_end",
                                   cell["name"])
        values = res["e2e"]
    metrics = {m["name"]: dict(value=values[m["name"]], unit=m["unit"])
               for m in specs if values.get(m["name"]) is not None}
    line = dict(correct=res["correct"], attempted=res["attempted"],
                failed=res["failed"], metrics=metrics, device=res["device"])
    if trace:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    return line


def main(argv=None) -> int:
    args = _args(argv)
    _caches()
    sys.path.insert(0, ROOT)
    import torch

    from gpu_bench import cells, peaks
    from gpu_bench.harness import run_loaded

    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device is visible: nothing measured", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    res = run_loaded(cell, args.seed, args.seconds, bool(args.trace),
                     t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {found}", file=sys.stderr)
        return 3
    card = peaks.card()
    info = dict(res["info"], card=card, fabric_ok=res["fabric_ok"],
                leaves_left_out=res["leaves_left_out"],
                e2e=res["e2e"] if args.trace else None)
    print("run: " + json.dumps(info), file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result_line(cell, res, bool(args.trace))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
