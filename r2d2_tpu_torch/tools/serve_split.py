"""Where the session server's batch loop spends its time under the load
generator, with the act replayed from its CUDA graphs and with the same
act issued eagerly.

One cell of ``tools/session_load_gen.py`` (the flagship geometry, the
``bfloat16`` params cell by default, 256 sessions over 8 client workers
in this process, at most 192 live, both session chaos sites armed as
chip_smoke.py's phase 15 arms them, 20 steps and 20 ms of think time a
session on average, the load generator's defaults) runs once per mode,
in turns (graphed, eager, eager, graphed for ``--rounds 2``).  The eager mode
swaps the batcher's act for a ``functional_call`` of its module on the
published params, as chip_smoke.py's phase 4 does; nothing else changes.
Timers wrap the server's pieces from outside:

- ``turn``: one ``serve_once`` that served a batch (wall and the batch
  loop thread's CPU time), and the idle turns;
- ``gather``, ``act``, ``scatter``: the server's own spans;
- inside ``act``: the put of the padded rows, the act call, and the rest
  (the concatenation and the one fetch of ``(q, new hidden)``);
- inside the graphed act call: the param adoption, the wait to enter
  ``PROFILER_LOCK`` and the graph's launch inside it.

Each run prints one JSON line: per batch the mean of each piece in ms,
the batches and their mean size, the batch loop's busy share, the
process's CPU use in cores, and the clients' acts/s and act p50/p99.

    python -m r2d2_tpu_torch.tools.serve_split [--rounds 2] \\
        [--cell bfloat16] [--chaos SPEC] [--seconds 5] [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from collections import defaultdict

A = 9  # the load generator's head (MsPacman's action count)
CHAOS = ("kill_session_client:every=50,n=6;"
         "slow_session_client:every=40,dur=1.0,n=4")


class _Clock:
    """Per-piece wall-clock totals, each piece counted per call."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    def add(self, name: str, dt: float) -> None:
        self.total[name] += dt
        self.count[name] += 1

    @contextlib.contextmanager
    def timed(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def wrap(self, name: str, fn):
        def timed_fn(*a, **k):
            with self.timed(name):
                return fn(*a, **k)
        return timed_fn


def _instrument(server, clock: _Clock):
    """Wrap the server's, the batcher's and the act's pieces with
    ``clock``; returns the undo."""
    from r2d2_tpu_torch.actor import GraphedAct
    from r2d2_tpu_torch.serving import batcher as batcher_mod
    from r2d2_tpu_torch.utils import graphs as graphs_mod

    real_span = server.tracer.span
    real_serve = server.serve_once
    real_put = batcher_mod._Bucket.put
    real_adopt = GraphedAct.adopt
    real_gate = graphs_mod.PROFILER_LOCK
    batcher = server.batcher
    real_run = batcher._run

    @contextlib.contextmanager
    def span(name):
        with clock.timed(name), real_span(name):
            yield

    def serve_once(*a, **k):
        t0, c0 = time.perf_counter(), time.thread_time()
        n = real_serve(*a, **k)
        key = "turn" if n else "idle_turn"
        clock.add(key, time.perf_counter() - t0)
        clock.add(key + "_cpu", time.thread_time() - c0)
        return n

    class Gate:
        @contextlib.contextmanager
        def shared(self):
            t0 = time.perf_counter()
            with real_gate.shared():
                clock.add("gate_wait", time.perf_counter() - t0)
                with clock.timed("launch"):
                    yield

        def exclusive(self):
            return real_gate.exclusive()

    def act_call(*a, **k):
        with clock.timed("act_call"):
            return batcher._act_inner(*a, **k)

    server.tracer.span = span
    server.serve_once = serve_once
    batcher_mod._Bucket.put = clock.wrap("put", real_put)
    GraphedAct.adopt = clock.wrap("adopt", real_adopt)
    graphs_mod.PROFILER_LOCK = Gate()
    batcher._run = clock.wrap("run", real_run)
    batcher._act_inner, batcher._act = batcher._act, act_call

    def undo():
        server.tracer.span = real_span
        server.serve_once = real_serve
        batcher_mod._Bucket.put = real_put
        GraphedAct.adopt = real_adopt
        graphs_mod.PROFILER_LOCK = real_gate
        batcher._run = real_run
        batcher._act = batcher._act_inner

    return undo


def run_cell(mode: str, cell: str, seconds: float, chaos_spec: str,
             seed: int, device: str = "cuda") -> dict:
    """One load-generator run of ``cell`` with the act ``mode`` ("graphed"
    or "eager"); the split per batch."""
    import torch
    from torch.func import functional_call

    from r2d2_tpu_torch.models.network import create_network
    from r2d2_tpu_torch.serving.server import SessionServer
    from r2d2_tpu_torch.tools import session_load_gen as slg
    from r2d2_tpu_torch.utils.chaos import ChaosInjector

    cfg = slg.cell_config(cell, 64, 192)
    net = create_network(cfg, A, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    server = SessionServer(cfg, A, device=torch.device(device))
    server.publish_params(net.state_dict())
    server.warmup()
    batcher = server.batcher
    if mode == "eager":
        def eager(params, *x):
            with torch.inference_mode():
                return functional_call(batcher.net, params, x)
        batcher._act = eager
    clock = _Clock()
    undo = _instrument(server, clock)
    server.start()
    cpu0, t0 = os.times(), time.perf_counter()
    try:
        load = slg.run_load(
            cfg, A, server.host, server.port, sessions=256, workers=8,
            steps_mean=20, think_s=0.02, run_seconds=seconds, seed=seed,
            chaos=ChaosInjector(chaos_spec, seed=seed) if chaos_spec
            else None)
        stats = server.stats()
    finally:
        wall = time.perf_counter() - t0
        cpu1 = os.times()
        server.stop()
        server.close()
        undo()
    batches = max(clock.count["turn"], 1)

    def per_batch(name):
        return round(clock.total[name] / batches * 1e3, 4)

    split = {k: per_batch(k) for k in (
        "turn", "turn_cpu", "serving.gather", "serving.act", "put",
        "act_call", "adopt", "gate_wait", "launch", "serving.scatter")}
    split["cat_fetch"] = round(per_batch("run") - split["put"]
                               - split["act_call"], 4)
    busy = clock.total["turn"] + clock.total["idle_turn"]
    return dict(
        mode=mode, cell=cell, chaos=chaos_spec, batches=stats["batches"],
        mean_batch=stats["mean_batch"],
        idle_turns=clock.count["idle_turn"],
        busy_share=round(clock.total["turn"] / busy, 4) if busy else 0.0,
        process_cores=round(((cpu1.user + cpu1.system)
                             - (cpu0.user + cpu0.system)) / wall, 3),
        acts_per_sec=load["acts_per_sec"], act_p50_ms=load.get("act_p50_ms"),
        act_p99_ms=load.get("act_p99_ms"), kills=load["kills"],
        slow=load["slow"], ms_per_batch=split)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2,
                    help="graphed, eager, eager, graphed per two rounds")
    ap.add_argument("--cell", default="bfloat16")
    ap.add_argument("--chaos", default=CHAOS,
                    help="session chaos spec ('' for none)")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the server acts (on the CPU both modes "
                         "run eagerly: a dry run of the script)")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serve_split needs a CUDA device")
    order = []
    for r in range(args.rounds):
        order += ["graphed", "eager"] if r % 2 == 0 else ["eager", "graphed"]
    for mode in order:
        print(json.dumps(run_cell(mode, args.cell, args.seconds,
                                  args.chaos, args.seed, args.device)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
