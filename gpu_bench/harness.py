"""One run of one cell: build the port's config from the cell's files,
make the weights, run ``r2d2_tpu_torch.train.train`` with the window's
tracer until the window closes, read the end-to-end metrics (and, traced,
the per-layer ones), then free the port's state and run the check.

The entry the window drives is the port's ``train()`` in every cell: the
threaded fabric (actors, replay, learner with priority feedback) or, for
``actor_transport="anakin"``, the fused loop.  A result is a
``learner.result_sync``: one update on host-staged batches, one
super-step (``superstep_k`` updates) otherwise."""
from __future__ import annotations

import gc
import importlib.util
import os
import statistics
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from gpu_bench import cells, check, peaks, trace_read
from gpu_bench.capture import Capture, act_sample, env_frames
from gpu_bench.weights import make_weights
from gpu_bench.window import WindowTracer

HERE = os.path.dirname(os.path.abspath(__file__))


class FakeEnvFactory:
    """The port's fake Atari-shaped env (``envs/fake.py``) with the
    traffic's episode length; a module-level class, so it pickles."""

    def __init__(self, episode_len: int, actions: int):
        self.episode_len, self.actions = episode_len, actions

    def __call__(self, cfg, seed: int):
        from r2d2_tpu_torch.envs import FakeAtariEnv

        return FakeAtariEnv(obs_shape=cfg.stored_obs_shape,
                            action_dim=self.actions,
                            episode_len=self.episode_len, seed=seed)


def _reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "gpu_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _arith(name: str):
    return importlib.import_module(f"gpu_bench.arith.{name}")


class Context:
    """What a per-layer reader reads: the run's config and sizes, the
    window (``tracer``, its ``seconds``, the updates and acts in it), the
    traced stretch's device operations and busy time, the configuration's
    arithmetic module and the card's peaks."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run_loaded(cell: Dict[str, Any], seed: int, seconds: float,
               trace: bool, device="cuda", extra: bool = False,
               t_start: Optional[float] = None) -> Dict[str, Any]:
    """Run ``cell`` (as :func:`cells.load_cell` returns it) once.  Returns
    the result line's fields plus ``checks``, and with ``extra`` the
    control's and the faults' readings under ``calibration``."""
    from r2d2_tpu_torch.train import train

    t_start = time.perf_counter() if t_start is None else t_start
    cfg = cells.build_config(cell, seed)
    traffic, own = cell["traffic_file"], cell["cell_file"]
    env = traffic["env"]
    arch = cells.arch_of(cfg, env["actions"])
    hyper = cells.hyper_of(cfg)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    weights = make_weights(arch, seed, dev)
    ck = own["check"]
    cap = Capture(weights, act_sample(seed, ck["acts"], 0, ck["act_window"]),
                  cfg.seqs_per_block)
    upr = cfg.superstep_k if cfg.device_replay else 1
    tracer = WindowTracer(seconds, lambda: cap.done,
                          setup_limit=traffic["setup_limit_s"],
                          profile=trace,
                          trace_seconds=traffic["trace_seconds"])
    learner_thread = threading.current_thread().name
    cap.install()
    try:
        out = train(cfg, env_factory=FakeEnvFactory(env["episode_len"],
                                                    env["actions"]),
                    tracer=tracer, stop_fn=tracer.stop, device=dev,
                    verbose=False)
    finally:
        cap.uninstall()
        tracer.finish()
    if tracer.t_open is None:
        raise RuntimeError(
            f"the window never opened: set-up passed "
            f"{traffic['setup_limit_s']} s (learner calls "
            f"{cap.learner_calls}, acts kept {len(cap.acts)} of "
            f"{len(cap.act_picks)}, acts {len(cap.act_log)})")
    fabric_ok = not out.get("fabric_failed") and not out.get(
        "learner_stalled")
    del out
    t0, t1 = tracer.t_open, tracer.t_open + seconds
    results = tracer.window_results()
    updates = upr * len(results)
    intervals = tracer.intervals()
    frames = env_frames(cap.act_log, t0, t1)
    e2e = dict(
        learner_frames_per_s=updates * cfg.batch_size * cfg.learning_steps
        / seconds,
        dispatch_ms_p90=(float(np.percentile(intervals, 90)) * 1e3
                         if intervals else None),
        env_frames_per_s=frames / seconds,
        setup_s=t0 - t_start)
    info = dict(results=len(results), intervals=len(intervals),
                dispatch_ms_median=(statistics.median(intervals) * 1e3
                                    if intervals else None),
                acts=sum(1 for t, _ in cap.act_log if t0 < t <= t1),
                dispatch_ms_quartiles=([q * 1e3 for q in statistics.quantiles(
                    intervals, n=4)] if len(intervals) > 1 else None),
                first_step_s=cap.t_first_step - t_start)
    device_info: Dict[str, Any] = dict(
        platform="gpu" if dev.type == "cuda" else dev.type,
        kind=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
              else "cpu"),
        count=1,
        memory_peak_bytes=(int(torch.cuda.max_memory_allocated(dev))
                           if dev.type == "cuda" else 0))
    ctx = None
    breakdown = None
    if trace:
        ctx, breakdown = _traced(tracer, cfg, arch, cell, cap, updates,
                                 seconds, learner_thread)
        device_info.update(busy_s=ctx.busy_s, window_s=ctx.window_s)
    # the port's state is freed before the reference runs: the peak above
    # is the port's alone
    tracer.profiler = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    got = check.readings(cap, weights, arch, hyper, ck["rows"], extra=extra)
    numbers = got["numbers"]
    ok, table = check.judge(numbers, own["limits"])
    info["readings"] = numbers
    res = dict(correct=bool(ok and fabric_ok), attempted=updates,
               failed=0 if fabric_ok else updates, e2e=e2e,
               device=device_info, checks=table, info=info,
               leaves_left_out=got["leaves_left_out"], fabric_ok=fabric_ok)
    if ctx is not None:
        res["per_layer"] = _per_layer(cell, ctx)
        res["breakdown"] = breakdown
    if extra:
        res["calibration"] = dict(program=numbers, control=got["control"],
                                  half_batch=got["half_batch"],
                                  swapped_act=got["swapped_act"],
                                  worst=got["worst"])
    return res


def _traced(tracer: WindowTracer, cfg, arch, cell, cap, updates, seconds,
            learner_thread):
    """The traced stretch's device record, and the breakdown."""
    a, b = tracer.t_prof
    offset = time.time_ns() - time.perf_counter_ns()
    t0_ns, t1_ns = int(a * 1e9) + offset, int(b * 1e9) + offset
    ops = trace_read.device_ops(tracer.profiler, t0_ns, t1_ns)
    busy = trace_read.busy_seconds(ops, t0_ns, t1_ns)
    spans = [(n, th, int(sa * 1e9) + offset, int(sb * 1e9) + offset)
             for n, th, sa, sb in tracer.host_spans]
    breakdown = dict(
        device_ops=trace_read.top_ops(ops, t0_ns, t1_ns),
        idle_gaps=trace_read.idle_gaps(ops, t0_ns, t1_ns, spans,
                                       learner_thread))
    t_open = tracer.t_open
    lanes = [n for _, n in cap.act_log]
    ctx = Context(cfg=cfg, arch=arch, tracer=tracer, seconds=seconds,
                  updates=updates,
                  acts_lanes=sum(n for t, n in cap.act_log
                                 if t_open < t <= t_open + seconds),
                  lanes_per_act=max(lanes) if lanes else 0,
                  ops=ops, t0_ns=t0_ns, t1_ns=t1_ns, busy_s=busy,
                  window_s=(t1_ns - t0_ns) / 1e9,
                  arith=_arith(cell["config_file"]["arith"]),
                  peaks=peaks, trace_read=trace_read)
    return ctx, breakdown


def _per_layer(cell, ctx) -> Dict[str, float]:
    out = {}
    for m in cells.metric_names(cell["bench"], "per_layer", cell["name"]):
        v = _reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = v
    return out
