"""Single-card benchmark: learner step, actor plane, and the full system.

Port of ``r2d2_tpu/bench.py``: three measurements on the CUDA device.

1. **Learner micro-bench** — the R2D2 train step on the flagship config
   (Nature torso, LSTM-512, batch 64, T=85, bf16 — reference scale knobs,
   config.py:7,27-33) with a pre-staged device batch, plain and with
   ``fused_double_unroll``.  This is the compute ceiling.  The FLOPs of
   one step, counted by ``torch.utils.flop_counter.FlopCounterMode``,
   ground it in hardware terms (``achieved_tflops``, ``mfu``).  That
   counter counts matrix products and convolutions only (forward and
   backward), so it is not XLA's ``cost_analysis`` count, which the JAX
   package reports: the elementwise work of the cell, the loss and Adam is
   left out.
2. **Actor-plane bench** — a 64-lane ``VectorActor`` (pong preset scale,
   BASELINE configs[1]) stepping fake envs with batched inference on the
   card, and the same workload through the process fleets
   (``parallel/actor_procs.py``) in local and serve mode.
3. **System bench** — the full threaded fabric (``train.train``: actors →
   replay → sampling → learner, priority feedback) on fake envs for a
   fixed wall budget, host-sampled and with ``in_graph_per``; reports
   steady-state ``updates/s × batch × learning_steps`` and the busiest
   tracer spans so the bottleneck is named, not guessed.

``python -m r2d2_tpu_torch bench`` runs every phase in its own bounded
subprocess (:func:`_main_isolated`) and prints ONE JSON line; the headline
metric stays ``learner_env_frames_per_sec`` (vs the 50k frames/s north
star), with the system/actor/MFU numbers as additional fields.  The parent
never initialises CUDA: a bounded child probes the card first.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

import numpy as np

from r2d2_tpu_torch.utils.batch import synthetic_batch as make_batch

NORTH_STAR_FPS = 50_000.0

# dense bf16 tensor-core peak TFLOPS by torch.cuda.get_device_name()
# prefix, for MFU: NVIDIA's H100 Tensor Core GPU data sheet, H100 SXM
# column, BF16 Tensor Core 1,979 TFLOPS with sparsity, so 989 dense.  The
# SXM part reports this name; another card gets no MFU
_PEAK_TFLOPS = (
    ("NVIDIA H100 80GB HBM3", 989.0),
)

# the flagship system-bench cell (the learning presets' knobs); shared by
# both bench entry paths so they always measure the same fabric
FLAGSHIP_SYSTEM_KNOBS = dict(device_replay=True, superstep_k=4,
                             superstep_pipeline=2, num_actors=64,
                             env_workers=0)

# the actor-plane phases, in the order the isolated driver runs them:
# (label, --knobs for the "actor" phase)
ACTOR_CELLS = (("actor", {}),
               ("actor_process", dict(transport="process",
                                      actor_inference="local")),
               ("actor_process_serve", dict(transport="process",
                                            actor_inference="serve")))


def _peak_tflops(kind: str) -> float:
    for prefix, peak in _PEAK_TFLOPS:
        if kind.startswith(prefix):
            return peak
    return 0.0


def _learner_micro_bench(steps: int, warmup: int, fused: bool = False):
    """(frames/s, steps/s, flops_per_step) for the flagship step on the
    CUDA device.

    ``fused=True`` times the same step with ``fused_double_unroll`` — the
    single double-batch online+target unroll (learner/step.py) — so the
    feature's value is a measured train-step cell."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.learner.step import create_train_state, make_train_step
    from r2d2_tpu_torch.models.network import create_network

    device = torch.device("cuda", torch.cuda.current_device())
    cfg = Config(fused_double_unroll=fused)
    action_dim = 9  # MsPacman minimal action set
    net = create_network(cfg, action_dim, device=device,
                         generator=torch.Generator().manual_seed(0))
    state = create_train_state(cfg, dict(net.state_dict()))
    step_fn = make_train_step(cfg, net)

    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in make_batch(cfg, action_dim, rng).items()}

    # one counted step (it also warms up): matmuls and convolutions of
    # the forward and backward passes
    counter = FlopCounterMode(display=False)
    with counter:
        state, loss, _ = step_fn(state, batch)
    flops = float(counter.get_total_flops())
    for _ in range(warmup):
        state, loss, _ = step_fn(state, batch)
    torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss, _ = step_fn(state, batch)
    final_loss = float(loss)      # waits for the last step
    dt = time.perf_counter() - t0
    if not np.isfinite(final_loss):
        raise RuntimeError(f"non-finite loss {final_loss}")

    steps_per_sec = steps / dt
    frames_per_sec = cfg.batch_size * cfg.learning_steps * steps_per_sec
    return frames_per_sec, steps_per_sec, flops


def _actor_plane_bench(iterations: int = 400, num_lanes: int = 64,
                       env_workers: Optional[int] = None,
                       act_device: Optional[str] = None,
                       fleets: int = 1):
    """env-frames/s of a pong-scale lockstep fleet on fake envs.

    ``env_workers``/``act_device``/``fleets`` override the preset: the
    env-stepping pool width, where acting runs, and the number of
    independent lockstep fleets (lanes split contiguously, each fleet its
    own thread and its own copy of the network — exactly train.py's
    actor_fleets split)."""
    import copy
    import threading

    import torch

    from r2d2_tpu_torch.actor import (
        VectorActor,
        _resolve_act_device,
        make_host_act_fn,
    )
    from r2d2_tpu_torch.config import pong_config
    from r2d2_tpu_torch.envs.fake import FakeAtariEnv
    from r2d2_tpu_torch.models.network import create_network
    from r2d2_tpu_torch.utils.math import epsilon_ladder
    from r2d2_tpu_torch.utils.store import ParamStore

    over = {}
    if env_workers is not None:
        over["env_workers"] = env_workers
    if act_device is not None:
        over["act_device"] = act_device
    cfg = pong_config(game_name="Fake", num_actors=num_lanes, **over)
    device = _resolve_act_device(cfg.act_device)
    net = create_network(cfg, 4, device=device,
                         generator=torch.Generator().manual_seed(0))
    store = ParamStore({k: v.detach().clone()
                        for k, v in net.state_dict().items()})
    per = num_lanes // fleets
    actors = []
    for f in range(fleets):
        lanes = range(f * per, (f + 1) * per)
        envs = [FakeAtariEnv(obs_shape=cfg.stored_obs_shape, action_dim=4,
                             seed=i, episode_len=500) for i in lanes]
        eps = [epsilon_ladder(i, num_lanes) for i in lanes]
        act_fn = make_host_act_fn(net if f == 0 else copy.deepcopy(net))
        actors.append(VectorActor(cfg, envs, eps, act_fn, store,
                                  sink=lambda b, p, r: None,
                                  rng=np.random.default_rng(1 + f)))
    for a in actors:
        a.run(max_steps=20)  # warmup: build the kernel, prime the pools
    # bare Threads by design: bounded measurement workers, started and
    # joined inside this one timed window — a Supervisor restart would
    # silently rerun part of the workload and corrupt the timing
    threads = [threading.Thread(target=a.run,  # graftlint: disable=thread-discipline -- bounded, joined below; a restart would corrupt the measurement
                                kwargs=dict(max_steps=iterations))
               for a in actors[1:]]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    actors[0].run(max_steps=iterations)
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    for a in actors:
        a.close()
    return fleets * per * iterations / dt


def _bench_env_factory(cfg, seed):
    """Module-level (picklable) fake-env factory: the process-transport
    bench's spawn children unpickle it by reference."""
    from r2d2_tpu_torch.envs.fake import FakeAtariEnv

    return FakeAtariEnv(obs_shape=cfg.stored_obs_shape, action_dim=4,
                        seed=seed, episode_len=500)


def _actor_plane_bench_process(num_lanes: int = 64, fleets: int = 2,
                               env_workers: int = 0,
                               budget_s: float = 300.0,
                               actor_inference: str = "local"):
    """env-frames/s of the PROCESS-fleet actor plane on fake envs — the
    same pong-scale workload as :func:`_actor_plane_bench`, through
    ``parallel/actor_procs`` instead of in-process threads.
    ``actor_inference="serve"`` measures the centralized InferenceService
    path (fleets RPC a trainer-side act server on the card that batches
    across all of them), driven here by a supervised serve loop standing
    in for the fabric's ``inference_serve``.

    The trainer only observes block-granular arrivals, and a lockstep
    fleet cuts ALL its lanes' blocks in the same iteration — arrivals are
    periodic BURSTS (alternating 400-step boundary cuts and
    episode-truncation cuts at the fake env's 500-step episodes), so a
    fixed wall window aliases against the burst phase.  Instead, per
    fleet, frames are timed from the start of burst 0 to the start of
    burst 2 — one full cut cycle — which is phase-exact; the fleet rates
    sum to the plane rate.  Bursts are identified by COUNT (every burst is
    exactly one block per lane), so the alignment holds at any host speed.
    Children's start-up happens before their first burst and is never
    charged."""
    import threading

    import torch

    from r2d2_tpu_torch.actor import _resolve_act_device
    from r2d2_tpu_torch.config import pong_config
    from r2d2_tpu_torch.models.network import create_network
    from r2d2_tpu_torch.parallel.actor_procs import ProcessFleetPlane
    from r2d2_tpu_torch.utils.math import epsilon_ladder
    from r2d2_tpu_torch.utils.store import ParamStore
    from r2d2_tpu_torch.utils.supervisor import Supervisor

    cfg = pong_config(game_name="Fake", num_actors=num_lanes,
                      env_workers=env_workers, actor_fleets=fleets,
                      actor_transport="process",
                      actor_inference=actor_inference)
    device = _resolve_act_device(cfg.act_device)
    net = create_network(cfg, 4, device=device,
                         generator=torch.Generator().manual_seed(0))
    store = ParamStore({k: v.detach().clone()
                        for k, v in net.state_dict().items()})
    eps = [epsilon_ladder(i, num_lanes) for i in range(num_lanes)]
    plane = ProcessFleetPlane(cfg, 4, _bench_env_factory, eps)
    F = plane.num_fleets
    serve_stop = threading.Event()
    # serve_once is re-enterable (pending requests live in service
    # state), so a crash restarts cleanly instead of wedging every
    # blocked fleet — the discipline train() gives the real loop
    serve_sup = Supervisor(max_restarts=3) if plane.service else None

    def _serve_loop():
        while not serve_stop.is_set():
            plane.service.serve_once()

    # a burst = one block per lane, so burst k starts at event index k*L
    lanes = [spec.hi - spec.lo for spec in plane.specs]
    need = [2 * L + 1 for L in lanes]     # through burst 2's first block
    events = [[] for _ in range(F)]       # per fleet: (t, frames)

    def noop_sink(block, prios, episode_reward):
        pass

    try:
        plane.start(store)
        if serve_sup is not None:
            serve_sup.start("bench_serve", _serve_loop)
        deadline = time.time() + budget_s
        while (time.time() < deadline
               and any(len(ev) < n for ev, n in zip(events, need))):
            got = plane.ingest_once(noop_sink, timeout=0.2)
            if got is None:
                continue
            src, n = got
            events[src].append((time.perf_counter(), n))
    finally:
        # stop and JOIN the serve thread BEFORE plane.shutdown closes the
        # act channels: a mid-iteration serve_once still holds slab views
        serve_stop.set()
        if serve_sup is not None:
            serve_sup.join_all(10)
        plane.shutdown()

    rate = 0.0
    for src in range(F):
        ev, L = events[src], lanes[src]
        if len(ev) < need[src]:
            raise RuntimeError(
                f"fleet{src} produced {len(ev)}/{need[src]} blocks in "
                f"{budget_s:.0f} s; need one full cut cycle for a "
                "phase-exact window")
        frames = sum(n for _, n in ev[0:2 * L])
        rate += frames / (ev[2 * L][0] - ev[0][0])
    return rate


def _system_bench(wall_seconds: float, *, device_replay: bool = True,
                  superstep_k: int = 4, num_actors: int = 64,
                  env_workers: int = 0, superstep_pipeline: int = 2,
                  in_graph_per: bool = False):
    """Steady-state env-frames/s of the full threaded fabric on fake envs.

    Returns (frames/s, top_spans, num_updates) where top_spans names the
    busiest tracer stages (the measured bottleneck)."""
    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.train import train

    cfg = Config().replace(
        game_name="Fake",
        num_actors=num_actors,
        env_workers=env_workers,
        buffer_capacity=200_000,   # 500-block ring ≈ 1.6 GB on the card
        learning_starts=10_000,
        training_steps=1_000_000_000,  # wall-clock bound, not step bound
        log_interval=5.0,
        save_interval=1_000_000_000,
        device_replay=device_replay,  # device-resident ring + gather
        superstep_k=superstep_k,      # optimizer steps per dispatch — the
                                      # learning presets' value
        in_graph_per=in_graph_per,    # device-resident PER: no host round
                                      # trips on the training path
        superstep_pipeline=superstep_pipeline,  # dispatches in flight
    )
    metrics = train(cfg, max_wall_seconds=wall_seconds, verbose=False)

    # steady state: median updates/s over the logged entries after the
    # buffer reached learning_starts (those report nonzero rates)
    rates = [e["updates_per_sec"] for e in metrics.get("logs", [])
             if e["updates_per_sec"] > 0]
    ups = float(np.median(rates[-6:])) if rates else 0.0
    frames_per_sec = ups * cfg.batch_size * cfg.learning_steps

    trace = metrics.get("trace", {})
    spans = sorted(
        ((name[len("span."):-len(".mean_ms")],
          trace[name] * trace.get(name.replace(".mean_ms", ".count"), 0))
         for name in trace if name.endswith(".mean_ms")),
        key=lambda kv: -kv[1])
    top_spans = {name: round(total_ms, 1) for name, total_ms in spans[:5]}
    return frames_per_sec, top_spans, metrics.get("num_updates", 0)


# the probe child: brings up a CUDA context and runs one op on the card
_PROBE = ("import torch; torch.zeros(1, device='cuda').add_(1); "
          "torch.cuda.synchronize(); print(torch.cuda.get_device_name(0))")


def _device_probe(timeout_s: float = 240.0):
    """Check the card answers at all, from a bounded subprocess.

    A child that cannot bring up a CUDA context (no card, a broken driver,
    a wedged device) is turned into a parseable artifact line instead of a
    silent hang with no JSON at all, and the parent never initialises
    CUDA itself.  Returns ``(ok, reason)`` — reason distinguishes a
    timeout from a fast failure and carries the child's stderr tail."""
    import subprocess

    try:
        proc = subprocess.Popen([sys.executable, "-c", _PROBE],
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE)
        try:
            _, err = proc.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            try:
                # bounded reap: a child wedged in an uninterruptible
                # driver call may be unkillable — leak it rather than hang
                proc.communicate(timeout=10.0)
            except subprocess.TimeoutExpired:
                pass
            return False, "device probe timed out"
        if proc.returncode == 0:
            return True, ""
        tail = (err or b"").decode(errors="replace").strip().splitlines()
        return False, (f"device probe failed (rc={proc.returncode}): "
                       + " | ".join(tail[-3:]))
    except OSError as e:
        return False, f"device probe error: {type(e).__name__}: {e}"


def _run_phase(phase: str, timeout_s: float, extra=(), label=None):
    """Run one bench phase as a bounded subprocess; (result_dict, reason).

    A wedged phase is killed at ``timeout_s`` and reported, instead of
    hanging the whole bench run with no artifact.  Phases run strictly one
    at a time, so each has the card to itself."""
    import subprocess

    label = label or phase
    cmd = [sys.executable, "-m", "r2d2_tpu_torch.bench", "--phase", phase,
           *map(str, extra)]
    # run from a source tree, not installed: the child can only import
    # r2d2_tpu_torch with the repo root as cwd
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, cwd=repo_root)
        try:
            out, err = proc.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            try:
                proc.communicate(timeout=10.0)  # bounded reap
            except subprocess.TimeoutExpired:
                pass
            return None, (f"{label} phase wedged (no result after "
                          f"{timeout_s:.0f}s; child killed)")
    except OSError as e:
        return None, f"{label} phase spawn error: {type(e).__name__}: {e}"
    tail = (err or b"").decode(errors="replace").strip().splitlines()
    if proc.returncode != 0:
        return None, (f"{label} phase failed (rc={proc.returncode}): "
                      + " | ".join(tail[-3:]))
    for line in reversed((out or b"").decode(errors="replace").splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line), ""
            except ValueError:
                break
    return None, f"{label} phase emitted no JSON: " + " | ".join(tail[-3:])


def _phase_main(argv) -> int:
    """Child entry for one isolated phase; prints ONE JSON line."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--phase", required=True,
                   choices=("micro", "actor", "system"))
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--seconds", type=float, default=75.0)
    p.add_argument("--knobs", type=str, default="{}")
    p.add_argument("--fused", action="store_true")
    a = p.parse_args(argv)
    knobs = json.loads(a.knobs)

    if a.phase == "micro":
        import torch

        fps, sps, flops = _learner_micro_bench(a.steps, a.warmup,
                                               fused=a.fused)
        out = dict(learner_fps=fps, steps_per_sec=sps, flops=flops,
                   platform="gpu",
                   device_kind=torch.cuda.get_device_name(0))
    elif a.phase == "actor":
        if knobs.pop("transport", "thread") == "process":
            out = dict(actor_fps=_actor_plane_bench_process(**knobs))
        else:
            out = dict(actor_fps=_actor_plane_bench(**knobs))
    else:
        fps, spans, ups = _system_bench(a.seconds, **knobs)
        out = dict(system_fps=fps, top_spans=spans, updates=ups)
    print(json.dumps(out), flush=True)
    return 0


def _main_isolated(steps: int, warmup: int, system_seconds: float) -> None:
    """The bench as ``python -m r2d2_tpu_torch bench`` runs it: every phase
    in its own bounded subprocess.

    Ordering is by evidential value: the headline learner micro first (a
    later failure can no longer zero it), then the system fabric, then the
    actor planes.  The parent composes the one-line JSON and never
    initialises CUDA itself."""
    ok, reason = _device_probe()
    if not ok:
        _print_unreachable_artifact(reason)
        sys.exit(1)

    system_knobs = dict(FLAGSHIP_SYSTEM_KNOBS)
    ig_knobs = dict(FLAGSHIP_SYSTEM_KNOBS, in_graph_per=True)
    # build slack + 1 s/step: a deliberately long run must not be
    # misreported as a wedge
    micro, m_err = _run_phase("micro", 900.0 + (steps + warmup) * 1.0,
                              ("--steps", steps, "--warmup", warmup))
    micro_fused, mf_err = _run_phase(
        "micro", 900.0 + (steps + warmup) * 1.0,
        ("--steps", steps, "--warmup", warmup, "--fused"),
        label="micro_fused")
    system, s_err = _run_phase(
        "system", system_seconds + 900.0,
        ("--seconds", system_seconds, "--knobs", json.dumps(system_knobs)))
    system_ig, ig_err = _run_phase(
        "system", system_seconds + 900.0,
        ("--seconds", system_seconds, "--knobs", json.dumps(ig_knobs)),
        label="system_ingraph")
    actors = {label: _run_phase("actor", 600.0,
                                ("--knobs", json.dumps(knobs)), label=label)
              for label, knobs in ACTOR_CELLS}

    def fps(res, key):
        return round(res[key], 1) if res else -1.0

    result = {
        "metric": "learner_env_frames_per_sec",
        "value": fps(micro, "learner_fps"),
        "unit": "frames/s",
        "vs_baseline": (round(micro["learner_fps"] / NORTH_STAR_FPS, 3)
                        if micro else -1.0),
        "system_env_frames_per_sec": fps(system, "system_fps"),
        "system_vs_baseline": (round(system["system_fps"] / NORTH_STAR_FPS,
                                     3) if system else -1.0),
        "system_knobs": system_knobs,
        "system_ingraph_env_frames_per_sec": fps(system_ig, "system_fps"),
        "learner_fused_env_frames_per_sec": fps(micro_fused, "learner_fps"),
        **{f"{label}_env_frames_per_sec": fps(res, "actor_fps")
           for label, (res, _) in actors.items()},
        "host_cpus": os.cpu_count() or 0,
    }
    errors = {k: v for k, v in (("micro", m_err), ("system", s_err),
                                ("micro_fused", mf_err),
                                ("system_ingraph", ig_err),
                                *((label, err) for label, (_, err)
                                  in actors.items())) if v}
    if errors:
        result["phase_errors"] = errors
    if micro and micro.get("flops", 0) > 0:
        achieved = micro["flops"] * micro["steps_per_sec"] / 1e12
        result["achieved_tflops"] = round(achieved, 2)
        peak = _peak_tflops(micro.get("device_kind", ""))
        if peak > 0:
            result["mfu"] = round(achieved / peak, 4)
    print(json.dumps(result))
    if micro:
        print(f"# platform={micro.get('platform')} "
              f"kind={micro.get('device_kind')} "
              f"learner_steps/s={micro['steps_per_sec']:.2f} "
              f"flops/step={micro['flops']:.3e} "
              f"system_updates={system['updates'] if system else -1} "
              "busiest_spans_total_ms="
              f"{json.dumps(system['top_spans'] if system else {})}",
              file=sys.stderr)
    if not micro:
        sys.exit(1)


def _print_unreachable_artifact(reason: str) -> None:
    print(json.dumps({
        "metric": "learner_env_frames_per_sec",
        "value": -1.0, "unit": "frames/s", "vs_baseline": -1.0,
        "error": f"accelerator backend unreachable ({reason})",
    }))


def _script_main(argv) -> int:
    """Shared script entry for ``python -m r2d2_tpu_torch.bench`` and
    ``python -m r2d2_tpu_torch bench`` — one place for the phase dispatch
    and the default steps/warmup/system_seconds.  (The JAX package also
    keeps an in-process ``main`` for its root ``bench.py`` shim; the port
    has no such shim, so every run goes through the isolated driver.)"""
    if "--phase" in argv:
        return _phase_main(argv)
    _main_isolated(steps=int(argv[0]) if argv else 100,
                   warmup=5, system_seconds=75.0)
    return 0


if __name__ == "__main__":
    sys.exit(_script_main(sys.argv[1:]))
