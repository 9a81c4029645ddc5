#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``r2d2_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (each exits non-zero on failure):

1. device: require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them;
2. build: compile every kernel of the serving path from ``r2d2_tpu_torch/
   csrc`` (one ``nvcc`` per source, all at once) and print the seconds;
3. kernel vs plain: three designs against ``lstm_unroll_reference`` on
   the card, H=512, B in {1, 7, 8, 64, 65, 256} (65 crosses a 64-row tile;
   8 is the actor fleet's batch),
   T in {1, 85}, TF32 off: the tensor-core kernel (bf16 ``wh``, the main
   path), the CUDA-core kernel in float32 (the f32 route) and in bfloat16
   (the first design, kept for comparison).  Each step, taken from the
   kernel's own state, must match the plain step to 1e-5 max-abs in
   float32 and 1e-4 in bfloat16 (the operands are rounded at the same
   points, only the order of the f32 sums differs), the one-launch unroll
   must equal the chain of one-step launches bit for bit, and the whole
   unroll must match the plain unroll to 1e-5 in float32 and 1e-2 in
   bfloat16 (there a last-bit difference that crosses a bf16 rounding
   boundary of h moves the next operand by one bf16 ulp, and the
   recurrence carries it).  Then the tensor-core kernel's device time at
   each tile width n, and at (T, B) = (1, 1), (1, 8), (1, 32), (1, 64),
   (1, 256), (85, 64) in bf16, in ``ROUNDS`` rounds that take the designs in turns
   (forward, then backward): time per call with the launch (CUDA events),
   device time (``torch.profiler``) and the host's time to issue a call, of
   both kernels and the plain version, and of the layer step (``x @ wi +
   b`` then the kernel) against one library call for the same layer step
   (``torch.lstm_cell`` at T=1, cuDNN ``nn.LSTM`` at T=85, both in bf16,
   held to the plain layer to a loose ``LIB_TOL``); and the bound;
4. full-width serving: the flagship ``Config()`` (nature torso over
   84×84 frames space-to-depth folded, H=512, bfloat16 compute,
   ``serve_max_batch=256`` so 9 buckets, 9 actions) with seeded random
   params behind the port's ``SessionServer`` on 127.0.0.1.  A
   ``SessionClient`` opens 64 sessions and sends 4 act steps each (step 0
   resets) in groups of 1, 2, 5, 8, 16 and 32 sessions so that batches of
   different sizes form.  Checked: every reply is OK with finite q; each
   batch's rows are the sessions' requests and carry each session's
   hidden from its previous step (zeros after the reset); each batch's q
   matches a direct ``R2D2Network.act`` on the same card and params, with
   the plain LSTM in place of the kernel, to 2e-3 max-abs (the new hidden
   to 1e-4); the store's ``admitted == completed + reaped + evicted +
   live``; and the tensor-core kernel was launched once per batch and
   layer, the CUDA-core one never (counts reset just before the traffic).
   Prints the client-side p50/p99 act latency, and per act alone at n in
   {1, 32, 256} the host wall clock against the device time, in which the
   profiler must find the tensor-core kernel and not the CUDA-core one;
5. full-width training: ``train_sync(cfg, device="cuda")`` on the flagship
   ``Config(game_name="Fake")`` (nature torso on 21×21×16 frames, H=512,
   bf16 compute, batch 64, burn-in 40 + learning 40 + forward 5, 8 actors,
   blocks of 400) with only the replay size, warm-up and run length cut
   (printed on the ``reduced:`` line): 16 updates, a target sync at step 8,
   saves at 8 and 16, then 4 greedy evaluation episodes.  Checked: the
   tensor-core kernel launched once per layer for every actor iteration and
   evaluator step and the CUDA-core one never (counts reset just before
   the run); all 16 losses finite and all 16 priority feedbacks in the
   buffer; the target equal to the online params after step 8 and not
   after 7; the latest checkpoint restoring into a fresh learner bit for
   bit; a finite greedy return; the profiler finding the tensor-core
   kernel in an actor iteration and no LSTM kernel in a learner update;
   and one learner step at a reduced width (mlp torso, H=64) in bf16 on
   the card against float32 on the CPU (``STEP_LOSS_RTOL``,
   ``STEP_PRIO_ATOL``).  Prints env steps/s while filling, the learner
   update's wall clock, device time, idle share and top device ops, and
   the host and device time of an actor iteration;
6. the IMPALA-deep fabric at full width: ``impala_deep_config(game_name=
   "Fake")`` (the IMPALA residual CNN over raw 84×84 frames, two LSTM
   layers of H=512, batch 64, burn-in 40 + learning 75 + forward 5, blocks
   of 375, remat, bf16 compute, 8 actors) with only the replay size,
   warm-up and run length cut (the ``reduced:`` line), trained by the
   threaded ``train()`` in this (the main) thread for 24 updates, resumed
   warm to 28, then its checkpoint served by ``run_server`` in a worker
   thread to a client process (16 sessions × 4 steps).  Checked: 24
   updates and 24 priority feedbacks, no thread restarted, every loss
   finite; the kernel launched twice per actor act (one per layer), the
   CUDA-core one never; ``/healthz`` (``ok``) and ``/metrics`` answered on
   the run's ephemeral port; the JSONL run log and a complete ``step_24``
   replay snapshot on disk; the resume restores the replay and the actors
   (counters monotone) and ends at 28 updates; every served q within 2e-3
   of the plain-LSTM act of the same restored params; the store's
   accounting quadruple exact; two launches per served batch; the
   shutdown session snapshot's counters equal to the server's.  Prints env
   steps/s while filling and while training, updates/s and the update
   interval p50, the device time, idle share and top ops of one profiled
   update, an actor iteration's host/device time and the kernel's share,
   tensor-map encodes per act, the served act and client round trip
   p50/p99, and the phase's seconds;
7. the Pong preset from a device-resident replay ring:
   ``pong_config(game_name="Fake")`` at full width (nature torso on
   21×21×16 frames, one LSTM layer of H = 512, bf16, batch 64, burn-in 40
   + learning 40 + forward 5, 64 actors with 8 env workers,
   ``superstep_k=4``, ``superstep_pipeline=2``) with the full
   2 000 000-transition ring (15.80 GB) on the card, cut only in warm-up
   and run length (the ``reduced:`` line).  First, on the card: a ring of
   a few blocks at the full slot shapes, filled like a host
   ``ReplayBuffer``, gathers every ``sample_meta`` bundle bit for bit
   like the host ring's ``_gather_rows``; the in-graph sampler over the
   full ring's 50 000 leaves draws the same indices and ints as on the
   CPU for the same uniforms, weights within 1e-6; one host-sampled
   super-step equals k sequential train steps bit for bit (cuDNN
   deterministic for that check only).  Then ``train()`` on the main
   thread, 32 updates with ``in_graph_per=True`` and 16 with it off, under
   a wall budget.  Checked: the ring built on the card (no fallback
   warning, ``in_graph_per`` kept) with ``nbytes() == data_bytes``;
   updates k per dispatch and every loss finite; one ``learner.
   result_fetch`` per dispatch; dispatch puts under 10 KB per dispatch;
   k priority feedbacks per dispatch (host-sampled); the scatter changing
   only drawn leaves and every padding leaf still 0 (in-graph); the
   kernel launched once per act (one layer), the CUDA-core one never, and
   no LSTM kernel in a profiled super-step; the checkpoint at 16 written
   and no replay snapshot.  Prints env steps/s while filling and while
   training, the dispatch interval p50, the lock hold per in-graph
   dispatch, a profiled super-step's host wall clock, device time, idle
   share and top device ops, ring and peak GB, and the phase's seconds;
8. one ``{"kernels": [...]}`` JSON line;
9. last line: ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import multiprocessing
import os
import queue
import subprocess
import sys
import threading
import time

import numpy as np

H = 512
ACTION_DIM = 9
N_SESSIONS = 64
N_STEPS = 4
GROUPS = (1, 2, 5, 8, 16, 32)
F32_TOL = 1e-5
BF16_TOL = 1e-4
# a whole bf16 unroll compounds: where the kernel's and the plain h differ
# in the last f32 bits across a bf16 rounding boundary, the next step's
# operand differs by one bf16 ulp, and that carries through the recurrence
BF16_FREE_TOL = 1e-2
Q_TOL = 2e-3
# phase 3's shapes: B = 65 crosses a 64-row tile of the tensor-core kernel;
# B = 8 is the flagship actor fleet's lockstep batch (phase 5), B = 64 the
# Pong preset's one 64-lane fleet (phase 7)
CHECK_B = (1, 7, 8, 64, 65, 256)
TIMED = ((1, 1), (1, 8), (1, 32), (1, 64), (1, 256), (85, 64))
# rounds of the timing, each taking the designs in turns
ROUNDS = 4
# the flagship LSTM layer's input: torso features, last action, reward
IN_DIM = H + ACTION_DIM + 1
# the library yardstick runs in bf16 end to end (x @ wi, the gates, h and
# c all rounded to bf16 each step), the plain layer in f32 around a bf16
# product: a loose bound, far below the O(1) of a wrong gate order
LIB_TOL = {1: 6e-2, 85: 2.5e-1}
# the two designs' kernels, as the profiler names them
WGMMA_KERNEL = "lstm_step_wgmma"
CUDACORE_KERNEL = "lstm_step_cudacore"
# phase 5: the flagship Config(game_name="Fake") cut only in replay size,
# warm-up and run length, so that a target sync and two saves happen
TRAIN_REDUCED = dict(buffer_capacity=40_000, learning_starts=4_000,
                     training_steps=16, target_net_update_interval=8,
                     save_interval=8)
# the fake env's episodes: its default of 32 steps would fill each of the
# 100 ring slots with one 32-step block, 3 200 transitions in all, under
# learning_starts; 1 000-step episodes fill blocks to block_length (400)
FAKE_EPISODE_LEN = 1000
TRAIN_ACTIONS = 4
EVAL_EPISODES = 4
# the learner step in bf16 on the card against float32 on the CPU: bf16
# keeps 8 significant bits, so every dense/conv output and every h the
# scan feeds back is rounded by up to 2^-9 relative; a CPU rehearsal of the
# same comparison (bf16 CPU step vs f32 CPU step, this batch, these
# params) measured 4.8e-4 relative on the loss and 1.9e-3 max-abs on the
# priorities (max 1.17).  The bounds are 20x and 10x that; a wrong gate,
# window index or target is off by O(1)
STEP_LOSS_RTOL = 1e-2
STEP_PRIO_ATOL = 2e-2
STEP_H = 64
# phase 6: impala_deep_config(game_name="Fake") cut only in replay size
# (1 500 000 -> 37 500 transitions, 100 blocks), warm-up and run length;
# the exporter on an ephemeral port and a log entry a second, so that the
# run's /healthz and /metrics can be read while it trains
FABRIC_REDUCED = dict(buffer_capacity=37_500, learning_starts=3_750,
                      training_steps=24, target_net_update_interval=8,
                      save_interval=8, telemetry_port=-1, log_interval=1.0)
FABRIC_RESUME_STEPS = 28
# a wall budget that fails the phase rather than let a stuck fabric hang
FABRIC_WALL_S = 420
FABRIC_SESSIONS = 16
FABRIC_GROUPS = (1, 2, 5, 8)
# phase 7: pong_config(game_name="Fake") with its full ring on the card,
# cut only in warm-up (the first block of each of the 64 actors), run
# length (two runs: in-graph PER, then host-sampled) and the cadences
DEVICE_REDUCED = dict(learning_starts=25_600, target_net_update_interval=8,
                      save_interval=16)
DEVICE_RUNS = ((True, 32), (False, 16))    # (in_graph_per, updates)
DEVICE_WALL_S = 240
# a dispatch's H2D: the (k, B, 6) int32 bundle and (k, B) weights, 7 KB at
# k=4, B=64 — far below one batch's 38 MB of observations
DISPATCH_PUT_MAX_BYTES = 10_000
SAMPLER_W_RTOL = 1e-6
CHECK_RING_BLOCKS = 4
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, dense
# bf16 tensor-core FLOP/s, f32 FLOP/s outside the tensor cores
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bench_ms(torch, fn, reps: int = 15, iters: int = 20) -> float:
    """Median over ``reps`` of the mean time per call of ``iters``
    back-to-back calls, CUDA events around each run (launch overhead
    included: this is what a caller pays per call)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / iters)
    return float(np.median(times))


def host_us(torch, fn, iters: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the host's wall clock, in µs per call, to
    issue ``iters`` calls with no synchronisation among them: what the
    host pays per call while the card keeps up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        times.append((time.perf_counter() - t0) / iters * 1e6)
        torch.cuda.synchronize()
    return float(np.median(times))


def host_pairs_us(torch, fa, fb, iters: int, pairs: int = 60) -> dict:
    """The host's µs per call to issue ``iters`` calls of ``fa`` and of
    ``fb``, taken in ``pairs`` back-to-back pairs whose order alternates,
    so that the host's load, which drifts over milliseconds, hits both
    alike: the median of each, and the median and quartiles of the
    paired differences ``fa - fb``."""
    for f in (fa, fb):
        f()
    torch.cuda.synchronize()
    ta, tb = [], []
    for i in range(pairs):
        for f, out in ((fa, ta), (fb, tb))[::1 if i % 2 == 0 else -1]:
            t0 = time.perf_counter()
            for _ in range(iters):
                f()
            out.append((time.perf_counter() - t0) / iters * 1e6)
            torch.cuda.synchronize()
    diff = np.asarray(ta) - np.asarray(tb)
    q25, q50, q75 = np.percentile(diff, [25, 50, 75])
    return {"a_us": float(np.median(ta)), "b_us": float(np.median(tb)),
            "diff_median_us": float(q50), "diff_q25_us": float(q25),
            "diff_q75_us": float(q75), "pairs": pairs}


def device_ms(torch, fn, iters: int = 20, name: str = "", tries: int = 3):
    """``(ms, events)`` per call from a ``torch.profiler`` trace: the summed
    time and the number of the device events (kernels, copies) whose name
    contains ``name`` (all of them for ""), over ``iters`` calls.  ms is
    None when the trace holds no device time in any of ``tries`` traces
    (one trace in a few hundred comes back empty on the H100)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        # only device-side events: a CPU op's row repeats the device time
        # of the kernels it launched
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and name in e.key]
        total = sum(getattr(e, "self_device_time_total", 0.0)
                    for e in events)
        if total > 0:
            return total / iters / 1e3, sum(e.count for e in events) / iters
    return None, 0.0


def fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def lstm_bound_ms(T: int, B: int, dtype: str) -> tuple:
    """The least time for the unroll's work on an H100: the bytes it must
    move (xp, wh, h0, c0 in; hs, c_T out; each once) over HBM bandwidth,
    against the recurrent product's FLOPs over the dtype's peak."""
    wbytes = 2 if dtype == "bfloat16" else 4
    nbytes = (T * B * 4 * H * 4 + H * 4 * H * wbytes + 2 * B * H * 4
              + T * B * H * 4 + B * H * 4)
    flops = 2.0 * T * B * H * 4 * H
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_designs(torch, lstm, randn):
    """Each design against the plain version at T in {1, 85} and every B
    of CHECK_B: step by step from the kernel's own state (each step is the
    plain step up to the order of the f32 sums), the one-launch unroll bit
    for bit against the chain of one-step launches, and the whole unroll.
    Returns {design: (per-step error, whole-unroll error)}."""
    designs = (("tensor_core", lstm.lstm_unroll_cuda, torch.bfloat16),
               ("cuda_core_f32", lstm.lstm_unroll_cuda, torch.float32),
               ("cuda_core_bf16", lstm._lstm_unroll_cudacore, torch.bfloat16))
    errs = {name: [0.0, 0.0] for name, _, _ in designs}
    for T in (1, 85):
        for B in CHECK_B:
            xp = randn(T, B, 4 * H, scale=0.5)
            wh = randn(H, 4 * H, scale=H ** -0.5)
            h0, c0 = randn(B, H, scale=0.5), randn(B, H, scale=0.5)
            for name, fn, dt in designs:
                whc = wh.to(dt)
                got = fn(xp, whc, h0, c0)
                want = lstm.lstm_unroll_reference(xp, wh, h0, c0, dt)
                h, c = h0, c0
                step_err = 0.0
                for t in range(T):
                    _, h1, c1 = fn(xp[t:t + 1], whc, h, c)
                    _, h2, c2 = lstm.lstm_unroll_reference(
                        xp[t:t + 1], wh, h, c, dt)
                    step_err = max(step_err, (h1 - h2).abs().max().item(),
                                   (c1 - c2).abs().max().item())
                    if not torch.equal(h1, got[0][t]):
                        fail(f"{name} T={T} B={B}: the unroll's step {t} "
                             "differs from the one-step launch")
                    h, c = h1, c1
                torch.cuda.synchronize()
                if not torch.equal(c, got[2]):
                    fail(f"{name} T={T} B={B}: c_T differs from the chain")
                if not all(torch.isfinite(g).all().item() for g in got):
                    fail(f"{name} output not finite at T={T} B={B}")
                err = max((g - w).abs().max().item()
                          for g, w in zip(got, want))
                tol = F32_TOL if dt == torch.float32 else BF16_TOL
                free_tol = F32_TOL if dt == torch.float32 else BF16_FREE_TOL
                print(f"lstm_infer {name} vs plain T={T} B={B}: per-step "
                      f"max_abs_err={step_err:.3e} (tol {tol:.0e}), whole "
                      f"unroll {err:.3e} (tol {free_tol:.0e})", flush=True)
                if step_err > tol or err > free_tol:
                    fail(f"lstm_infer {name} disagrees with its plain "
                         f"version at T={T} B={B}")
                errs[name][0] = max(errs[name][0], step_err)
                errs[name][1] = max(errs[name][1], err)
    return errs


def layer_inputs(torch, randn, T: int, B: int):
    """One LSTM layer of the flagship net at random weights: x (T, B, IN)
    in bf16, wi (IN, 4H), wh (H, 4H), b (4H,), h0, c0 (B, H)."""
    x = randn(T, B, IN_DIM, scale=0.5).to(torch.bfloat16)
    wi = randn(IN_DIM, 4 * H, scale=IN_DIM ** -0.5)
    wh = randn(H, 4 * H, scale=H ** -0.5)
    b = randn(4 * H, scale=0.1)
    return x, wi, wh, b, randn(B, H, scale=0.5), randn(B, H, scale=0.5)


def library_step(torch, T, x, wi, wh, b, h0, c0):
    """The yardstick: one PyTorch call for the layer's T steps in bf16 —
    ``torch.lstm_cell`` (what ``nn.LSTMCell`` calls) at T=1, cuDNN through
    ``nn.LSTM`` at T>1 — with the layer's weights (gate order i, f, g, o in
    both).  Returns the call, which gives (h_T, c_T)."""
    bf = torch.bfloat16
    w_ih, w_hh = wi.t().contiguous().to(bf), wh.t().contiguous().to(bf)
    b_ih, b_hh = b.to(bf), torch.zeros_like(b, dtype=bf)
    h16, c16 = h0.to(bf), c0.to(bf)
    if T == 1:
        def call():
            return torch.lstm_cell(x[0], (h16, c16), w_ih, w_hh, b_ih, b_hh)
    else:
        mod = torch.nn.LSTM(IN_DIM, H).to(device="cuda", dtype=bf)
        with torch.no_grad():
            mod.weight_ih_l0.copy_(w_ih)
            mod.weight_hh_l0.copy_(w_hh)
            mod.bias_ih_l0.copy_(b_ih)
            mod.bias_hh_l0.copy_(b_hh)
        mod.flatten_parameters()   # one weight buffer, as cuDNN wants it
        hx = (h16[None], c16[None])

        def call():
            _, (h, c) = mod(x, hx)
            return h[0], c[0]
    return call


def phase_kernel(torch, lstm):
    """Phase 3: every design against the plain version, the tile sweep,
    and the timings of the main path's shapes."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    errs = check_designs(torch, lstm, randn)

    # the tensor-core kernel at each tile width n, device time
    sweep = {}
    for B in (64, 256):
        xp = randn(1, B, 4 * H, scale=0.5)
        wh = randn(H, 4 * H, scale=H ** -0.5).to(torch.bfloat16)
        h0, c0 = randn(B, H, scale=0.5), randn(B, H, scale=0.5)
        base = lstm.launch_plan(B, H)
        for n in lstm.UNITS_PER_GATE:
            plan = lstm.plan_for(n, B, H)
            dev, _ = device_ms(torch, lambda: lstm._launch_wgmma(
                xp, wh, h0, c0, plan), name=WGMMA_KERNEL)
            sweep[f"B={B} n={n}"] = dev
        print(f"tile sweep (1, {B}) bf16, device ms per call: " + ", ".join(
            f"n={n} {fmt(sweep[f'B={B} n={n}'])}"
            for n in lstm.UNITS_PER_GATE)
            + f"; launch_plan picks n={base.n}", flush=True)

    timings = {}
    with torch.inference_mode():
        for T, B in TIMED:
            timings[(T, B)] = time_shape(torch, lstm, randn, T, B)
    return errs, sweep, timings


def time_shape(torch, lstm, randn, T: int, B: int) -> dict:
    """One shape's numbers, bf16 wh, each the mean over ``ROUNDS`` rounds
    that take the runs in turns: time per call with the launch (CUDA
    events), device time (profiler) and host µs to issue a call, of the
    tensor-core kernel, the CUDA-core kernel, the plain version, the layer
    step (x @ wi + b, then the kernel) and the library call for the same
    layer step; the bound.  Keys: ``<run>_ms``, ``<run>_device_ms``,
    ``<run>_host_us`` (the tensor-core kernel's without the prefix), and
    each round's numbers of the two kernels under ``rounds``."""
    x, wi, wh, b, h0, c0 = layer_inputs(torch, randn, T, B)
    wi16, whb = wi.to(torch.bfloat16), wh.to(torch.bfloat16)
    xp = ((x @ wi16).float() + b).contiguous()
    lib = library_step(torch, T, x, wi, wh, b, h0, c0)

    # the yardstick computes the same function: held to the plain layer
    _, ph, pc = lstm.lstm_unroll_reference(xp, wh, h0, c0, torch.bfloat16)
    lh, lc = lib()
    lib_err = max((lh.float() - ph).abs().max().item(),
                  (lc.float() - pc).abs().max().item())
    if not lib_err <= LIB_TOL[T]:
        fail(f"the library yardstick at ({T}, {B}) is {lib_err:.3e} from "
             f"the plain layer (tol {LIB_TOL[T]:.0e})")

    runs = {
        "": (lambda: lstm.lstm_unroll_cuda(xp, whb, h0, c0), WGMMA_KERNEL),
        "cudacore_": (lambda: lstm._lstm_unroll_cudacore(xp, whb, h0, c0),
                      CUDACORE_KERNEL),
        "plain_": (lambda: lstm.lstm_unroll_reference(
            xp, wh, h0, c0, torch.bfloat16), ""),
        "layer_step_": (lambda: lstm.lstm_unroll_cuda(
            ((x @ wi16).float() + b).contiguous(), whb, h0, c0), ""),
        "library_": (lib, ""),
    }
    # in turns, forward then back, so a drift of the card's clock or of
    # the host's load hits every run alike
    got = {f"{k}{m}": [] for k in runs for m in ("ms", "device_ms",
                                                 "host_us")}
    iters = 5 if T > 1 else 20
    for r in range(ROUNDS):
        for k in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            fn, name = runs[k]
            d, _ = device_ms(torch, fn, iters=iters, name=name)
            if d is None:
                fail(f"no device time for {k or 'kernel'} at ({T}, {B})")
            got[f"{k}device_ms"].append(d)
            got[f"{k}ms"].append(bench_ms(torch, fn, reps=5, iters=iters))
            got[f"{k}host_us"].append(host_us(torch, fn, iters=iters))
    out = {k: float(np.mean(v)) for k, v in got.items()}
    out["rounds"] = {k: got[k] for k in ("ms", "cudacore_ms", "host_us",
                                         "cudacore_host_us")}
    # the host's cost of the two kernels' wrappers, in alternating pairs:
    # a = the tensor-core kernel, b = the CUDA-core kernel
    pair = host_pairs_us(torch, runs[""][0], runs["cudacore_"][0], iters)
    out["host_pairs_us"] = pair
    # the same for the bare C entry points (the launches and what the C
    # side does around them, without the Python wrappers)
    lib = lstm._library()
    plan = lstm.launch_plan(B, H)
    hs, c = torch.empty(T, B, H, device="cuda"), c0.clone()
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (xp, whb, h0, c, hs)]
    bare = host_pairs_us(
        torch, lambda: lib.lstm_infer_wgmma(*ptrs, T, B, H, plan.n,
                                            *plan.grid, stream),
        lambda: lib.lstm_infer_cudacore(ptrs[0], ptrs[1], 1, *ptrs[2:], T,
                                        B, H, stream), iters)
    out["c_entry_pairs_us"] = bare
    bound, by = lstm_bound_ms(T, B, "bfloat16")
    out.update(library_max_abs_err=lib_err, bound_ms=bound, bound_by=by,
               share_of_bound=bound / out["device_ms"],
               cudacore_share_of_bound=bound / out["cudacore_device_ms"])
    lib_name = "lstm_cell" if T == 1 else "cuDNN nn.LSTM"
    print(f"lstm_infer time ({T}, {B}) bf16 H={H}, mean of {ROUNDS} rounds, "
          "per call / device / host issue: tensor-core kernel "
          f"{out['ms']:.4f} / {out['device_ms']:.4f} ms / "
          f"{out['host_us']:.1f} us; CUDA-core kernel (the first design) "
          f"{out['cudacore_ms']:.4f} / {out['cudacore_device_ms']:.4f} ms / "
          f"{out['cudacore_host_us']:.1f} us; plain {out['plain_ms']:.4f} / "
          f"{out['plain_device_ms']:.4f} ms; layer step (x @ wi + b, "
          f"kernel) {out['layer_step_ms']:.4f} / "
          f"{out['layer_step_device_ms']:.4f} ms against library "
          f"({lib_name}) {out['library_ms']:.4f} / "
          f"{out['library_device_ms']:.4f} ms, library vs plain "
          f"{lib_err:.3e} (tol {LIB_TOL[T]:.0e}); bound {bound:.4f} ms "
          f"({by}), share of bound {out['share_of_bound']:.1%} (CUDA-core "
          f"kernel {out['cudacore_share_of_bound']:.1%})", flush=True)
    print(f"lstm_infer host us per call ({T}, {B}), {pair['pairs']} "
          f"alternating pairs: tensor-core {pair['a_us']:.1f}, CUDA-core "
          f"{pair['b_us']:.1f}, paired difference median "
          f"{pair['diff_median_us']:+.1f} (quartiles "
          f"{pair['diff_q25_us']:+.1f}, {pair['diff_q75_us']:+.1f}); bare C "
          f"entry points: tensor-core {bare['a_us']:.1f}, CUDA-core "
          f"{bare['b_us']:.1f}, difference {bare['diff_median_us']:+.1f} "
          f"({bare['diff_q25_us']:+.1f}, {bare['diff_q75_us']:+.1f})",
          flush=True)
    print(f"lstm_infer rounds ({T}, {B}): per call ms tensor-core "
          f"{fmt_list(got['ms'])} CUDA-core {fmt_list(got['cudacore_ms'])}; "
          f"host us tensor-core {fmt_list(got['host_us'], 1)} CUDA-core "
          f"{fmt_list(got['cudacore_host_us'], 1)}", flush=True)
    return out


def fmt_list(xs, digits: int = 4) -> str:
    return "[" + ", ".join(f"{x:.{digits}f}" for x in xs) + "]"


def session_inputs(obs_shape, seed: int = 1, n_sessions: int = N_SESSIONS):
    """The traffic: per (session, step) an observation and a reward, made
    from ``seed`` — the client process and the checks rebuild the same."""
    rng = np.random.default_rng(seed)
    sids = list(range(100, 100 + n_sessions))
    obs = {(s, t): rng.integers(0, 256, obs_shape, np.uint8)
           for s in sids for t in range(N_STEPS)}
    reward = {(s, t): float(rng.normal()) for s in sids
              for t in range(N_STEPS)}
    return sids, obs, reward


def client_setup(kind: str):
    """(config, action dim, sessions, groups) of a client: ``flagship``
    for phase 4's served net, ``impala`` for phase 6's checkpoint."""
    from r2d2_tpu_torch.config import Config, impala_deep_config

    if kind == "flagship":
        return Config(serve_max_batch=256), ACTION_DIM, N_SESSIONS, GROUPS
    return (impala_deep_config(game_name="Fake").replace(**FABRIC_REDUCED),
            TRAIN_ACTIONS, FABRIC_SESSIONS, FABRIC_GROUPS)


def client_process(host: str, port: int, out, kind: str = "flagship"
                   ) -> None:
    """The external client (its own process, as a frontend would be):
    opens the sessions, sends the steps in groups, feeds each session its
    greedy action back, and puts ``("ok", replies, latencies)`` or
    ``("error", message)`` on ``out``."""
    from r2d2_tpu_torch.serving.client import SessionClient
    from r2d2_tpu_torch.serving.wire import STATUS_OK

    cfg, action_dim, n_sessions, groups = client_setup(kind)
    sids, obs, reward = session_inputs(cfg.stored_obs_shape,
                                       n_sessions=n_sessions)
    replies, lat = {}, []
    try:
        client = SessionClient(cfg, action_dim, host, port, timeout=60.0)
    except OSError as e:
        out.put(("error", f"connect failed: {e}"))
        return
    try:
        for s in sids:
            if client.open_session(s) != STATUS_OK:
                out.put(("error", f"open_session({s}) refused"))
                return
        la = {s: np.zeros(action_dim, np.float32) for s in sids}
        for t in range(N_STEPS):
            lo = 0
            for g in groups:
                group = sids[lo:lo + g]
                lo += g
                sent = {s: (client.send_act(s, obs[(s, t)], la[s],
                                            reward[(s, t)], reset=t == 0),
                            time.perf_counter()) for s in group}
                for s in group:
                    status, q = client.recv(s, sent[s][0])
                    lat.append(time.perf_counter() - sent[s][1])
                    if status != STATUS_OK or q is None:
                        out.put(("error", f"session {s} step {t}: status "
                                          f"{status}"))
                        return
                    replies[(s, t)] = q
                    la[s] = np.zeros(action_dim, np.float32)
                    la[s][int(np.argmax(q))] = 1.0
        for s in sids:
            client.close_session(s)
    except Exception as e:  # reported to the parent, which fails the run
        out.put(("error", f"client: {type(e).__name__}: {e}"))
        return
    finally:
        client.close()
    out.put(("ok", replies, lat))


def phase_serving(torch, card: str):
    """Phase 4: the flagship net served over the session tier."""
    from r2d2_tpu_torch.actor import make_act_fn
    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.models import create_network
    from r2d2_tpu_torch.ops import lstm
    from r2d2_tpu_torch.serving import SessionServer
    from r2d2_tpu_torch.utils.trace import KERNEL_LAUNCHES

    cfg = Config(serve_max_batch=256)
    if (cfg.torso, cfg.obs_shape, cfg.stored_obs_shape, cfg.hidden_dim,
            cfg.compute_dtype) != ("nature", (84, 84, 1), (21, 21, 16), H,
                                   "bfloat16"):
        fail(f"Config() is not the flagship configuration: {cfg}")
    net = create_network(cfg, ACTION_DIM, device="cuda",
                         generator=torch.Generator().manual_seed(0))
    if net.lstm_layers[0].impl != "pallas":
        fail("the serving network did not resolve the fused LSTM kernel")
    params = {k: v.detach().clone() for k, v in net.state_dict().items()}

    server = SessionServer(cfg, ACTION_DIM, host="127.0.0.1")
    if server.batcher.device.type != "cuda":
        fail(f"the server acts on {server.batcher.device}, not the card")
    server.publish_params(params)
    t0 = time.perf_counter()
    server.warmup()
    torch.cuda.synchronize()
    print(f"serving warmup ({len(server.batcher.buckets)} buckets "
          f"{server.batcher.buckets}): {time.perf_counter() - t0:.2f} s",
          flush=True)

    # record every served batch (inputs and outputs, host copies) to hold
    # it against the plain-LSTM act afterwards
    served = []
    act = server.batcher.act

    def recording_act(obs, last_action, last_reward, hidden):
        q, new_hidden = act(obs, last_action, last_reward, hidden)
        served.append(tuple(np.array(a) for a in (
            obs, last_action, last_reward, hidden, q, new_hidden)))
        return q, new_hidden

    server.batcher.act = recording_act
    _, obs, _ = session_inputs(cfg.stored_obs_shape)

    KERNEL_LAUNCHES.reset()
    server.start()
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    child = ctx.Process(target=client_process,
                        args=(server.host, server.port, out))
    child.start()
    try:
        result = out.get(timeout=600)
    except queue.Empty:
        result = ("error", "the client process sent nothing in 600 s")
    finally:
        child.join(timeout=30)
        if child.is_alive():
            child.terminate()
            child.join(timeout=10)
        server.stop()
        server.close()
    if result[0] != "ok":
        fail(result[1])
    _, replies, lat = result
    if len(replies) != N_SESSIONS * N_STEPS:
        fail(f"{len(replies)} replies, expected {N_SESSIONS * N_STEPS}")
    for (s, t), q in replies.items():
        if q.shape != (ACTION_DIM,) or not np.isfinite(q).all():
            fail(f"session {s} step {t}: bad q {q}")
    launches = KERNEL_LAUNCHES.get(lstm.KERNEL)
    old_launches = KERNEL_LAUNCHES.get(lstm.CUDACORE_COUNTER)
    stats = server.stats()
    counts = server.store.counts()
    if counts["admitted"] != (counts["completed"] + counts["reaped"]
                              + counts["evicted"] + counts["live"]):
        fail(f"store accounting broken: {counts}")
    if stats["requests"] != N_SESSIONS * N_STEPS or stats["act_failures"]:
        fail(f"server stats: {stats}")
    if (launches != stats["batches"] * cfg.lstm_layers or launches < 1
            or old_launches):
        fail(f"the tensor-core lstm_infer kernel launched {launches} times "
             f"(the CUDA-core one {old_launches}) for {stats['batches']} "
             "batches on the main path")

    # every batch row is one session step: its hidden is the session's
    # previous output (zeros after the step-0 reset) and its q went out
    key = {obs[k].tobytes(): k for k in obs}
    out_hidden = {}
    rows = {}
    for b_obs, _, _, b_hid, b_q, b_new in served:
        for i in range(len(b_obs)):
            k = key[b_obs[i].tobytes()]
            rows[k] = (b_hid[i], b_q[i])
            out_hidden[k] = b_new[i]
    if len(rows) != N_SESSIONS * N_STEPS:
        fail(f"{len(rows)} session steps were batched, expected "
             f"{N_SESSIONS * N_STEPS}")
    for (s, t), (hid_in, q) in rows.items():
        want = (np.zeros_like(hid_in) if t == 0 else out_hidden[(s, t - 1)])
        if not np.array_equal(hid_in, want):
            fail(f"session {s} step {t} was served with the wrong hidden")
        if not np.array_equal(q, replies[(s, t)]):
            fail(f"session {s} step {t}: the reply is not the batch's q")

    # the same batches through a direct act with the plain LSTM
    plain = create_network(cfg, ACTION_DIM, device="cuda",
                           lstm_impl="reference")
    plain_act = make_act_fn(plain)
    gparams = {k: v.to("cuda") for k, v in params.items()}
    q_err = h_err = 0.0
    for b_obs, b_la, b_lr, b_hid, b_q, b_new in served:
        n = len(b_obs)
        pad = server.batcher.bucket(n)

        def padded(a):
            out = np.zeros((pad, *a.shape[1:]), a.dtype)
            out[:n] = a
            return torch.from_numpy(out).to("cuda")

        q, new_hidden = plain_act(gparams, padded(b_obs), padded(b_la),
                                  padded(b_lr), padded(b_hid))
        q_err = max(q_err, float(np.abs(q[:n].cpu().numpy() - b_q).max()))
        h_err = max(h_err, float(np.abs(new_hidden[:n].cpu().numpy()
                                        - b_new).max()))
    sizes = sorted(len(b[0]) for b in served)
    spans = server.tracer.snapshot()
    print("serving spans (ms): " + ", ".join(
        f"{k[5:]}={v:.3f}" for k, v in sorted(spans.items())
        if k.endswith(("p50_ms", "p99_ms", "mean_ms"))), flush=True)
    print(f"serving: {stats['batches']} batches, sizes {sizes}; "
          f"lstm_infer launches {launches}; q vs plain-LSTM act max_abs_err "
          f"{q_err:.3e} (tol {Q_TOL:.0e}), new hidden {h_err:.3e} "
          f"(tol {BF16_TOL:.0e}); store {counts}", flush=True)
    if q_err > Q_TOL or h_err > BF16_TOL:
        fail("served q or hidden disagrees with the plain-LSTM act")
    p50, p99 = np.percentile(np.asarray(lat) * 1e3, [50, 99])
    print(f"serving act latency (client round trip, {len(lat)} requests) "
          f"p50 {p50:.3f} ms p99 {p99:.3f} ms on {card}", flush=True)

    # where one batch's time goes, the traffic gone: the host's wall clock
    # per batcher.act against the device time in it
    rng = np.random.default_rng(2)
    for n in (1, 32, 256):
        rows = (rng.integers(0, 256, (n, *cfg.stored_obs_shape), np.uint8),
                np.zeros((n, ACTION_DIM), np.float32),
                np.zeros(n, np.float32),
                np.zeros((n, 2, cfg.lstm_layers, H), np.float32))
        for _ in range(3):
            act(*rows)
        t0 = time.perf_counter()
        for _ in range(20):
            act(*rows)
        wall = (time.perf_counter() - t0) / 20 * 1e3
        dev, events = device_ms(torch, lambda: act(*rows), iters=20)
        kern, n_kern = device_ms(torch, lambda: act(*rows), iters=20,
                                 name=WGMMA_KERNEL)
        _, n_old = device_ms(torch, lambda: act(*rows), iters=20,
                             name=CUDACORE_KERNEL)
        if kern is None or n_kern != cfg.lstm_layers or n_old:
            fail(f"the served act at n={n} ran {n_kern} tensor-core and "
                 f"{n_old} CUDA-core LSTM kernels, device time {fmt(kern)}")
        casts, n_casts = device_ms(torch, lambda: act(*rows), iters=20,
                                   name="copy")
        idle = "not measured" if dev is None else f"{1 - dev / wall:.1%}"
        print(f"serving act alone n={n}: host wall {wall:.3f} ms per batch, "
              f"device {fmt(dev)} in {events:.0f} device events (lstm_infer "
              f"tensor-core kernel {fmt(kern)}, {n_casts:.0f} copy/cast kernels {fmt(casts)}), "
              f"device idle {idle} on {card}", flush=True)
    return launches


def profile_events(torch, fn, iters: int, tries: int = 3):
    """Device-side events of ``iters`` calls of ``fn`` under
    ``torch.profiler``: ``[(name, ms per call, count per call)]``, longest
    first, or None when no trace in ``tries`` holds device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [(e.key, getattr(e, "self_device_time_total", 0.0)
                   / iters / 1e3, e.count / iters)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        if sum(ms for _, ms, _ in events) > 0:
            return sorted(events, key=lambda e: -e[1])
    return None


def short_kernel_name(name: str, width: int = 110) -> str:
    """A device kernel's symbol without the namespaces that every ATen
    kernel shares, so the functor (add, sigmoid, gemm ...) shows."""
    for prefix in ("void ", "at::native::", "(anonymous namespace)::",
                   "c10::"):
        name = name.replace(prefix, "")
    return name[:width]


def wall_ms(torch, fn, iters: int) -> float:
    """Host wall clock per call of ``iters`` calls, synchronised at the end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def step_batch(cfg, seed: int = 0) -> dict:
    """One learner batch with ragged windows, made from ``seed``."""
    rng = np.random.default_rng(seed)
    B, T, L, n = (cfg.batch_size, cfg.seq_len, cfg.learning_steps,
                  cfg.forward_steps)
    learning = rng.integers(1, L + 1, B).astype(np.int32)
    burn_in = rng.integers(0, cfg.burn_in_steps + 1, B).astype(np.int32)
    forward = np.where(learning == L, rng.integers(1, n + 1, B),
                       1).astype(np.int32)
    return dict(
        obs=rng.integers(0, 256, (B, T, *cfg.stored_obs_shape), np.uint8),
        last_action=np.eye(TRAIN_ACTIONS, dtype=np.float32)[
            rng.integers(TRAIN_ACTIONS, size=(B, T))],
        last_reward=rng.normal(size=(B, T)).astype(np.float32),
        hidden=(rng.normal(size=(B, 2, cfg.lstm_layers, cfg.hidden_dim))
                * 0.5).astype(np.float32),
        action=rng.integers(0, TRAIN_ACTIONS, (B, L)).astype(np.int32),
        n_step_reward=rng.normal(size=(B, L)).astype(np.float32),
        n_step_gamma=np.full((B, L), cfg.gamma ** n, np.float32),
        burn_in=burn_in, learning=learning, forward=forward,
        is_weights=rng.uniform(0.2, 1.0, B).astype(np.float32))


def learner_step_card_vs_cpu(torch) -> dict:
    """One learner step at a reduced width (mlp torso, H=64) from the same
    params on the same batch: bf16 on the card against float32 on the
    CPU, which is the reference here (the card has no JAX)."""
    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.learner.step import (
        create_train_state,
        make_train_step,
    )
    from r2d2_tpu_torch.models import create_network

    out = {}
    for dev, dtype in (("cuda", "bfloat16"), ("cpu", "float32")):
        cfg = Config(game_name="Fake", torso="mlp", hidden_dim=STEP_H,
                     compute_dtype=dtype)
        net = create_network(cfg, TRAIN_ACTIONS, device=dev,
                             generator=torch.Generator().manual_seed(0))
        state = create_train_state(cfg, net.state_dict())
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in step_batch(cfg).items()}
        _, loss, prios = make_train_step(cfg, net)(state, batch)
        out[dev] = (loss.item(), prios.cpu().numpy())
    (lc, pc), (lf, pf) = out["cuda"], out["cpu"]
    loss_rel = abs(lc - lf) / abs(lf)
    prio_err = float(np.abs(pc - pf).max())
    print(f"learner step card vs CPU (mlp torso, H={STEP_H}, batch 64, "
          f"T=85): loss bf16 card {lc:.6f} vs f32 CPU {lf:.6f}, relative "
          f"{loss_rel:.3e} (tol {STEP_LOSS_RTOL:.0e}); priorities max-abs "
          f"{prio_err:.3e} (tol {STEP_PRIO_ATOL:.0e}, max {pf.max():.3f})",
          flush=True)
    if not (np.isfinite(lc) and np.isfinite(pc).all()):
        fail("the card's learner step is not finite")
    if loss_rel > STEP_LOSS_RTOL or prio_err > STEP_PRIO_ATOL:
        fail("the card's learner step disagrees with the CPU's")
    return dict(loss_rel_err=loss_rel, prio_max_abs_err=prio_err)


def phase_training(torch, card: str) -> int:
    """Phase 5: ``train_sync`` at the flagship width on the card."""
    import shutil
    import tempfile

    from r2d2_tpu_torch import train
    from r2d2_tpu_torch.actor import ACTOR_ACT
    from r2d2_tpu_torch.checkpoint import Checkpointer
    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.envs import FakeAtariEnv
    from r2d2_tpu_torch.evaluate import EVAL_ACT, evaluate_params
    from r2d2_tpu_torch.learner.learner import Learner
    from r2d2_tpu_torch.ops import lstm
    from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS, KERNEL_LAUNCHES

    t_phase = time.perf_counter()
    base = Config(game_name="Fake")
    flagship = dict(torso="nature", stored_obs_shape=(21, 21, 16),
                    hidden_dim=H, lstm_layers=1, compute_dtype="bfloat16",
                    param_dtype="float32", batch_size=64, burn_in_steps=40,
                    learning_steps=40, forward_steps=5, num_actors=8,
                    block_length=400)
    got = {k: getattr(base, k) for k in flagship}
    if got != flagship:
        fail(f"Config(game_name='Fake') is not the flagship: {got}")
    cfg = base.replace(**TRAIN_REDUCED)
    print("reduced: " + ", ".join(
        f"{k} {getattr(base, k)} -> {v}" for k, v in TRAIN_REDUCED.items())
        + f" (host ring {cfg.num_blocks} blocks of {cfg.block_length}); "
        f"fake env episodes of {FAKE_EPISODE_LEN} steps, {TRAIN_ACTIONS} "
        "actions", flush=True)

    def env_factory(c, seed):
        return FakeAtariEnv(obs_shape=c.stored_obs_shape,
                            action_dim=TRAIN_ACTIONS,
                            episode_len=FAKE_EPISODE_LEN, seed=seed)

    # the run's parts, captured as train_sync builds them, so that the
    # checks below can read the buffer, the actor and the learner; the
    # actor's bursts and the learner's steps are timed (each step ends in
    # a synchronise, as the result fetch at pipeline 0 does anyway)
    rec = dict(fill=[], acts=[], updates=[], synced={})
    built = {}
    real_build = train._build

    def capture(*args, **kw):
        sys_ = real_build(*args, **kw)
        actor, learner = sys_["actor"], sys_["learner"]
        run, step = actor.run, learner._step_fn

        def timed_run(max_steps, stop=None):
            t0 = time.perf_counter()
            run(max_steps, stop)
            key = "fill" if max_steps == cfg.block_length else "acts"
            rec[key].append((max_steps, time.perf_counter() - t0))

        def timed_step(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            rec["updates"].append((time.perf_counter() - t0) * 1e3)
            st = out[0]
            if st.step in (7, 8):
                rec["synced"][st.step] = all(
                    torch.equal(st.params[k], st.target_params[k])
                    for k in st.params)
            return out

        actor.run, learner._step_fn = timed_run, timed_step
        built.update(sys_, run=run, step=step)
        return sys_

    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        KERNEL_LAUNCHES.reset()
        HOST_TRANSFERS.reset()
        train._build = capture
        t0 = time.perf_counter()
        try:
            m = train.train_sync(cfg, env_factory, checkpoint_dir=ckdir,
                                 device="cuda")
        finally:
            train._build = real_build
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eval_return = evaluate_params(cfg, built["act_net"],
                                      m["final_params"], env_factory,
                                      episodes=EVAL_EPISODES, epsilon=0.0,
                                      seed=cfg.seed)
        eval_s = time.perf_counter() - t0
        launches = KERNEL_LAUNCHES.get(lstm.KERNEL)
        old_launches = KERNEL_LAUNCHES.get(lstm.CUDACORE_COUNTER)
        acts = HOST_TRANSFERS.get(ACTOR_ACT)
        evals = HOST_TRANSFERS.get(EVAL_ACT)
        actor, learner, buffer = (built["actor"], built["learner"],
                                  built["buffer"])

        # the main path's checks
        if built["act_net"].lstm_layers[0].impl != "pallas":
            fail("the actors' network did not resolve the fused LSTM kernel")
        if acts != actor.actor_steps:
            fail(f"{acts} actor acts for {actor.actor_steps} lockstep "
                 "iterations")
        if (launches != cfg.lstm_layers * (acts + evals) or not acts
                or not evals or old_launches):
            fail(f"lstm_infer launched {launches} times (CUDA-core "
                 f"{old_launches}) for {acts} actor iterations and {evals} "
                 f"evaluator steps, {cfg.lstm_layers} layer(s)")
        losses = np.asarray(m["losses"])
        stats = buffer.stats()
        if (m["num_updates"] != cfg.training_steps
                or losses.shape != (cfg.training_steps,)
                or not np.isfinite(losses).all()
                or stats["training_steps"] != cfg.training_steps):
            fail(f"training: {m['num_updates']} updates, losses {losses}, "
                 f"buffer training_steps {stats['training_steps']}")
        if rec["synced"] != {7: False, 8: True}:
            fail(f"target params equal to the online params after steps "
                 f"7, 8: {rec['synced']} (want False, True)")
        if not np.isfinite(eval_return):
            fail(f"evaluation return {eval_return}")

        # the latest checkpoint restores into a fresh learner bit for bit
        ck = Checkpointer(ckdir)
        if ck.steps() != [8, 16]:
            fail(f"checkpoints {ck.steps()}, expected [8, 16]")
        state, meta = ck.restore()
        fresh = Learner(built["cfg"], built["net"], state)
        a, b = learner.state, fresh.state
        same = (a.step == b.step == cfg.training_steps
                and a.opt_state.count == b.opt_state.count
                and all(torch.equal(x[k], y[k])
                        for x, y in ((a.params, b.params),
                                     (a.target_params, b.target_params),
                                     (a.opt_state.mu, b.opt_state.mu),
                                     (a.opt_state.nu, b.opt_state.nu))
                        for k in x))
        if not same:
            fail("the latest checkpoint did not restore bit for bit")
        print(f"training: {m['num_updates']} updates in {train_s:.2f} s, "
              f"losses {fmt_list(losses.tolist())}, buffer training_steps "
              f"{stats['training_steps']}, env_steps {m['env_steps']}; "
              f"target == online after step 7 {rec['synced'][7]}, after 8 "
              f"{rec['synced'][8]}; checkpoints {ck.steps()} restore bit "
              f"for bit (step {b.step}, env_steps {meta['env_steps']}); "
              f"greedy return over {EVAL_EPISODES} episodes "
              f"{eval_return:.3f} in {eval_s:.2f} s; lstm_infer launches "
              f"{launches} = {cfg.lstm_layers} x ({acts} actor iterations "
              f"+ {evals} evaluator steps), CUDA-core {old_launches}",
              flush=True)

        # timings (after the checks; they run the actor and learner on)
        fill_steps = sum(n for n, _ in rec["fill"])
        fill_s = sum(t for _, t in rec["fill"])
        upd = np.asarray(rec["updates"])
        spans = learner.tracer.snapshot()
        print(f"training timings on {card}: fill {fill_steps} lockstep "
              f"iterations x {cfg.num_actors} envs in {fill_s:.2f} s = "
              f"{fill_steps * cfg.num_actors / fill_s:.0f} env steps/s; "
              f"learner update (step + synchronise) p50 "
              f"{np.percentile(upd, 50):.2f} ms, min {upd.min():.2f}, max "
              f"{upd.max():.2f}, first {upd[0]:.2f} over {len(upd)}; "
              "per-update spans (mean ms) "
              + ", ".join(f"{k[5:-8]} {v:.2f}" for k, v in sorted(
                  spans.items()) if k.endswith(".mean_ms")), flush=True)

        one_iter = lambda: built["run"](1)   # noqa: E731
        act_events = profile_events(torch, one_iter, 10)
        act_wall = wall_ms(torch, one_iter, 20)
        if act_events is None:
            fail("no device time in an actor iteration")
        act_dev = sum(ms for _, ms, _ in act_events)
        kern = [(ms, n) for k, ms, n in act_events if WGMMA_KERNEL in k]
        if (not kern or kern[0][1] != cfg.lstm_layers
                or any("lstm_step_cudacore" in k for k, _, _ in act_events)):
            fail(f"an actor iteration ran {kern} tensor-core LSTM kernels")

        def one_update():
            dev, _ = learner._stage(buffer.sample_batch())
            _, loss, _ = built["step"](learner.state, dev)
            return loss.item()

        upd_events = profile_events(torch, one_update, 2)
        upd_wall = wall_ms(torch, one_update, 2)
        if upd_events is None:
            fail("no device time in a learner update")
        if any("lstm_step" in k for k, _, _ in upd_events):
            fail("a learner update launched an lstm_infer kernel")
        upd_dev = sum(ms for _, ms, _ in upd_events)
        n_upd = sum(n for _, _, n in upd_events)
        print(f"actor iteration (B={cfg.num_actors}) on {card}: host wall "
              f"{act_wall:.3f} ms, device {act_dev:.4f} ms in "
              f"{sum(n for _, _, n in act_events):.0f} device events, "
              f"lstm_infer tensor-core kernel {kern[0][0]:.4f} ms "
              f"({kern[0][0] / act_dev:.1%} of the device time), device idle "
              f"{1 - act_dev / act_wall:.1%}", flush=True)
        print(f"learner update (sample, stage, step, fetch; 2 updates "
              f"profiled) on {card}: host wall {upd_wall:.2f} ms, device "
              f"{upd_dev:.3f} ms in {n_upd:.0f} device events, device idle "
              f"{1 - upd_dev / upd_wall:.1%}; no lstm_infer kernel; top 5 "
              "device ops (ms per update, count): " + "; ".join(
                  f"{short_kernel_name(k)} {ms:.3f} ({n:.0f})"
                  for k, ms, n in upd_events[:5]), flush=True)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    learner_step_card_vs_cpu(torch)
    print(f"phase 5 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def http_get(port: int, path: str):
    """``(status, body)`` of a GET to the local exporter (no proxy: a
    direct connection to 127.0.0.1)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read().decode()
    finally:
        conn.close()


def served_vs_plain(torch, cfg, action_dim, served, params, bucket):
    """Max-abs error of every served batch's (q, new hidden) against a
    direct act with the plain LSTM on the same card, params and padded
    rows."""
    from r2d2_tpu_torch.actor import make_act_fn
    from r2d2_tpu_torch.models import create_network

    plain = create_network(cfg, action_dim, device="cuda",
                           lstm_impl="reference")
    plain_act = make_act_fn(plain)
    gparams = {k: v.to("cuda") for k, v in params.items()}
    q_err = h_err = 0.0
    for b_obs, b_la, b_lr, b_hid, b_q, b_new in served:
        n = len(b_obs)
        pad = bucket(n)

        def padded(a):
            out = np.zeros((pad, *a.shape[1:]), a.dtype)
            out[:n] = a
            return torch.from_numpy(out).to("cuda")

        q, new_hidden = plain_act(gparams, padded(b_obs), padded(b_la),
                                  padded(b_lr), padded(b_hid))
        q_err = max(q_err, float(np.abs(q[:n].cpu().numpy() - b_q).max()))
        h_err = max(h_err, float(np.abs(new_hidden[:n].cpu().numpy()
                                        - b_new).max()))
    return q_err, h_err


def phase_fabric(torch, card: str):
    """Phase 6: the IMPALA-deep net trained by the threaded ``train()``,
    resumed warm, and its checkpoint served by ``run_server``.  Returns
    the kernel's launches on the fabric and on the served checkpoint."""
    import shutil
    import tempfile

    from r2d2_tpu_torch import train
    from r2d2_tpu_torch.actor import ACTOR_ACT
    from r2d2_tpu_torch.checkpoint import Checkpointer
    from r2d2_tpu_torch.config import impala_deep_config
    from r2d2_tpu_torch.envs import FakeAtariEnv
    from r2d2_tpu_torch.ops import lstm
    from r2d2_tpu_torch.replay.replay_buffer import data_bytes
    from r2d2_tpu_torch.serving import server as server_mod
    from r2d2_tpu_torch.telemetry.runlog import read_entries
    from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS, KERNEL_LAUNCHES

    t_phase = time.perf_counter()
    base = impala_deep_config(game_name="Fake")
    literal = dict(torso="impala", lstm_layers=2, hidden_dim=H,
                   obs_shape=(84, 84, 1), stored_obs_shape=(84, 84, 1),
                   obs_space_to_depth=False, batch_size=64,
                   burn_in_steps=40, learning_steps=75, forward_steps=5,
                   block_length=375, remat=True, compute_dtype="bfloat16",
                   param_dtype="float32", num_actors=8)
    got = {k: getattr(base, k) for k in literal}
    if got != literal:
        fail(f"impala_deep_config(game_name='Fake') is not the IMPALA-deep "
             f"configuration: {got}")
    cfg = base.replace(**FABRIC_REDUCED)
    print("reduced: " + ", ".join(
        f"{k} {getattr(base, k)} -> {v}" for k, v in FABRIC_REDUCED.items())
        + f" (host ring {cfg.num_blocks} blocks of {cfg.block_length}, "
        f"{data_bytes(cfg, TRAIN_ACTIONS) / 1e9:.3f} GB); fake env episodes "
        f"of {FAKE_EPISODE_LEN} steps, {TRAIN_ACTIONS} actions", flush=True)

    def env_factory(c, seed):
        return FakeAtariEnv(obs_shape=c.stored_obs_shape,
                            action_dim=TRAIN_ACTIONS,
                            episode_len=FAKE_EPISODE_LEN, seed=seed)

    # each run's parts, captured as train() builds them: the learner's
    # steps are stamped (entry, exit, actor iterations so far) without any
    # synchronisation, so the fabric runs as it would unobserved
    runs = []
    real_build = train._build

    def capture(*args, **kw):
        sys_ = real_build(*args, **kw)
        actor, learner = sys_["actor"], sys_["learner"]
        run, step = actor.run, learner._step_fn
        rec = dict(sys_, run=run, step=step, steps=[], start=None,
                   actor_steps0=actor.actor_steps,
                   episode_steps0=actor.episode_steps.copy())

        def timed_run(max_steps, stop=None):
            if rec["start"] is None:
                rec["start"] = (time.perf_counter(), actor.actor_steps)
            run(max_steps, stop)

        def timed_step(state, batch):
            t0, a0 = time.perf_counter(), actor.actor_steps
            out = step(state, batch)
            rec["steps"].append((t0, a0, time.perf_counter(),
                                 actor.actor_steps))
            return out

        actor.run, learner._step_fn = timed_run, timed_step
        runs.append(rec)
        return sys_

    probe = {}

    def log_sink(entry):
        # the first entry: read the run's exporter while it trains
        if probe:
            return
        try:
            port = entry["telemetry_port"]
            probe["healthz"] = http_get(port, "/healthz")
            probe["metrics"] = http_get(port, "/metrics")
        except Exception as e:  # checked below, after the run
            probe["error"] = f"{type(e).__name__}: {e}"

    def counts():
        return (KERNEL_LAUNCHES.get(lstm.KERNEL),
                KERNEL_LAUNCHES.get(lstm.CUDACORE_COUNTER),
                HOST_TRANSFERS.get(ACTOR_ACT),
                lstm.TENSOR_MAP_ENCODES.get(lstm.KERNEL))

    def reset():
        KERNEL_LAUNCHES.reset()
        HOST_TRANSFERS.reset()
        lstm.TENSOR_MAP_ENCODES.reset()

    ckdir = tempfile.mkdtemp(prefix="chip_smoke_fabric_")
    try:
        train._build = capture
        try:
            reset()
            t0 = time.perf_counter()
            m = train.train(cfg, env_factory, checkpoint_dir=ckdir,
                            max_wall_seconds=FABRIC_WALL_S, verbose=False,
                            log_sink=log_sink)
            train_s = time.perf_counter() - t0
            launches, old, acts, encodes = counts()
            first = runs[0]
            actor = first["actor"]
            saved_steps = actor.actor_steps
            saved_episode_steps = actor.episode_steps.copy()

            # the fabric's checks
            if first["act_net"].lstm_layers[0].impl != "pallas":
                fail("the fabric's actors did not resolve the fused LSTM "
                     "kernel")
            lh = m["learnhealth"]
            restarts = {k: h["restarts"] for k, h in m["health"].items()}
            if (m["num_updates"] != cfg.training_steps
                    or m["buffer_training_steps"] != m["num_updates"]
                    or lh["loss_count"] != cfg.training_steps
                    or lh["nonfinite"] or not np.isfinite(m["mean_loss"])):
                fail(f"fabric: {m['num_updates']} updates, buffer "
                     f"{m['buffer_training_steps']} feedbacks, learnhealth "
                     f"{lh}")
            if m["fabric_failed"] or any(restarts.values()):
                fail(f"fabric threads: failed {m['fabric_failed']}, "
                     f"restarts {restarts}")
            if launches != cfg.lstm_layers * acts or not acts or old:
                fail(f"lstm_infer launched {launches} times (CUDA-core "
                     f"{old}) for {acts} actor acts, {cfg.lstm_layers} "
                     "layers")
            if "error" in probe or probe["healthz"][0] != 200:
                fail(f"the run's exporter: {probe}")
            health = json.loads(probe["healthz"][1])
            if (health.get("status") != "ok" or probe["metrics"][0] != 200
                    or "r2d2_replay_buffer_size" not in
                    probe["metrics"][1]):
                fail(f"/healthz {health}, /metrics status "
                     f"{probe['metrics'][0]}")
            runlog = os.path.join(ckdir, "telemetry", "run.jsonl")
            ck = Checkpointer(ckdir)
            if not os.path.exists(runlog) or cfg.training_steps not in (
                    ck.replay_steps()):
                fail(f"run log {os.path.exists(runlog)}, replay snapshots "
                     f"{ck.replay_steps()}")
            print(f"fabric on {card}: {m['num_updates']} updates in "
                  f"{train_s:.2f} s, "
                  f"buffer feedbacks {m['buffer_training_steps']}, mean loss "
                  f"{m['mean_loss']:.5f}, losses finite "
                  f"{lh['loss_count']}/{cfg.training_steps}; threads "
                  f"{sorted(restarts)} restarts 0; /healthz "
                  f"{health['status']}, /metrics "
                  f"{len(probe['metrics'][1])} bytes; checkpoints "
                  f"{ck.steps()}, replay snapshots {ck.replay_steps()}; "
                  f"lstm_infer launches {launches} = {cfg.lstm_layers} x "
                  f"{acts} actor acts, CUDA-core {old}; tensor-map encodes "
                  f"{encodes} ({encodes / acts:.2f} per act)", flush=True)

            # the fabric's timings (from the stamps, no synchronisation)
            steps = first["steps"]
            n_env = cfg.num_actors
            t_start, a_start = first["start"]
            fill_rate = (steps[0][1] - a_start) * n_env / (steps[0][0]
                                                           - t_start)
            train_rate = ((steps[-1][3] - steps[0][1]) * n_env
                          / (steps[-1][2] - steps[0][0]))
            exits = np.asarray([s[2] for s in steps])
            gaps = np.diff(exits) * 1e3
            print(f"fabric timings on {card}: env steps/s while filling "
                  f"{fill_rate:.0f} ({steps[0][1] - a_start} iterations x "
                  f"{n_env} envs), while training {train_rate:.0f}; "
                  f"updates/s {(len(exits) - 1) / (exits[-1] - exits[0]):.3f}"
                  f", update interval p50 {np.percentile(gaps, 50):.2f} ms "
                  f"(min {gaps.min():.2f}, max {gaps.max():.2f}, "
                  f"{len(gaps)} intervals); first update dispatched "
                  f"{(steps[0][2] - steps[0][0]) * 1e3:.1f} ms", flush=True)
            spans = m["trace"]
            print(f"fabric spans on {card} (mean / p50 ms): " + ", ".join(
                f"{k[5:-8]} {v:.2f} / {spans[k[:-8] + '.p50_ms']:.2f}"
                for k, v in sorted(spans.items()) if k.endswith(".mean_ms")),
                flush=True)

            # where an update's and an actor iteration's time goes, the
            # fabric stopped (both run on after the snapshot was saved)
            learner, buffer = first["learner"], first["buffer"]

            def one_update():
                dev, _ = learner._stage(buffer.sample_batch())
                _, loss, _ = first["step"](learner.state, dev)
                return loss.item()

            upd_events = profile_events(torch, one_update, 1)
            upd_wall = wall_ms(torch, one_update, 2)
            if upd_events is None:
                fail("no device time in a learner update")
            if any("lstm_step" in k for k, _, _ in upd_events):
                fail("a learner update launched an lstm_infer kernel")
            upd_dev = sum(ms for _, ms, _ in upd_events)
            print(f"learner update at IMPALA-deep (sample, stage, step, "
                  f"fetch; 1 profiled) on {card}: host wall {upd_wall:.2f} "
                  f"ms, device {upd_dev:.3f} ms in "
                  f"{sum(n for _, _, n in upd_events):.0f} device events, "
                  f"device idle {1 - upd_dev / upd_wall:.1%}; top 5 device "
                  "ops (ms per update, count): " + "; ".join(
                      f"{short_kernel_name(k)} {ms:.3f} ({n:.0f})"
                      for k, ms, n in upd_events[:5]), flush=True)
            one_iter = lambda: first["run"](1)   # noqa: E731
            act_events = profile_events(torch, one_iter, 10)
            act_wall = wall_ms(torch, one_iter, 20)
            if act_events is None:
                fail("no device time in an actor iteration")
            act_dev = sum(ms for _, ms, _ in act_events)
            kern = [(ms, n) for k, ms, n in act_events if WGMMA_KERNEL in k]
            if (not kern or kern[0][1] != cfg.lstm_layers
                    or any(CUDACORE_KERNEL in k for k, _, _ in act_events)):
                fail(f"an IMPALA-deep actor iteration ran {kern} "
                     "tensor-core LSTM kernels")
            print(f"actor iteration at IMPALA-deep (B={cfg.num_actors}) on "
                  f"{card}: host wall {act_wall:.3f} ms, device "
                  f"{act_dev:.4f} ms in "
                  f"{sum(n for _, _, n in act_events):.0f} device events, "
                  f"lstm_infer tensor-core kernel {kern[0][0]:.4f} ms in "
                  f"{kern[0][1]:.0f} launches ({kern[0][0] / act_dev:.1%} of "
                  f"the device time), device idle "
                  f"{1 - act_dev / act_wall:.1%}", flush=True)

            # resume warm: the replay ring and the actors come back
            reset()
            t0 = time.perf_counter()
            m2 = train.train(cfg.replace(training_steps=FABRIC_RESUME_STEPS),
                             env_factory, checkpoint_dir=ckdir, resume=True,
                             max_wall_seconds=FABRIC_WALL_S, verbose=False)
            resume_s = time.perf_counter() - t0
            launches2, old2, acts2, encodes2 = counts()
        finally:
            train._build = real_build
        second = runs[1]
        entries = list(read_entries(runlog))
        env_curve = [e["env_steps"] for e in entries]
        upd_curve = [e["training_steps"] for e in entries]
        if (not m2["restored_replay"]
                or m2["num_updates"] != FABRIC_RESUME_STEPS
                or m2["buffer_training_steps"] != FABRIC_RESUME_STEPS
                or second["actor_steps0"] != saved_steps
                or not np.array_equal(second["episode_steps0"],
                                      saved_episode_steps)
                or second["actor"].actor_steps <= saved_steps
                or m2["env_steps"] < m["env_steps"]
                or env_curve != sorted(env_curve)
                or upd_curve != sorted(upd_curve)):
            fail(f"resume: restored_replay {m2['restored_replay']}, "
                 f"{m2['num_updates']} updates, feedbacks "
                 f"{m2['buffer_training_steps']}, actor steps "
                 f"{second['actor_steps0']} (saved {saved_steps}), env steps "
                 f"{m['env_steps']} -> {m2['env_steps']}, run log env steps "
                 f"{env_curve}, updates {upd_curve}")
        if launches2 != cfg.lstm_layers * acts2 or not acts2 or old2:
            fail(f"resumed: lstm_infer launched {launches2} times (CUDA-core "
                 f"{old2}) for {acts2} actor acts")
        print(f"fabric resume on {card}: restored_replay true, "
              f"{m2['num_updates']} "
              f"updates in {resume_s:.2f} s, actor iterations "
              f"{saved_steps} -> {second['actor_steps0']} (restored) -> "
              f"{second['actor'].actor_steps}, env steps {m['env_steps']} -> "
              f"{m2['env_steps']}, run log {len(entries)} entries monotone; "
              f"lstm_infer launches {launches2} = {cfg.lstm_layers} x "
              f"{acts2} acts, CUDA-core {old2}", flush=True)
        fabric_launches = launches + launches2

        serve_launches = serve_checkpoint(torch, card, cfg, ckdir,
                                          server_mod)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    print(f"phase 6 took {time.perf_counter() - t_phase:.1f} s on {card}",
          flush=True)
    return fabric_launches, serve_launches


def serve_checkpoint(torch, card: str, cfg, ckdir: str, server_mod) -> int:
    """Phase 6's serving half: ``run_server`` on the fabric's checkpoint in
    a worker thread, a client process driving the sessions.  Returns the
    kernel's launches under that traffic."""
    from r2d2_tpu_torch.checkpoint import Checkpointer
    from r2d2_tpu_torch.ops import lstm
    from r2d2_tpu_torch.utils.trace import KERNEL_LAUNCHES

    t0 = time.perf_counter()
    served, holder, result = [], {}, {}
    done = threading.Event()
    real_server = server_mod.SessionServer

    class RecordingServer(real_server):
        """The server run_server builds, with every served batch's inputs
        and outputs recorded (host copies)."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            act = self.batcher.act

            def recording_act(obs, last_action, last_reward, hidden):
                q, new_hidden = act(obs, last_action, last_reward, hidden)
                served.append(tuple(np.array(a) for a in (
                    obs, last_action, last_reward, hidden, q, new_hidden)))
                return q, new_hidden

            self.batcher.act = recording_act
            holder["server"] = self

    def serve():
        try:
            result["stats"] = server_mod.run_server(
                cfg, ckdir, action_dim=TRAIN_ACTIONS,
                max_wall_seconds=FABRIC_WALL_S, verbose=False,
                stop_fn=done.is_set)
        except BaseException as e:  # reported by the main thread
            result["error"] = f"{type(e).__name__}: {e}"

    server_mod.SessionServer = RecordingServer
    thread = threading.Thread(target=serve, name="run_server")
    try:
        thread.start()
        deadline = time.monotonic() + 300
        while not (holder.get("server") is not None
                   and holder["server"]._started):
            if "error" in result or time.monotonic() > deadline:
                fail(f"run_server did not start: {result}")
            time.sleep(0.05)
        server = holder["server"]
        if server.batcher.device.type != "cuda":
            fail(f"run_server acts on {server.batcher.device}")
        # the traffic only: warmup's launches are behind us
        KERNEL_LAUNCHES.reset()
        lstm.TENSOR_MAP_ENCODES.reset()
        ctx = multiprocessing.get_context("spawn")
        out = ctx.Queue()
        child = ctx.Process(target=client_process,
                            args=(server.host, server.port, out, "impala"))
        child.start()
        try:
            reply = out.get(timeout=300)
        except queue.Empty:
            reply = ("error", "the client process sent nothing in 300 s")
        finally:
            child.join(timeout=30)
            if child.is_alive():
                child.terminate()
                child.join(timeout=10)
        launches = KERNEL_LAUNCHES.get(lstm.KERNEL)
        old = KERNEL_LAUNCHES.get(lstm.CUDACORE_COUNTER)
        encodes = lstm.TENSOR_MAP_ENCODES.get(lstm.KERNEL)
        batches = server.batches
        spans = server.tracer.snapshot()
    finally:
        done.set()
        thread.join(timeout=120)
        server_mod.SessionServer = real_server
    if thread.is_alive() or "error" in result:
        fail(f"run_server did not end cleanly: {result}")
    if reply[0] != "ok":
        fail(reply[1])
    _, replies, lat = reply
    stats = result["stats"]
    if len(replies) != FABRIC_SESSIONS * N_STEPS or not all(
            q.shape == (TRAIN_ACTIONS,) and np.isfinite(q).all()
            for q in replies.values()):
        fail(f"{len(replies)} served replies, or a bad q")
    if stats["step"] != FABRIC_RESUME_STEPS or stats["admitted"] != (
            stats["completed"] + stats["reaped"] + stats["evicted"]
            + stats["live"]) or stats["act_failures"]:
        fail(f"run_server stats: {stats}")
    if launches != cfg.lstm_layers * batches or not batches or old:
        fail(f"the served checkpoint launched lstm_infer {launches} times "
             f"(CUDA-core {old}) for {batches} batches")
    snap = os.path.join(ckdir, "sessions.snap", "meta.json")
    if not os.path.exists(snap):
        fail("no session snapshot at shutdown")
    with open(snap) as f:
        snap_counters = json.load(f)["counters"]
    want = {k: stats[k] for k in ("admitted", "completed", "reaped",
                                  "evicted")}
    if snap_counters != want:
        fail(f"session snapshot counters {snap_counters}, server {want}")
    state, _ = Checkpointer(ckdir).restore(FABRIC_RESUME_STEPS)
    q_err, h_err = served_vs_plain(torch, cfg, TRAIN_ACTIONS, served,
                                   state.params, server.batcher.bucket)
    sizes = sorted(len(b[0]) for b in served)
    print(f"served checkpoint step_{stats['step']} on {card}: {batches} "
          f"batches, "
          f"sizes {sizes}; q vs plain-LSTM act of the restored params "
          f"max_abs_err {q_err:.3e} (tol {Q_TOL:.0e}), new hidden "
          f"{h_err:.3e}; store {want} live {stats['live']}, session "
          f"snapshot counters equal; lstm_infer launches {launches} = "
          f"{cfg.lstm_layers} x {batches} batches, CUDA-core {old}; "
          f"tensor-map encodes {encodes} ({encodes / batches:.2f} per "
          f"batch)", flush=True)
    if q_err > Q_TOL or h_err > Q_TOL:
        fail("the served checkpoint disagrees with the plain-LSTM act")
    p50, p99 = np.percentile(np.asarray(lat) * 1e3, [50, 99])
    print(f"served checkpoint latency on {card}: serving.act p50 "
          f"{spans['span.serving.act.p50_ms']:.3f} ms p99 "
          f"{spans['span.serving.act.p99_ms']:.3f} ms; client round trip "
          f"({len(lat)} requests) p50 {p50:.3f} ms p99 {p99:.3f} ms; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def scripted_blocks(cfg, n_blocks: int, seed: int = 0):
    """``n_blocks`` well-formed blocks at ``cfg``'s shapes, cut by the
    port's LocalBuffer from seeded random steps."""
    from r2d2_tpu_torch.replay.block import LocalBuffer

    rng = np.random.default_rng(seed)
    local = LocalBuffer(cfg, TRAIN_ACTIONS)
    local.reset(rng.integers(0, 256, cfg.stored_obs_shape, np.uint8))
    out = []
    while len(out) < n_blocks:
        for _ in range(cfg.block_length):
            local.add(int(rng.integers(TRAIN_ACTIONS)), float(rng.normal()),
                      rng.integers(0, 256, cfg.stored_obs_shape, np.uint8),
                      rng.normal(size=TRAIN_ACTIONS).astype(np.float32),
                      (rng.normal(size=(2, cfg.lstm_layers, cfg.hidden_dim))
                       * 0.5).astype(np.float32))
        blk, prios, _ = local.finish(
            rng.normal(size=TRAIN_ACTIONS).astype(np.float32))
        out.append((blk, prios))
    return out


def device_ring_checks(torch, base) -> dict:
    """Phase 7's checks on the card before the fabric runs: the device
    gather against the host ring, the in-graph sampler against its CPU
    run, and a super-step against k sequential train steps."""
    from r2d2_tpu_torch.learner import step as step_mod
    from r2d2_tpu_torch.models import create_network
    from r2d2_tpu_torch.replay.device_ring import (
        DeviceRing,
        gather_batch,
        to_device,
    )
    from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer

    cuda = torch.device("cuda", torch.cuda.current_device())
    k, B = base.superstep_k, base.batch_size
    # a ring of a few blocks at the full slot shapes, wrapped once
    cfg = base.replace(buffer_capacity=CHECK_RING_BLOCKS * base.block_length,
                       learning_starts=base.block_length, in_graph_per=False)
    host = ReplayBuffer(cfg.replace(device_replay=False), TRAIN_ACTIONS,
                        rng=np.random.default_rng(3))
    ring = DeviceRing(cfg, TRAIN_ACTIONS, device=cuda)
    dev = ReplayBuffer(cfg, TRAIN_ACTIONS, rng=np.random.default_rng(3),
                       device_ring=ring)
    for blk, prios in scripted_blocks(cfg, CHECK_RING_BLOCKS + 2):
        host.add(blk, prios, None)
        dev.add(blk, prios, None)
    meta = dev.sample_meta(k)
    ints = to_device(meta["ints"], cuda)
    weights = to_device(meta["is_weights"], cuda)
    for j in range(k):
        got = gather_batch(cfg, ring.snapshot(), ints[j], weights[j])
        want = dict(host._gather_rows(meta["idxes"][j]),
                    is_weights=meta["is_weights"][j])
        for key, v in want.items():
            if not np.array_equal(got[key].cpu().numpy(), v):
                fail(f"device gather field {key} differs from the host "
                     f"ring's _gather_rows (bundle {j})")
    print(f"device gather on the card: {k} bundles x {B} rows from a "
          f"{cfg.num_blocks}-block ring at the full slot shapes (obs "
          f"{tuple(ring.arrays['obs'].shape[1:])}, hidden "
          f"{tuple(ring.arrays['hidden'].shape[1:])}), every field bit for "
          "bit equal to the host ring's _gather_rows", flush=True)

    # the in-graph sampler over the full ring's leaf count, card vs CPU
    rng = np.random.default_rng(11)
    NB, K = base.num_blocks, base.seqs_per_block
    prios = (rng.random(NB * K) * rng.exponential(1.0, NB * K)).astype(
        np.float32)
    prios[rng.random(NB * K) < 0.3] = 0.0
    seq_meta = np.stack([rng.integers(0, base.burn_in_steps + 1, (NB, K)),
                         rng.integers(1, base.learning_steps + 1, (NB, K)),
                         rng.integers(1, base.forward_steps + 1, (NB, K))],
                        axis=-1).astype(np.int32)
    first = rng.integers(0, base.burn_in_steps + 1, NB).astype(np.int32)
    u = rng.random((k, B)).astype(np.float32)
    w_err = 0.0
    for j in range(k):
        leaves = [torch.from_numpy(a) for a in (prios, seq_meta, first)]
        cpu = step_mod._in_graph_sample(base, torch.from_numpy(u[j]), *leaves)
        card = step_mod._in_graph_sample(
            base, torch.from_numpy(u[j]).to(cuda),
            *(t.to(cuda) for t in leaves))
        if not (torch.equal(card[0].cpu(), cpu[0])
                and torch.equal(card[2].cpu(), cpu[2])):
            fail("the in-graph sampler's indices or ints differ between the "
                 "card and the CPU")
        w_err = max(w_err, float(((card[1].cpu() - cpu[1]).abs()
                                  / cpu[1]).max()))
    if w_err > SAMPLER_W_RTOL:
        fail(f"the in-graph sampler's weights: {w_err:.3e} relative")
    print(f"in-graph sampler on the card vs the CPU over {NB * K} leaves "
          f"(30% zero), {k} x {B} draws: indices and ints equal, weights "
          f"max relative error {w_err:.3e} (tol {SAMPLER_W_RTOL:.0e})",
          flush=True)

    # one host-sampled super-step against k sequential train steps on the
    # same bundles, bit for bit: cuDNN's conv weight gradients may
    # otherwise pick algorithms with atomics, so deterministic for this
    # check only
    net = create_network(cfg, TRAIN_ACTIONS, device=cuda,
                         generator=torch.Generator().manual_seed(5))
    fused = step_mod.create_train_state(cfg, net.state_dict())
    seq = step_mod.create_train_state(cfg, net.state_dict())
    super_step = step_mod.make_super_step_fn(cfg, net, k)
    train_step = step_mod.make_train_step(cfg, net)
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        fused, losses, fprios = super_step(fused, ring.snapshot(), ints,
                                           weights)
        seq_losses, seq_prios = [], []
        for j in range(k):
            seq, loss, p = train_step(seq, gather_batch(
                cfg, ring.snapshot(), ints[j], weights[j]))
            seq_losses.append(loss)
            seq_prios.append(p)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = was
    same = (torch.equal(losses, torch.stack(seq_losses))
            and torch.equal(fprios, torch.stack(seq_prios))
            and all(torch.equal(a[n], b[n])
                    for a, b in ((fused.params, seq.params),
                                 (fused.target_params, seq.target_params),
                                 (fused.opt_state.mu, seq.opt_state.mu),
                                 (fused.opt_state.nu, seq.opt_state.nu))
                    for n in a))
    if not (same and torch.isfinite(losses).all()):
        fail(f"a super-step is not k sequential steps bit for bit (losses "
             f"{losses.tolist()} vs {[x.item() for x in seq_losses]})")
    print(f"super-step (k={k}) vs {k} sequential train steps on the card: "
          f"losses {fmt_list(losses.tolist())}, priorities, params, target "
          "params and Adam moments bit for bit equal (cuDNN deterministic)",
          flush=True)
    return dict(gather_bitwise=True, sampler_w_rel_err=w_err,
                superstep_bitwise=True)


def device_replay_run(torch, card: str, cfg, need: int) -> int:
    """One of phase 7's ``train()`` runs on the full ring (in-graph PER or
    host-sampled, as ``cfg.in_graph_per`` says), its checks, timings and a
    profiled super-step.  Returns the kernel's launches in the run.  The
    run's ring, learner and buffer are only referenced from this frame,
    so they are freed when it returns."""
    import shutil
    import tempfile
    import warnings

    from r2d2_tpu_torch import train
    from r2d2_tpu_torch.actor import ACTOR_ACT
    from r2d2_tpu_torch.checkpoint import Checkpointer
    from r2d2_tpu_torch.envs import FakeAtariEnv
    from r2d2_tpu_torch.learner import step as step_mod
    from r2d2_tpu_torch.ops import lstm
    from r2d2_tpu_torch.replay.device_ring import to_device
    from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS, KERNEL_LAUNCHES

    in_graph, steps, k = cfg.in_graph_per, cfg.training_steps, cfg.superstep_k
    real_build = train._build
    real_sample = step_mod._in_graph_sample

    def env_factory(c, seed):
        return FakeAtariEnv(obs_shape=c.stored_obs_shape,
                            action_dim=TRAIN_ACTIONS,
                            episode_len=FAKE_EPISODE_LEN, seed=seed)

    rec = dict(dispatches=[], start=None, leaves=[], drawn=[])

    def capture(*args, **kw):
        sys_ = real_build(*args, **kw)
        actor, learner, ring = (sys_["actor"], sys_["learner"],
                                sys_["ring"])
        run, loop = actor.run, learner._superstep_loop
        rec.update(sys_)

        def timed_run(max_steps, stop=None):
            if rec["start"] is None:
                rec["start"] = (time.perf_counter(), actor.actor_steps)
            run(max_steps, stop)

        def stamped_loop(k_, target, t0, gate, sample, harvest,
                         prepare=None, tracer=None):
            # each dispatch stamped (entry, actor iterations, exit,
            # actor iterations), without any synchronisation
            def stamped():
                t, a = time.perf_counter(), actor.actor_steps
                out = sample()
                rec["dispatches"].append(
                    (t, a, time.perf_counter(), actor.actor_steps))
                return out
            return loop(k_, target, t0, gate, stamped, harvest,
                        prepare, tracer)

        actor.run, learner._superstep_loop = timed_run, stamped_loop
        if ring is not None and ring.cfg.in_graph_per:
            # the leaves just before and after each super-step, both
            # copied on the card under the buffer lock (per_meta and
            # put_prios run inside it)
            per_meta, put_prios = ring.per_meta, ring.put_prios

            def meta_before():
                rec["leaves"].append([ring.take_prios().clone(), None,
                                      len(rec["drawn"])])
                return per_meta()

            def prios_after(p):
                rec["leaves"][-1][1] = p.clone()
                put_prios(p)

            ring.per_meta, ring.put_prios = meta_before, prios_after
        return sys_

    def drawing(*args, **kw):
        out = real_sample(*args, **kw)
        rec["drawn"].append(out[0])
        return out

    ckdir = tempfile.mkdtemp(prefix="chip_smoke_device_ring_")
    try:
        KERNEL_LAUNCHES.reset()
        HOST_TRANSFERS.reset()
        torch.cuda.reset_peak_memory_stats()
        train._build = capture
        step_mod._in_graph_sample = drawing
        t0 = time.perf_counter()
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                m = train.train(cfg, env_factory, checkpoint_dir=ckdir,
                                max_wall_seconds=DEVICE_WALL_S,
                                verbose=False)
        finally:
            train._build = real_build
            step_mod._in_graph_sample = real_sample
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = KERNEL_LAUNCHES.get(lstm.KERNEL)
        old = KERNEL_LAUNCHES.get(lstm.CUDACORE_COUNTER)
        acts = HOST_TRANSFERS.get(ACTOR_ACT)
        fetches = HOST_TRANSFERS.get("learner.result_fetch")
        put_bytes = HOST_TRANSFERS.get("learner.dispatch_put_bytes")
        ring, learner, buffer = rec["ring"], rec["learner"], rec["buffer"]
        n_disp = len(rec["dispatches"])
        mode = "in-graph PER" if in_graph else "host-sampled PER"

        # the run's checks
        fallback = [str(w.message) for w in caught
                    if "falling back" in str(w.message)
                    or "in_graph_per disabled" in str(w.message)]
        if (fallback or ring is None
                or rec["cfg"].in_graph_per != in_graph
                or ring.arrays["obs"].device.type != "cuda"):
            fail(f"{mode}: the ring was not built on the card "
                 f"({fallback})")
        if ring.nbytes() != need:
            fail(f"ring nbytes {ring.nbytes()} != data_bytes {need}")
        lh = m["learnhealth"]
        restarts = {n: h["restarts"] for n, h in m["health"].items()}
        if (m["num_updates"] != steps or n_disp * k != steps
                or lh["loss_count"] != steps or lh["nonfinite"]
                or not np.isfinite(m["mean_loss"])
                or m["fabric_failed"] or any(restarts.values())):
            fail(f"{mode}: {m['num_updates']} updates in {n_disp} "
                 f"dispatches, learnhealth {lh}, failed "
                 f"{m['fabric_failed']}, restarts {restarts}")
        if fetches != n_disp:
            fail(f"{mode}: {fetches} result fetches for {n_disp} "
                 "dispatches")
        if put_bytes / n_disp >= DISPATCH_PUT_MAX_BYTES:
            fail(f"{mode}: {put_bytes} bytes put for {n_disp} dispatches")
        if not in_graph and m["buffer_training_steps"] != k * n_disp:
            fail(f"{mode}: {m['buffer_training_steps']} priority "
                 f"feedbacks for {n_disp} dispatches")
        if launches != cfg.lstm_layers * acts or not acts or old:
            fail(f"{mode}: lstm_infer launched {launches} times "
                 f"(CUDA-core {old}) for {acts} actor acts")
        ck = Checkpointer(ckdir)
        if 16 not in ck.steps() or ck.replay_steps():
            fail(f"{mode}: checkpoints {ck.steps()}, replay snapshots "
                 f"{ck.replay_steps()}")
        scatter = ""
        if in_graph:
            drawn_n = changed_n = 0
            for before, after, first in rec["leaves"][:n_disp]:
                drawn = torch.zeros_like(before, dtype=torch.bool)
                for idx in rec["drawn"][first:first + k]:
                    drawn[idx] = True
                changed = after != before
                if (not changed.any() or (changed & ~drawn).any()
                        or (before[drawn] <= 0).any()):
                    fail("in-graph PER: the scatter changed leaves it "
                         "did not draw, or drew a zero leaf")
                drawn_n += int(drawn.sum())
                changed_n += int(changed.sum())
            padding = ring.per_meta()["seq_meta"][:, :, 1].reshape(-1) == 0
            if (ring.take_prios()[padding] != 0).any():
                fail("in-graph PER: a padding leaf became sampleable")
            scatter = (f"; scatter changed {changed_n} of {drawn_n} "
                       f"drawn leaves over {n_disp} dispatches, none "
                       "undrawn; "
                       f"{int(padding.sum())} padding/empty leaves all 0")
        print(f"device replay, {mode}, on {card}: {m['num_updates']} "
              f"updates in {n_disp} dispatches of k={k} in {run_s:.2f} s,"
              f" losses finite {lh['loss_count']}/{steps}, mean loss "
              f"{m['mean_loss']:.5f}; priority feedbacks "
              f"{m['buffer_training_steps']}; result fetches {fetches}; "
              f"dispatch puts {put_bytes} bytes "
              f"({put_bytes / n_disp:.0f} per dispatch); lstm_infer "
              f"launches {launches} = {cfg.lstm_layers} x {acts} acts, "
              f"CUDA-core {old}; checkpoints {ck.steps()}, replay "
              f"snapshots {ck.replay_steps()}{scatter}", flush=True)

        # timings, from the stamps (no synchronisation added)
        d = rec["dispatches"]
        n_env = cfg.num_actors
        t_start, a_start = rec["start"]
        fill = (d[0][1] - a_start) * n_env / (d[0][0] - t_start)
        training = ((d[-1][3] - d[0][1]) * n_env / (d[-1][2] - d[0][0]))
        gaps = np.diff([x[0] for x in d]) * 1e3
        issue = np.asarray([x[2] - x[0] for x in d]) * 1e3
        spans = m["trace"]
        hold = (f"; lock hold per dispatch (learner.dispatch_lock) p50 "
                f"{spans['span.learner.dispatch_lock.p50_ms']:.2f} ms, "
                f"mean {spans['span.learner.dispatch_lock.mean_ms']:.2f}"
                if in_graph else
                f"; gathers under the lock (learner.gather_dispatch) "
                f"mean {spans['span.learner.gather_dispatch.mean_ms']:.2f}"
                " ms")
        print(f"device replay timings, {mode}, on {card}: env steps/s "
              f"while filling {fill:.0f} ({d[0][1] - a_start} iterations"
              f" x {n_env} envs), while training {training:.0f}; "
              f"dispatch interval p50 {np.percentile(gaps, 50):.2f} ms "
              f"({len(gaps)} intervals, min {gaps.min():.2f}, max "
              f"{gaps.max():.2f}); dispatch issue p50 "
              f"{np.percentile(issue, 50):.2f} ms, first "
              f"{issue[0]:.2f}{hold}; ring {ring.nbytes() / 1e9:.2f} GB,"
              f" peak allocated {peak / 1e9:.2f} GB", flush=True)

        # one super-step profiled, the fabric stopped
        if in_graph:
            fn = step_mod.make_in_graph_per_super_step_fn(
                cfg, learner.net, k)
            gen = torch.Generator(device=learner.device).manual_seed(1)
            per = ring.per_meta()

            def one_super():
                fn(learner.state, ring.snapshot(), ring.take_prios(),
                   per["seq_meta"], per["first"], generator=gen)
        else:
            fn = step_mod.make_super_step_fn(cfg, learner.net, k)

            def one_super():
                meta = buffer.sample_meta(k)
                fn(learner.state, ring.snapshot(),
                   to_device(meta["ints"], learner.device),
                   to_device(meta["is_weights"], learner.device))
        events = profile_events(torch, one_super, 1)
        wall = wall_ms(torch, one_super, 1)
        if events is None:
            fail(f"{mode}: no device time in a super-step")
        if any("lstm_step" in name for name, _, _ in events):
            fail(f"{mode}: a super-step launched an lstm_infer kernel")
        dev_ms = sum(ms for _, ms, _ in events)
        print(f"super-step ({mode}, k={k}, 1 profiled) on {card}: host "
              f"wall {wall:.2f} ms, device {dev_ms:.3f} ms in "
              f"{sum(n for _, _, n in events):.0f} device events, "
              f"device idle {1 - dev_ms / wall:.1%}; no lstm_infer "
              "kernel; top 5 device ops (ms per super-step, count): "
              + "; ".join(f"{short_kernel_name(n)} {ms:.3f} ({c:.0f})"
                          for n, ms, c in events[:5]), flush=True)
        return launches
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


def phase_device_replay(torch, card: str) -> int:
    """Phase 7: the Pong preset trained by ``train()`` from its full replay
    ring on the card, with in-graph PER and then host-sampled.  Returns
    the kernel's launches over both runs."""
    import gc

    from r2d2_tpu_torch.config import pong_config
    from r2d2_tpu_torch.replay.replay_buffer import data_bytes

    t_phase = time.perf_counter()
    base = pong_config(game_name="Fake")
    literal = dict(torso="nature", stored_obs_shape=(21, 21, 16),
                   hidden_dim=H, lstm_layers=1, compute_dtype="bfloat16",
                   batch_size=64, burn_in_steps=40, learning_steps=40,
                   forward_steps=5, block_length=400, num_actors=64,
                   env_workers=8, device_replay=True, in_graph_per=True,
                   superstep_k=4, superstep_pipeline=2,
                   buffer_capacity=2_000_000)
    got = {k: getattr(base, k) for k in literal}
    if got != literal:
        fail(f"pong_config(game_name='Fake') is not the Pong preset: {got}")
    need = data_bytes(base, TRAIN_ACTIONS)
    print("reduced: " + ", ".join(
        f"{k} {getattr(base, k)} -> {v}" for k, v in DEVICE_REDUCED.items())
        + ", training_steps " + " then ".join(
            f"{n} (in_graph_per={igp})" for igp, n in DEVICE_RUNS)
        + f"; the full ring on the card ({base.num_blocks} blocks of "
        f"{base.block_length}, {need / 1e9:.2f} GB); fake env episodes of "
        f"{FAKE_EPISODE_LEN} steps, {TRAIN_ACTIONS} actions", flush=True)
    device_ring_checks(torch, base)
    launches = 0
    for in_graph, steps in DEVICE_RUNS:
        launches += device_replay_run(
            torch, card, base.replace(in_graph_per=in_graph,
                                      training_steps=steps, **DEVICE_REDUCED),
            need)
        # the next run builds its own 15.8 GB ring; this one's went with
        # the run's frame
        gc.collect()
        torch.cuda.empty_cache()
    print(f"phase 7 took {time.perf_counter() - t_phase:.1f} s on {card}",
          flush=True)
    return launches


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    try:
        from r2d2_tpu_torch.ops import _build
        from r2d2_tpu_torch.ops import lstm
    except ImportError as e:
        fail(f"the port is not importable from here ({e}); run from the "
             "root of a checkout")

    # phase 1: the device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build every kernel from the checkout's sources
    t0 = time.perf_counter()
    secs = _build.build([lstm.KERNEL], verbose=True)
    print(f"build: {secs} ({time.perf_counter() - t0:.2f} s)", flush=True)

    # phase 3: every design against its plain version, and the timings
    errs, sweep, timings = phase_kernel(torch, lstm)

    # phase 4: the serving path at full width
    serve_launches = phase_serving(torch, card)

    # phase 5: the training path at full width
    train_launches = phase_training(torch, card)

    # phase 6: the IMPALA-deep fabric, resumed, and its checkpoint served
    fabric_launches, serve_ckpt_launches = phase_fabric(torch, card)

    # phase 7: the Pong preset from its full replay ring on the card
    device_replay_launches = phase_device_replay(torch, card)

    head = timings[(1, 256)]
    print(json.dumps({"kernels": [{
        "name": "lstm_infer",
        "route": "cuda",
        "source": "r2d2_tpu_torch/csrc/lstm_infer.cu",
        "replaces": "r2d2_tpu/ops/lstm.py:46",
        "launches": (serve_launches + train_launches + fabric_launches
                     + serve_ckpt_launches + device_replay_launches),
        "launches_by_path": {"serving": serve_launches,
                             "training": train_launches,
                             "fabric": fabric_launches,
                             "serving_checkpoint": serve_ckpt_launches,
                             "device_replay": device_replay_launches},
        "max_abs_err": errs["tensor_core"][0],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "layer_step_ms": head["layer_step_ms"],
        "device_ms": head["device_ms"],
        "plain_device_ms": head["plain_device_ms"],
        "library_device_ms": head["library_device_ms"],
        "layer_step_device_ms": head["layer_step_device_ms"],
        "checked": True,
        "times": "*ms: per call with the launch (CUDA events); *device_ms: "
                 "device time per call (torch.profiler); *host_us: host "
                 "time to issue a call; library_ms (torch.lstm_cell) and "
                 "layer_step_ms are one LSTM layer step (x @ wi + b and "
                 "the recurrence), ms and plain_ms the recurrence alone; "
                 f"bf16 wh, H={H}, mean of {ROUNDS} rounds",
        "shape": {"T": 1, "B": 256, "H": H, "wh": "bfloat16"},
        "by_shape": {f"T={T} B={B}": v for (T, B), v in timings.items()},
        "max_abs_err_by_design": {k: {"per_step": v[0], "whole_unroll": v[1]}
                                  for k, v in errs.items()},
        "tile_sweep_device_ms": sweep,
        "card": card,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
