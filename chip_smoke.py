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
   the card, H=512, B in {1, 7, 64, 65, 256} (65 crosses a 64-row tile),
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
   each tile width n, and at (T, B) = (1, 1), (1, 32), (1, 256), (85, 64)
   in bf16, in ``ROUNDS`` rounds that take the designs in turns (forward,
   then backward): time per call with the launch (CUDA events), device
   time (``torch.profiler``) and the host's time to issue a call, of both
   kernels and the plain version, and of the layer step (``x @ wi + b``
   then the kernel) against one library call for the same layer step
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
5. one ``{"kernels": [...]}`` JSON line;
6. last line: ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import multiprocessing
import queue
import subprocess
import sys
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
# phase 3's shapes: B = 65 crosses a 64-row tile of the tensor-core kernel
CHECK_B = (1, 7, 64, 65, 256)
TIMED = ((1, 1), (1, 32), (1, 256), (85, 64))
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


def session_inputs(obs_shape, seed: int = 1):
    """The traffic: per (session, step) an observation and a reward, made
    from ``seed`` — the client process and the checks rebuild the same."""
    rng = np.random.default_rng(seed)
    sids = list(range(100, 100 + N_SESSIONS))
    obs = {(s, t): rng.integers(0, 256, obs_shape, np.uint8)
           for s in sids for t in range(N_STEPS)}
    reward = {(s, t): float(rng.normal()) for s in sids
              for t in range(N_STEPS)}
    return sids, obs, reward


def client_process(host: str, port: int, out) -> None:
    """The external client (its own process, as a frontend would be):
    opens the sessions, sends the steps in groups, feeds each session its
    greedy action back, and puts ``("ok", replies, latencies)`` or
    ``("error", message)`` on ``out``."""
    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.serving.client import SessionClient
    from r2d2_tpu_torch.serving.wire import STATUS_OK

    cfg = Config(serve_max_batch=256)
    sids, obs, reward = session_inputs(cfg.stored_obs_shape)
    replies, lat = {}, []
    try:
        client = SessionClient(cfg, ACTION_DIM, host, port, timeout=60.0)
    except OSError as e:
        out.put(("error", f"connect failed: {e}"))
        return
    try:
        for s in sids:
            if client.open_session(s) != STATUS_OK:
                out.put(("error", f"open_session({s}) refused"))
                return
        la = {s: np.zeros(ACTION_DIM, np.float32) for s in sids}
        for t in range(N_STEPS):
            lo = 0
            for g in GROUPS:
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
                    la[s] = np.zeros(ACTION_DIM, np.float32)
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

    # phase 4: the main path — serving at full width
    launches = phase_serving(torch, card)

    head = timings[(1, 256)]
    print(json.dumps({"kernels": [{
        "name": "lstm_infer",
        "route": "cuda",
        "source": "r2d2_tpu_torch/csrc/lstm_infer.cu",
        "replaces": "r2d2_tpu/ops/lstm.py:46",
        "launches": launches,
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
