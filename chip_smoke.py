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
3. kernel vs plain: the fused LSTM inference kernel against
   ``lstm_unroll_reference`` on the card, H=512, B in {1, 7, 256}, T in
   {1, 85}, ``wh`` in float32 and bfloat16 (TF32 off).  Each step, taken
   from the kernel's own state, must match the plain step to 1e-5 max-abs
   in float32 and 1e-4 in bfloat16 (the operands are rounded at the same
   points, only the order of the f32 sums differs), the one-launch unroll
   must equal the chain of one-step launches bit for bit, and the whole
   unroll must match the plain unroll to 1e-5 in float32 and 1e-2 in
   bfloat16 (there a last-bit difference that crosses a bf16 rounding
   boundary of h moves the next operand by one bf16 ulp, and the
   recurrence carries it).  Prints the kernel's, the plain version's and
   the library comparator's (``torch.addmm`` plus the elementwise cell)
   time per call;
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
   live``; and the kernel was launched once per batch (counts reset just
   before the traffic).  Prints the client-side p50/p99 act latency;
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


def device_ms(torch, fn, iters: int = 20, name: str = ""):
    """``(ms, events)`` per call from a ``torch.profiler`` trace: the summed
    time and the number of the device events (kernels, copies) whose name
    contains ``name`` (all of them for ""), over ``iters`` calls.  ms is
    None when the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    # only device-side events: a CPU op's row repeats the device time of
    # the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and name in e.key]
    total = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
    count = sum(e.count for e in events) / iters
    return (total / iters / 1e3 if total > 0 else None), count


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


def phase_kernel(torch, lstm):
    """Phase 3: kernel vs plain on the card, and the timings."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    max_err = {"float32": 0.0, "bfloat16": 0.0}     # per step
    free_err = {"float32": 0.0, "bfloat16": 0.0}    # whole unroll
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for T in (1, 85):
        for B in (1, 7, 256):
            xp = randn(T, B, 4 * H, scale=0.5)
            wh = randn(H, 4 * H, scale=H ** -0.5)
            h0, c0 = randn(B, H, scale=0.5), randn(B, H, scale=0.5)
            for name, dt in dts.items():
                whc = wh.to(dt)
                got = lstm.lstm_unroll_cuda(xp, whc, h0, c0)
                want = lstm.lstm_unroll_reference(xp, wh, h0, c0, dt)
                # step by step from the kernel's own state: each step is
                # the plain step up to the order of the f32 sums, and the
                # one-launch unroll is the chain of one-step launches
                h, c = h0, c0
                step_err = 0.0
                for t in range(T):
                    _, h1, c1 = lstm.lstm_unroll_cuda(xp[t:t + 1], whc, h, c)
                    _, h2, c2 = lstm.lstm_unroll_reference(
                        xp[t:t + 1], wh, h, c, dt)
                    step_err = max(step_err, (h1 - h2).abs().max().item(),
                                   (c1 - c2).abs().max().item())
                    if not torch.equal(h1, got[0][t]):
                        fail(f"T={T} B={B} {name}: the unroll's step {t} "
                             "differs from the one-step launch")
                    h, c = h1, c1
                torch.cuda.synchronize()
                if not torch.equal(c, got[2]):
                    fail(f"T={T} B={B} {name}: c_T differs from the chain")
                if not all(torch.isfinite(g).all().item() for g in got):
                    fail(f"kernel output not finite at T={T} B={B} {name}")
                err = max((g - w).abs().max().item()
                          for g, w in zip(got, want))
                tol = F32_TOL if name == "float32" else BF16_TOL
                free_tol = F32_TOL if name == "float32" else BF16_FREE_TOL
                print(f"lstm_infer vs plain T={T} B={B} {name}: per-step "
                      f"max_abs_err={step_err:.3e} (tol {tol:.0e}), whole "
                      f"unroll {err:.3e} (tol {free_tol:.0e})", flush=True)
                if step_err > tol or err > free_tol:
                    fail(f"lstm_infer disagrees with its plain version at "
                         f"T={T} B={B} {name}")
                max_err[name] = max(max_err[name], step_err)
                free_err[name] = max(free_err[name], err)

    timings = {}
    for T, B in ((1, 256), (85, 64)):
        xp = randn(T, B, 4 * H, scale=0.5)
        wh = randn(H, 4 * H, scale=H ** -0.5)
        h0, c0 = randn(B, H, scale=0.5), randn(B, H, scale=0.5)
        for name, dt in dts.items():
            whc = wh.to(dt)
            whf = whc.float()

            def library():
                h, c = h0, c0
                for t in range(T):
                    gates = torch.addmm(xp[t], h.to(dt).float(), whf)
                    i, f, g, o = gates.split(H, dim=-1)
                    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                    h = torch.sigmoid(o) * torch.tanh(c)
                return h, c

            ms = bench_ms(torch,
                          lambda: lstm.lstm_unroll_cuda(xp, whc, h0, c0))
            plain = bench_ms(torch, lambda: lstm.lstm_unroll_reference(
                xp, wh, h0, c0, dt))
            lib = bench_ms(torch, library)
            dev, _ = device_ms(torch, lambda: lstm.lstm_unroll_cuda(
                xp, whc, h0, c0), name="lstm_step_kernel")
            plain_dev, _ = device_ms(
                torch, lambda: lstm.lstm_unroll_reference(xp, wh, h0, c0, dt))
            bound, by = lstm_bound_ms(T, B, name)
            timings[(T, B, name)] = dict(ms=ms, plain_ms=plain,
                                         library_ms=lib, bound_ms=bound,
                                         bound_by=by, device_ms=dev,
                                         plain_device_ms=plain_dev)

            print(f"lstm_infer time T={T} B={B} {name}: kernel {ms:.4f} ms "
                  f"per call (device {fmt(dev)}), plain {plain:.4f} ms "
                  f"(device {fmt(plain_dev)}), library (addmm + cell) "
                  f"{lib:.4f} ms, bound {bound:.4f} ms ({by})", flush=True)
    return max_err, free_err, timings


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
    launches = KERNEL_LAUNCHES.get("lstm_infer")
    stats = server.stats()
    counts = server.store.counts()
    if counts["admitted"] != (counts["completed"] + counts["reaped"]
                              + counts["evicted"] + counts["live"]):
        fail(f"store accounting broken: {counts}")
    if stats["requests"] != N_SESSIONS * N_STEPS or stats["act_failures"]:
        fail(f"server stats: {stats}")
    if launches != stats["batches"] * cfg.lstm_layers or launches < 1:
        fail(f"lstm_infer launched {launches} times for {stats['batches']} "
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
        kern, _ = device_ms(torch, lambda: act(*rows), iters=20,
                            name="lstm_step_kernel")
        casts, n_casts = device_ms(torch, lambda: act(*rows), iters=20,
                                   name="copy")
        idle = "not measured" if dev is None else f"{1 - dev / wall:.1%}"
        print(f"serving act alone n={n}: host wall {wall:.3f} ms per batch, "
              f"device {fmt(dev)} in {events:.0f} device events (lstm_infer "
              f"{fmt(kern)}, {n_casts:.0f} copy/cast kernels {fmt(casts)}), "
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

    # phase 3: kernel vs plain on the card
    max_err, free_err, timings = phase_kernel(torch, lstm)

    # phase 4: the main path — serving at full width
    launches = phase_serving(torch, card)

    head = timings[(1, 256, "bfloat16")]
    eval_ = timings[(85, 64, "bfloat16")]
    print(json.dumps({"kernels": [{
        "name": "lstm_infer",
        "route": "cuda",
        "source": "r2d2_tpu_torch/csrc/lstm_infer.cu",
        "replaces": "r2d2_tpu/ops/lstm.py:46",
        "launches": launches,
        "max_abs_err": max(max_err.values()),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "checked": True,
        "shape": {"T": 1, "B": 256, "H": H, "wh": "bfloat16"},
        "max_abs_err_by_dtype": max_err,
        "max_abs_err_whole_unroll": free_err,
        "T85_B64_bf16": eval_,
        "card": card,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
