"""Synthetic episodic traffic against the session-serving tier.

Port of ``tools/session_load_gen.py``.  Drives hundreds–thousands of
concurrent sessions at a :class:`~r2d2_tpu_torch.serving.server.
SessionServer` the way external clients would: W worker threads each own
ONE connection multiplexing M sessions (an event loop per worker — send
every due request pipelined, poll replies, schedule the next step after a
seeded think-time), with seeded per-session episode lengths so the run
replays.  Per-request latency is measured client-side send→reply and
published as p50/p95/p99 alongside the server's own ``serving.*``
registry surfaces; throughput is sessions/s (completed episodes) and
acts/s.

Chaos sites (the session tier's failure drills, ``utils/chaos.py``):

- ``kill_session_client`` — a worker drops its connection abruptly,
  abandoning every live session it owned; the server's disconnect reap
  must free the hidden slots (``serving.reaped``), and the worker
  reconnects with fresh sessions so load holds.
- ``slow_session_client`` — one session freezes ``dur`` seconds
  mid-episode; continuous batching must keep serving everyone else.

Run:

    python -m r2d2_tpu_torch.tools.session_load_gen [--sessions N]
        [--workers W] [--steps-mean M] [--think-ms T] [--seconds S]
        [--seed K] [--chaos SPEC] [--max-sessions N] [--out OUT.json]
        [--device {cuda,cpu}]

:func:`main` builds its own server in two cells, ``float32`` and
``bfloat16``, each serving an untrained flagship network (nature torso,
LSTM-512, 9 actions) drawn from a seeded ``torch.Generator`` on
``--device`` (default: the CUDA device).  One difference from the JAX
package's cells: there, both cells compute in the flagship's bf16 and
differ only in the published params; here the ``float32`` cell also
computes in float32, so its LSTM runs the f32 route of the kernel
(``lstm_step_cudacore``) and the ``bfloat16`` cell the tensor-core route
(``lstm_step_wgmma``).  Each cell prints one JSON line, with the kernel
launches it made; then the summary.  Exit code 1 when a cell's
accounting ``admitted == completed + reaped + evicted + live`` fails or
its health is ``failing``.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import threading
import time

import numpy as np

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.serving.client import SessionClient, SessionClientError
from r2d2_tpu_torch.serving.wire import (
    STATUS_EXPIRED,
    STATUS_GONE,
    STATUS_OK,
    STATUS_SHED,
)
from r2d2_tpu_torch.utils.supervisor import Supervisor

CELLS = ("float32", "bfloat16")


class _SessionSim:
    """One synthetic episodic client: seeded length, seeded think-time."""

    __slots__ = ("sid", "steps_total", "step", "due", "inflight",
                 "opened", "done", "outcome", "last_action", "last_reward")

    def __init__(self, sid, steps_total, due):
        self.sid = sid
        self.steps_total = steps_total
        self.step = 0
        self.due = due
        self.inflight = None        # (seq, send_ts) while a request flies
        self.opened = False
        self.done = False
        self.outcome = None         # completed / gone / abandoned / timeout
        self.last_action = None
        self.last_reward = 0.0


def _run_worker(cfg, action_dim, host, port, widx, sids, args, chaos,
                stop, results, results_lock):
    """One worker's event loop over its session set.  All mutable state
    is worker-local; the merged stats land in ``results`` under the
    lock at the end."""
    rng = np.random.default_rng([args["seed"], widx])
    think_s = args["think_s"]
    now = time.monotonic()
    sims = [
        _SessionSim(sid,
                    steps_total=1 + int(rng.geometric(
                        1.0 / max(1, args["steps_mean"]))),
                    due=now + float(rng.uniform(0, max(think_s, 0.002))))
        for sid in sids
    ]
    # replacement ids after a chaos kill: each worker mints from its own
    # disjoint million-wide namespace — overlapping namespaces would let
    # two workers drive ONE server-side session after a couple of kills
    next_sid = 1_000_000 * (widx + 1)
    client = None
    lats, stats = [], dict(completed=0, abandoned=0, gone=0, shed=0,
                           expired=0, acts=0, kills=0, slow=0,
                           client_errors=0)
    deadline = time.monotonic() + args["run_seconds"]

    def connect():
        return SessionClient(cfg, action_dim, host, port,
                             timeout=args["call_timeout"])

    try:
        client = connect()
        while not stop.is_set() and time.monotonic() < deadline:
            live = [s for s in sims if not s.done]
            if not live:
                break
            if chaos is not None and chaos.session_client_kill():
                # mid-episode disconnect: abandon every live session —
                # the server must reap them all on the dead connection,
                # then hold load with fresh replacements
                stats["kills"] += 1
                client.abandon()
                fresh = []
                for s in live:
                    s.done, s.outcome = True, "abandoned"
                    stats["abandoned"] += 1
                    next_sid += 1
                    fresh.append(_SessionSim(
                        next_sid,
                        1 + int(rng.geometric(
                            1.0 / max(1, args["steps_mean"]))),
                        time.monotonic()))
                sims.extend(fresh)
                client = connect()
                continue
            if chaos is not None:
                dur = chaos.session_client_slow_seconds()
                if dur > 0:
                    stats["slow"] += 1
                    live[0].due += dur    # one straggler; others unharmed
            now = time.monotonic()
            idle = True
            for s in live:
                if s.inflight is not None:
                    hit = client.poll_reply(s.sid, s.inflight[0])
                    if hit is None:
                        if now - s.inflight[1] > args["call_timeout"]:
                            s.done, s.outcome = True, "timeout"
                        continue
                    idle = False
                    status, q = hit
                    seq, send_ts = s.inflight
                    s.inflight = None
                    if status == STATUS_OK:
                        lats.append(now - send_ts)
                        stats["acts"] += 1
                        s.step += 1
                        a = int(np.argmax(q))
                        s.last_action = np.zeros(action_dim, np.float32)
                        s.last_action[a] = 1.0
                        s.last_reward = float(rng.normal()) * 0.1
                        if s.step >= s.steps_total:
                            try:
                                client.close_session(s.sid)
                            except SessionClientError:
                                stats["client_errors"] += 1
                            s.done, s.outcome = True, "completed"
                            stats["completed"] += 1
                        else:
                            s.due = now + float(rng.exponential(think_s)
                                                if think_s > 0 else 0.0)
                    elif status == STATUS_GONE:
                        # evicted under the LRU budget: a real frontend
                        # would re-open and restart the episode; the
                        # bench just retires the session
                        s.done, s.outcome = True, "gone"
                        stats["gone"] += 1
                    elif status in (STATUS_SHED, STATUS_EXPIRED):
                        key = ("shed" if status == STATUS_SHED
                               else "expired")
                        stats[key] += 1
                        s.due = now + 0.05 * (1 + rng.random())
                    continue
                if now < s.due:
                    continue
                idle = False
                try:
                    if not s.opened:
                        st = client.open_session(s.sid)
                        if st != STATUS_OK:
                            stats["shed"] += 1
                            s.due = now + 0.1 * (1 + rng.random())
                            continue
                        s.opened = True
                    obs = rng.integers(
                        0, 256, cfg.stored_obs_shape).astype(np.uint8)
                    la = (s.last_action if s.last_action is not None
                          else np.zeros(action_dim, np.float32))
                    seq = client.send_act(s.sid, obs, la, s.last_reward,
                                          reset=s.step == 0)
                    s.inflight = (seq, time.monotonic())
                except SessionClientError:
                    stats["client_errors"] += 1
                    client.close()
                    client = connect()
                    break
            if idle:
                time.sleep(0.001)
        for s in sims:
            if not s.done:
                s.done, s.outcome = True, "deadline"
    finally:
        if client is not None:
            client.close()
        with results_lock:
            results.append(dict(widx=widx, lats=lats, **stats))


def run_load(cfg: Config, action_dim: int, host: str, port: int, *,
             sessions: int = 200, workers: int = 4, steps_mean: int = 10,
             think_s: float = 0.0, run_seconds: float = 120.0,
             call_timeout: float = 30.0, seed: int = 0, chaos=None):
    """Drive ``sessions`` synthetic sessions and return the client-side
    summary (latency percentiles, sessions/s, outcome counts)."""
    args = dict(seed=seed, steps_mean=steps_mean, think_s=think_s,
                run_seconds=run_seconds, call_timeout=call_timeout)
    stop = threading.Event()
    results, results_lock = [], threading.Lock()
    sup = Supervisor(max_restarts=0)
    shards = np.array_split(np.arange(1, sessions + 1), workers)
    t0 = time.monotonic()
    for w, sids in enumerate(shards):
        if not len(sids):
            continue
        sup.start(
            f"loadgen_{w}",
            lambda w=w, sids=[int(s) for s in sids]: _run_worker(
                cfg, action_dim, host, port, w, sids, args, chaos, stop,
                results, results_lock))
    budget = run_seconds + call_timeout + 30.0
    while time.monotonic() - t0 < budget:
        with results_lock:
            if len(results) == sum(1 for s in shards if len(s)):
                break
        if sup.any_failed:
            break
        time.sleep(0.05)
    stop.set()
    sup.join_all(timeout=10.0)
    wall = time.monotonic() - t0
    with results_lock:
        rows = list(results)
    lats = np.asarray([v for r in rows for v in r["lats"]], np.float64)
    total = {k: int(sum(r[k] for r in rows))
             for k in ("completed", "abandoned", "gone", "shed", "expired",
                       "acts", "kills", "slow", "client_errors")}
    out = dict(
        sessions=sessions, workers=workers, steps_mean=steps_mean,
        think_ms=round(think_s * 1e3, 3), wall_seconds=round(wall, 3),
        acts_per_sec=round(len(lats) / wall, 2) if wall else 0.0,
        sessions_per_sec=round(total["completed"] / wall, 3)
        if wall else 0.0,
        workers_failed=sup.any_failed,
        **total)
    if len(lats):
        p50, p95, p99 = np.percentile(lats, [50, 95, 99])
        out.update(act_p50_ms=round(float(p50) * 1e3, 3),
                   act_p95_ms=round(float(p95) * 1e3, 3),
                   act_p99_ms=round(float(p99) * 1e3, 3),
                   act_mean_ms=round(float(lats.mean()) * 1e3, 3))
    return out


def _publish_client_percentiles(registry, summary) -> None:
    """Client-observed latency → the shared registry, next to the
    server's own serving.act_latency_* gauges (two vantage points: the
    delta between them IS the queueing + wire cost)."""
    for key, name in (("act_p50_ms", "serving.client.act_p50_ms"),
                      ("act_p95_ms", "serving.client.act_p95_ms"),
                      ("act_p99_ms", "serving.client.act_p99_ms")):
        if key in summary:
            registry.set_gauge(name, summary[key])  # graftlint: disable=telemetry-discipline -- fixed 3-entry table of literal names, not a hot-loop key
    registry.set_gauge("serving.client.sessions_per_sec",
                       summary.get("sessions_per_sec", 0.0))


def cell_config(dtype: str, max_batch: int, max_sessions: int) -> Config:
    """A cell's config: the flagship geometry, ``dtype`` for both the
    published params and the compute (module docstring)."""
    return Config(game_name="Fake", serve_dtype=dtype, compute_dtype=dtype,
                  serve_max_batch=max_batch, serve_max_sessions=max_sessions,
                  serve_session_idle_s=30.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sessions", type=int, default=500)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--steps-mean", type=int, default=20)
    ap.add_argument("--think-ms", type=float, default=20.0)
    ap.add_argument("--seconds", type=float, default=120.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chaos", default="")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-sessions", type=int, default=None,
                    help="serve_max_sessions (default: --sessions, so "
                         "no evictions; set lower to exercise the LRU)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the cells' servers act (default: the "
                         "CUDA device; raises without one)")
    args = ap.parse_args(argv)

    import torch

    from r2d2_tpu_torch.actor import _resolve_act_device
    from r2d2_tpu_torch.models.network import create_network
    from r2d2_tpu_torch.serving.server import SessionServer
    from r2d2_tpu_torch.utils.chaos import ChaosInjector
    from r2d2_tpu_torch.utils.trace import KERNEL_LAUNCHES

    device = _resolve_act_device("cpu" if args.device == "cpu" else "auto")
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    A = 9  # MsPacman's action count — the default geometry's real head
    cells = []
    for dtype in CELLS:
        cfg = cell_config(dtype, args.max_batch,
                          args.max_sessions or args.sessions)
        net = create_network(cfg, A, device="cpu",
                             generator=torch.Generator().manual_seed(0))
        launched = KERNEL_LAUNCHES.snapshot()
        server = SessionServer(cfg, A, device=device)
        server.publish_params(net.state_dict())
        server.warmup()
        server.start()
        chaos = (ChaosInjector(args.chaos, seed=args.seed)
                 if args.chaos else None)
        try:
            summary = run_load(
                cfg, A, server.host, server.port,
                sessions=args.sessions, workers=args.workers,
                steps_mean=args.steps_mean,
                think_s=args.think_ms / 1e3, run_seconds=args.seconds,
                seed=args.seed, chaos=chaos)
            _publish_client_percentiles(server.registry, summary)
            srv = server.stats()
            hz = server.healthz()
        finally:
            server.stop()
            server.close()
        after = KERNEL_LAUNCHES.snapshot()
        c = dict(serve_dtype=dtype, client=summary, server=srv,
                 health=hz["status"],
                 warmup_batches=len(server.batcher.buckets),
                 lstm_layers=cfg.lstm_layers,
                 kernel_launches={k: after[k] - launched.get(k, 0)
                                  for k in after
                                  if after[k] != launched.get(k, 0)},
                 chaos=chaos.counts() if chaos is not None else {},
                 accounting_ok=(srv["admitted"] == srv["completed"]
                                + srv["reaped"] + srv["evicted"]
                                + srv["live"]))
        cells.append(c)
        print(json.dumps(c), flush=True)

    payload = dict(
        generated=datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
        device=kind,
        config=dict(sessions=args.sessions, workers=args.workers,
                    steps_mean=args.steps_mean, think_ms=args.think_ms,
                    max_batch=args.max_batch, chaos=args.chaos,
                    seed=args.seed),
        cells=cells)
    print(json.dumps(dict(cells=len(cells), device=kind,
                          f32_p99_ms=cells[0]["client"].get("act_p99_ms"),
                          bf16_p99_ms=cells[1]["client"].get(
                              "act_p99_ms"))), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {args.out}")
    return 1 if any(not c["accounting_ok"] or c["health"] == "failing"
                    for c in cells) else 0


if __name__ == "__main__":
    sys.exit(main())
