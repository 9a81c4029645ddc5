"""Loopback sample round trip of the socket replay plane, with and without
``TCP_NODELAY`` on both ends of every link.

Two shard servers run in spawned processes on 127.0.0.1; the coordinator
attaches to them (``replay_hosts``) and draws batches the way the fabric's
sample thread does, feeding priorities back after each draw as the
learner's priority thread does.  The two socket settings run in turns
(off, on, on, off) and the script prints one JSON line: per setting, the
p50 and p99 of ``sample_batch`` and the draws per second.  The replay
geometry is the test preset's (mlp-sized blocks, batch 8) unless
``--flagship`` asks for the flagship's (B = 64, 38.9 MB responses).

    python -m r2d2_tpu_torch.tools.replay_rtt [--draws 300] [--flagship]
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import socket
import time

import numpy as np

A = 4


def _tune(nodelay: bool):
    """The link's ``_tune_socket`` with TCP_NODELAY set or cleared."""
    from r2d2_tpu_torch.parallel import replay_net

    base = replay_net._tune_socket

    def tune(sock):
        base(sock)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                        int(nodelay))
    return tune


def _server(cfg, shard_id: int, nodelay: bool, port_q, stop) -> None:
    from r2d2_tpu_torch.parallel import replay_net

    replay_net._tune_socket = _tune(nodelay)
    srv = replay_net.ShardServer(replay_net.shard_slice_config(cfg), A,
                                 shard_id, epoch=1)
    port_q.put((shard_id, srv.port))
    try:
        srv.serve_forever(stop.is_set)
    finally:
        srv.close()


def _blocks(cfg, n: int):
    from r2d2_tpu_torch.replay.block import LocalBuffer

    rng = np.random.default_rng(0)
    for b in range(n):
        local = LocalBuffer(cfg, A)
        local.reset(rng.integers(0, 255, cfg.stored_obs_shape, np.uint8))
        for s in range(cfg.block_length):
            local.add(s % A, float(s),
                      rng.integers(0, 255, cfg.stored_obs_shape, np.uint8),
                      rng.normal(size=A).astype(np.float32),
                      np.zeros((2, cfg.lstm_layers, cfg.hidden_dim),
                               np.float32))
        block, _, ep = local.finish(None)
        yield block, np.full(cfg.seqs_per_block, 1.0 + b % 7,
                             np.float32), ep


def measure(cfg, nodelay: bool, draws: int) -> dict:
    from r2d2_tpu_torch.parallel import replay_net

    ctx = mp.get_context("spawn")
    stop, port_q = ctx.Event(), ctx.Queue()
    procs = [ctx.Process(target=_server, args=(cfg, s, nodelay, port_q,
                                               stop), daemon=True)
             for s in range(cfg.replay_shards)]
    for p in procs:
        p.start()
    ports = dict(port_q.get(timeout=60) for _ in procs)
    hosts = ",".join(f"127.0.0.1:{ports[s]}" for s in sorted(ports))
    saved = replay_net._tune_socket
    replay_net._tune_socket = _tune(nodelay)
    plane = None
    try:
        plane = replay_net.NetShardedReplayPlane(
            cfg.replace(replay_hosts=hosts), A, rng=np.random.default_rng(0))
        plane.start(wait_ready=30.0)
        for block, prios, ep in _blocks(cfg, cfg.learning_starts
                                        // cfg.block_length + 4):
            plane.add(block, prios, ep)
        deadline = time.time() + 60
        while not plane.ready and time.time() < deadline:
            time.sleep(0.05)
        times = []
        t_start = time.perf_counter()
        while len(times) < draws:
            t0 = time.perf_counter()
            batch = plane.sample_batch()
            dt = time.perf_counter() - t0
            if batch is None:
                continue
            times.append(dt)
            plane.update_priorities(batch["idxes"],
                                    np.full(cfg.batch_size, 0.5),
                                    batch["block_ptr"], 0.0)
        wall = time.perf_counter() - t_start
        ms = np.array(times) * 1e3
        return dict(nodelay=nodelay, draws=draws,
                    sample_p50_ms=float(np.percentile(ms, 50)),
                    sample_p99_ms=float(np.percentile(ms, 99)),
                    draws_per_s=draws / wall,
                    timeouts=plane.sample_timeouts)
    finally:
        if plane is not None:
            plane.shutdown()
        replay_net._tune_socket = saved
        stop.set()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.terminate()
                p.join(2)


def main(argv=None) -> None:
    from r2d2_tpu_torch.config import Config, test_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--draws", type=int, default=300)
    ap.add_argument("--flagship", action="store_true")
    args = ap.parse_args(argv)
    if args.flagship:
        cfg = Config(game_name="Fake", replay_shards=2,
                     replay_transport="socket", buffer_capacity=40_000,
                     learning_starts=4_000)
    else:
        cfg = test_config(game_name="Fake", replay_shards=2,
                          replay_transport="socket")
    runs = [measure(cfg, nd, args.draws) for nd in (False, True, True,
                                                     False)]
    out = {}
    for key in ("off", "on"):
        rs = [r for r in runs if r["nodelay"] == (key == "on")]
        out[key] = dict(
            sample_p50_ms=[r["sample_p50_ms"] for r in rs],
            sample_p99_ms=[r["sample_p99_ms"] for r in rs],
            draws_per_s=[r["draws_per_s"] for r in rs],
            timeouts=[r["timeouts"] for r in rs])
    print(json.dumps(dict(geometry="flagship" if args.flagship else "test",
                          batch=cfg.batch_size, shards=cfg.replay_shards,
                          **out)))


if __name__ == "__main__":
    main()
