"""Replay-plane throughput: in-process vs K shm shards vs K socket shards.

Port of ``tools/replay_bench.py``.  Does splitting the host replay plane
(ring + sum-tree + batch gather) across ``replay_shards=K`` owner
processes (``parallel/replay_shards.py``) raise aggregate ingest+sample
throughput past what ONE process's core can do, and what does the socket
transport (``replay_transport="socket"``, ``parallel/replay_net.py`` over
loopback TCP) add on identical content?  Three burst-aligned cells per
K ∈ {1, 2, 4} and transport, against the in-process ReplayBuffer
baseline:

- **ingest**: blocks/s from the first ``add`` to the last block
  CONSUMED (sharded cells count shard-side ingestion through the shm
  block channel, not just the route-side memcpy — burst-aligned, so
  queue depth can't flatter the number);
- **sample**: preassembled batches/s over a filled ring (sharded cells
  pay the RPC round trip but fan the gather out across shard cores);
- **combined**: a producer thread ingests continuously while the main
  thread samples — the steady-state contention case the learner
  actually lives in, where the K=1 buffer serialises both on one lock
  and one core.

Blocks are pre-built outside the timed region.  The whole plane is host
code (numpy and processes, no torch), so the cells measure the host this
runs on; each line names its CPU count.  Run:

    python -m r2d2_tpu_torch.tools.replay_bench [--out OUT.json] [--doc DOC.md]

It prints one JSON line per cell and writes the JSON and the rendered
doc only where ``--out`` / ``--doc`` name a path.
"""
import argparse
import json
import os
import sys
import threading
import time

import numpy as np

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.parallel.replay_net import NetShardedReplayPlane
from r2d2_tpu_torch.parallel.replay_shards import ShardedReplayPlane
from r2d2_tpu_torch.replay.block import LocalBuffer
from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer

A = 6

INGEST_BLOCKS = 192
SAMPLE_BATCHES = 120
COMBINED_SECONDS = 8.0


def bench_cfg(**kw):
    # pong-scale windows over real 84x84 (space-to-depth) frames so the
    # gathers/memcpys are representative; 64 blocks divide by K ∈ {2,4}
    base = dict(game_name="Pong", obs_shape=(84, 84, 1),
                burn_in_steps=40, learning_steps=40, forward_steps=5,
                block_length=80, buffer_capacity=80 * 64, batch_size=64,
                learning_starts=80, replay_sample_timeout=30.0)
    base.update(kw)
    return Config(**base)


def build_blocks(cfg, n, seed=0):
    # obs at the STORED shape (envs apply the space-to-depth fold at
    # emission; the ring only ever sees stored_obs_shape)
    rng = np.random.default_rng(seed)
    out = []
    local = LocalBuffer(cfg, A)
    for b in range(n):
        local.reset(rng.integers(0, 256, cfg.stored_obs_shape, np.uint8))
        for s in range(cfg.block_length):
            local.add(int(rng.integers(A)), float(rng.normal()),
                      rng.integers(0, 256, cfg.stored_obs_shape, np.uint8),
                      rng.normal(size=A).astype(np.float32),
                      rng.normal(size=(2, cfg.lstm_layers,
                                       cfg.hidden_dim)).astype(np.float32))
        block, prios, ep = local.finish(None)
        out.append((block, prios, ep))
    return out


class _InprocPlane:
    """The baseline behind the same mini-interface the cells drive."""

    def __init__(self, cfg):
        self.buf = ReplayBuffer(cfg, A, rng=np.random.default_rng(0))

    def add(self, block, prios, ep):
        self.buf.add(block, prios, ep)

    def consumed_blocks(self):
        # in-process add() is synchronous: consumed == added
        return None

    def sample(self, B):
        return self.buf.sample_batch(B)

    def close(self):
        pass


class _ShardPlaneCell:
    def __init__(self, cfg):
        self.plane = ShardedReplayPlane(cfg, A,
                                        rng=np.random.default_rng(0))
        self.plane.start()

    def add(self, block, prios, ep):
        self.plane.add(block, prios, ep)

    def consumed_blocks(self):
        t = self.plane.poll_shard_stats()["totals"]
        return int(t.get("blocks", 0))

    def sample(self, B):
        out = self.plane.sample_batch(B)
        assert out is not None
        return out

    def close(self):
        self.plane.shutdown()


class _NetPlaneCell:
    """The socket plane over managed loopback shards — the identical
    content through real TCP frames (encode + kernel loopback + decode
    + frame CRC both ways), so shm-vs-socket is a pure transport A/B."""

    def __init__(self, cfg):
        self.plane = NetShardedReplayPlane(cfg, A,
                                           rng=np.random.default_rng(0))
        self.plane.start()

    def add(self, block, prios, ep):
        self.plane.add(block, prios, ep)

    def consumed_blocks(self):
        t = self.plane.poll_shard_stats()["totals"]
        return int(t.get("blocks", 0))

    def sample(self, B):
        out = self.plane.sample_batch(B)
        if out is None:            # a transient redistribution round
            out = self.plane.sample_batch(B)
        assert out is not None
        return out

    def close(self):
        self.plane.shutdown()


def run_cell(name, make_plane, cfg, blocks):
    plane = make_plane(cfg)
    try:
        # --- ingest burst: first add → last block CONSUMED ------------
        t0 = time.perf_counter()
        for i in range(INGEST_BLOCKS):
            plane.add(*blocks[i % len(blocks)])
        if plane.consumed_blocks() is not None:
            while plane.consumed_blocks() < INGEST_BLOCKS:
                time.sleep(0.002)
        ingest_s = time.perf_counter() - t0
        # --- sample burst over the (now full) ring --------------------
        t0 = time.perf_counter()
        for _ in range(SAMPLE_BATCHES):
            plane.sample(cfg.batch_size)
        sample_s = time.perf_counter() - t0
        # --- combined: continuous ingest thread + sampling main thread
        stop = threading.Event()
        added = [0]

        def producer():
            i = 0
            while not stop.is_set():
                plane.add(*blocks[i % len(blocks)])
                added[0] += 1
                i += 1

        # a bounded producer: stop-event, joined before the cell exits
        th = threading.Thread(target=producer, daemon=True)  # graftlint: disable=thread-discipline -- bounded measured bench producer, stop-event + joined before the cell exits
        th.start()
        batches = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < COMBINED_SECONDS:
            plane.sample(cfg.batch_size)
            batches += 1
        combined_s = time.perf_counter() - t0
        stop.set()
        th.join(10.0)
        cell = dict(
            cell=name,
            ingest_blocks_per_sec=round(INGEST_BLOCKS / ingest_s, 1),
            sample_batches_per_sec=round(SAMPLE_BATCHES / sample_s, 1),
            combined_sample_batches_per_sec=round(batches / combined_s, 1),
            combined_ingest_blocks_per_sec=round(added[0] / combined_s, 1),
        )
        print(json.dumps(cell), flush=True)
        return cell
    finally:
        plane.close()


def render_doc(data):
    """The cells as markdown: the table, then the ratios the cells exist
    for (each plane against the in-process baseline, the K = 1 → 2 slope
    within the shm family, and the socket tax at matched K)."""
    lines = [
        "# Replay plane: in-process vs K shm shards vs K socket shards",
        "",
        f"Host: {data['host_cpus']} CPUs.  The socket cells run the "
        "cross-host fabric (parallel/replay_net.py) over loopback, so "
        "their tax is the frame encode, CRC and kernel TCP path with no "
        "propagation delay.",
        "",
        f"Burst-aligned cells: ingest = {data['ingest_blocks']} "
        f"pre-built blocks ({data['block_length']} steps), first add → "
        f"last block *consumed*; sample = {data['sample_batches']} "
        f"batch-{data['batch_size']} draws; combined = a continuous "
        "producer thread + a sampling main thread for "
        f"{data['combined_seconds']} s.",
        "",
        "| cell | ingest blocks/s | sample batches/s | combined "
        "batches/s | combined ingest blocks/s |",
        "|---|---|---|---|---|",
    ]
    for r in data["results"]:
        lines.append(
            f"| {r['cell']} | {r['ingest_blocks_per_sec']} "
            f"| {r['sample_batches_per_sec']} "
            f"| {r['combined_sample_batches_per_sec']} "
            f"| {r['combined_ingest_blocks_per_sec']} |")

    def ratio(a, b, key):
        return a[key] / max(1e-9, b[key])

    by = {r["cell"]: r for r in data["results"]}
    base = by.get("inprocess")
    if base:
        lines += ["", "## Combined cell against in-process", ""]
        lines += [f"- {name}: sample "
                  f"{ratio(r, base, 'combined_sample_batches_per_sec'):.2f}x"
                  ", ingest "
                  f"{ratio(r, base, 'combined_ingest_blocks_per_sec'):.2f}x"
                  for name, r in by.items() if name != "inprocess"]
    k1, k2 = by.get("sharded_k1"), by.get("sharded_k2")
    if k1 and k2:
        lines += ["", "## K = 1 → K = 2 within the shm shards", ""]
        lines += [f"- {label}: {ratio(k2, k1, key):.2f}x" for key, label in (
            ("sample_batches_per_sec", "sample burst"),
            ("combined_sample_batches_per_sec", "combined sample"),
            ("combined_ingest_blocks_per_sec", "combined ingest"))]
    taxes = [(K, by.get(f"sharded_k{K}"), by.get(f"socket_k{K}"))
             for K in (1, 2, 4)]
    if any(shm and sock for _, shm, sock in taxes):
        lines += ["", "## Socket against shm at matched K", ""]
        lines += [
            f"- K={K}: sample burst "
            f"{ratio(sock, shm, 'sample_batches_per_sec'):.2f}x, combined "
            "sample "
            f"{ratio(sock, shm, 'combined_sample_batches_per_sec'):.2f}x, "
            "combined ingest "
            f"{ratio(sock, shm, 'combined_ingest_blocks_per_sec'):.2f}x"
            for K, shm, sock in taxes if shm and sock]
    return "\n".join(lines + [""])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="write the cells' JSON here")
    ap.add_argument("--doc", default=None,
                    help="render the cells as a markdown doc here")
    ap.add_argument("--render", action="store_true",
                    help="re-render --doc from the JSON at --out (no "
                         "remeasure)")
    args = ap.parse_args(argv)
    if args.render:
        if not (args.out and args.doc):
            ap.error("--render needs --out (the JSON) and --doc")
        with open(args.out) as f:
            data = json.load(f)
        _write(args.doc, render_doc(data))
        return 0
    cfg1 = bench_cfg(replay_shards=1)
    print("building blocks...", flush=True)
    blocks = build_blocks(cfg1, 64)
    results = [run_cell("inprocess", _InprocPlane, cfg1, blocks)]
    for K in (1, 2, 4):
        cfg = bench_cfg(replay_shards=K)
        results.append(run_cell(f"sharded_k{K}", _ShardPlaneCell, cfg,
                                blocks))
    for K in (1, 2, 4):
        cfg = bench_cfg(replay_shards=K, replay_transport="socket",
                        replay_net_send_budget=30.0)
        results.append(run_cell(f"socket_k{K}", _NetPlaneCell, cfg,
                                blocks))
    data = dict(host_cpus=os.cpu_count() or 0,
                ingest_blocks=INGEST_BLOCKS,
                sample_batches=SAMPLE_BATCHES,
                combined_seconds=COMBINED_SECONDS,
                batch_size=cfg1.batch_size,
                block_length=cfg1.block_length,
                measure="burst-aligned (ingest timed to last consumed "
                        "block; blocks pre-built outside the timed "
                        "region)",
                results=results)
    if args.out:
        _write(args.out, json.dumps(data, indent=1))
    if args.doc:
        _write(args.doc, render_doc(data))
    return 0


def _write(path: str, text: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    print(f"→ {path}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
