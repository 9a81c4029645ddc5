"""Full-fabric soak: run the threaded production composition for a wall
budget and assert steady-state health.

Port of ``tools/soak.py``.  Two actor fleets + env workers + device-
resident replay + fused super-steps + pipelined harvest, on the fake env.
Checks at exit: zero fabric failures, exact priority accounting (buffer
counter == learner counter), no throughput decay (last-third updates/s
within 20% of the middle third), and prints the health summary.  The
per-interval stats entries go to ``soak_telemetry.jsonl`` (next to
``--out`` when given), one JSON line each.

Run:  python -m r2d2_tpu_torch.tools.soak [minutes] [--ingraph] [--dp]
          [--out OUT.json] [--device {cuda,cpu}] [--log-interval S]

``--device`` defaults to ``cuda``: like every entry point of the port, it
runs on the card unless asked for the CPU (``--device cpu`` acts on the
CPU too).  The reference's ``--device`` flag is the other way round: its
soak is CPU-pinned unless the flag is given.  The reference enables its
persistent compile cache first; the port compiles nothing per run (its
one kernel is built once by ``ops/_build.py``), so it has no counterpart.

``--ingraph`` soaks the device-PER drivetrain (cfg.in_graph_per):
priority feedback never crosses the host, and note_updates keeps the
accounting check exact.

``--dp`` soaks the reference's layout: the dp-sharded ring composition
on the learner mesh at dp = 4 x tp = 2 (the reference's 8 forced host
devices in one process), here 8 ranks, one process each
(``tools/rank_worker.py``), over gloo on the CPU, or over NCCL with one
card a rank; with ``--ingraph`` that is the cross-rank in-graph PER
fabric (global stratified sampling over the dp-sharded PER leaves).  Each
dp group spans two ranks: its leader (the lower rank) runs the group's
actors, slab of the ring and priority feedback and broadcasts each
update's rows to its peer, which trains on them and has no buffer.  With
``--device cuda`` and fewer than 8 cards it exits non-zero, naming the 8
ranks it needs; it never drops to the CPU or to fewer ranks.  Every
rank's accounting is checked — a leader's buffer counts one feedback per
update, a peer's counts none —; the decay check and the telemetry
artifact read rank 0's entries.  ``--log-interval`` (the reference's 10 s
by default) sets the stats entries' period: the decay check compares
medians of the entries' updates/s, so an entry must hold several
super-steps for the check to resolve a 20 % change (the ``--dp`` soak on
an 8-core CPU trains at under one update a second in super-steps of
k = 4, and wants 30 s).

The analyzer's preflight over ``r2d2_tpu_torch`` runs first: a dirty
tree fails the soak before it burns its budget.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from r2d2_tpu_torch.config import test_config
from r2d2_tpu_torch.envs.fake import FakeAtariEnv
from r2d2_tpu_torch.telemetry.runlog import artifact_log, read_entries

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the reference's --dp mesh (tools/soak.py:78-79), one rank a device
DP_SHAPE = (("dp", 4), ("tp", 2))
DP_RANKS = 8
# the keys of a rank's metrics the checks and the summary read
RANK_KEYS = ("num_updates", "env_steps", "fabric_failed",
             "buffer_training_steps", "health")


def soak_config(ingraph: bool = False, dp: bool = False,
                device: str = "cuda", log_interval: float = 10.0):
    """The reference soak's configuration (``tools/soak.py:69-79``),
    ``--dp``'s mesh included."""
    return test_config(
        game_name="Fake", num_actors=32, hidden_dim=128,
        obs_shape=(24, 24, 1), torso="mlp", batch_size=32,
        burn_in_steps=8, learning_steps=8, forward_steps=2,
        block_length=32, buffer_capacity=25600, learning_starts=1600,
        device_replay=True, superstep_k=4, superstep_pipeline=2,
        in_graph_per=ingraph,
        actor_fleets=2, env_workers=2,
        training_steps=10**9, log_interval=log_interval,
        **(dict(act_device="cpu") if device == "cpu" else {}),
        **(dict(device_ring_layout="dp", mesh_shape=DP_SHAPE)
           if dp else {}))


def env_factory(c, s):
    return FakeAtariEnv(obs_shape=c.stored_obs_shape, action_dim=4, seed=s,
                        episode_len=200)


def soak_run(minutes: float, ingraph: bool, dp: bool, device: str,
             log_sink=None, log_interval: float = 10.0) -> dict:
    """One rank's (or the lone process's) training run: ``train()`` for
    ``minutes`` of wall clock, with the metrics the checks read and
    whether the rank is a dp group's peer."""
    from r2d2_tpu_torch.train import train

    m = train(soak_config(ingraph, dp, device, log_interval),
              env_factory=env_factory,
              use_mesh=dp, max_wall_seconds=minutes * 60.0, verbose=False,
              log_sink=log_sink, device="cpu" if device == "cpu" else None)
    return dict({k: m[k] for k in RANK_KEYS}, peer=bool(m.get("peer")))


def _require_cards() -> None:
    """``--dp`` on the card needs one card a rank: exit naming the ranks
    otherwise (never the CPU, never dp = 1)."""
    import torch

    n = torch.cuda.device_count()
    if n < DP_RANKS:
        sys.exit(f"--dp soaks dp = 4 x tp = 2: {DP_RANKS} ranks, one "
                 f"card each, and this machine has {n}; run it with "
                 f"{DP_RANKS} cards, or on the CPU with --device cpu")


def _dp_ranks(minutes: float, ingraph: bool, device: str,
              log_path: str, log_interval: float) -> list:
    """``soak_run`` on each of the ``DP_RANKS`` ranks; rank 0 appends its
    stats entries to ``log_path``."""
    from r2d2_tpu_torch.tools.rank_worker import run_ranks

    with tempfile.TemporaryDirectory(prefix="soak_dp_") as work:
        return run_ranks(
            "soak", DP_RANKS, work,
            dict(minutes=minutes, ingraph=ingraph, device=device,
                 log_path=log_path, log_interval=log_interval),
            timeout=minutes * 60.0 + 600.0, device=device)


def main(minutes: float = 20.0, ingraph: bool = False, dp: bool = False,
         out: str = None, device: str = "cuda",
         log_interval: float = 10.0) -> int:
    from r2d2_tpu_torch.analysis import preflight

    # fail fast on a dirty tree before burning a soak budget
    preflight(ROOT)
    if dp and device == "cuda":
        _require_cards()
    t0 = time.time()
    # machine-readable per-interval telemetry next to the summary
    # artifact — every stats entry, one JSON line each, so a soak is
    # analyzable without re-running it
    runlog = artifact_log(out, "soak_telemetry.jsonl")
    try:
        if dp:
            runlog.close()   # rank 0 appends to it from its own process
            ranks = _dp_ranks(minutes, ingraph, device, runlog.path,
                              log_interval)
        else:
            ranks = [soak_run(minutes, ingraph, False, device,
                              log_sink=runlog.append,
                              log_interval=log_interval)]
    finally:
        runlog.close()
    wall = time.time() - t0
    m = ranks[0]

    # rates come from the JSONL (every entry of the run), so that the
    # mid-vs-last decay comparison sees the whole run
    rates = [e["updates_per_sec"] for e in read_entries(runlog.path)
             if e["updates_per_sec"] > 0]
    if len(rates) >= 3:
        third = len(rates) // 3
        mid = float(np.median(rates[third:2 * third]))
        last = float(np.median(rates[-third:]))
        ok_decay = last >= 0.8 * mid
    elif rates:  # run too short to split into thirds: no decay signal
        mid = last = float(np.median(rates))
        ok_decay = True
    else:
        mid = last = None
        ok_decay = False
    ok_failures = not any(r["fabric_failed"] for r in ranks)
    # a leader feeds back once per update; a peer has no buffer
    ok_priorities = all(
        r["buffer_training_steps"] == (0 if r.get("peer")
                                       else r["num_updates"])
        for r in ranks)

    summary = dict(
        minutes=round(wall / 60.0, 1),
        num_updates=int(m["num_updates"]),
        env_steps=int(m["env_steps"]),
        updates_per_sec_mid=round(mid, 1) if mid is not None else None,
        updates_per_sec_last=round(last, 1) if last is not None else None,
        fabric_failed=not ok_failures,
        priority_accounting_exact=ok_priorities,
        no_throughput_decay=ok_decay,
        health=m["health"],
    )
    print(json.dumps(summary, indent=1))
    if out:
        with open(out, "w") as f:
            json.dump(summary, f, indent=1)
    ok = ok_failures and ok_priorities and ok_decay
    print("SOAK", "PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("minutes", nargs="?", type=float, default=20.0)
    ap.add_argument("--ingraph", action="store_true")
    ap.add_argument("--dp", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--log-interval", type=float, default=10.0)
    return ap.parse_args(argv)


if __name__ == "__main__":
    a = parse_args()
    sys.exit(main(a.minutes, ingraph=a.ingraph, dp=a.dp, out=a.out,
                  device=a.device, log_interval=a.log_interval))
