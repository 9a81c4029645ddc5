"""Command-line entry points of the port.

Port of ``r2d2_tpu/cli.py``: the same six subcommands with the same
options, dests, defaults and choices, over the port's ``config.py``.  The
reference is driven by ``python3 train.py`` and ``python3 test.py``
(README.md:10,14) with configuration done by editing ``config.py``.  Here
the same two workflows are flags on one CLI:

    python -m r2d2_tpu_torch train --game MsPacman --actors 8 \
        --ckpt-dir models/
    python -m r2d2_tpu_torch eval --game MsPacman --ckpt-dir models/ \
        --plot curve.jpg

plus preset selection (``--preset pong`` etc., mirroring BASELINE.json
configs) and typed overrides for any Config field via ``--set field=value``.

The port adds one option, ``--device {cuda,cpu}`` on ``train``, ``serve``,
``eval``, ``replay-shard`` and ``sweep`` (default ``cuda``): the entry
points run on the CUDA device and raise without one; ``--device cpu``
(with ``--set act_device=cpu`` for acting) runs them on the CPU.  A
replay shard keeps its ring in host memory on any device.  The JAX
package's persistent compile cache has no counterpart: the only thing the
port compiles is its kernel, whose build ``ops/_build.py`` caches.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Any, Dict, List, Optional

from r2d2_tpu_torch import config as config_mod
from r2d2_tpu_torch.config import Config

_PRESETS = {
    "default": Config,
    "smoke": config_mod.smoke_config,
    "pong": config_mod.pong_config,
    "hard_exploration": config_mod.hard_exploration_config,
    "atari57": config_mod.atari57_config,
    "impala_deep": config_mod.impala_deep_config,
    "low_resource": config_mod.low_resource_config,
    "test": config_mod.test_config,
}

_FIELD_TYPES = {f.name: f.type for f in dataclasses.fields(Config)}


def _parse_override(kv: str) -> tuple:
    """``field=value`` → (field, typed value). Tuples/etc. parse as JSON."""
    if "=" not in kv:
        raise argparse.ArgumentTypeError(f"--set expects field=value, got {kv!r}")
    name, raw = kv.split("=", 1)
    if name not in _FIELD_TYPES:
        raise argparse.ArgumentTypeError(f"unknown Config field {name!r}")
    current = getattr(Config(), name)
    if isinstance(current, bool):
        low = raw.lower()
        if low in ("1", "true", "yes"):
            return name, True
        if low in ("0", "false", "no"):
            return name, False
        raise argparse.ArgumentTypeError(
            f"{name} expects a boolean (true/false), got {raw!r}")
    if isinstance(current, int):
        return name, int(raw)
    if isinstance(current, float):
        return name, float(raw)
    if isinstance(current, str):
        return name, raw
    return name, tuple(tuple(x) if isinstance(x, list) else x
                       for x in json.loads(raw))


def build_config(args: argparse.Namespace) -> Config:
    preset = _PRESETS[args.preset]
    kw: Dict[str, Any] = {}
    if args.game:
        kw["game_name"] = args.game
    if args.actors is not None:
        kw["num_actors"] = args.actors
    if getattr(args, "actor_transport", None):
        kw["actor_transport"] = args.actor_transport
    if getattr(args, "actor_inference", None):
        kw["actor_inference"] = args.actor_inference
    if args.training_steps is not None:
        kw["training_steps"] = args.training_steps
    if args.seed is not None:
        kw["seed"] = args.seed
    for name, value in (args.overrides or []):
        kw[name] = value
    if args.preset in ("atari57", "hard_exploration"):
        game = kw.pop("game_name", None)
        if game is None and args.preset == "atari57":
            raise ValueError("preset 'atari57' requires --game")
        return preset(game, **kw) if game else preset(**kw)
    return preset(**kw)


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", choices=sorted(_PRESETS), default="default")
    p.add_argument("--game", default=None, help="ALE game name, or 'Fake'")
    p.add_argument("--actors", type=int, default=None)
    p.add_argument("--actor-transport",
                   choices=("thread", "process", "anakin"), default=None,
                   help="experience-generation transport: 'thread' (one "
                        "process, fleet threads; default), 'process' "
                        "(subprocess fleets over a shared-memory block "
                        "channel — use for GIL-bound envs / many cores), "
                        "or 'anakin' (the Podracer fused on-device loop: "
                        "env+actor+replay+learner on the device over a "
                        "batched device env (--anakin-env) — zero host "
                        "crossings on the hot path; implies device_replay "
                        "and in_graph_per; with --mesh the fused program "
                        "shards over the dp x fsdp x tp mesh)")
    p.add_argument("--actor-inference", choices=("local", "serve"),
                   default=None,
                   help="process-transport acting: 'local' (each fleet "
                        "runs its own CPU act twin; default) or 'serve' "
                        "(fleets RPC a centralized InferenceService that "
                        "batches across all fleets and acts once per step "
                        "on the learner's backend)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--training-steps", type=int, default=None)
    p.add_argument("--set", dest="overrides", action="append",
                   type=_parse_override, metavar="FIELD=VALUE",
                   help="override any Config field (repeatable)")
    p.add_argument("--ckpt-dir", default=None)


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the entry point runs: the CUDA device "
                        "(default; raises without one) or the CPU (acting "
                        "on the CPU also needs --set act_device=cpu)")


def _device(args: argparse.Namespace) -> Optional[str]:
    """The ``device=`` an entry point gets: None (its default, the CUDA
    device) or ``"cpu"``."""
    return "cpu" if args.device == "cpu" else None


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="r2d2_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("train", help="run distributed training")
    _add_common(pt)
    _add_device(pt)
    pt.add_argument("--resume", action="store_true",
                    help="resume from the latest COMPLETE checkpoint in "
                         "--ckpt-dir (partial saves from a crash are "
                         "skipped); with a full-state replay snapshot "
                         "present, the replay ring, sum-tree and actor "
                         "RNG/env state resume warm too")
    pt.add_argument("--keep-checkpoints", type=int, default=None,
                    metavar="N",
                    help="retain only the newest N complete checkpoints "
                         "(+ replay snapshots); default keeps all")
    pt.add_argument("--telemetry-port", type=int, default=None,
                    metavar="PORT",
                    help="serve /metrics (Prometheus text), /healthz and "
                         "/statusz on 127.0.0.1:PORT "
                         "(r2d2_tpu_torch/telemetry; "
                         "-1 = ephemeral port, default off); overrides "
                         "cfg.telemetry_port")
    pt.add_argument("--trace-steps", type=int, default=None, metavar="N",
                    help="arm one cross-process trace capture at run "
                         "start covering N train steps; the merged "
                         "Chrome-trace JSON (Perfetto-loadable) lands "
                         "under <ckpt-dir>/telemetry/ "
                         "(telemetry/tracing.py; a live run is captured "
                         "via GET /tracez?steps=N on the telemetry port "
                         "instead); overrides cfg.trace_steps")
    pt.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the whole "
                         "run into DIR (Perfetto-loadable; "
                         "utils/trace.device_profile).  For a bounded "
                         "window on a live run use GET /profilez?secs=S "
                         "on the telemetry port")
    pt.add_argument("--chaos", default=None, metavar="SPEC",
                    help="fault-injection drill spec (utils/chaos.py), "
                         "e.g. 'kill_fleet:every=500;garble_block:p=0.01' "
                         "or 'freeze_service:at=40,dur=5' — overrides "
                         "cfg.chaos_spec")
    pt.add_argument("--act-response-timeout", type=float, default=None,
                    metavar="SECS",
                    help="serve mode: per-attempt act-RPC deadline before "
                         "a fleet retries and then degrades to local "
                         "inference (circuit breaker, "
                         "utils/resilience.py); overrides "
                         "cfg.act_response_timeout (must be > 0)")
    pt.add_argument("--population", default=None, metavar="JSON",
                    help="population plane (r2d2_tpu_torch/league, "
                         "docs/LEAGUE.md): a JSON list of per-member "
                         "config overrides, one process fleet per "
                         "member, e.g. '[{\"name\": \"base\"}, "
                         "{\"preset\": \"low_resource\"}]' — member "
                         "keys validate against the Config schema "
                         "(POPULATION_MEMBER_FIELDS); requires "
                         "--actor-transport process with actor_fleets "
                         "== member count; overrides "
                         "cfg.population_spec")
    pt.add_argument("--league-eval", action="store_true", default=None,
                    help="attach the standing evaluation sidecar "
                         "(league/eval_service.py): a supervised "
                         "subprocess follows this run's checkpoints, "
                         "scores every population member on held-out "
                         "scenario suites (league_eval_episodes per "
                         "member), and publishes "
                         "<ckpt-dir>/telemetry/league.jsonl plus the "
                         "/statusz league table and league.* metrics; "
                         "its death degrades /healthz, never training; "
                         "overrides cfg.league_eval (poll cadence "
                         "league_eval_interval, per-sweep budget "
                         "league_eval_deadline)")
    pt.add_argument("--replay-shards", type=int, default=None, metavar="K",
                    help="shard the host replay plane across K owner "
                         "processes (parallel/replay_shards.py): ingest "
                         "routes blocks to shards over the shm block "
                         "wire format, sampling becomes per-shard "
                         "stratified RPCs answered with preassembled "
                         "batches, priority feedback fans back out; "
                         "sampling stays distribution-equivalent to the "
                         "in-process path (K=1, default).  The sample "
                         "RPC deadline is cfg.replay_sample_timeout "
                         "(--set replay_sample_timeout=SECS); overrides "
                         "cfg.replay_shards")
    pt.add_argument("--replay-transport", choices=("shm", "socket"),
                    default=None,
                    help="how the sharded replay plane's RPCs travel: "
                         "'shm' (same-host owner processes, the fast "
                         "path; default) or 'socket' (length-framed "
                         "CRC'd TCP — the cross-host replay fabric, "
                         "parallel/replay_net.py; with no --replay-hosts "
                         "the plane spawns loopback shard servers "
                         "itself); overrides cfg.replay_transport")
    pt.add_argument("--replay-hosts", default=None, metavar="HOSTS",
                    help="socket replay transport: comma-separated "
                         "host:port endpoints of running `r2d2_tpu_torch "
                         "replay-shard` servers, one per replay shard "
                         "(implies --replay-transport socket); an "
                         "unreachable shard's strata redistribute over "
                         "the reachable mass and it re-attaches through "
                         "the epoch handshake when it returns; overrides "
                         "cfg.replay_hosts")
    pt.add_argument("--mesh", action="store_true",
                    help="learner mesh over the process group's ranks: one "
                         "table-driven DTensor train step on the dp x fsdp x "
                         "tp mesh (cfg.mesh_shape; default puts every "
                         "device on dp).  With --actor-transport anakin "
                         "the whole fused super-step compiles through the "
                         "sharded entry point instead — lanes, carry, "
                         "local buffers and ring/PER over dp, "
                         "params/moments per the table")
    pt.add_argument("--anakin-env", choices=("fake", "grid"), default=None,
                    help="anakin transport: which batched device env the "
                         "fused loop steps — 'fake' (the vmapped FakeAtariEnv "
                         "twin; default) or 'grid' (the goal-seeking "
                         "gridworld, envs/grid.py).  Any env on the "
                         "envs/anakin.py four-method surface inherits the "
                         "whole fast path; overrides cfg.anakin_env")
    pt.add_argument("--anakin-eval-interval", type=int, default=None,
                    metavar="N",
                    help="anakin transport: run the in-graph greedy eval "
                         "lane every N fused dispatches (epsilon=0 "
                         "episodes inside the compiled program, results "
                         "riding the per-dispatch result vector — "
                         "learning curves with no host env; 0 disables, "
                         "the default); overrides cfg.anakin_eval_interval")
    pt.add_argument("--sharding-table", default=None, metavar="SPEC",
                    help="override/extend the per-param sharding table "
                         "(parallel/sharding.py), e.g. "
                         "'lstm_*.wh=,tp;head.*.kernel=' — pattern="
                         "axis,axis clauses over the dp/fsdp/tp mesh "
                         "axes; overrides cfg.sharding_table "
                         "(docs/SHARDING.md)")
    pt.add_argument("--distributed", action="store_true",
                    help="join the torch.distributed process group "
                         "first (torchrun's RANK / WORLD_SIZE / "
                         "LOCAL_RANK / MASTER_ADDR / MASTER_PORT; raises "
                         "when none is set); implies --mesh")
    pt.add_argument("--transfer-guard", action="store_true", default=None,
                    help="arm transfer-guard windows (torch.cuda."
                         "set_sync_debug_mode) around every declared "
                         "dispatch/harvest site after bring-up: an "
                         "undeclared device<->host sync in the hot loop "
                         "raises "
                         "TransferGuardTripped (trip.* counters on "
                         "/statusz) instead of silently stalling the "
                         "stream; overrides cfg.transfer_guard "
                         "(docs/ANALYSIS.md)")
    pt.add_argument("--sync", action="store_true",
                    help="deterministic single-thread trainer (debug)")
    pt.add_argument("--max-wall-seconds", type=float, default=None)
    pt.add_argument("--quiet", action="store_true")

    pv = sub.add_parser(
        "serve", help="session-serving tier over a trained checkpoint")
    _add_common(pv)
    _add_device(pv)
    pv.add_argument("--port", type=int, default=None, metavar="PORT",
                    help="listen port for session traffic on 127.0.0.1 "
                         "(overrides cfg.serve_port; -1 = ephemeral, "
                         "printed at start).  Clients speak the "
                         "serving/wire.py framed protocol "
                         "(docs/SERVING.md)")
    pv.add_argument("--metrics-port", type=int, default=None,
                    metavar="PORT",
                    help="serve /metrics (serving.* histograms incl. act "
                         "latency), three-state /healthz and /statusz on "
                         "127.0.0.1:PORT (overrides cfg.telemetry_port; "
                         "-1 = ephemeral, default off)")
    pv.add_argument("--action-dim", type=int, default=None, metavar="A",
                    help="the policy's action count; default creates the "
                         "configured env once to read it")
    pv.add_argument("--resume-sessions", action="store_true",
                    help="restore the live-session snapshot a previous "
                         "server wrote at shutdown, resuming mid-episode "
                         "sessions bit-exact (clients reconnect and "
                         "continue by session id)")
    pv.add_argument("--follow", action="store_true",
                    help="follow-mode serving: track a live trainer's "
                         "checkpoints in --ckpt-dir (the eval sidecar's "
                         "follow loop, serving/server.py) and republish "
                         "each new complete step's params through the "
                         "ContinuousBatcher — arch-compat-checked, and "
                         "under serve_dtype=bfloat16 the greedy-parity "
                         "gate re-runs per republish (a failing step is "
                         "skipped, serving stays on the last good "
                         "params).  Waits for the first checkpoint if "
                         "none exists yet")
    pv.add_argument("--max-wall-seconds", type=float, default=None)
    pv.add_argument("--quiet", action="store_true")

    pp = sub.add_parser(
        "replay-shard",
        help="run ONE cross-host replay shard server (the socket "
             "replay fabric's remote end, parallel/replay_net.py)")
    _add_common(pp)
    _add_device(pp)
    pp.add_argument("--port", type=int, required=True, metavar="PORT",
                    help="listen port on --host (0 = ephemeral, printed "
                         "at start).  The trainer names it in "
                         "--replay-hosts")
    pp.add_argument("--host", default="127.0.0.1",
                    help="listen address (default loopback; bind a "
                         "routable address for a genuinely remote "
                         "trainer — no TLS/auth yet, keep it on a "
                         "trusted network, docs/OPERATIONS.md)")
    pp.add_argument("--shard-id", type=int, default=0, metavar="S",
                    help="which of the trainer's replay_shards slices "
                         "this server owns (0-based; the trainer's "
                         "HELLO names the shard it expects)")
    pp.add_argument("--replay-shards", type=int, default=None,
                    metavar="K",
                    help="total shard count K (must match the "
                         "trainer's --replay-shards: the slice geometry "
                         "is derived from it); overrides "
                         "cfg.replay_shards")
    pp.add_argument("--action-dim", type=int, default=None, metavar="A",
                    help="the policy's action count; default creates "
                         "the configured env once to read it")
    pp.add_argument("--epoch", type=int, default=None, metavar="N",
                    help="incarnation tag stamped into every frame "
                         "(default: a boot-time stamp — every restart "
                         "is a new epoch, so stale feedback from a "
                         "previous incarnation is droppable on the "
                         "wire)")
    pp.add_argument("--max-wall-seconds", type=float, default=None)
    pp.add_argument("--quiet", action="store_true")

    pe = sub.add_parser("eval", help="checkpoint sweep -> learning curve")
    _add_common(pe)
    _add_device(pe)
    pe.add_argument("--episodes", type=int, default=None)
    pe.add_argument("--out-json", default=None)
    pe.add_argument("--plot", default=None, help="write curve image here")
    pe.add_argument("--follow", action="store_true",
                    help="trail a concurrent training run: keep polling "
                         "--ckpt-dir for new checkpoints (reference "
                         "test.py:26-27 semantics)")
    pe.add_argument("--follow-timeout", type=float, default=600.0,
                    help="with --follow: exit after this many seconds "
                         "without a new checkpoint (default 600)")

    pb = sub.add_parser("bench", help="single-card learner throughput")
    pb.add_argument("--steps", type=int, default=100)

    ps = sub.add_parser("sweep",
                        help="train+eval a game ladder (Atari-57 default)")
    _add_common(ps)
    _add_device(ps)
    ps.add_argument("--games", default=None,
                    help="comma-separated game list (default: Atari-57)")
    ps.add_argument("--out-dir", required=True,
                    help="root for per-game checkpoints + sweep.json")
    ps.add_argument("--episodes", type=int, default=None)
    ps.add_argument("--max-wall-seconds-per-game", type=float, default=None)
    ps.add_argument("--mesh", action="store_true")
    ps.add_argument("--quiet", action="store_true")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.cmd == "bench":
        from r2d2_tpu_torch import bench

        # the phase-isolated path: a wedged phase times out on its own
        # bound instead of hanging the CLI
        return bench._script_main([str(args.steps)])

    try:
        cfg = build_config(args)
    except ValueError as e:
        parser.error(str(e))

    if args.cmd == "train":
        from r2d2_tpu_torch.train import train, train_sync

        try:
            if args.keep_checkpoints is not None:
                cfg = cfg.replace(keep_checkpoints=args.keep_checkpoints)
            if args.chaos is not None:
                cfg = cfg.replace(chaos_spec=args.chaos)
            if args.telemetry_port is not None:
                cfg = cfg.replace(telemetry_port=args.telemetry_port)
            if args.trace_steps is not None:
                cfg = cfg.replace(trace_steps=args.trace_steps)
            if args.act_response_timeout is not None:
                cfg = cfg.replace(
                    act_response_timeout=args.act_response_timeout)
            if args.replay_shards is not None:
                cfg = cfg.replace(replay_shards=args.replay_shards)
            if args.replay_hosts is not None:
                # naming hosts implies the socket transport
                cfg = cfg.replace(replay_transport="socket",
                                  replay_hosts=args.replay_hosts)
            if args.replay_transport is not None:
                cfg = cfg.replace(replay_transport=args.replay_transport)
            if args.sharding_table is not None:
                cfg = cfg.replace(sharding_table=args.sharding_table)
            if args.anakin_env is not None:
                cfg = cfg.replace(anakin_env=args.anakin_env)
            if args.anakin_eval_interval is not None:
                cfg = cfg.replace(
                    anakin_eval_interval=args.anakin_eval_interval)
            if args.population is not None:
                cfg = cfg.replace(population_spec=args.population)
            if args.league_eval:
                cfg = cfg.replace(league_eval=True)
            if args.transfer_guard:
                cfg = cfg.replace(transfer_guard=True)
        except ValueError as e:
            parser.error(str(e))
        if args.sync and args.max_wall_seconds is not None:
            parser.error("--max-wall-seconds is not supported with --sync "
                         "(the deterministic trainer runs to training_steps)")
        if args.sync and (args.trace_steps or cfg.trace_steps):
            parser.error("--trace-steps is not supported with --sync "
                         "(the deterministic trainer runs no telemetry/"
                         "tracing fabric — no capture could ever dump)")
        if args.distributed:
            from r2d2_tpu_torch.parallel.distributed import init_distributed

            # auto=True: with nothing configured it raises instead of
            # silently degrading to N independent single-host runs
            info = init_distributed(auto=True, device=_device(args))
            print(json.dumps(dict(distributed=info)), flush=True)
        fn = train_sync if args.sync else train
        kwargs: Dict[str, Any] = dict(
            checkpoint_dir=args.ckpt_dir, resume=args.resume,
            use_mesh=args.mesh or args.distributed, device=_device(args))
        if not args.sync:
            kwargs.update(max_wall_seconds=args.max_wall_seconds,
                          verbose=not args.quiet,
                          profile_dir=args.profile_dir)
        elif args.profile_dir:
            parser.error("--profile-dir is not supported with --sync "
                         "(the deterministic trainer has no device loop "
                         "worth profiling)")
        metrics = fn(cfg, **kwargs)
        print(json.dumps({k: v for k, v in metrics.items()
                          if isinstance(v, (int, float, str))}))
        return 0

    if args.cmd == "serve":
        if not args.ckpt_dir:
            parser.error("serve requires --ckpt-dir (the checkpoints to "
                         "serve)")
        try:
            if args.port is not None:
                cfg = cfg.replace(serve_port=args.port)
            if args.metrics_port is not None:
                cfg = cfg.replace(telemetry_port=args.metrics_port)
        except ValueError as e:
            parser.error(str(e))
        from r2d2_tpu_torch.serving import run_server

        summary = run_server(
            cfg, args.ckpt_dir, action_dim=args.action_dim,
            resume_sessions=args.resume_sessions,
            max_wall_seconds=args.max_wall_seconds,
            follow=args.follow,
            verbose=not args.quiet, device=_device(args))
        print(json.dumps({k: v for k, v in summary.items()
                          if isinstance(v, (int, float, str))}))
        return 0

    if args.cmd == "sweep":
        from r2d2_tpu_torch.sweep import ATARI_57, run_sweep

        games = (args.games.split(",") if args.games else ATARI_57)
        summary = run_sweep(
            games, cfg, args.out_dir, eval_episodes=args.episodes,
            max_wall_seconds_per_game=args.max_wall_seconds_per_game,
            use_mesh=args.mesh, verbose=not args.quiet,
            device=_device(args))
        print(json.dumps({g: s["final_reward"] for g, s in summary.items()}))
        return 0

    if args.cmd == "replay-shard":
        try:
            if args.replay_shards is not None:
                cfg = cfg.replace(replay_shards=args.replay_shards)
            if not 0 <= args.shard_id < cfg.replay_shards:
                raise ValueError(
                    f"--shard-id {args.shard_id} is outside "
                    f"[0, {cfg.replay_shards}) — it names which of the "
                    "trainer's replay_shards slices this server owns")
        except ValueError as e:
            parser.error(str(e))
        action_dim = args.action_dim
        if action_dim is None:
            from r2d2_tpu_torch.envs import create_env

            probe = create_env(cfg, noop_start=False, seed=cfg.seed)
            action_dim = probe.action_space.n
            close = getattr(probe, "close", None)
            if callable(close):
                close()
        # the shard's ring, sum tree and batch gather live in host memory
        # on any device: --device selects nothing here
        from r2d2_tpu_torch.parallel.replay_net import run_shard_server

        summary = run_shard_server(
            cfg, action_dim, shard_id=args.shard_id, host=args.host,
            port=args.port, epoch=args.epoch,
            max_wall_seconds=args.max_wall_seconds,
            verbose=not args.quiet)
        print(json.dumps({k: v for k, v in summary.items()
                          if isinstance(v, (int, float, str))}))
        return 0

    if args.cmd == "eval":
        if not args.ckpt_dir:
            parser.error("eval requires --ckpt-dir")
        from r2d2_tpu_torch.envs import create_env
        from r2d2_tpu_torch.evaluate import evaluate_sweep

        # noop_start=True matches the reference eval protocol
        # (test.py:16): random 1-30 no-ops diversify eval start states
        # exactly as during training
        curve = evaluate_sweep(
            cfg, args.ckpt_dir,
            env_factory=lambda c, seed: create_env(c, noop_start=True,
                                                   seed=seed),
            episodes=args.episodes, out_json=args.out_json,
            out_plot=args.plot, follow=args.follow,
            follow_timeout=args.follow_timeout, device=_device(args))
        for rec in curve:
            print(json.dumps(rec))
        return 0

    return 1  # pragma: no cover


if __name__ == "__main__":
    sys.exit(main())
