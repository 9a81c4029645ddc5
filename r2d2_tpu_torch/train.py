"""Training: the threaded fabric and the deterministic single-thread trainer.

Port of the thread-, process- and anakin-transport subset of
``r2d2_tpu/train.py``, on one device or, with ``use_mesh``, as one rank of
the learner mesh (one process per card under torchrun):

- ``_build``: envs (or, for the process transport, one probe env and the
  fleet plane, ``parallel/actor_procs.py``), network, train state with an
  optional resume, the
  device-resident replay ring when ``cfg.device_replay`` (falling back to
  host replay, and to host-sampled PER, when the ring does not fit the
  card), learner, replay buffer (or, with ``replay_shards > 1`` or
  ``replay_transport="socket"``, the sharded replay plane over shm or TCP,
  ``parallel/replay_shards.py``, ``parallel/replay_net.py``), ladder
  epsilons (each population member's own ladder over its fleet's lanes
  under ``cfg.population_spec``, ``league/population.py``, with every
  member's env probed), vector actors, and the
  full-state resume (a warm replay ring and the actors' RNG/env state from
  a replay snapshot; a device ring resumes cold);
- ``_HostScaffold``: the stop predicate, the SIGTERM/SIGINT drain-then-save
  hooks, the learner heartbeat watchdog, the bounded log ring, the
  telemetry plane (registry, JSONL run log, HTTP exporter) and the
  learning-health monitor and alert engine;
- ``train``: the concurrent system — actor fleet threads (or, with
  ``actor_transport="process"``, fleet subprocesses and the plane's
  ingest, pump, watchdog and, under ``actor_inference="serve"``, inference
  service threads), the replay plane's ``replay_watch`` (sharded replay),
  a sample thread (host ring only), a priority-feedback
  thread (not under in-graph PER), a log thread, the periodic snapshot
  thread (host ring only), the league's eval sidecar and its
  ``eval_watch`` (``cfg.league_eval``, ``league/eval_service.py``) and
  the learner on the calling thread, all but the learner under the
  supervisor — with drain-then-save and replay snapshots;
- ``train_sync``: the deterministic interleaving of the same components
  (the integration tests' and the debugger's loop);
- ``_train_anakin``: ``actor_transport="anakin"``, the fused on-device
  loop (learner/anakin.py) on the same scaffold, with full-state resume.

The learner runs on ``device`` (default: the CUDA device; raises without
one).  Acting runs where ``cfg.act_device`` says (``actor.
_resolve_act_device``): on the CUDA device for ``"auto"``, through the
fused LSTM kernel, one launch per LSTM layer per act.  On a machine without
a card, pass ``device="cpu"`` and ``act_device="cpu"`` in the config.

Every branch of the reference's ``train()`` that needs a module the port
does not have yet raises ``ValueError`` naming its ROADMAP.md item
(:func:`check_unported`); nothing falls back silently.  Threads share the
card through PyTorch's default stream; each actor fleet acts through its
own copy of the network module, because ``torch.func.functional_call``
swaps a module's parameters in place while it runs.
"""
from __future__ import annotations

import collections
import contextlib
import logging
import os
import queue
import signal
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from r2d2_tpu_torch.actor import (
    VectorActor,
    _resolve_act_device,
    fleet_shards,
    make_host_act_fn,
)
from r2d2_tpu_torch.checkpoint import Checkpointer, check_arch_compat
from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.envs import create_env
from r2d2_tpu_torch.learner.learner import Learner
from r2d2_tpu_torch.learner.step import create_train_state
from r2d2_tpu_torch.models.network import create_network
from r2d2_tpu_torch.replay.replay_buffer import (
    ReplayBuffer,
    _available_host_bytes,
    data_bytes,
)
from r2d2_tpu_torch.telemetry.console import format_entry
from r2d2_tpu_torch.telemetry.learnhealth import (
    AlertEngine,
    LearnHealthMonitor,
)
from r2d2_tpu_torch.telemetry.plane import Telemetry
from r2d2_tpu_torch.utils.math import epsilon_ladder
from r2d2_tpu_torch.utils.store import ParamStore
from r2d2_tpu_torch.utils.supervisor import Heartbeat, Supervisor
from r2d2_tpu_torch.utils.trace import Tracer, device_profile

log = logging.getLogger(__name__)

EnvFactory = Callable[[Config, int], Any]

# chaos sites train() fires (wedge_dispatch only in the anakin transport,
# the six fleet and service sites only in the process transport, the
# seven shard and link sites only with replay_shards > 1 or the socket
# transport, kill_eval_sidecar only with the league's eval sidecar).
# train() accepts any spec, as the reference does; the other two kinds,
# kill_session_client and slow_session_client, fire in the session load
# generator (r2d2_tpu_torch/tools/session_load_gen.py), never in a run
CHAOS_SITES = ("truncate_ckpt", "freeze_learner", "poison_params",
               "wedge_dispatch", "kill_fleet", "garble_block",
               "freeze_service", "drop_act_response", "garble_act_response",
               "stall_pump", "kill_replay_shard", "garble_sample_response",
               "stall_shard", "partition_shard_link", "delay_shard_link",
               "half_open_shard", "garble_net_frame", "kill_eval_sidecar")


def _default_env_factory(cfg: Config, seed: int):
    return create_env(cfg, noop_start=True, seed=seed)


def resolve_device(device=None) -> torch.device:
    """The learner's device: ``device`` when given, else the current CUDA
    device — raises when there is none (no silent CPU fallback)."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "training needs a CUDA device and none is visible; pass "
            "device='cpu' (and act_device='cpu' in the config) to train on "
            "the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def check_unported(cfg: Config, use_mesh: bool = False) -> None:
    """Raise ``ValueError`` for a ``train()`` configuration that needs a
    module the port has not ported yet, naming its ROADMAP.md item: a
    ``"dp"`` device-ring layout without the learner mesh (item 7a)."""
    if cfg.device_replay and not use_mesh:
        from r2d2_tpu_torch.replay.device_ring import resolve_layout

        resolve_layout(cfg)     # the dp layout needs the learner mesh


@contextlib.contextmanager
def _rank_world(use_mesh: bool, device):
    """Under ``use_mesh``: the process group this rank trains in — the
    caller's (``parallel.distributed.init_distributed`` under torchrun),
    or, when none is up, a world of one on an in-process store (NCCL on
    the card, gloo on the CPU), destroyed on the way out.  A meshed run
    always takes the rank-collective route, even alone.  The calling
    thread is bound as the learner thread: no other thread may issue a
    collective."""
    if not use_mesh:
        yield
        return
    import torch.distributed as dist

    from r2d2_tpu_torch.parallel import distributed as pd

    created = False
    if not dist.is_initialized():
        pd.init_distributed(store=dist.HashStore(), world_size=1, rank=0,
                            device=resolve_device(device))
        created = True
    pd.bind_learner_thread()
    try:
        yield
    finally:
        pd.unbind_learner_thread()
        if created:
            dist.destroy_process_group()


def _build(cfg: Config, env_factory: EnvFactory,
           checkpoint_dir: Optional[str], resume: bool,
           device=None, use_mesh: bool = False) -> Dict[str, Any]:
    """Common bring-up: envs, net, state (maybe restored), the device ring,
    learner, buffer (the in-process ring, or the sharded replay plane over
    shm or sockets), actors, and the full-state resume from the newest
    replay snapshot.  Parameters are drawn from a ``torch.Generator``
    seeded with ``cfg.seed``.  The returned ``cfg`` is the effective one:
    ``in_graph_per`` is off when no ring was built.

    ``use_mesh`` (the default process group is up, :func:`_rank_world`):
    one learner mesh (``make_mesh``), one ``ShardingTable`` and this
    rank's dp group (``dp_group``) per bring-up.  The leader of a dp
    group (its lowest rank) runs the group's data plane: it samples
    ``host_batch_size`` rows of the global batch for the group, its
    replay (host ring, shard plane or device ring) is its dp group's slab
    of the global ring (``ring_slice_config``), and its envs and actors
    draw from streams offset by the dp coordinate (dp group 0's are the
    meshless run's), so a dp group's experience is the same at any fsdp ×
    tp.  A peer (``sys["peer"]``) builds the learner alone: no envs,
    actors, fleets or replay.  Whether the ranks replay from device rings
    is decided by all of them together, so no rank runs a drivetrain its
    peers do not."""
    device = resolve_device(device)
    mesh = table = span = None
    host_bs, dp, peer = cfg.batch_size, 1, False
    actor_cfg = cfg
    if use_mesh:
        from r2d2_tpu_torch.parallel.distributed import (
            dp_group,
            host_batch_size,
        )
        from r2d2_tpu_torch.parallel.mesh import make_mesh
        from r2d2_tpu_torch.parallel.sharding import ShardingTable

        mesh = make_mesh(cfg, device.type)
        table = ShardingTable(mesh, cfg)
        span = dp_group(mesh)
        peer = not span.is_leader
        # cfg.batch_size is the GLOBAL batch; the group's leader samples
        # its dp share from its own replay
        host_bs = host_batch_size(cfg, mesh)
        dp = table.sizes["dp"]
        if span.index:
            # each dp group's actors explore their own streams (the JAX
            # package seeds every host's alike: identical experience)
            actor_cfg = cfg.replace(seed=cfg.seed + 1_000_003 * span.index)
    process = cfg.actor_transport == "process"
    if process or peer:
        # the fleets own the envs in their subprocesses, and a peer runs
        # none; the trainer only needs the action space to size the
        # network and replay layouts
        probe = env_factory(cfg, cfg.seed)
        action_dim = probe.action_space.n
        _close_env(probe)
        envs = []
    else:
        act_device = _resolve_act_device(cfg.act_device)
        envs = [env_factory(actor_cfg, actor_cfg.seed + i)
                for i in range(cfg.num_actors)]
        action_dim = envs[0].action_space.n

    def network(dev):
        return create_network(cfg, action_dim, device=dev,
                              generator=torch.Generator().manual_seed(
                                  cfg.seed))

    net = network(device)
    state = create_train_state(cfg, net.state_dict())

    checkpointer = (Checkpointer(checkpoint_dir, keep=cfg.keep_checkpoints)
                    if checkpoint_dir else None)
    start_env_steps, start_minutes = 0, 0.0
    if (checkpointer is not None and resume
            and checkpointer.latest_step() is not None):
        check_arch_compat(cfg, checkpointer.peek_meta())
        state, meta = checkpointer.restore()
        start_env_steps = int(meta.get("env_steps", 0))
        start_minutes = float(meta.get("minutes", 0.0))

    param_store = ParamStore()
    ring = layout = None
    # this rank's share of the replay: the whole ring without a mesh, its
    # dp group's slab under one
    replay_cfg = cfg
    if mesh is not None:
        from r2d2_tpu_torch.replay.device_ring import (
            DeviceRing,
            ring_slice_config,
        )

        replay_cfg = ring_slice_config(cfg, dp)
    if cfg.device_replay and mesh is not None:
        # a peer joins the agreement and builds no ring
        layout = _mesh_ring_layout(cfg, replay_cfg, mesh, action_dim, device)
        if layout is not None and not peer:
            ring = DeviceRing(replay_cfg, action_dim, device=device,
                              layout=layout)
    elif cfg.device_replay:
        from r2d2_tpu_torch.replay.device_ring import DeviceRing

        need, dev_cap = data_bytes(cfg, action_dim), _device_memory_bytes(
            device)
        # on the CPU "device" memory IS host memory: the host guard applies
        cap = dev_cap if dev_cap is not None else _available_host_bytes()
        if cap is not None and need > 0.8 * cap:
            warnings.warn(
                f"device_replay ring needs {need / 1e9:.1f} GB per device "
                f"(layout=replicated) but the device has {cap / 1e9:.1f} "
                "GB; falling back to host replay — reduce buffer_capacity "
                "to fit", stacklevel=2)
        else:
            ring = DeviceRing(cfg, action_dim, device=device)
    if cfg.in_graph_per and ring is None and layout is None:
        # the ring fallback above degrades the PER plane with it: device
        # PER cannot run on host replay (ReplayBuffer would fail fast),
        # and the reference's behaviour here is host replay, not a crash
        warnings.warn(
            "in_graph_per disabled: no device ring was built (see the "
            "fallback warning above) — continuing on host-sampled PER; "
            "shrink buffer_capacity to restore the device-PER plane",
            stacklevel=2)
        cfg = cfg.replace(in_graph_per=False)
        replay_cfg = replay_cfg.replace(in_graph_per=False)
    # the learner is built AFTER the ring/in_graph_per decisions so it, and
    # everything below, sees the effective config
    learner = Learner(cfg, net, state, param_store=param_store,
                      checkpointer=checkpointer,
                      start_env_steps=start_env_steps,
                      start_minutes=start_minutes, mesh=mesh, table=table,
                      span=span)
    # one replay snapshot per run: a mesh of several dp groups has several
    # replays and neither writes nor reads one, as in the JAX package
    # (its full save needs a single process)
    single_replay = dp == 1
    if peer:
        return dict(cfg=cfg, envs=[], action_dim=action_dim, net=net,
                    act_net=None, learner=learner, buffer=None, actors=[],
                    actor=None, plane=None, replay_plane=None,
                    param_store=param_store, checkpointer=checkpointer,
                    host_bs=host_bs, restored_replay=False, ring=None,
                    device_plane=layout is not None, mesh=mesh, table=table,
                    single_replay=single_replay, peer=True)
    replay_plane = None
    if cfg.replay_transport == "socket":
        # cross-host replay fabric (parallel/replay_net.py): the shard RPCs
        # travel as length-framed CRC'd TCP messages, to remote shard
        # servers (cfg.replay_hosts) or plane-spawned loopback processes.
        # Same facade as the shm plane; config validation already rejected
        # device_replay and anakin here
        from r2d2_tpu_torch.parallel.replay_net import NetShardedReplayPlane

        buffer = NetShardedReplayPlane(
            replay_cfg, action_dim, rng=np.random.default_rng(actor_cfg.seed))
        replay_plane = buffer
    elif cfg.replay_shards > 1:
        # sharded replay plane (parallel/replay_shards.py): K owner
        # processes each run the ReplayBuffer core over their slot slice;
        # this coordinator facade fills the buffer role in the fabric.
        # The processes spawn in train() at plane start, like the fleets
        from r2d2_tpu_torch.parallel.replay_shards import ShardedReplayPlane

        buffer = ShardedReplayPlane(
            replay_cfg, action_dim,
            rng=np.random.default_rng(actor_cfg.seed))
        replay_plane = buffer
    else:
        buffer = ReplayBuffer(replay_cfg, action_dim,
                              rng=np.random.default_rng(actor_cfg.seed),
                              device_ring=ring)
    if replay_plane is not None:
        # the assembled batch crosses to the card in one copy from pinned
        # memory (learner.packed_batch)
        replay_plane.pin_batches = device.type == "cuda"
    buffer.env_steps = start_env_steps
    epsilons = [epsilon_ladder(i, cfg.num_actors, cfg.base_eps, cfg.eps_alpha)
                for i in range(cfg.num_actors)]
    members = None
    if cfg.population_spec:
        # the population plane (league/population.py; Config validation
        # already pinned actor_transport="process" and one fleet per
        # member): the member configs, each member's own ladder over its
        # fleet's lanes, and the members' envs probed — one Q-head serves
        # the whole population
        from r2d2_tpu_torch.league.population import (
            build_members,
            population_epsilons,
        )

        members = build_members(actor_cfg)
        epsilons = population_epsilons(cfg, members)
        _probe_members(cfg, members, env_factory, action_dim)
    # actor_fleets fleets over contiguous lane slices: the ladder epsilons
    # stay GLOBAL, and each fleet gets its own RNG stream.  Each fleet acts
    # through its own network module (the act swaps the module's
    # parameters for the published ones while it runs, so a module shared
    # between threads would race); the learner's module is never one of
    # them (same parameter names, the LSTM impl resolved for act_device)
    plane, act_nets = None, [None]
    actors: List[VectorActor] = []
    if process:
        # subprocess fleets (parallel/actor_procs.py): constructed here,
        # spawned by train() once the fabric is up; serve mode acts on the
        # learner's device
        from r2d2_tpu_torch.parallel.actor_procs import ProcessFleetPlane

        plane = ProcessFleetPlane(actor_cfg, action_dim, env_factory,
                                  epsilons,
                                  device=(device if cfg.act_device != "cpu"
                                          else None),
                                  members=members)
    else:
        shards, fleet_workers = fleet_shards(cfg)
        act_nets = [network(act_device) for _ in shards]
        actors = [
            VectorActor(cfg, envs[lo:hi], epsilons[lo:hi],
                        make_host_act_fn(act_nets[f]), param_store,
                        sink=buffer.add, env_workers=fleet_workers,
                        rng=np.random.default_rng(
                            actor_cfg.seed + 7919 + 104729 * f))
            for f, (lo, hi) in enumerate(shards)
        ]
    # full-state resume: a warm replay ring + resumable actor state saved
    # by a previous run's drain-then-save exit (checkpoint.save_replay).
    # Loaded AFTER everything is built so a failure here degrades to the
    # plain learner-state resume above instead of killing bring-up
    restored_replay = False
    if checkpointer is not None and resume and single_replay:
        rep = checkpointer.restore_replay()
        if rep is not None and ring is not None:
            warnings.warn(
                "a replay snapshot exists but this run uses device_replay "
                "— replay state lives on the device and is not restored "
                "(resuming with a cold ring)", stacklevel=2)
        elif rep is not None:
            meta_r, ring_path, actor_snaps = rep
            try:
                buffer.read_state(ring_path, meta_r)
                restored_replay = True
            except (ValueError, OSError) as e:
                warnings.warn(f"replay snapshot not restored: {e}",
                              stacklevel=2)
            if restored_replay and actor_snaps and plane is not None:
                plane.set_restore_snapshots(actor_snaps)
            elif restored_replay and actor_snaps:
                for a, snap in zip(actors, actor_snaps):
                    if snap is None:
                        continue
                    try:
                        a.restore(snap)
                    except ValueError as e:
                        warnings.warn(f"actor snapshot skipped: {e}",
                                      stacklevel=2)
    return dict(cfg=cfg, envs=envs, action_dim=action_dim, net=net,
                act_net=act_nets[0], learner=learner,
                buffer=buffer, actors=actors,
                actor=actors[0] if actors else None, plane=plane,
                replay_plane=replay_plane,
                param_store=param_store, checkpointer=checkpointer,
                host_bs=host_bs, restored_replay=restored_replay,
                ring=ring, device_plane=ring is not None, mesh=mesh,
                table=table, single_replay=single_replay, peer=False)


def _close_env(env) -> None:
    close = getattr(env, "close", None)
    if callable(close):
        close()


def _probe_members(cfg: Config, members, env_factory: EnvFactory,
                   action_dim: int) -> None:
    """Refuse, at start-up and naming the member, a population member whose
    env cannot serve the base's Q-head: another action set, an env the
    factory cannot build, or (with ``league_eval``) a real game the eval
    sidecar's suite cannot build without the ALE (``league/scenarios.py``
    builds its suites with ``create_env``, which refuses a real game
    without ``ale_py``)."""
    from r2d2_tpu_torch.envs import atari_available

    for m in members:
        if (cfg.league_eval and m.cfg.game_name != "Fake"
                and not atari_available()):
            raise ValueError(
                f"population member {m.member_id} ({m.name}): game "
                f"{m.cfg.game_name!r} needs the ALE for the eval sidecar's "
                "held-out suite, and ale_py is not installed")
        if m.cfg.game_name == cfg.game_name:
            continue
        try:
            probe = env_factory(m.cfg, m.cfg.seed)
        except RuntimeError as e:
            raise ValueError(
                f"population member {m.member_id} ({m.name}): env "
                f"{m.cfg.game_name!r} cannot be built: {e}") from e
        member_dim = probe.action_space.n
        _close_env(probe)
        if member_dim != action_dim:
            raise ValueError(
                f"population member {m.member_id} ({m.name}): env "
                f"{m.cfg.game_name!r} has action_dim {member_dim} but the "
                f"base env has {action_dim} — one Q-head serves the whole "
                "population")


def _mesh_ring_layout(cfg: Config, replay_cfg: Config, mesh,
                      action_dim: int, device: torch.device
                      ) -> Optional[str]:
    """The layout of the dp group leaders' device rings under the learner
    mesh, or None (host staging).  The layout follows ``resolve_layout``'s
    rules, agreed over the ranks ("auto" reads each rank's own card); a
    ``"dp"`` ring is the dp group's slab of ``num_blocks / dp`` blocks.
    The ring-or-staging choice is collective (one ``sync_counter`` min),
    as in the JAX package: the two drivetrains issue different
    collectives, so one rank failing its memory guard moves every rank to
    host staging instead of deadlocking them.  Every rank votes as if it
    held the ring, the peers of a dp group too."""
    import torch.distributed as dist

    from r2d2_tpu_torch.parallel.distributed import sync_counter
    from r2d2_tpu_torch.replay.device_ring import resolve_layout

    need, dev_cap = data_bytes(cfg, action_dim), _device_memory_bytes(device)
    cap = dev_cap if dev_cap is not None else _available_host_bytes()
    layout = resolve_layout(cfg, mesh, need, dev_cap)
    dp = mesh.size(mesh.mesh_dim_names.index("dp"))
    if (cfg.device_ring_layout == "auto" and dist.get_world_size() > 1
            and cfg.num_blocks % dp == 0 and cfg.batch_size % dp == 0):
        # the JAX package's multi-host rule: each host owns the slabs of
        # its dp groups unless the config asks for a replicated ring
        layout = "dp"
    if sync_counter(int(layout == "dp"), "max", tag="ring") > 0:
        layout = "dp"
    # a whole ring on each of several ranks has no dp slab to sample
    # from: the JAX package stages from the host there, and so does this
    whole_each = layout == "replicated" and dist.get_world_size() > 1
    per_rank = data_bytes(replay_cfg, action_dim)
    fits = cap is None or per_rank <= 0.8 * cap
    if sync_counter(int(fits and not whole_each), "min", tag="ring") > 0:
        return layout
    warnings.warn(
        "meshed device_replay disabled (on at least one rank): "
        f"layout={layout}, ring {per_rank / 1e9:.1f} GB per rank"
        + (f" against {cap / 1e9:.1f} GB" if cap is not None else "")
        + (" — a replicated ring over several ranks" if whole_each else "")
        + "; using host staging instead", stacklevel=3)
    return None


def _rank(use_mesh: bool) -> int:
    """This process's rank in the learner mesh (0 without one)."""
    if not use_mesh:
        return 0
    import torch.distributed as dist

    return dist.get_rank()


def _device_memory_bytes(device: torch.device) -> Optional[int]:
    """The learner device's total memory: the card's, from
    ``torch.cuda.mem_get_info``; None on the CPU (the caller then applies
    the host-RAM guard)."""
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[1]


class _HostScaffold:
    """Host-side scaffolding of the threaded trainer (the reference's
    ``_HostScaffold``).

    Owns the stop predicate (event + wall-clock deadline + supervisor
    failure + a tripped learnhealth monitor + the caller's ``stop_fn``),
    the SIGTERM/SIGINT drain-then-save handlers, the learner Heartbeat and
    its stall-watchdog loop, the bounded in-memory log ring, the telemetry
    plane with the supervisor's give-up stamping wired in, the alert
    engine, the cross-process trace slab with its ``/tracez`` and
    ``/profilez`` capture controllers (:meth:`tracing_loops`), and the
    quiesce/teardown order."""

    def __init__(self, cfg: Config, checkpoint_dir: Optional[str],
                 max_wall_seconds: Optional[float] = None,
                 max_thread_restarts: int = 3,
                 signal_msg: str = "draining fabric, then saving full state",
                 watch_label: str = "learner",
                 stop_fn: Optional[Callable[[], bool]] = None):
        self.cfg = cfg
        self._stop_fn = stop_fn
        self.checkpoint_dir = checkpoint_dir
        self.telemetry = Telemetry(cfg, checkpoint_dir)
        self.alerts = AlertEngine(
            cfg, self.telemetry.registry,
            log_dir=(os.path.join(checkpoint_dir, "telemetry")
                     if checkpoint_dir else None))
        self.learnhealth = LearnHealthMonitor(cfg, engine=self.alerts)
        self.routes: Dict[str, Any] = {"/alertz": self.alerts.route}
        # tracing_loops() builds the trace slab and its controllers and
        # registers the /tracez and /profilez routes
        self.trace_slab = None
        self.trace_ctl = None
        self.profile_ctl = None
        # a thread exhausting its restart budget is stamped straight into
        # the registry by the supervisor itself — the log loop (the usual
        # absorption path) may be the very thread that died
        self.supervisor = Supervisor(
            max_restarts=max_thread_restarts,
            on_giveup=lambda name: self.telemetry.registry.inc(
                "supervisor.gaveup", thread=name))
        self.stop_event = threading.Event()
        self.deadline = (time.time() + max_wall_seconds
                         if max_wall_seconds else None)
        # learner liveness: the learner beats through every stop poll
        # (loop iterations AND queue waits), so a stale heartbeat means a
        # genuinely frozen thread, not a slow batch
        self.heartbeat = Heartbeat()
        self.stall = {"stalled": False}
        self.logs: collections.deque = collections.deque(
            maxlen=cfg.log_history_cap)
        self._signal_msg = signal_msg
        self._watch_label = watch_label
        self._prev_handlers: Dict[int, Any] = {}

    def stop(self) -> bool:
        return (self.stop_event.is_set() or self.supervisor.any_failed
                or (self.deadline is not None
                    and time.time() > self.deadline)
                # non-finite loss: stop cleanly (drain-then-save) instead
                # of training on through poisoned numerics
                or self.learnhealth.tripped
                or (self._stop_fn is not None and self._stop_fn()))

    def record_learnhealth(self, entry: Dict[str, Any],
                           replay_health: Optional[Dict[str, Any]] = None
                           ) -> None:
        """Stamp the monitor snapshot (+ replay data-health) into the
        entry, then run the alert engine over it; the entry carries the
        cumulative alert counts."""
        entry["learnhealth"] = self.learnhealth.snapshot()
        if replay_health is not None:
            entry["replay_health"] = replay_health
        self.alerts.evaluate(dict(
            learnhealth=entry["learnhealth"], replay=replay_health,
            training_steps=entry.get("training_steps", 0)))
        entry["alerts"] = self.alerts.counts()

    def install_signals(self) -> None:
        """SIGTERM/SIGINT request a drain-then-save shutdown.  Signals
        only reach the main thread; a trainer driven from a worker thread
        skips the hook.  :meth:`close` restores the previous handlers."""
        if threading.current_thread() is not threading.main_thread():
            return

        def _on_signal(signum, frame):
            log.warning("signal %d: %s", signum, self._signal_msg)
            self.stop_event.set()

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev_handlers[sig] = signal.signal(sig, _on_signal)
            except (ValueError, OSError):  # exotic embedding: no signals
                pass

    def _learner_watch(self) -> None:
        cfg = self.cfg
        poll = min(0.05, cfg.learner_stall_timeout / 4)
        while not self.stop():
            time.sleep(poll)
            if self.heartbeat.age() > cfg.learner_stall_timeout:
                self.stall["stalled"] = True
                log.error("%s heartbeat stale for %.1fs (budget %.1fs): "
                          "declaring a stall and stopping the fabric",
                          self._watch_label, self.heartbeat.age(),
                          cfg.learner_stall_timeout)
                self.stop_event.set()
                return

    def watch_loops(self) -> List[Any]:
        """The heartbeat stall-watchdog loop (empty when disabled)."""
        return ([("learner_watch", self._learner_watch)]
                if self.cfg.learner_stall_timeout > 0 else [])

    def _telemetry_dir(self) -> str:
        """Where trace and profile dumps land: ``<checkpoint_dir>/
        telemetry/`` next to the run log, or a one-shot temporary
        directory for a run without checkpoints."""
        if self.checkpoint_dir:
            return os.path.join(self.checkpoint_dir, "telemetry")
        if not hasattr(self, "_tmp_telemetry_dir"):
            import tempfile

            self._tmp_telemetry_dir = tempfile.mkdtemp(
                prefix="r2d2_telemetry_")
        return self._tmp_telemetry_dir

    def tracing_loops(self, num_slots: int, step_fn: Callable[[], int],
                      device) -> List[Any]:
        """Build the run's cross-process trace slab (one event-ring slot
        per fabric process: trainer, fleets, replay shards), attach the
        process-wide recorder to slot 0, build the capture controllers
        (``/tracez`` trace windows, ``/profilez`` profiles of ``device``,
        boot-time ``cfg.trace_steps``) and return the supervised capture
        loop.  Call before :meth:`exporter_loops`, which serves the
        routes registered here."""
        from r2d2_tpu_torch.telemetry.tracing import (
            EVENTS,
            ProfileController,
            TraceController,
            TraceSlab,
        )

        cfg = self.cfg
        self.trace_slab = TraceSlab(num_slots, cfg.trace_buffer_events)
        EVENTS.attach(self.trace_slab.writer_info(0, 0, "trainer"))
        out_dir = self._telemetry_dir()
        self.trace_ctl = TraceController(self.trace_slab, step_fn, out_dir,
                                         tracer=EVENTS)
        self.profile_ctl = ProfileController(out_dir, device=device)

        def tracez(params: Dict[str, str]):
            if "steps" in params:
                res = self.trace_ctl.arm(int(params["steps"]))
                return (409 if "error" in res else 200), res
            return 200, self.trace_ctl.status()

        def profilez(params: Dict[str, str]):
            if "secs" in params:
                res = self.profile_ctl.arm(float(params["secs"]))
                return (409 if "error" in res else 200), res
            return 200, self.profile_ctl.status()

        self.routes.update({"/tracez": tracez, "/profilez": profilez})
        if cfg.trace_steps > 0:
            self.trace_ctl.arm(cfg.trace_steps)

        def capture_loop():
            while not self.stop():
                self.trace_ctl.poll()
                self.profile_ctl.poll()
                EVENTS.flush()       # the trainer's ring publishes at the
                time.sleep(0.1)      # cadence of any other writer
            # a window still open at shutdown is closed, so its dump is
            # never lost
            self.trace_ctl.poll(force=True)

        return [("capture", capture_loop)]

    def exporter_loops(self, healthz: Callable[[], Dict[str, Any]]
                       ) -> List[Any]:
        """Arm the HTTP exporter around the trainer's healthz verdict.
        The loop is close-driven, NOT stop-driven: a stalling or stopping
        run must stay scrapeable; quiesce closes the exporter before
        joining it."""
        exporter = self.telemetry.serve(healthz, routes=self.routes)
        if exporter is None:    # telemetry_port == 0
            return []

        def telemetry_loop():
            while not exporter.closed:
                try:
                    exporter.handle_once()
                except (OSError, ValueError):
                    return        # server closed under a late poll

        return [("telemetry", telemetry_loop)]

    def start(self, loops) -> None:
        for name, loop in loops:
            self.supervisor.start(name, loop)

    def quiesce(self) -> None:
        """Stop, close the exporter BEFORE joining (its loop exits on
        close), then reap the fabric threads."""
        self.stop_event.set()
        self.telemetry.close_exporter()
        self.supervisor.join_all(timeout=5.0)

    def close(self) -> None:
        self.alerts.close()
        self.telemetry.close()
        if self.trace_slab is not None:
            # after the planes' shutdown: every subprocess writer is gone,
            # so the unlink is safe
            from r2d2_tpu_torch.telemetry.tracing import EVENTS

            EVENTS.detach()
            self.trace_slab.close()
        if hasattr(self, "_tmp_telemetry_dir"):
            try:
                os.rmdir(self._tmp_telemetry_dir)   # only when no dump
            except OSError:
                pass
        for sig, handler in self._prev_handlers.items():
            try:
                signal.signal(sig, handler)
            except (ValueError, OSError):
                pass


# --------------------------------------------------------------------------
# deterministic single-thread trainer (integration-test / debug path)
# --------------------------------------------------------------------------

def train_sync(cfg: Config, env_factory: EnvFactory = _default_env_factory,
               checkpoint_dir: Optional[str] = None, resume: bool = False,
               actor_steps_per_update: int = 4,
               device=None, use_mesh: bool = False) -> Dict[str, Any]:
    """Deterministic interleaving: fill the buffer to ``learning_starts``,
    then alternate ``actor_steps_per_update`` lockstep actor iterations
    with one learner update, applying priority feedback inline.
    ``use_mesh`` trains this rank of the learner mesh, as in
    :func:`train` (each rank fills its own buffer; the updates are
    collective).

    Returns metrics incl. the per-update loss curve and episode returns
    (the JAX package's keys; ``final_params`` is the learner's state dict,
    full plain tensors).
    """
    check_unported(cfg, use_mesh)
    # prefetch would run batch_source (which steps the actor) on a thread,
    # and env workers / multiple fleets would make block arrival order racy
    # — all break the deterministic interleaving this function promises;
    # a nonzero result pipeline would defer priority feedback (this path
    # applies it after every single update)
    cfg = cfg.replace(prefetch_batches=0, env_workers=0, actor_fleets=1,
                      device_replay=False, in_graph_per=False,
                      superstep_pipeline=0, actor_transport="thread",
                      actor_inference="local", replay_shards=1,
                      population_spec="", league_eval=False,
                      learnhealth_interval=0)
    with _rank_world(use_mesh, device):
        return _train_sync(cfg, env_factory, checkpoint_dir, resume,
                           actor_steps_per_update, device, use_mesh)


def _train_sync(cfg: Config, env_factory: EnvFactory,
                checkpoint_dir: Optional[str], resume: bool,
                actor_steps_per_update: int, device, use_mesh: bool
                ) -> Dict[str, Any]:
    sys = _build(cfg, env_factory, checkpoint_dir, resume, device=device,
                 use_mesh=use_mesh)
    if sys["peer"]:
        return _train_peer(sys, sync=True)
    actor: VectorActor = sys["actor"]
    buffer: ReplayBuffer = sys["buffer"]
    learner: Learner = sys["learner"]

    while not buffer.ready:
        actor.run(max_steps=cfg.block_length)

    losses: List[float] = []
    episode_returns: List[float] = []

    def batch_source():
        actor.run(max_steps=actor_steps_per_update)
        return buffer.sample_batch(sys["host_bs"])

    def priority_sink(idxes, priorities, old_ptr, loss):
        buffer.update_priorities(idxes, priorities, old_ptr, loss)
        losses.append(loss)
        s = buffer.stats()
        if s["num_episodes"]:
            episode_returns.append(s["episode_reward"] / s["num_episodes"])

    metrics = learner.run(batch_source, priority_sink)
    metrics.update(losses=losses, episode_returns=episode_returns,
                   buffer_size=len(buffer),
                   final_params=learner.full_params())
    return metrics


def _train_peer(sys: Dict[str, Any], sync: bool = False,
                max_wall_seconds: Optional[float] = None,
                max_thread_restarts: int = 3,
                stop_fn: Optional[Callable[[], bool]] = None,
                tracer: Optional[Tracer] = None) -> Dict[str, Any]:
    """A peer of a dp group that spans ranks (``sys["peer"]``): the
    learner alone, on the rows its leader broadcasts, in the drivetrain
    every rank agreed on — ``Learner.run`` on host-staged batches, or
    ``run_device`` under a device ring.  It runs no actors, replay,
    feedback, snapshots, telemetry files or tracing: its metrics are the
    learner's, with an empty data plane (``buffer_size`` and
    ``buffer_training_steps`` 0).  ``sync`` is :func:`train_sync`'s
    peer: no scaffold, no stop but the leaders'."""
    learner: Learner = sys["learner"]
    empty = dict(buffer_size=0, buffer_training_steps=0, peer=True)
    if sync:
        metrics = learner.run(None)
        metrics.update(empty, losses=[], episode_returns=[],
                       final_params=learner.full_params())
        return metrics
    tracer = tracer or Tracer()
    scaffold = _HostScaffold(sys["cfg"], None,
                             max_wall_seconds=max_wall_seconds,
                             max_thread_restarts=max_thread_restarts,
                             stop_fn=stop_fn)
    learner.monitor = scaffold.learnhealth
    heartbeat, stop = scaffold.heartbeat, scaffold.stop

    def learner_stop() -> bool:
        heartbeat.beat()
        return stop()

    scaffold.install_signals()
    try:
        try:
            scaffold.start(scaffold.watch_loops())
            if sys["device_plane"]:
                metrics = learner.run_device(None, None, stop=learner_stop,
                                             tracer=tracer)
            else:
                metrics = learner.run(None, stop=learner_stop,
                                      tracer=tracer)
        finally:
            scaffold.quiesce()
        metrics.update(empty, logs=[], final_params=learner.full_params(),
                       restored_replay=False,
                       learner_stalled=scaffold.stall["stalled"],
                       trace=tracer.snapshot(),
                       health=scaffold.supervisor.health(),
                       telemetry_port=None,
                       fabric_failed=scaffold.supervisor.any_failed,
                       learnhealth=scaffold.learnhealth.snapshot(),
                       alerts=scaffold.alerts.counts(), healthz={})
        return metrics
    finally:
        scaffold.close()


# --------------------------------------------------------------------------
# anakin trainer: the fused on-device loop (learner/anakin.py)
# --------------------------------------------------------------------------

def _train_anakin(cfg: Config, checkpoint_dir: Optional[str] = None,
                  resume: bool = False,
                  max_wall_seconds: Optional[float] = None,
                  verbose: bool = True,
                  log_sink: Optional[Callable[[Dict[str, Any]], None]] = None,
                  tracer: Optional[Tracer] = None,
                  profile_dir: Optional[str] = None,
                  stop_fn: Optional[Callable[[], bool]] = None,
                  device=None, use_mesh: bool = False) -> Dict[str, Any]:
    """``actor_transport="anakin"``: the whole training loop — batched
    device env, device actor, device replay writes, train steps — runs on
    the device, issued dispatch by dispatch from this thread
    (learner/anakin.py).  The host reads a (k + 5)-float result vector
    back per dispatch; there are no actor, sample or priority threads.

    What carries over from the threaded fabric: the telemetry plane (the
    registry, the JSONL run log, the HTTP exporter and the console line),
    SIGTERM/SIGINT drain-then-save with full-state resume (the snapshot
    holds the ENTIRE on-device loop state: ring, PER leaves, env state
    and streams, the agents' LSTM carry, the local buffers — ``resume``
    continues bit-exact), the heartbeat watchdog, ``/healthz`` and the
    checkpoint cadence.  Chaos: the ``wedge_dispatch`` site stalls one
    dispatch's harvest, and ``cfg.dispatch_deadline`` (> 0) turns a
    dispatch that blows its budget into a snapshot-then-clean-abort
    (``metrics["dispatch_wedged"]``).

    ``use_mesh`` (the process group is up, :func:`_rank_world`): the
    learner mesh and its sharding table, this rank's slab of the ring
    (``ring_slice_config``; "auto" or "dp" layout, as JAX's multi-host
    rings), the meshed ``Learner`` and the meshed plane — this rank's
    share of the lanes, blocks routed to the slabs that own their slots
    (or, when the lanes do not split over dp, every lane on every rank),
    the global draw — with one collective stop gate per dispatch.  A dp
    group over several ranks (fsdp or tp across ranks) steps the group's
    lanes on every one of its ranks, each holding a replica of the
    group's slab (``learner/anakin.py``).  The full-state snapshot is
    written at world size 1 only (the JAX package's rule), and read at
    any mesh shape."""
    from r2d2_tpu_torch.learner.anakin import AnakinPlane, run_anakin_loop
    from r2d2_tpu_torch.replay.device_ring import DeviceRing

    if cfg.game_name != "Fake":
        warnings.warn(
            f"anakin transport needs a device env; substituting the "
            f"{cfg.anakin_env!r} device env for {cfg.game_name!r} "
            "(cfg.anakin_env selects it)", stacklevel=3)
    # the fused loop IS device replay with in-graph PER: flip the flags
    # so the ring/PER state and the train step build as the in_graph_per
    # drivetrain's (the effective-config pattern)
    cfg = cfg.replace(device_replay=True, in_graph_per=True)
    device = resolve_device(device)
    action_dim = 4  # both anakin envs' action set (envs/anakin.py)
    net = create_network(cfg, action_dim, device=device,
                         generator=torch.Generator().manual_seed(cfg.seed))
    state = create_train_state(cfg, net.state_dict())
    checkpointer = (Checkpointer(checkpoint_dir, keep=cfg.keep_checkpoints)
                    if checkpoint_dir else None)
    start_env_steps, start_minutes = 0, 0.0
    if (checkpointer is not None and resume
            and checkpointer.latest_step() is not None):
        check_arch_compat(cfg, checkpointer.peek_meta())
        state, meta = checkpointer.restore()
        start_env_steps = int(meta.get("env_steps", 0))
        start_minutes = float(meta.get("minutes", 0.0))

    mesh = table = None
    ring_cfg, layout, world = cfg, "replicated", 1
    if use_mesh:
        import torch.distributed as dist

        from r2d2_tpu_torch.parallel.mesh import make_mesh
        from r2d2_tpu_torch.parallel.sharding import ShardingTable
        from r2d2_tpu_torch.replay.device_ring import (
            resolve_layout,
            ring_slice_config,
        )

        mesh = make_mesh(cfg, device.type)
        table = ShardingTable(mesh, cfg)
        world = dist.get_world_size()
        resolve_layout(cfg, mesh)       # an explicit "dp" must divide
        if world > 1 and cfg.device_ring_layout == "replicated":
            raise ValueError(
                "anakin over several ranks routes each block to the rank "
                "whose slab holds its slot: device_ring_layout must be "
                "'auto' or 'dp', not 'replicated'")
        ring_cfg, layout = ring_slice_config(cfg, table.sizes["dp"]), "dp"
    ring = DeviceRing(ring_cfg, action_dim, device=device, layout=layout)
    # no ParamStore: the fused loop acts on the current params on the
    # device, and nothing else reads published snapshots in this mode
    learner = Learner(cfg, net, state, checkpointer=checkpointer,
                      start_env_steps=start_env_steps,
                      start_minutes=start_minutes, mesh=mesh, table=table)
    plane = AnakinPlane(cfg, net, action_dim, ring,
                        start_env_steps=start_env_steps, table=table,
                        state_template=learner.state)

    restored_anakin = False
    if checkpointer is not None and resume:
        rep = checkpointer.restore_replay()
        if rep is not None:
            meta_r, ring_path, _ = rep
            if meta_r.get("kind") == "anakin":
                try:
                    plane.read_state(ring_path, meta_r)
                    restored_anakin = True
                except (ValueError, OSError) as e:
                    warnings.warn(f"anakin snapshot not restored: {e}",
                                  stacklevel=3)
            else:
                warnings.warn(
                    "a replay snapshot exists but it is not an anakin "
                    "loop snapshot (different transport) — resuming with "
                    "a cold ring", stacklevel=3)

    tracer = tracer or Tracer()
    scaffold = _HostScaffold(
        cfg, checkpoint_dir, max_wall_seconds=max_wall_seconds,
        signal_msg="draining the anakin loop, then saving full "
                   "on-device state",
        watch_label="anakin loop", stop_fn=stop_fn)
    telemetry, supervisor = scaffold.telemetry, scaffold.supervisor
    heartbeat, stall, logs = (scaffold.heartbeat, scaffold.stall,
                              scaffold.logs)
    stop = scaffold.stop
    # learnhealth: the plane's harvests feed the monitor; a non-finite
    # loss fires the nonfinite alert and trips scaffold.stop
    plane.monitor = scaffold.learnhealth
    chaos = None
    if cfg.chaos_spec:
        from r2d2_tpu_torch.utils.chaos import ChaosInjector

        # wedge_dispatch and truncate_ckpt fire here; the other armed
        # kinds never reach an opportunity in this transport
        chaos = ChaosInjector(cfg.chaos_spec, seed=cfg.seed)
        if checkpointer is not None:
            checkpointer.chaos = chaos
    scaffold.install_signals()

    def learner_stop() -> bool:
        heartbeat.beat()
        if mesh is None:
            return stop()
        # every dispatch is a collective: every rank stops or none does
        return learner._agree(stop(), True) == "break"

    def healthz() -> Dict[str, Any]:
        age = heartbeat.age()
        stale = (cfg.learner_stall_timeout > 0
                 and age > cfg.learner_stall_timeout)
        ok = not (supervisor.any_failed or stall["stalled"] or stale)
        # the nonfinite alert is the one learnhealth signal that degrades
        # /healthz: the checkpoint stream is numerically suspect
        degraded = ok and scaffold.alerts.nonfinite_active
        return dict(ok=ok, degraded=degraded,
                    status=("failing" if not ok
                            else "degraded" if degraded else "ok"),
                    learner_heartbeat_age=age,
                    learner_stalled=stall["stalled"] or stale,
                    threads=supervisor.health())

    def log_loop():
        last_steps, last_frames, last_time = 0, 0, time.time()
        while not stop():
            time.sleep(min(cfg.log_interval, 0.5))
            now = time.time()
            if now - last_time < cfg.log_interval:
                continue
            s = plane.stats()
            dt = now - last_time
            entry = dict(
                time=now, buffer_size=s["size"], env_steps=s["env_steps"],
                training_steps=s["training_steps"],
                updates_per_sec=(s["training_steps"] - last_steps) / dt,
                mean_episode_return=(s["episode_reward"] / s["num_episodes"]
                                     if s["num_episodes"] else float("nan")),
                mean_loss=(s["sum_loss"]
                           / max(1, s["training_steps"] - last_steps)),
                interval_episodes=s["num_episodes"],
                trace=tracer.snapshot(),
                health=supervisor.health(),
                learner_heartbeat_age=heartbeat.age(),
                telemetry_port=telemetry.port,
                anakin=dict(super_steps=s["super_steps"],
                            frames=s["frames"],
                            frames_per_sec=(s["frames"] - last_frames) / dt,
                            blocks=s["blocks"],
                            episodes_total=s["episodes_total"],
                            eval_episodes=s["eval_episodes"],
                            eval_return=s["eval_return"]),
            )
            if chaos is not None:
                entry["chaos"] = chaos.counts()
            # the anakin PER leaves live on the device (no host tree to
            # walk), so no replay data-health here
            scaffold.record_learnhealth(entry)
            logs.append(entry)
            telemetry.record(entry)
            if log_sink is not None:
                log_sink(entry)
            if verbose:
                print(format_entry(entry), flush=True)
            last_steps, last_frames, last_time = (
                s["training_steps"], s["frames"], now)

    want_full_save = (checkpointer is not None and cfg.replay_snapshot
                      and world == 1)

    def save_anakin_snapshot(step: int) -> None:
        """Persist the ENTIRE on-device loop state through the atomic
        replay-snapshot machinery — what ``resume`` restores through
        ``plane.read_state``."""
        try:
            checkpointer.save_replay(step, plane.write_state)
        except Exception as e:  # never fail the run over snapshot I/O
            log.warning("anakin full-state snapshot failed: %s", e)

    # tracing: the fused loop is one process, so the capture plane is a
    # single-slot slab — trainer-track spans and the /tracez and
    # /profilez triggers work unchanged; block lineage does not exist
    # here (blocks never leave the device)
    loops = ([("log", log_loop)] + scaffold.watch_loops()
             + scaffold.tracing_loops(1, lambda: plane.training_steps,
                                      device)
             + scaffold.exporter_loops(healthz))
    try:
        try:
            scaffold.start(loops)
            with device_profile(profile_dir):
                metrics = run_anakin_loop(
                    learner, plane, stop=learner_stop, tracer=tracer,
                    snapshot_fn=(save_anakin_snapshot if want_full_save
                                 else None), chaos=chaos)
        finally:
            # the final health verdict BEFORE the quiesce (post-quiesce
            # the heartbeat stops, and the epilogue snapshot below can
            # outlast the stall budget)
            try:
                final_health = healthz()
            except Exception:
                final_health = {}
            scaffold.quiesce()

        # drain-then-save: the learner state was saved by the loop's
        # epilogue; persist the on-device loop state next to it.  A
        # wedged abort already parked its snapshot inside the loop
        # (bounded, on a hard wedge) — saving again here would read the
        # wedged device unbounded on this thread
        if want_full_save and not metrics.get("dispatch_wedged"):
            save_anakin_snapshot(learner.num_updates)

        metrics.update(buffer_size=plane.fill, logs=list(logs),
                       buffer_training_steps=plane.training_steps,
                       final_params=learner.full_params(),
                       restored_replay=restored_anakin,
                       learner_stalled=stall["stalled"],
                       trace=tracer.snapshot(), health=supervisor.health(),
                       telemetry_port=telemetry.port,
                       fabric_failed=supervisor.any_failed,
                       learnhealth=scaffold.learnhealth.snapshot(),
                       alerts=scaffold.alerts.counts(),
                       healthz=final_health)
        if chaos is not None:
            metrics["chaos"] = chaos.counts()
        return metrics
    finally:
        scaffold.close()


# --------------------------------------------------------------------------
# threaded fabric trainer (the reference's process topology, thread-native)
# --------------------------------------------------------------------------

def train(cfg: Config, env_factory: EnvFactory = _default_env_factory,
          checkpoint_dir: Optional[str] = None, resume: bool = False,
          use_mesh: bool = False, max_wall_seconds: Optional[float] = None,
          verbose: bool = True,
          log_sink: Optional[Callable[[Dict[str, Any]], None]] = None,
          tracer: Optional[Tracer] = None,
          profile_dir: Optional[str] = None,
          max_thread_restarts: int = 3,
          stop_fn: Optional[Callable[[], bool]] = None,
          device=None) -> Dict[str, Any]:
    """The full concurrent system (the reference's ``train()`` for
    ``actor_transport="thread"`` and ``"process"``), or, for
    ``actor_transport="anakin"``, the fused on-device loop
    (:func:`_train_anakin`).

    ``use_mesh`` trains this process as one rank of the learner mesh
    (``parallel/``): launch one process per card under ``torchrun``, call
    ``parallel.distributed.init_distributed()`` in each, then this.  With
    no process group up it trains in a world of one it creates.  The
    state is DTensors in the sharding table's layout; each rank keeps its
    own actors and its dp group's slab of the replay, and every update
    or dispatch is agreed by all ranks.

    With ``cfg.device_replay`` the replay data lives on the card and the
    learner drives ``Learner.run_device``: it samples index bundles itself
    and gathers batches on the device (no sample thread), and under
    ``cfg.in_graph_per`` priority feedback never leaves the device (no
    priority thread).

    Threads and their reference analogues:
      actor[0..F]  — the N actor processes, regrouped into
                     ``cfg.actor_fleets`` lockstep fleet threads with
                     batched inference on the card; with
                     ``actor_transport="process"`` the fleets are
                     subprocesses (parallel/actor_procs.py), and these
                     threads become the plane's ``fleet_ingest``,
                     ``param_pump``, ``fleet_watch`` and, under
                     ``actor_inference="serve"``, ``inference_serve``
      sample       — ReplayBuffer.prepare_data: batch assembly (host ring)
      priority     — ReplayBuffer.update_data: priority feedback
      log          — the stats loop: the JSONL run log, the registry, the
                     alert engine, ``log_sink`` and the console line
      chaos        — the fleet plane's ``kill_fleet``/``garble_block``
                     sites (process transport) and the replay plane's
                     ``kill_replay_shard``/``stall_shard`` (sharded
                     replay), when armed
      replay_watch — the replay shard watchdog: respawns a dead shard,
                     restored from the latest replay snapshot
      eval_watch   — the eval sidecar's watchdog (``cfg.league_eval``
                     with a ``checkpoint_dir``): respawns a dead sidecar,
                     its cursor resumed from league.jsonl; an exhausted
                     budget degrades /healthz
      snapshot     — periodic replay snapshots
                     (``cfg.replay_snapshot_interval`` > 0)
      learner_watch— the heartbeat stall watchdog
                     (``cfg.learner_stall_timeout`` > 0)
      telemetry    — the HTTP exporter (``cfg.telemetry_port``; -1 binds
                     an ephemeral port): ``/metrics``, ``/healthz``,
                     ``/statusz``, ``/alertz``
      prefetch     — batch staging onto the device, inside Learner.run
      caller       — the learner hot loop

    Fabric threads run under a Supervisor (a crash is recorded and the
    thread restarted up to ``max_thread_restarts``; an exhausted budget
    stops the run).  SIGTERM/SIGINT (main thread only) and ``stop_fn``
    trigger a drain-then-save shutdown: the learner checkpoints its final
    state and, with ``cfg.replay_snapshot``, the replay ring, sum-tree,
    counters and actor RNG/env state are snapshotted atomically so
    ``resume=True`` restarts warm (host ring only: a device ring's run
    saves learner state alone, and resumes with a cold ring); the process
    fleets hand their actor snapshots over in their shutdown handshake.
    ``cfg.chaos_spec`` fires the fault sites of :data:`CHAOS_SITES`; a
    spec naming the session sites is accepted and they never fire here.
    ``profile_dir`` captures a ``torch.profiler`` trace of the learner loop.

    Returns the learner's metrics (``num_updates``, ``env_steps``,
    ``minutes``, ``mean_loss``) plus the JAX package's fabric keys.
    """
    check_unported(cfg, use_mesh)
    if cfg.actor_transport == "anakin":
        # the fused on-device loop (learner/anakin.py): env, actor, replay
        # and learner run on the device — none of the thread fabric below
        # applies
        if env_factory is not _default_env_factory:
            # a hard error, not a warning: host env factories cannot run
            # inside the fused loop, and a silent fallback would hide it
            raise ValueError(
                "anakin transport cannot run a host env_factory — the env "
                "must be batched device ops.  Select one with "
                "cfg.anakin_env ('fake' or 'grid'), or implement the "
                "envs/anakin.py four-method surface "
                "(init_state/observe/step/reset_lanes + STATE_KEYS) and "
                "register it in make_anakin_env")
        if cfg.league_eval:
            warnings.warn(
                "league_eval is not wired into the anakin transport "
                "(the fused loop has its own on-device eval-lane "
                "follow-on, ROADMAP item 2) — running without the eval "
                "sidecar", stacklevel=2)
        with _rank_world(use_mesh, device):
            return _train_anakin(cfg, checkpoint_dir=checkpoint_dir,
                                 resume=resume,
                                 max_wall_seconds=max_wall_seconds,
                                 verbose=verbose, log_sink=log_sink,
                                 tracer=tracer, profile_dir=profile_dir,
                                 stop_fn=stop_fn, device=device,
                                 use_mesh=use_mesh)
    with _rank_world(use_mesh, device):
        return _train_fabric(cfg, env_factory, checkpoint_dir, resume,
                             use_mesh, max_wall_seconds, verbose, log_sink,
                             tracer, profile_dir, max_thread_restarts,
                             stop_fn, device)


def _train_fabric(cfg: Config, env_factory: EnvFactory,
                  checkpoint_dir: Optional[str], resume: bool,
                  use_mesh: bool, max_wall_seconds: Optional[float],
                  verbose: bool, log_sink, tracer, profile_dir,
                  max_thread_restarts: int, stop_fn, device
                  ) -> Dict[str, Any]:
    """The thread and process transports of :func:`train` (its
    arguments, in its order)."""
    sys = _build(cfg, env_factory, checkpoint_dir, resume, device=device,
                 use_mesh=use_mesh)
    if sys["peer"]:
        return _train_peer(sys, max_wall_seconds=max_wall_seconds,
                           max_thread_restarts=max_thread_restarts,
                           stop_fn=stop_fn, tracer=tracer)
    cfg = sys["cfg"]     # the effective config (in_graph_per may be off)
    actors: List[VectorActor] = sys["actors"]
    buffer: ReplayBuffer = sys["buffer"]
    learner: Learner = sys["learner"]
    checkpointer = sys["checkpointer"]
    plane = sys["plane"]
    replay_plane = sys["replay_plane"]
    tracer = tracer or Tracer()
    scaffold = _HostScaffold(cfg, checkpoint_dir,
                             max_wall_seconds=max_wall_seconds,
                             max_thread_restarts=max_thread_restarts,
                             stop_fn=stop_fn)
    telemetry, supervisor = scaffold.telemetry, scaffold.supervisor
    heartbeat, stall, logs = (scaffold.heartbeat, scaffold.stall,
                              scaffold.logs)
    stop = scaffold.stop
    # learnhealth: the learner's harvests feed the monitor; a non-finite
    # loss fires the nonfinite alert and trips scaffold.stop
    learner.monitor = scaffold.learnhealth

    chaos = None
    if cfg.chaos_spec:
        from r2d2_tpu_torch.utils.chaos import ChaosInjector

        chaos = ChaosInjector(cfg.chaos_spec, seed=cfg.seed)
        if checkpointer is not None:
            checkpointer.chaos = chaos

    # cross-process tracing (telemetry/tracing.py): one event-ring slot
    # per fabric process — trainer (slot 0), fleets, replay shards —
    # armed fabric-wide by /tracez or cfg.trace_steps.  Built before the
    # planes start, so every worker attaches at birth
    num_fleets = plane.num_fleets if plane is not None else 0
    shard_procs = replay_plane.K if replay_plane is not None else 0
    tracing_loops = scaffold.tracing_loops(
        1 + num_fleets + shard_procs, lambda: buffer.training_steps,
        learner.device)
    if plane is not None:
        plane.trace_slab = scaffold.trace_slab
        plane.trace_slot_base = 1
    if shard_procs:
        replay_plane.trace_slab = scaffold.trace_slab
        replay_plane.trace_slot_base = 1 + num_fleets

    if plane is not None:
        # CRC-failed blocks dropped at ingest surface in buffer.stats()
        plane.on_corrupt = buffer.note_corrupt_block
        # the plane's counters (respawns, ingest histogram, serve shard
        # resets, slab-merged actor stats) land in the run's namespace
        plane.set_registry(telemetry.registry)
        # fault sites of the plane's loops (freeze_service, stall_pump)
        # and the service's scatter (drop/garble response)
        plane.chaos = chaos
        if plane.service is not None:
            plane.service.tracer = tracer
            plane.service.chaos = chaos

    scaffold.install_signals()
    # full-state snapshots need the host ring (a device ring's state lives
    # on the card) and one replay per run
    want_full_save = (checkpointer is not None and cfg.replay_snapshot
                      and sys["ring"] is None and sys["single_replay"])

    if replay_plane is not None:
        # shard counters land in the run's namespace (replay.shard.*,
        # replay.net.*); the Checkpointer lets the watchdog restore a
        # respawned shard's slots from the latest committed replay
        # snapshot; the chaos injector arms the receipt-side sites
        replay_plane.set_registry(telemetry.registry)
        if want_full_save:
            replay_plane.checkpointer = checkpointer
        replay_plane.chaos = chaos

    # the standing evaluation sidecar (league/eval_service.py): a CPU
    # subprocess that follows this run's checkpoints, scores every
    # population member on its held-out suite and publishes league.jsonl
    # and the /statusz league table.  Its death only ever DEGRADES
    # /healthz: the eval_watch loop respawns it (the cursor resumes from
    # league.jsonl), and an exhausted budget stops evaluation, never
    # training.  On the learner mesh rank 0 writes the checkpoints, so
    # rank 0 runs it
    sidecar = None
    if cfg.league_eval and _rank(use_mesh) == 0:
        if checkpoint_dir is None:
            log.warning("league_eval requested without a checkpoint_dir — "
                        "the eval sidecar follows checkpoints; running "
                        "without it")
        else:
            from r2d2_tpu_torch.league.eval_service import EvalSidecar

            sidecar = EvalSidecar(cfg, checkpoint_dir, sys["action_dim"],
                                  registry=telemetry.registry)

    def learner_stop() -> bool:
        if chaos is not None:
            freeze = chaos.learner_freeze_seconds()
            if freeze > 0:
                time.sleep(freeze)
            if chaos.poison_params_now():
                # runs ON the learner thread (this predicate is only
                # polled there), between steps
                log.warning("chaos: poisoning learner params with NaN")
                learner.poison_params()
        heartbeat.beat()
        return stop()

    batch_queue: "queue.Queue" = queue.Queue(maxsize=8)
    priority_queue: "queue.Queue" = queue.Queue(maxsize=8)
    # sample→feedback latency pairing: batches and their feedback move
    # through FIFO queues in order, so a deque of enqueue stamps pairs each
    # feedback with its batch (bounded: a drained stop drops stragglers)
    sample_ts: collections.deque = collections.deque(maxlen=64)

    def make_actor_loop(a: VectorActor):
        def actor_loop():
            while not stop():
                with tracer.span("actor.run256"):
                    a.run(max_steps=256, stop=stop)
        return actor_loop

    def sample_loop():
        registry = telemetry.registry
        while not stop():
            if not buffer.ready:
                time.sleep(0.05)
                continue
            with tracer.span("buffer.sample_batch"):
                if replay_plane is not None:
                    # the scatter/gather sample RPC; None = every shard
                    # suspect or empty this draw (every RPC deadline is
                    # bounded) — retry, the watchdog respawns the dead
                    batch = buffer.sample_batch(sys["host_bs"], stop=stop)
                    if batch is None:
                        continue
                else:
                    batch = buffer.sample_batch(sys["host_bs"])
            # block-lineage latency decomposition: per-row ages stamped in
            # the ring, observed here where the registry lives
            ages = batch.pop("ages", None)
            if ages is not None:
                ages = np.asarray(ages)
                cut, add = ages[:, 0], ages[:, 1]
                registry.observe_many("pipeline.block_age_at_train_s",
                                      cut[cut >= 0])
                registry.observe_many("pipeline.hop.ingest_to_sample_s",
                                      add[add >= 0])
            while not stop():
                try:
                    batch_queue.put(batch, timeout=0.1)
                    sample_ts.append(time.perf_counter())
                    break
                except queue.Full:
                    continue

    def priority_loop():
        registry = telemetry.registry
        while not stop():
            try:
                idxes, priorities, old_ptr, loss = priority_queue.get(
                    timeout=0.1)
            except queue.Empty:
                continue
            if sample_ts:
                try:
                    registry.observe(
                        "pipeline.hop.sample_to_feedback_s",
                        time.perf_counter() - sample_ts.popleft())
                except IndexError:
                    pass   # raced the deque's bound — skip the sample
            with tracer.span("buffer.update_priorities"):
                buffer.update_priorities(idxes, priorities, old_ptr, loss)

    def healthz() -> Dict[str, Any]:
        """The /healthz verdict: ``ok``, ``degraded`` (HTTP 200: a fleet's
        act circuit open, a fleet's params stale past the budget, a replay
        shard dead, partitioned or reconnecting, the eval sidecar dead or
        failed, or the nonfinite learnhealth alert) or ``failing`` (HTTP
        503: a supervisor give-up, a failed fleet or replay plane, or a
        heartbeat past its stall budget)."""
        age = heartbeat.age()
        stale = (cfg.learner_stall_timeout > 0
                 and age > cfg.learner_stall_timeout)
        out = dict(
            ok=not (supervisor.any_failed or stall["stalled"] or stale
                    or (plane is not None and plane.failed)
                    or (replay_plane is not None and replay_plane.failed)),
            learner_heartbeat_age=age,
            learner_stalled=stall["stalled"] or stale,
            threads=supervisor.health(),
        )
        degraded = False
        if plane is not None:
            h = plane.health()
            out["fleet"] = dict(fleets=h["fleets"], alive=h["alive"],
                                restarts=h["restarts"], failed=h["failed"],
                                resilience=h["resilience"])
            degraded = bool(h["resilience"].get("degraded"))
        if replay_plane is not None:
            rh = replay_plane.health()
            out["replay_shards"] = dict(shards=rh["shards"],
                                        alive=rh["alive"],
                                        respawns=rh["respawns"],
                                        failed=rh["failed"])
            if "net" in rh:
                # socket transport: the per-link verdicts, so a prober
                # sees WHICH link is partitioned
                out["replay_shards"]["net"] = dict(
                    connected=rh["net"]["connected"],
                    reconnects=rh["net"]["reconnects"],
                    epoch_drops=rh["net"]["epoch_drops"],
                    circuits=[row["circuit"]
                              for row in rh["net"]["links"]])
            # a dead or partitioned shard mid-heal: the plane keeps serving
            # from the survivors (redistributed strata) — degraded, not
            # failing
            degraded = degraded or bool(rh["degraded"])
        if sidecar is not None:
            # a dead or failed evaluator blinds the run to policy quality
            # but touches nothing on the training path: degraded, never
            # failing
            out["league"] = sidecar.health()
            degraded = degraded or bool(out["league"]["degraded"])
        degraded = degraded or scaffold.alerts.nonfinite_active
        out["degraded"] = degraded and out["ok"]
        out["status"] = ("failing" if not out["ok"]
                         else "degraded" if degraded else "ok")
        return out

    def log_loop():
        last_steps, last_time = 0, time.time()
        while not stop():
            time.sleep(min(cfg.log_interval, 0.5))
            now = time.time()
            if now - last_time < cfg.log_interval:
                continue
            s = buffer.stats()
            dt = now - last_time
            tracer.gauge("batch_queue_depth", batch_queue.qsize())
            tracer.gauge("priority_queue_depth", priority_queue.qsize())
            tracer.gauge("buffer_fill", s["size"])
            entry = dict(
                time=now, buffer_size=s["size"], env_steps=s["env_steps"],
                training_steps=s["training_steps"],
                updates_per_sec=(s["training_steps"] - last_steps) / dt,
                mean_episode_return=(s["episode_reward"] / s["num_episodes"]
                                     if s["num_episodes"] else float("nan")),
                mean_loss=(s["sum_loss"]
                           / max(1, s["training_steps"] - last_steps)),
                interval_episodes=s["num_episodes"],
                trace=tracer.snapshot(),
                health=supervisor.health(),
                learner_heartbeat_age=heartbeat.age(),
                telemetry_port=telemetry.port,
            )
            if chaos is not None:
                entry["chaos"] = chaos.counts()
            if plane is not None:
                entry["fleet"] = plane.health()
            if replay_plane is not None:
                entry["replay_shards"] = replay_plane.health()
            if sidecar is not None:
                # the league standings ride the entry: /statusz's
                # last_entry, the JSONL run log and the league.* metrics
                entry["league"] = sidecar.status()
            entry["corrupt_blocks"] = s["corrupt_blocks"]
            entry["shard_respawns"] = s.get("shard_respawns", 0)
            try:
                replay_health = buffer.data_health()
            except Exception:   # telemetry must never kill the log loop
                replay_health = None
            scaffold.record_learnhealth(entry, replay_health)
            logs.append(entry)
            # registry absorption + the persistent JSONL record
            telemetry.record(entry)
            if log_sink is not None:
                log_sink(entry)
            if verbose:
                print(format_entry(entry), flush=True)
            last_steps, last_time = s["training_steps"], now

    def chaos_loop():
        # the fleet plane's fault sites (fleet kill, slab garbling), the
        # replay plane's (shard kill, shard stall) and the eval sidecar's
        # kill; the learner freeze fires from learner_stop, checkpoint
        # truncation from the Checkpointer, the service and pump sites
        # from the plane's own loops, the response/frame garbling and the
        # link faults from the replay plane's receipt and issue paths
        while not stop():
            time.sleep(0.05)
            if plane is not None:
                chaos.maybe_kill_fleet(plane)
                chaos.maybe_garble_block(plane)
            if replay_plane is not None:
                chaos.maybe_kill_replay_shard(replay_plane)
                chaos.maybe_stall_shard(replay_plane)
            if sidecar is not None:
                chaos.maybe_kill_eval_sidecar(sidecar)

    def snapshot_loop():
        # periodic insurance against kill -9 (no drain possible): the
        # buffer snapshot is lock-consistent; the actors' state is only
        # captured by the quiesced shutdown save
        last = time.time()
        while not stop():
            time.sleep(0.2)
            if time.time() - last < cfg.replay_snapshot_interval:
                continue
            try:
                checkpointer.save_replay(buffer.training_steps,
                                         buffer.write_state)
            except Exception as e:
                # a snapshot is insurance, not the run: warn and retry
                # next cadence instead of burning the restart budget
                log.warning("periodic replay snapshot failed: %s", e)
            last = time.time()

    loops = [(f"actor{f}" if len(actors) > 1 else "actor",
              make_actor_loop(a)) for f, a in enumerate(actors)]
    loops += scaffold.watch_loops()
    if chaos is not None and (
            (plane is not None and (chaos.enabled("kill_fleet")
                                    or chaos.enabled("garble_block")))
            or (replay_plane is not None
                and (chaos.enabled("kill_replay_shard")
                     or chaos.enabled("stall_shard")))
            or (sidecar is not None
                and chaos.enabled("kill_eval_sidecar"))):
        loops.append(("chaos", chaos_loop))
    if want_full_save and cfg.replay_snapshot_interval > 0:
        loops.append(("snapshot", snapshot_loop))
    if plane is not None:
        # process transport: the fleets' trainer-side plumbing (block
        # ingest, act server, weight pump, watchdog) runs as supervised
        # fabric threads
        loops += plane.make_loops(stop, buffer.add)
    if sidecar is not None:
        # the eval sidecar's watchdog (respawn with the cursor resumed):
        # an exhausted budget degrades health, never the fabric
        loops += sidecar.make_loops(stop)
    if replay_plane is not None:
        # sharded replay: the shard-process watchdog (respawn + restore)
        loops += replay_plane.make_loops(stop)
    if sys["ring"] is None:
        # device replay: the learner samples index bundles itself, coupled
        # to its dispatch — no batch-staging thread
        loops.append(("sample", sample_loop))
    if not cfg.in_graph_per:
        # in-graph PER scatters the feedback on the device — nothing would
        # ever feed this queue
        loops.append(("priority", priority_loop))
    loops.append(("log", log_loop))
    loops += tracing_loops
    loops += scaffold.exporter_loops(healthz)

    # both run on the learner thread, so their waits poll learner_stop:
    # the heartbeat keeps beating through a legitimately slow batch, and a
    # chaos freeze bites wherever the learner happens to be waiting
    def batch_source():
        while not learner_stop():
            try:
                return batch_queue.get(timeout=0.1)
            except queue.Empty:
                continue
        return None

    def priority_sink(idxes, priorities, old_ptr, loss):
        while not learner_stop():
            try:
                priority_queue.put((idxes, priorities, old_ptr, loss),
                                   timeout=0.1)
                return
            except queue.Full:
                continue
        # stopped: the learner's exit drain still delivers its pipelined
        # results through this sink, and the priority thread may already
        # be gone — apply directly (lock-protected) instead of dropping
        buffer.update_priorities(idxes, priorities, old_ptr, loss)

    # everything that launches concurrent machinery (fleet subprocesses,
    # fabric threads) lives inside the try: a failure anywhere in bring-up
    # still reaches the teardown, so no process or /dev/shm slab outlives
    # the call
    try:
        fleet_snaps = None
        try:
            if replay_plane is not None:
                # shard processes first: every other plane's ingest path
                # routes into them (restores armed by _build apply here).
                # A plane that cannot start raises out of train(): there
                # is no in-process ring to fall back on
                replay_plane.start()
            if plane is not None:
                plane.start(sys["param_store"])
            if sidecar is not None:
                sidecar.start()
            scaffold.start(loops)
            with device_profile(profile_dir):
                if sys["ring"] is not None:
                    metrics = learner.run_device(buffer, sys["ring"],
                                                 priority_sink,
                                                 stop=learner_stop,
                                                 tracer=tracer)
                else:
                    metrics = learner.run(batch_source, priority_sink,
                                          stop=learner_stop, tracer=tracer)
        finally:
            # the run's final health verdict, sampled while every plane
            # still exists (post-quiesce the heartbeat stops beating, and
            # a shut-down plane reports no live fleet)
            try:
                final_health = healthz()
            except Exception:
                final_health = {}
            scaffold.quiesce()
            league_final = None
            if sidecar is not None:
                # the standings the run served with, then the child stopped
                # before the fleet plane: evaluation is pure overhead in a
                # drain, and a sidecar mid-restore must not race the
                # retention GC the epilogue save may run
                league_final = sidecar.status()
                sidecar.shutdown()
            if plane is not None:
                # drain-then-save: resumable actor snapshots from the dying
                # fleets, answered by their shutdown handshake
                fleet_snaps = plane.shutdown(snapshot=want_full_save)
            for a in actors:
                a.close()

        # drain remaining priority feedback so buffer counters are final
        while True:
            try:
                idxes, priorities, old_ptr, loss = priority_queue.get_nowait()
            except queue.Empty:
                break
            buffer.update_priorities(idxes, priorities, old_ptr, loss)

        # full-state snapshot, AFTER the drain so ring priorities/counters
        # are final: the learner state was already saved by Learner.run's
        # epilogue; this persists the warm replay ring + sum-tree + actor
        # RNG/env state next to it, atomically
        if want_full_save:
            try:
                checkpointer.save_replay(
                    learner.num_updates, buffer.write_state,
                    actors=(fleet_snaps if plane is not None
                            else [a.snapshot() for a in actors]))
            except Exception as e:  # never fail the run over snapshot I/O
                log.warning("full-state replay snapshot failed: %s", e)

        metrics.update(buffer_size=len(buffer), logs=list(logs),
                       buffer_training_steps=buffer.training_steps,
                       final_params=learner.full_params(),
                       restored_replay=sys["restored_replay"],
                       learner_stalled=stall["stalled"],
                       trace=tracer.snapshot(), health=supervisor.health(),
                       telemetry_port=telemetry.port,
                       fabric_failed=(supervisor.any_failed
                                      or (plane is not None and plane.failed)),
                       learnhealth=scaffold.learnhealth.snapshot(),
                       alerts=scaffold.alerts.counts(),
                       healthz=final_health)
        if chaos is not None:
            metrics["chaos"] = chaos.counts()
        if plane is not None:
            metrics["fleet_health"] = plane.health()
        if replay_plane is not None:
            metrics["replay_shard_health"] = replay_plane.health()
        if sidecar is not None:
            # the health the run served with, and a final re-read of the
            # table (rows the sidecar committed in its own drain count)
            metrics["league"] = dict(sidecar.status(max_age=0.0),
                                     health=league_final["health"])
        metrics["blocks_per_member"] = buffer.stats().get(
            "blocks_per_member", {})
        return metrics
    finally:
        # AFTER the epilogue: the priority drain and the full-state
        # snapshot fan-out above both need live shard processes
        if replay_plane is not None:
            replay_plane.shutdown()
        scaffold.close()
