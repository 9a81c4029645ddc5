"""Typed configuration, copied whole from ``r2d2_tpu/config.py``.

The port keeps its own copy because importing ``r2d2_tpu`` pulls in JAX.
Field names, defaults and validation are identical, so ``arch_meta`` and the
checkpoint meta stay compatible between the two packages.  Two readings
differ in the port: ``lstm_impl="pallas"`` selects the fused inference
kernel (CUDA here, ``r2d2_tpu_torch/ops/lstm.py``), and ``act_device="auto"``
acts on the CUDA device (``actor._resolve_act_device``).

Immutable dataclass: values are captured at construction, derived
quantities are validated, and presets mirror the benchmark configurations in
``BASELINE.json``.  Nothing reads config at import time; every component takes
a ``Config`` explicitly.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Dict, List, Optional, Tuple

# the canonical learner-mesh axes, in mesh order (parallel/mesh.py's AXES
# aliases this — defined here so Config validation needs no jax import);
# the r8-era "mp" axis folded into "tp" with the sharding table
MESH_AXES = ("dp", "fsdp", "tp")


def validate_mesh_shape(mesh_shape) -> dict:
    """The single mesh-axis rule set (axis names, duplicates, sizes),
    shared by Config.__post_init__ and parallel/mesh.make_mesh so the
    two can never drift.  Returns {axis: size or None} for the named
    axes."""
    sizes = {name: None for name in MESH_AXES}
    for name, size in mesh_shape:
        if name not in MESH_AXES:
            raise ValueError(
                f"unknown mesh axis {name!r} in mesh_shape (expected one "
                f"of {MESH_AXES}; the 'mp' axis was folded into 'tp' "
                "with the sharding table)")
        if sizes[name] is not None:
            raise ValueError(f"duplicate mesh axis {name!r}")
        if int(size) < 1:
            raise ValueError(f"mesh axis {name!r} size must be >= 1")
        sizes[name] = int(size)
    return sizes


_INT_TOKEN = re.compile(r"^\d+$")
_INT_SUFFIX = re.compile(r"^(.+?)_\d+$")


def normalize_token(token: str) -> str:
    """Wildcard integer layer indices: ``"3"`` → ``"*"``, ``"lstm_0"`` →
    ``"lstm_*"`` (all layers of a family share one layout — SNIPPETS.md
    [3]'s ``_process_sharding_name``)."""
    if _INT_TOKEN.match(token):
        return "*"
    m = _INT_SUFFIX.match(token)
    if m:
        return m.group(1) + "_*"
    return token


def parse_table(spec: str) -> Dict[str, Tuple[Optional[str], ...]]:
    """Parse a ``cfg.sharding_table`` override string.

    Format: ``pattern=axis,axis;pattern2=...`` — one entry per pattern,
    dims comma-separated, an empty slot (or no slots at all) replicates.
    E.g. ``"lstm_*.wh=,tp;head.*.kernel="`` keeps ``wh``'s input dim
    replicated but tp-splits its gates, and fully replicates the head
    kernels.  Raises ``ValueError`` on malformed entries or unknown axis
    names (validated at Config construction, not mid-run).

    Lives here (not parallel/sharding.py, which re-exports it) so Config
    validation stays jax-free — the grammar only needs ``MESH_AXES``.
    """
    out: Dict[str, Tuple[Optional[str], ...]] = {}
    for clause in filter(None, (c.strip() for c in spec.split(";"))):
        if "=" not in clause:
            raise ValueError(
                f"sharding_table clause {clause!r} is not 'pattern=axes'")
        pattern, axes = clause.split("=", 1)
        pattern = pattern.strip()
        if not pattern:
            raise ValueError("sharding_table clause with empty pattern")
        # normalize concrete layer indices to the table's wildcard form
        # ("lstm_0.wh" → "lstm_*.wh"): lookup() normalizes the LEAF path
        # before matching, so a verbatim "lstm_0" entry could never match
        # and the override would be a silent no-op
        pattern = ".".join(normalize_token(t) for t in pattern.split("."))
        dims = []
        for d in axes.split(","):
            d = d.strip()
            if d and d not in MESH_AXES:
                raise ValueError(
                    f"sharding_table axis {d!r} not in {MESH_AXES}")
            dims.append(d or None)
        if dims == [None]:
            dims = []  # "pattern=" → fully replicated
        out[pattern] = tuple(dims)
    return out


# --- population / league (r2d2_tpu/league, docs/LEAGUE.md) ----------------
# JSON member-object keys that are population metadata, not Config
# overrides.  Restated in r2d2_tpu/analysis/config_integrity.py for the
# jax-free lint pass — tests/test_league.py pins the two in sync.
POPULATION_META_KEYS = ("name", "preset")

# Config fields one population member may override.  A deliberate
# WHITELIST, not a blacklist: every member's blocks flow into ONE shared
# replay plane and act on ONE learner's params, so anything that changes
# parameter shapes (checkpoint.ARCH_FIELDS), the block wire format /
# replay geometry (block_length, learning_steps, burn_in_steps, obs
# layout), or the fabric topology must stay base-config-owned.  What
# remains is the scenario-diversity axis: the env, the exploration
# ladder, the discount (gamma is pure per-block DATA — n_step_reward /
# n_step_gamma carry it through the wire, the learner never reads
# cfg.gamma), and eval-side knobs.  ``forward_steps`` is deliberately
# NOT here: the learner's target gather bootstraps at the BASE config's
# n (learner/step._window_indices), so a member with a smaller n would
# pair an n'-step reward sum with Q(s_{t+n}) — a silently biased
# Bellman target.  Per-member n-step needs a per-row n word through the
# batch wire (ring accounting + shard RPC + in-graph meta) and is an
# explicit follow-on (docs/LEAGUE.md).  Restated in
# analysis/config_integrity.py (pinned by tests/test_league.py).
POPULATION_MEMBER_FIELDS = (
    "game_name", "seed", "base_eps", "eps_alpha",
    "gamma", "max_episode_steps", "actor_update_interval",
    "test_epsilon", "eval_episodes", "noop_max",
)

# named member presets a population_spec entry may start from
# ("preset": "low_resource"); explicit member keys override preset keys.
# "low_resource" is the acting-side slice of low_resource_config (the
# "Human-Level Control without Server-Grade Hardware" recipe, PAPERS.md)
# — the net/replay knobs of that preset are base-config territory.
# Preset names are restated in analysis/config_integrity.py (pinned).
POPULATION_PRESETS: Dict[str, Dict[str, Any]] = {
    "default": {},
    # NOTE: low_resource_config's forward_steps=3 does NOT ride the
    # member preset — per-member n-step is whitelisted out (see
    # POPULATION_MEMBER_FIELDS); the discount/exploration slice does
    "low_resource": dict(gamma=0.99, base_eps=0.3, eps_alpha=5.0),
}

MAX_POPULATION_MEMBERS = 64


def parse_population(spec: str) -> List[Dict[str, Any]]:
    """``cfg.population_spec`` JSON → normalized member list
    ``[{name, preset, overrides}, ...]``.

    The spec is a JSON list of member objects; each object holds optional
    ``name``/``preset`` metadata plus Config-field overrides drawn from
    :data:`POPULATION_MEMBER_FIELDS`.  Raises ``ValueError`` on malformed
    JSON, an unknown preset, a key that is not a Config field (typo), or
    a real field that is not population-overridable — misspelled member
    knobs fail at Config construction (and in graftlint's
    config-integrity pass), never silently no-op.  Value types are
    coerced to the field's declared default type so ``"forward_steps":
    3.0`` from hand-written JSON cannot smuggle a float into an int knob.
    """
    try:
        raw = json.loads(spec)
    except ValueError as e:
        raise ValueError(f"population_spec is not valid JSON: {e}")
    if not isinstance(raw, list) or not raw:
        raise ValueError(
            "population_spec must be a non-empty JSON list of member "
            "objects, e.g. '[{\"name\": \"base\"}, "
            "{\"preset\": \"low_resource\"}]'")
    if len(raw) > MAX_POPULATION_MEMBERS:
        raise ValueError(
            f"population_spec declares {len(raw)} members "
            f"(max {MAX_POPULATION_MEMBERS})")
    fields = Config.__dataclass_fields__
    out: List[Dict[str, Any]] = []
    for i, m in enumerate(raw):
        if not isinstance(m, dict):
            raise ValueError(
                f"population member {i} must be a JSON object, got "
                f"{type(m).__name__}")
        preset = m.get("preset", "default")
        if preset not in POPULATION_PRESETS:
            raise ValueError(
                f"population member {i}: unknown preset {preset!r} "
                f"(expected one of {tuple(POPULATION_PRESETS)})")
        name = m.get("name", preset if preset != "default" else f"m{i}")
        if not isinstance(name, str) or not name:
            raise ValueError(
                f"population member {i}: 'name' must be a non-empty "
                "string")
        overrides = dict(POPULATION_PRESETS[preset])
        for k, v in m.items():
            if k in POPULATION_META_KEYS:
                continue
            if k not in fields:
                raise ValueError(
                    f"population member {i} ({name}): {k!r} is not a "
                    "Config field (typo or removed knob?)")
            if k not in POPULATION_MEMBER_FIELDS:
                raise ValueError(
                    f"population member {i} ({name}): {k!r} is not "
                    "population-overridable — members share the "
                    "learner's network, replay geometry and fabric "
                    "topology (overridable: "
                    f"{POPULATION_MEMBER_FIELDS})")
            default = fields[k].default
            if isinstance(default, bool):
                overrides[k] = bool(v)
            elif isinstance(default, int):
                overrides[k] = int(v)
            elif isinstance(default, float):
                overrides[k] = float(v)
            else:
                overrides[k] = v
        out.append(dict(name=name, preset=preset, overrides=overrides))
    names = [m["name"] for m in out]
    if len(set(names)) != len(names):
        raise ValueError(
            f"population member names must be unique, got {names} — "
            "names label league.jsonl rows and population.* metrics")
    return out


@dataclasses.dataclass(frozen=True)
class Config:
    # --- environment -----------------------------------------------------
    # reference: config.py:1-2 (game name, (1,84,84) CHW obs). We use NHWC
    # (84,84,1) because that is the native TPU/XLA conv layout.
    game_name: str = "MsPacman"
    obs_shape: Tuple[int, int, int] = (84, 84, 1)
    frameskip: int = 4
    noop_max: int = 30
    max_episode_steps: int = 27000  # reference: config.py:17
    # Store observations space-to-depth transformed: 4x4 pixel blocks fold
    # into channels host-side ((84,84,1) -> (21,21,16) uint8, same bytes),
    # so the first conv is a 2x2/1 conv with an MXU-shaped contraction
    # instead of 8x8/4 over 1 channel (the reference's TPU choice; the
    # port keeps it so stored obs stay byte-identical).  The
    # transform is exact: same linear function class, kernel entries
    # permuted.  nature/mlp torsos only.
    obs_space_to_depth: bool = True

    # --- optimisation ----------------------------------------------------
    lr: float = 1e-4            # reference: config.py:4
    adam_eps: float = 1e-3      # reference: config.py:5
    grad_norm: float = 40.0     # reference: config.py:6
    batch_size: int = 64        # reference: config.py:7
    gamma: float = 0.997        # reference: config.py:11
    training_steps: int = 100000  # reference: config.py:15

    # --- prioritised replay ----------------------------------------------
    prio_exponent: float = 0.9               # reference: config.py:12
    importance_sampling_exponent: float = 0.6  # reference: config.py:13
    learning_starts: int = 50000             # reference: config.py:8
    buffer_capacity: int = 2_000_000         # reference: config.py:16 (transitions)
    block_length: int = 400                  # reference: config.py:19

    # --- sequence windows -------------------------------------------------
    burn_in_steps: int = 40     # reference: config.py:27
    learning_steps: int = 40    # reference: config.py:28
    forward_steps: int = 5      # reference: config.py:29 (n-step bootstrap)
    stored_hidden_mode: str = "burn_in_start"
    # Which recurrent state a sequence stores for replay:
    #   "burn_in_start" — state at the sequence's burn-in start (the R2D2
    #       paper's scheme; replay/block.py docstring).
    #   "seq_start"     — the reference's indexing (worker.py:461,
    #       hidden_buffer[i * learning_steps]): identical once an episode's
    #       carried prefix is full, but for the first block of an episode it
    #       feeds a state recorded after part of the burn-in window.
    # Compat switch so the divergence can be A/B'd (tools/ab_curves.py).

    # --- actor fleet ------------------------------------------------------
    num_actors: int = 8         # reference: config.py:21
    base_eps: float = 0.4       # reference: config.py:22
    eps_alpha: float = 7.0      # reference: config.py:23
    actor_update_interval: int = 400  # reference: config.py:18

    # --- cadences ---------------------------------------------------------
    save_interval: int = 500               # reference: config.py:9
    target_net_update_interval: int = 2000  # reference: config.py:10
    weight_publish_interval: int = 4       # reference: worker.py:372
    log_interval: float = 10.0             # reference: config.py:24

    # --- network ----------------------------------------------------------
    hidden_dim: int = 512       # reference: config.py:33
    torso: str = "nature"       # "nature" (model.py:39-49) or "impala" (BASELINE configs[4])
    lstm_layers: int = 1        # BASELINE configs[4] uses 2

    # --- evaluation -------------------------------------------------------
    test_epsilon: float = 0.001  # reference: config.py:37
    eval_episodes: int = 5       # reference: test.py:17

    # --- population / league (r2d2_tpu/league, docs/LEAGUE.md) -----------
    population_spec: str = ""         # JSON list of per-member overrides
                                      # generalizing the per-actor epsilon
                                      # ladder to per-fleet member
                                      # CONFIGURATIONS (env, epsilon
                                      # ladder, n-step, discount — the
                                      # scenario-diversity axis): one
                                      # fleet subprocess per member, each
                                      # acting under base.replace(
                                      # **member overrides), blocks
                                      # member-tagged through the shm
                                      # wire into the shared replay
                                      # plane.  Keys validate against
                                      # POPULATION_MEMBER_FIELDS at
                                      # construction (and in graftlint);
                                      # requires actor_transport=
                                      # "process" with actor_fleets ==
                                      # member count.  "" = no
                                      # population (the degenerate
                                      # single-member run)
    league_eval: bool = False         # attach the standing EvalSidecar
                                      # (league/eval_service.py): a
                                      # supervised subprocess follows the
                                      # run's checkpoints, scores every
                                      # population member on its held-out
                                      # scenario suite, and publishes
                                      # league.jsonl + the /statusz
                                      # league table + league.* metrics.
                                      # Its death degrades /healthz —
                                      # training never stops for eval
    league_eval_episodes: int = 3     # rollouts per (checkpoint, member)
                                      # eval — the held-out suite size
    league_eval_interval: float = 2.0  # sidecar checkpoint-poll cadence
                                      # in seconds (the follow loop's
                                      # idle wait)
    league_eval_deadline: float = 120.0  # per-sweep time budget: a sweep
                                      # (all members on one checkpoint)
                                      # that blows it yields mid-step and
                                      # resumes the remaining members
                                      # next poll — a slow suite can lag
                                      # the trainer but never wedge the
                                      # sidecar on one checkpoint (0 =
                                      # unbounded)

    # --- TPU-native knobs (no reference equivalent) -----------------------
    compute_dtype: str = "bfloat16"   # activations dtype for conv/matmul
    param_dtype: str = "float32"
    remat: bool = False               # rematerialise the LSTM scan (long seq)
    lstm_impl: str = "auto"           # "auto" | "scan" | "pallas": the
                                      # recurrence for NO-GRAD paths
                                      # (acting/eval).  Training always
                                      # runs the scan.  In the port
                                      # "pallas" is the fused CUDA
                                      # inference kernel (ops/lstm.py);
                                      # "auto" picks it on a CUDA device
    pallas_interpret: bool = False    # run pallas kernels interpreted (CPU tests)
    transfer_guard: bool = False      # arm the transfer guard's
                                      # windows around every declared
                                      # dispatch/harvest site: an
                                      # UNDECLARED implicit device<->host
                                      # transfer in the hot loop raises
                                      # TransferGuardTripped instead of
                                      # silently stalling the stream
                                      # (docs/ANALYSIS.md; armed after
                                      # bring-up so compile-time staging
                                      # is never misattributed)
    mesh_shape: Tuple[Tuple[str, int], ...] = ()  # learner mesh axes, e.g.
                                      # (("dp", 4), ("fsdp", 2), ("tp", 2)):
                                      # dp = data parallel (batch rows,
                                      # ring slots, grad psums), fsdp =
                                      # param/moment sharding for memory,
                                      # tp = Megatron-style tensor split
                                      # of the LSTM 4H / dense output
                                      # dims.  Omitted axes default to 1;
                                      # empty = all local devices on dp.
                                      # Which param shards where is the
                                      # sharding table's decision
                                      # (parallel/sharding.py,
                                      # docs/SHARDING.md)
    sharding_table: str = ""          # per-param sharding-table override:
                                      # "pattern=axis,axis;pattern2=..."
                                      # entries extend/replace the default
                                      # table (parallel/sharding.py
                                      # DEFAULT_TABLE) — e.g.
                                      # "lstm_*.wh=,tp;head.*.kernel="
                                      # tp-splits wh's gates and fully
                                      # replicates the head kernels.
                                      # Patterns match trailing param-path
                                      # tokens with integer layer indices
                                      # wildcarded; "" keeps the default
                                      # table (docs/SHARDING.md)
    prefetch_batches: int = 4         # reference staging list depth, worker.py:312
    env_workers: int = 0              # >1: thread-pool env stepping (the
                                      # reference's N-process parallelism,
                                      # train.py:30-34); 0/1 = serial
    actor_fleets: int = 1             # independent lockstep fleets, each
                                      # its own thread: fleet A's env
                                      # stepping overlaps fleet B's batched
                                      # inference on multi-core hosts (the
                                      # reference's N actor processes,
                                      # train.py:30-34, regrouped); lanes
                                      # split contiguously, ladder epsilons
                                      # stay global
    actor_transport: str = "thread"   # "thread": fleets are threads in the
                                      # trainer process (scales only when
                                      # the env releases the GIL);
                                      # "process": each fleet is a
                                      # subprocess (parallel/actor_procs),
                                      # blocks return over preallocated
                                      # shared-memory slabs and weights
                                      # arrive on a versioned publication
                                      # queue — the reference's N-process
                                      # topology (train.py:30-34) in
                                      # TPU-native form, for GIL-bound
                                      # envs / multi-core hosts.  Fleet
                                      # inference runs on the host CPU
                                      # backend in this mode.
                                      # "anakin": the Podracer fused loop
                                      # (learner/anakin.py) — env, actor,
                                      # replay writes and train steps run
                                      # as ONE jitted on-device program
                                      # over the pure-JAX env
                                      # (envs/anakin.py); zero host
                                      # crossings on the hot path.
                                      # Requires a jittable env (v1: the
                                      # fake env only) and implies
                                      # device_replay + in_graph_per
                                      # (train() flips them on)
    actor_inference: str = "local"    # process-transport acting:
                                      # "local": each fleet subprocess
                                      # runs its own CPU-jitted act twin
                                      # (weights pumped per fleet).
                                      # "serve": fleets stop running the
                                      # network entirely — every env step
                                      # is an RPC over a per-fleet
                                      # shared-memory act slab to the
                                      # trainer's InferenceService, which
                                      # batches across ALL fleets and
                                      # runs one device act per step with
                                      # server-resident recurrent state
                                      # and ~zero-staleness weights (the
                                      # Sebulba/Seed-RL topology;
                                      # parallel/inference_service.py).
                                      # Thread transport ignores it (the
                                      # fleets already share the
                                      # trainer's act fn in-process)
    param_pump_dtype: str = "float32" # wire dtype for process-fleet
                                      # weight publication: "bfloat16"
                                      # halves the per-fleet pickled
                                      # snapshot (QuaRL: low-precision
                                      # weight transport is ~free in RL);
                                      # fleets cast back to float32 at
                                      # publish, so acting math is
                                      # unchanged — only the wire narrows
    inference_batch_window: float = 0.002  # serve mode: after the first
                                      # pending act request, wait up to
                                      # this many seconds for the other
                                      # lockstep fleets' requests before
                                      # dispatching, so F singleton
                                      # batches coalesce into one
                                      # cross-fleet batch (0 disables)
    act_response_timeout: float = 60.0  # serve mode: per-attempt deadline
                                      # a fleet waits on one act RPC
                                      # before treating the service as
                                      # unresponsive (bounded retries,
                                      # then its circuit breaker opens
                                      # and the fleet degrades to local
                                      # inference on its last pumped
                                      # weights — utils/resilience.py;
                                      # must be > 0 and comfortably above
                                      # the service's worst-case act
                                      # compile; the old behavior was a
                                      # hardcoded 600 s then a fleet-
                                      # killing RuntimeError)
    # --- session-serving tier (r2d2_tpu/serving, docs/SERVING.md) --------
    serve_port: int = -1              # session tier listen port
                                      # (127.0.0.1): > 0 binds that port,
                                      # -1 (default) binds an ephemeral
                                      # OS-assigned one (the bound port
                                      # is printed / on SessionServer
                                      # .port).  Used by `r2d2_tpu serve`
    serve_max_sessions: int = 1024    # server-resident recurrent-state
                                      # budget: concurrent sessions whose
                                      # (2, layers, H) hidden lives in
                                      # the SessionStore pool; admitting
                                      # past it LRU-evicts the least-
                                      # recently-used idle session (an
                                      # in-flight session is never
                                      # evicted — the admit sheds
                                      # instead)
    serve_max_batch: int = 256        # continuous-batching cap: the
                                      # batch loop drains up to this many
                                      # pending act requests per turn and
                                      # bucket-pads them into one of
                                      # log2(serve_max_batch)+1 pre-
                                      # compiled act entry points
                                      # (serving/batcher.py)
    serve_dtype: str = "float32"      # quantized act path: "bfloat16"
                                      # rounds every f32 param leaf
                                      # through bf16 at publish (QuaRL
                                      # weights-only quantization, the
                                      # param_pump_dtype pattern on the
                                      # serving tier), gated by the
                                      # greedy-action-parity test
    serve_session_idle_s: float = 60.0  # idle-reap timeout: a session
                                      # untouched this long (and not in
                                      # flight) is reaped — abandoned
                                      # clients must never pin hidden-
                                      # state slots
    serve_pending_max: int = 4096     # bound on the admission queue:
                                      # past it act requests are shed
                                      # with a 429-style reply (counted
                                      # in serving.rejected) — never an
                                      # unbounded wait
    serve_request_deadline: float = 5.0  # per-request deadline: a
                                      # request still queued past this
                                      # answers 408 instead of being
                                      # served stale (the client gave up)
    replay_shards: int = 1            # host replay owner processes
                                      # (parallel/replay_shards.py): 1 =
                                      # the in-process ring+sum-tree (the
                                      # default, unchanged code shape);
                                      # K > 1 splits the ring across K
                                      # spawn-started shard processes —
                                      # ingest routes blocks round-robin
                                      # over the shm block wire format,
                                      # the learner's sample thread
                                      # issues stratified sample RPCs
                                      # answered with preassembled
                                      # batches over preallocated
                                      # response slabs, and priority
                                      # feedback fans back to the owning
                                      # shards.  Strata allocate across
                                      # shards proportionally to priority
                                      # mass, so sampling stays
                                      # content-for-content
                                      # distribution-equivalent to K=1.
                                      # Host replay only (device_replay
                                      # keeps its own device sharding);
                                      # num_blocks must divide by K
    replay_sample_timeout: float = 5.0  # sharded replay: per-RPC deadline
                                      # the sample thread waits on one
                                      # shard's preassembled batch before
                                      # marking it suspect and
                                      # redistributing its rows over the
                                      # healthy shards' mass (the learner
                                      # never stalls on a dead or stalled
                                      # shard); must be > 0
    replay_transport: str = "shm"     # how the sharded replay plane's
                                      # RPCs travel: "shm" (same-host
                                      # owner processes over preallocated
                                      # shared-memory slabs — the fast
                                      # path, parallel/replay_shards.py)
                                      # or "socket" (length-framed CRC'd
                                      # TCP frames, replay/netwire.py +
                                      # parallel/replay_net.py — the
                                      # cross-host fabric; with no
                                      # replay_hosts the plane spawns
                                      # loopback shard servers itself,
                                      # keeping the whole wire path
                                      # tier-1-testable)
    replay_hosts: str = ""            # socket transport only: comma-
                                      # separated "host:port" endpoints,
                                      # one per replay shard, of already-
                                      # running `r2d2_tpu replay-shard`
                                      # servers.  Empty = managed
                                      # loopback (the plane spawns local
                                      # shard servers on ephemeral
                                      # 127.0.0.1 ports).  Remote shards
                                      # are re-attached through the epoch
                                      # handshake on reconnect, never
                                      # respawned from here
    replay_net_cooldown: float = 2.0  # socket transport: per-shard-link
                                      # circuit-breaker cooldown — while
                                      # a link's circuit is open its mass
                                      # leaves the gossiped view and its
                                      # strata redistribute; one probe
                                      # RPC per cooldown re-closes it
                                      # (utils/resilience.py); must be >0
    replay_net_send_budget: float = 2.0  # socket transport: hard bound on
                                      # one ingest frame send before the
                                      # block is dropped-with-count — a
                                      # partitioned shard must never
                                      # wedge an actor sink; must be > 0
    device_replay: bool = False       # replay data lives in HBM; batches
                                      # are gathered in-graph (device_ring)
    device_ring_layout: str = "auto"  # "replicated" (full ring per device)
                                      # | "dp" (ring sharded over dp, per-
                                      # group sampling) | "auto" (replicate
                                      # if it fits, else shard)
    superstep_k: int = 8              # train steps fused per dispatch when
                                      # device_replay (learner/step.py)
    superstep_pipeline: int = 1       # in-flight dispatches the learner
                                      # keeps ahead of its result harvest
                                      # (both learner loops): hides D2H
                                      # round-trip latency at the cost of
                                      # priority-feedback lag — up to
                                      # (pipeline+1)*superstep_k updates
                                      # under device_replay, up to pipeline
                                      # single steps in the host-staged
                                      # loop (train_sync forces 0: inline
                                      # feedback)
    act_device: str = "auto"          # actor inference backend: "auto"
                                      # (CPU when the learner owns an
                                      # accelerator), "cpu", or "default"
    in_graph_per: bool = False        # device-resident PER: prioritized
                                      # sampling, IS weights, AND priority
                                      # feedback run INSIDE the super-step
                                      # (learner/step.py), so the learner
                                      # needs zero host round trips per
                                      # dispatch and the k inner steps see
                                      # fresh priorities (the host path's
                                      # feedback lags >= k updates).
                                      # Requires device_replay; composes
                                      # with replicated AND dp-sharded
                                      # rings, single- and multi-host.
                                      # Default False only for the plain
                                      # constructor (host-replay users);
                                      # the device-replay learning presets
                                      # turn it ON — see pong_config's
                                      # rationale
    # --- robustness / recovery (SURVEY §5.3-grade, no reference equivalent)
    keep_checkpoints: int = 0         # >0: after each successful save, GC
                                      # all but the newest N COMPLETE
                                      # checkpoints (+ their replay
                                      # snapshots); in-progress saves are
                                      # never collected.  0 keeps all
    replay_snapshot: bool = True      # full-state recovery: at shutdown
                                      # (incl. SIGTERM/SIGINT drain) write
                                      # the replay ring + sum-tree +
                                      # counters + actor RNG/env state
                                      # next to the learner checkpoint so
                                      # --resume restarts with a warm
                                      # buffer.  Host-ring buffers only;
                                      # device_replay runs persist learner
                                      # state alone (docs/OPERATIONS.md)
    replay_snapshot_interval: float = 0.0  # seconds between periodic
                                      # replay snapshots mid-run (0 = only
                                      # at shutdown).  Periodic snapshots
                                      # capture the buffer consistently
                                      # (its lock) but skip thread-
                                      # transport actor state — the warm
                                      # ring is the expensive asset a
                                      # kill -9 must not lose
    learner_stall_timeout: float = 0.0  # >0: a heartbeat watchdog declares
                                      # the learner stalled after this
                                      # many seconds without a loop
                                      # iteration and stops the fabric
                                      # (set it above the worst-case XLA
                                      # compile; 0 disables)
    chaos_spec: str = ""              # deterministic fault injection
                                      # (utils/chaos.py), e.g.
                                      # "kill_fleet:every=500;garble_block:p=0.01"
                                      # — drills/soaks only; "" disables
    dispatch_deadline: float = 0.0    # anakin transport: >0 bounds one
                                      # fused-dispatch harvest to this
                                      # many seconds; a dispatch that
                                      # blows the budget (wedged device,
                                      # chaos wedge_dispatch drill) makes
                                      # the loop snapshot its full state
                                      # and abort cleanly instead of
                                      # training on through a flaky
                                      # device (0 disables — the
                                      # heartbeat watchdog + periodic
                                      # snapshots remain the backstop)
    # --- telemetry (r2d2_tpu/telemetry, docs/OBSERVABILITY.md) ------------
    telemetry_port: int = 0           # HTTP scrape endpoint (/metrics
                                      # Prometheus text, /healthz,
                                      # /statusz JSON) on 127.0.0.1:
                                      # 0 disables (default), >0 binds
                                      # that port, -1 binds an ephemeral
                                      # OS-assigned port (tests/multi-run
                                      # hosts; the bound port surfaces in
                                      # log entries and train() metrics)
    log_history_cap: int = 512        # in-memory stats entries train()
                                      # retains (a ring — the JSONL run
                                      # log under <ckpt_dir>/telemetry/
                                      # is the durable record; the old
                                      # unbounded list leaked in soaks)
    telemetry_log_max_bytes: int = 64_000_000  # run.jsonl size cap
                                      # before rotation to .1/.2/...
                                      # (append-only either way: resume
                                      # continues the same file)
    trace_buffer_events: int = 4096   # per-process event-ring capacity of
                                      # the cross-process tracer
                                      # (telemetry/tracing.py): each
                                      # process of the fabric (trainer,
                                      # fleets, replay shards) owns one
                                      # preallocated ring of this many
                                      # fixed-size records; a capture
                                      # window keeps the newest N (older
                                      # events overflow, counted in the
                                      # dump status)
    trace_steps: int = 0              # >0: arm one cross-process trace
                                      # capture at run start covering
                                      # this many train steps, dumped to
                                      # <ckpt_dir>/telemetry/trace_1.json
                                      # (Chrome trace JSON — load in
                                      # Perfetto).  0 (default) records
                                      # nothing; a live run is captured
                                      # on demand via the exporter's
                                      # /tracez endpoint instead
                                      # (--trace-steps / docs/
                                      # OBSERVABILITY.md)
    # --- learning health (telemetry/learnhealth.py, docs/OBSERVABILITY.md)
    learnhealth_interval: int = 0     # >0: every N optimizer steps the
                                      # jitted train step computes the
                                      # in-graph diagnostic bundle
                                      # (lax.cond-gated: the paper's ΔQ
                                      # stored-vs-recomputed-state
                                      # divergence via a zero-state
                                      # re-unroll, |TD|/IS-weight
                                      # histograms, grad/update/param
                                      # norms, target lag, max|Q|, the
                                      # NaN/Inf sentry) riding the
                                      # existing per-dispatch D2H fetch.
                                      # 0 (default) compiles the step
                                      # without the bundle — bit-
                                      # identical to the pre-learnhealth
                                      # program
    alert_loss_spike_factor: float = 10.0  # loss_spike alert rule: a
                                      # harvested loss above this factor
                                      # times the loss EWMA fires
                                      # learnhealth.alert{rule=
                                      # "loss_spike"} (always armed;
                                      # must be > 1)
    alert_dq_budget: float = 0.0      # >0: dq_drift alert rule — the
                                      # armed diag's mean ΔQ above this
                                      # budget fires (edge-triggered);
                                      # 0 disables (no universal ΔQ
                                      # scale exists — set it from a
                                      # healthy run's learnhealth.dq_mean)
    alert_ess_min: float = 0.0        # >0: ess_collapse alert rule —
                                      # any ring/shard whose PER
                                      # effective-sample-size fraction
                                      # drops below this (with at least
                                      # batch_size positive leaves)
                                      # fires; 0 disables
    alert_replay_ratio_min: float = 0.0  # replay_ratio alert band lower
                                      # edge (meaningful only when
                                      # alert_replay_ratio_max > 0)
    alert_replay_ratio_max: float = 0.0  # >0: replay_ratio alert rule —
                                      # the cumulative samples-per-
                                      # insert ratio leaving
                                      # [alert_replay_ratio_min, max]
                                      # fires (edge-triggered); 0
                                      # disables the band
    anakin_env_steps_per_update: int = 4  # anakin transport: fused
                                      # env/actor steps per optimizer step
                                      # inside the super-step (the
                                      # actor:learner cadence the threaded
                                      # fabric gets implicitly; 4 mirrors
                                      # train_sync's default interleave)
    anakin_episode_len: int = 32      # anakin transport: the pure-JAX
                                      # env's truncation length
                                      # (envs/anakin.py; must be <=
                                      # max_episode_steps — the fused
                                      # loop relies on truncation firing
                                      # before the episode-step cap)
    anakin_env: str = "fake"          # anakin transport: which jittable
                                      # env the fused loop steps —
                                      # "fake" (the vmapped FakeAtariEnv
                                      # twin) or "grid" (the goal-
                                      # seeking gridworld, envs/grid.py
                                      # oracle).  Both run through the
                                      # UNCHANGED fused program via the
                                      # envs/anakin.py four-method
                                      # surface (make_anakin_env)
    anakin_eval_interval: int = 0     # anakin transport: >0 runs an
                                      # in-graph GREEDY eval lane every
                                      # N fused dispatches (lax.cond-
                                      # gated: one truncation-length
                                      # episode per lane with epsilon=0,
                                      # results riding the existing
                                      # per-dispatch result vector) so
                                      # anakin learning curves need no
                                      # host env; 0 (default) disables
                                      # — the compiled program then
                                      # carries no eval branch
    fused_double_unroll: bool = False  # compute the online+target forwards
                                      # as ONE unroll vmapped over stacked
                                      # params: half the sequential LSTM
                                      # chain at double per-step batch
                                      # (learner/step.py:_double_unroll);
                                      # off until measured faster on the
                                      # target chip
    seed: int = 0

    # --- derived ----------------------------------------------------------
    @property
    def stored_obs_shape(self) -> Tuple[int, int, int]:
        """Observation shape as stored/batched/fed to the network:
        space-to-depth folded when ``obs_space_to_depth`` (envs apply the
        fold at emission, everything downstream sees only this shape)."""
        if not self.obs_space_to_depth:
            return self.obs_shape
        h, w, c = self.obs_shape
        return (h // 4, w // 4, 16 * c)

    @property
    def seq_len(self) -> int:
        """reference: config.py:30 (burn_in + learning + forward)."""
        return self.burn_in_steps + self.learning_steps + self.forward_steps

    @property
    def seqs_per_block(self) -> int:
        """Sequences per block (reference: worker.py:48)."""
        return self.block_length // self.learning_steps

    @property
    def num_blocks(self) -> int:
        """Ring size in blocks (reference: worker.py:47)."""
        return self.buffer_capacity // self.block_length

    @property
    def num_sequences(self) -> int:
        """PER leaf count (reference: worker.py:45)."""
        return self.buffer_capacity // self.learning_steps

    @property
    def max_block_steps(self) -> int:
        """Max env steps stored per block incl. burn-in prefix and the final obs."""
        return self.block_length + self.burn_in_steps + 1

    def __post_init__(self):
        if self.block_length % self.learning_steps != 0:
            raise ValueError(
                f"block_length ({self.block_length}) must be a multiple of "
                f"learning_steps ({self.learning_steps})"
            )
        if self.buffer_capacity % self.block_length != 0:
            raise ValueError("buffer_capacity must be a multiple of block_length")
        if self.forward_steps < 1:
            raise ValueError("forward_steps must be >= 1")
        if self.num_actors < 1:
            raise ValueError("num_actors must be >= 1")
        if self.env_workers < 0:
            raise ValueError("env_workers must be >= 0")
        if not (1 <= self.actor_fleets <= self.num_actors):
            raise ValueError(
                f"actor_fleets ({self.actor_fleets}) must be in "
                f"[1, num_actors={self.num_actors}]")
        if self.actor_transport not in ("thread", "process", "anakin"):
            raise ValueError(
                f"unknown actor_transport {self.actor_transport!r} "
                "(expected 'thread', 'process' or 'anakin')")
        if self.anakin_env_steps_per_update < 1:
            raise ValueError("anakin_env_steps_per_update must be >= 1")
        if self.anakin_episode_len < 1:
            raise ValueError("anakin_episode_len must be >= 1")
        if self.anakin_env not in ("fake", "grid"):
            raise ValueError(
                f"unknown anakin_env {self.anakin_env!r} (expected 'fake' "
                "or 'grid' — a custom jittable env plugs in at the "
                "envs/anakin.py four-method surface)")
        if self.anakin_eval_interval < 0:
            raise ValueError(
                "anakin_eval_interval must be >= 0 (0 disables the "
                "in-graph eval lane)")
        if (self.actor_transport == "anakin"
                and self.anakin_episode_len > self.max_episode_steps):
            raise ValueError(
                f"anakin_episode_len ({self.anakin_episode_len}) must be "
                f"<= max_episode_steps ({self.max_episode_steps}) — the "
                "fused loop has no episode-step-cap bootstrap path")
        if self.actor_inference not in ("local", "serve"):
            raise ValueError(
                f"unknown actor_inference {self.actor_inference!r} "
                "(expected 'local' or 'serve')")
        if self.actor_inference == "serve" and self.actor_transport != "process":
            raise ValueError(
                "actor_inference='serve' requires actor_transport='process' "
                "(thread fleets already share the trainer's act fn; the "
                "inference service exists to centralize subprocess acting)")
        if self.param_pump_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"unknown param_pump_dtype {self.param_pump_dtype!r} "
                "(expected 'float32' or 'bfloat16')")
        if self.inference_batch_window < 0:
            raise ValueError("inference_batch_window must be >= 0")
        if self.act_response_timeout <= 0:
            raise ValueError(
                "act_response_timeout must be > 0 (the act RPC deadline "
                "is what keeps a frozen service from wedging a fleet "
                "forever — there is no unbounded mode)")
        if self.dispatch_deadline < 0:
            raise ValueError("dispatch_deadline must be >= 0 (0 disables)")
        if not (-1 <= self.serve_port <= 65535):
            raise ValueError(
                f"serve_port must be in [-1, 65535] (-1 = ephemeral), "
                f"got {self.serve_port}")
        if self.serve_max_sessions < 1:
            raise ValueError("serve_max_sessions must be >= 1")
        if self.serve_max_batch < 1:
            raise ValueError("serve_max_batch must be >= 1")
        if self.serve_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"unknown serve_dtype {self.serve_dtype!r} "
                "(expected 'float32' or 'bfloat16')")
        if self.serve_session_idle_s <= 0:
            raise ValueError(
                "serve_session_idle_s must be > 0 (the idle reaper is "
                "what keeps abandoned sessions from pinning hidden-state "
                "slots — there is no unbounded mode)")
        if self.serve_pending_max < 1:
            raise ValueError("serve_pending_max must be >= 1")
        if self.serve_request_deadline <= 0:
            raise ValueError(
                "serve_request_deadline must be > 0 (the per-request "
                "deadline is what keeps a backlogged tier from serving "
                "replies nobody awaits — there is no unbounded mode)")
        if self.superstep_k < 1:
            raise ValueError("superstep_k must be >= 1")
        if self.superstep_pipeline < 0:
            raise ValueError("superstep_pipeline must be >= 0")
        if self.replay_shards < 1:
            raise ValueError("replay_shards must be >= 1 (1 = in-process)")
        if self.replay_shards > 1:
            if self.device_replay:
                raise ValueError(
                    "replay_shards > 1 shards the HOST replay plane; "
                    "device_replay has its own dp slot sharding "
                    "(device_ring_layout) — pick one")
            if self.actor_transport == "anakin":
                raise ValueError(
                    "replay_shards > 1 is meaningless under the anakin "
                    "transport (the fused loop keeps replay on-device)")
            if self.num_blocks % self.replay_shards:
                raise ValueError(
                    f"num_blocks ({self.num_blocks}) must divide evenly "
                    f"over replay_shards ({self.replay_shards}) so every "
                    "shard owns an equal slot slice")
        if self.replay_sample_timeout <= 0:
            raise ValueError(
                "replay_sample_timeout must be > 0 (the sample RPC "
                "deadline is what keeps a dead shard from wedging the "
                "sample thread — there is no unbounded mode)")
        if self.replay_transport not in ("shm", "socket"):
            raise ValueError(
                f"replay_transport must be 'shm' or 'socket', got "
                f"{self.replay_transport!r}")
        if self.replay_hosts and self.replay_transport != "socket":
            raise ValueError(
                "replay_hosts names remote replay-shard servers and only "
                "means anything with replay_transport='socket'")
        if self.replay_transport == "socket":
            if self.device_replay:
                raise ValueError(
                    "replay_transport='socket' moves the HOST replay "
                    "plane off-host; device_replay keeps replay in HBM — "
                    "pick one")
            if self.actor_transport == "anakin":
                raise ValueError(
                    "replay_transport='socket' is meaningless under the "
                    "anakin transport (the fused loop keeps replay "
                    "on-device)")
            if self.num_blocks % self.replay_shards:
                raise ValueError(
                    f"num_blocks ({self.num_blocks}) must divide evenly "
                    f"over replay_shards ({self.replay_shards}) so every "
                    "shard owns an equal slot slice")
            if self.replay_hosts:
                hosts = parse_replay_hosts(self.replay_hosts)
                if len(hosts) != self.replay_shards:
                    raise ValueError(
                        f"replay_hosts names {len(hosts)} endpoints but "
                        f"replay_shards is {self.replay_shards} — one "
                        "host:port per shard")
        if self.replay_net_cooldown <= 0:
            raise ValueError(
                "replay_net_cooldown must be > 0 (the circuit cooldown "
                "paces re-attach probes to a partitioned shard)")
        if self.replay_net_send_budget <= 0:
            raise ValueError(
                "replay_net_send_budget must be > 0 (the bounded ingest "
                "send is what keeps a partitioned shard from wedging an "
                "actor sink — there is no unbounded mode)")
        if self.in_graph_per and not self.device_replay:
            raise ValueError("in_graph_per requires device_replay=True "
                             "(sampling reads the HBM-resident ring)")
        # in_graph_per composes with every ring layout: the stratified
        # draw is global either way — under a dp-sharded ring the PER
        # leaves shard with the slabs and GSPMD inserts the collectives
        # (parallel/sharding.py pjit_in_graph_per_super_step)
        if self.device_ring_layout not in ("auto", "replicated", "dp"):
            raise ValueError(
                f"unknown device_ring_layout {self.device_ring_layout!r}")
        if self.act_device not in ("auto", "cpu", "default"):
            raise ValueError(f"unknown act_device {self.act_device!r}")
        if self.torso not in ("nature", "impala", "mlp"):
            raise ValueError(f"unknown torso {self.torso!r}")
        if self.lstm_layers < 1:
            raise ValueError("lstm_layers must be >= 1")
        if self.lstm_impl not in ("auto", "scan", "pallas"):
            raise ValueError(f"unknown lstm_impl {self.lstm_impl!r} "
                             "(pallas_spmd was retired in r5 with the "
                             "backward kernel — training always scans)")
        if self.keep_checkpoints < 0:
            raise ValueError("keep_checkpoints must be >= 0 (0 keeps all)")
        if self.replay_snapshot_interval < 0:
            raise ValueError("replay_snapshot_interval must be >= 0")
        if self.learner_stall_timeout < 0:
            raise ValueError("learner_stall_timeout must be >= 0")
        if not (-1 <= self.telemetry_port <= 65535):
            raise ValueError(
                f"telemetry_port must be in [-1, 65535] (0 = disabled, "
                f"-1 = ephemeral), got {self.telemetry_port}")
        if self.log_history_cap < 1:
            raise ValueError("log_history_cap must be >= 1")
        if self.telemetry_log_max_bytes < 1024:
            raise ValueError("telemetry_log_max_bytes must be >= 1024")
        if self.trace_buffer_events < 64:
            raise ValueError(
                "trace_buffer_events must be >= 64 (a capture window "
                "needs room for at least a few block lifecycles)")
        if self.trace_steps < 0:
            raise ValueError("trace_steps must be >= 0 (0 = no boot-time "
                             "capture; /tracez arms one on demand)")
        if self.learnhealth_interval < 0:
            raise ValueError(
                "learnhealth_interval must be >= 0 (0 disables the "
                "in-graph diagnostics)")
        if self.alert_loss_spike_factor <= 1.0:
            raise ValueError(
                "alert_loss_spike_factor must be > 1 (a factor <= 1 "
                "would fire on every ordinary loss fluctuation)")
        if self.alert_dq_budget < 0:
            raise ValueError("alert_dq_budget must be >= 0 (0 disables)")
        if not (0.0 <= self.alert_ess_min < 1.0):
            raise ValueError(
                "alert_ess_min must be in [0, 1) — it is a fraction of "
                "the positive leaf count (0 disables)")
        if self.alert_replay_ratio_min < 0 or self.alert_replay_ratio_max < 0:
            raise ValueError("replay-ratio alert band edges must be >= 0")
        if (self.alert_replay_ratio_max > 0
                and self.alert_replay_ratio_min
                > self.alert_replay_ratio_max):
            raise ValueError(
                "alert_replay_ratio_min must not exceed "
                "alert_replay_ratio_max")
        if self.league_eval_episodes < 1:
            raise ValueError("league_eval_episodes must be >= 1")
        if self.league_eval_interval <= 0:
            raise ValueError(
                "league_eval_interval must be > 0 (the sidecar's "
                "checkpoint poll cadence)")
        if self.league_eval_deadline < 0:
            raise ValueError(
                "league_eval_deadline must be >= 0 (0 = unbounded)")
        if self.population_spec:
            members = parse_population(self.population_spec)
            if self.actor_transport != "process":
                raise ValueError(
                    "population_spec requires actor_transport='process' "
                    "— members run as fleet subprocesses, one per "
                    "member (the thread/anakin transports have no "
                    "per-fleet config axis)")
            if len(members) != self.actor_fleets:
                raise ValueError(
                    f"population_spec declares {len(members)} members "
                    f"but actor_fleets={self.actor_fleets} — one fleet "
                    "per member; set actor_fleets to the member count")
            for m in members:
                # full member-config validation: every override
                # combination must itself construct (epsilon/knob
                # ranges all re-checked through this same __post_init__)
                dataclasses.replace(self, population_spec="",
                                    **m["overrides"])
        if self.chaos_spec:
            # fail at construction, not mid-run: parse_spec raises on an
            # unknown kind/param or a clause without a trigger
            from r2d2_tpu_torch.utils.chaos import parse_spec

            parse_spec(self.chaos_spec)
        # mesh axes are fixed (dp, fsdp, tp) — the sharding table resolves
        # against them
        validate_mesh_shape(self.mesh_shape)
        if self.sharding_table:
            # fail at construction, not mid-compile: parse_table raises on
            # malformed clauses / unknown axis names
            parse_table(self.sharding_table)
        if self.stored_hidden_mode not in ("burn_in_start", "seq_start"):
            raise ValueError(
                f"unknown stored_hidden_mode {self.stored_hidden_mode!r}")
        if self.obs_space_to_depth:
            h, w, _ = self.obs_shape
            if h % 4 or w % 4:
                raise ValueError(
                    f"obs_space_to_depth needs obs H/W divisible by 4, got "
                    f"{self.obs_shape}")
            if self.torso == "impala":
                raise ValueError(
                    "obs_space_to_depth is for the nature/mlp torsos; the "
                    "impala torso consumes raw frames")
        # lstm_impl × remat needs no guard since r5: remat applies to the
        # training scan, and training always scans — the pallas kernel
        # only ever serves no-grad unrolls, where remat is meaningless

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# --- presets mirroring BASELINE.json configs[0..4] ------------------------

def _clamp_fleets(base: dict, kw: dict) -> dict:
    """Presets that default ``actor_fleets`` > 1 must not make a
    scaled-down ``num_actors`` override (e.g. ``--actors 2``) invalid;
    clamp the default — but never an explicit ``actor_fleets`` override —
    to the actor count."""
    if "actor_fleets" not in kw:
        base["actor_fleets"] = min(base["actor_fleets"], base["num_actors"])
    return base

def parse_replay_hosts(spec: str):
    """``"host:port,host:port"`` → ``[(host, port), ...]``.  Raises
    ValueError on a malformed entry (Config validation calls this so a
    typo fails at construction, not at first connect)."""
    out = []
    for entry in filter(None, (e.strip() for e in spec.split(","))):
        host, sep, port = entry.rpartition(":")
        if not sep or not host:
            raise ValueError(
                f"replay_hosts entry {entry!r} is not 'host:port'")
        try:
            port_n = int(port)
        except ValueError:
            raise ValueError(
                f"replay_hosts entry {entry!r} has a non-integer port")
        if not 1 <= port_n <= 65535:
            # 0 is never a valid connect target (the managed plane uses
            # it internally as the not-yet-spawned sentinel)
            raise ValueError(
                f"replay_hosts entry {entry!r}: port out of range")
        out.append((host, port_n))
    return out


def smoke_config(**kw) -> Config:
    """configs[0]: MsPacman, 1 actor, LSTM-512 CPU smoke."""
    base = dict(game_name="MsPacman", num_actors=1)
    base.update(kw)
    return Config(**base)


def pong_config(**kw) -> Config:
    """configs[1]: Pong, 64 actors.

    superstep_k=4: the priority-feedback lag is ≤ (pipeline+1)·k = 12
    updates — the reference's own lag envelope (8-batch queue + 4-batch
    staging, worker.py:300-316).  k=16 (lag 48) showed a measurable
    late-curve tax in the 4-run fabric A/B (CURVES_AB_PIPELINE_r04*:
    late-mean 22.9 vs 27.7 baseline, k=4 at parity 26.1); k=16 remains a
    throughput-bench knob, not a learning default.

    in_graph_per=True: the reference package's rationale for this default
    is in ``r2d2_tpu/config.py:pong_config``; its measurements were taken
    on a TPU and a CPU and say nothing about the port on a GPU."""
    base = dict(game_name="Pong", num_actors=64, env_workers=8,
                device_replay=True, in_graph_per=True,
                superstep_k=4, superstep_pipeline=2)
    base.update(kw)
    return Config(**base)


def hard_exploration_config(game: str = "MontezumaRevenge", **kw) -> Config:
    """configs[2]: hard-exploration Atari, 256 actors.  superstep_k=4 and
    in_graph_per=True: see pong_config's rationale."""
    base = dict(game_name=game, num_actors=256, env_workers=16,
                actor_fleets=4,
                device_replay=True, in_graph_per=True,
                superstep_k=4, superstep_pipeline=2)
    base.update(kw)
    return Config(**_clamp_fleets(base, kw))


def atari57_config(game: str, **kw) -> Config:
    """configs[3]: Atari-57 sweep, 256 actors, seq-len 80 (paper hyperparams)."""
    base = dict(
        game_name=game, num_actors=256, env_workers=16, actor_fleets=4,
        burn_in_steps=40, learning_steps=40, forward_steps=5,
    )
    base.update(kw)
    return Config(**_clamp_fleets(base, kw))


def impala_deep_config(game: str = "MsPacman", **kw) -> Config:
    """configs[4]: IMPALA-deep CNN + 2-layer LSTM, seq-len 120."""
    base = dict(
        game_name=game, torso="impala", lstm_layers=2,
        burn_in_steps=40, learning_steps=75, forward_steps=5,
        block_length=375, buffer_capacity=1_500_000, remat=True,
        obs_space_to_depth=False,
    )
    base.update(kw)
    return Config(**base)


def low_resource_config(game: str = "MsPacman", **kw) -> Config:
    """Workstation-scale R2D2 after "Human-Level Control without
    Server-Grade Hardware" (PAPERS.md): a smaller recurrent net, a
    shorter replay ring, fewer actors and a shorter n-step/discount
    horizon, tuned for a single commodity host instead of a pod.  Also
    the base config the ``low_resource`` population-member preset slices
    its acting-side knobs from (POPULATION_PRESETS — a member may only
    override the scenario axis; the net/replay shrinkage here applies
    when the preset is the RUN's base config)."""
    base = dict(
        game_name=game, num_actors=16, env_workers=4, actor_fleets=2,
        hidden_dim=256, batch_size=32,
        buffer_capacity=500_000, learning_starts=20_000,
        block_length=200, burn_in_steps=20, learning_steps=40,
        forward_steps=3, gamma=0.99, base_eps=0.3, eps_alpha=5.0,
    )
    base.update(kw)
    return Config(**_clamp_fleets(base, kw))


def test_config(**kw) -> Config:
    """Tiny config for unit/integration tests: small windows, tiny buffer."""
    base = dict(
        obs_shape=(12, 12, 1), torso="mlp",
        burn_in_steps=4, learning_steps=4, forward_steps=2,
        block_length=8, buffer_capacity=160, learning_starts=16,
        batch_size=8, hidden_dim=16, num_actors=2,
        max_episode_steps=50, training_steps=20,
        compute_dtype="float32", prefetch_batches=0,
        obs_space_to_depth=False,
    )
    base.update(kw)
    return Config(**base)
