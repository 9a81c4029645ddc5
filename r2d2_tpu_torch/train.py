"""Training: the deterministic single-thread trainer.

Port of the single-device, thread-transport, host-ring subset of
``r2d2_tpu/train.py``: ``_build`` (envs, network, train state with an
optional resume, learner, replay buffer, ladder epsilons, vector actors)
and ``train_sync``, the deterministic interleaving of the paper's learning
loop — actors → local buffers cutting blocks with n-step returns →
prioritized sequence replay → learner step (burn-in, double-Q n-step
targets under value rescaling, IS-weighted loss, mixed priorities, Adam
with clip 40, target sync) → priorities fed back.  The threaded
``train()`` fabric, the device ring, meshes and the process planes are
later slices (ROADMAP.md).

The learner runs on ``device`` (default: the CUDA device; raises without
one).  Acting runs where ``cfg.act_device`` says (``actor.
_resolve_act_device``): on the CUDA device for ``"auto"``, through the
fused LSTM kernel.  On a machine without a card, pass ``device="cpu"``
and ``act_device="cpu"`` in the config.
"""
from __future__ import annotations

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
from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer
from r2d2_tpu_torch.utils.math import epsilon_ladder
from r2d2_tpu_torch.utils.store import ParamStore

EnvFactory = Callable[[Config, int], Any]


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


def _build(cfg: Config, env_factory: EnvFactory,
           checkpoint_dir: Optional[str], resume: bool,
           device=None) -> Dict[str, Any]:
    """Common bring-up: envs, net, state (maybe restored), learner,
    buffer, actors.  Parameters are drawn from a ``torch.Generator``
    seeded with ``cfg.seed``."""
    device = resolve_device(device)
    act_device = _resolve_act_device(cfg.act_device)
    envs = [env_factory(cfg, cfg.seed + i) for i in range(cfg.num_actors)]
    action_dim = envs[0].action_space.n
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

    param_store = ParamStore()
    learner = Learner(cfg, net, state, param_store=param_store,
                      checkpointer=checkpointer,
                      start_env_steps=start_env_steps,
                      start_minutes=start_minutes)
    buffer = ReplayBuffer(cfg, action_dim,
                          rng=np.random.default_rng(cfg.seed))
    buffer.env_steps = start_env_steps
    epsilons = [epsilon_ladder(i, cfg.num_actors, cfg.base_eps, cfg.eps_alpha)
                for i in range(cfg.num_actors)]
    # acting shares the learner's network when both run on one device;
    # otherwise a twin on the acting device (same parameter names, the LSTM
    # impl resolved for that device)
    act_net = net if act_device == device else create_network(
        cfg, action_dim, device=act_device,
        generator=torch.Generator().manual_seed(cfg.seed))
    act_fn = make_host_act_fn(act_net)
    # actor_fleets fleets over contiguous lane slices: the ladder epsilons
    # stay GLOBAL, and each fleet gets its own RNG stream
    shards, fleet_workers = fleet_shards(cfg)
    actors = [
        VectorActor(cfg, envs[lo:hi], epsilons[lo:hi], act_fn, param_store,
                    sink=buffer.add, env_workers=fleet_workers,
                    rng=np.random.default_rng(cfg.seed + 7919 + 104729 * f))
        for f, (lo, hi) in enumerate(shards)
    ]
    return dict(cfg=cfg, envs=envs, action_dim=action_dim, net=net,
                act_net=act_net, learner=learner, buffer=buffer,
                actors=actors, actor=actors[0], param_store=param_store,
                checkpointer=checkpointer, host_bs=cfg.batch_size)


def train_sync(cfg: Config, env_factory: EnvFactory = _default_env_factory,
               checkpoint_dir: Optional[str] = None, resume: bool = False,
               actor_steps_per_update: int = 4,
               device=None) -> Dict[str, Any]:
    """Deterministic interleaving: fill the buffer to ``learning_starts``,
    then alternate ``actor_steps_per_update`` lockstep actor iterations
    with one learner update, applying priority feedback inline.

    Returns metrics incl. the per-update loss curve and episode returns
    (the JAX package's keys; ``final_params`` is the learner's state dict).
    """
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
    sys = _build(cfg, env_factory, checkpoint_dir, resume, device=device)
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
                   final_params=learner.state.params)
    return metrics
