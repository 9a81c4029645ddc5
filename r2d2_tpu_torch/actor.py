"""Actors: experience generation against the environment.

Port of ``r2d2_tpu/actor.py``: ``AgentState``, ``fleet_shards``,
``make_act_fn``, ``_resolve_act_device``, the lockstep ``VectorActor``
with ``snapshot``/``restore``, and ``Actor``, its one-lane form.  Under
serve mode the act function is a
:class:`~r2d2_tpu_torch.parallel.inference_service.RemoteActClient`
(duck-typed here): the actor notes lane resets to it, takes the
episode-step-cap bootstrap through its no-commit ``peek``, and keeps no
weights of its own.

One deliberate difference from the reference: there, ``act_device="auto"``
moves acting to the host CPU whenever an accelerator is present and acts
through a scan/float32 twin of the network, so its actors and serving tier
never reach the fused LSTM kernel.  Here ``"auto"`` and ``"default"`` act on
the CUDA device, through the network as configured (the fused kernel when
``lstm_impl`` resolves to ``"pallas"``), and only ``"cpu"`` (or an explicit
``device="cpu"``) acts on the CPU.  Nothing moves to the CPU silently: with
no CUDA device, ``"auto"`` raises.

The lockstep vector actor steps N environments and issues one batched act
per step, exactly as the reference package's; each lane keeps its own ε,
local buffer and episode lifecycle, so the learning semantics are the
reference fleet's.  A block-boundary bootstrap Q comes from the next
iteration's batched act (the finish is deferred one iteration), so acting
costs one forward per env step.  ``env_workers`` shards env stepping over a
thread pool; use ``env_workers=0`` (serial) where determinism matters.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.models.network import R2D2Network
from r2d2_tpu_torch.replay.block import Block, VectorLocalBuffer
from r2d2_tpu_torch.telemetry.tracing import EVENTS
from r2d2_tpu_torch.utils.store import ParamStore
from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS

ActFn = Callable[..., tuple]
# HOST_TRANSFERS name of the actors' acts (one per lockstep forward)
ACTOR_ACT = "actor.act_fetch"
# sink(block, priorities, episode_reward_or_None) — direct buffer.add in the
# single-process trainer
BlockSink = Callable[[Block, np.ndarray, Optional[float]], None]


@dataclasses.dataclass
class AgentState:
    """Recurrent-inference state for ONE env (reference: model.py:9-24).

    Arrays are unbatched host numpy; the vector actor keeps the batched
    (N, ...) stack of these instead.
    """
    obs: np.ndarray            # (*obs_shape) uint8
    last_action: np.ndarray    # (A,) float32 one-hot
    last_reward: float
    hidden: np.ndarray         # (2, layers, H) float32

    @classmethod
    def initial(cls, cfg: Config, obs: np.ndarray, action_dim: int
                ) -> "AgentState":
        la = np.zeros(action_dim, np.float32)
        hidden = np.zeros((2, cfg.lstm_layers, cfg.hidden_dim), np.float32)
        return cls(obs=np.asarray(obs, np.uint8), last_action=la,
                   last_reward=0.0, hidden=hidden)

    def update(self, obs: np.ndarray, action: int, reward: float,
               hidden: np.ndarray) -> None:
        self.obs = np.asarray(obs, np.uint8)
        self.last_action = np.zeros_like(self.last_action)
        self.last_action[action] = 1.0
        self.last_reward = float(reward)
        self.hidden = np.asarray(hidden, np.float32)


def fleet_shards(cfg: Config):
    """``([(lo, hi), ...], env_workers_per_fleet)`` — the fleet split:
    lanes split contiguously over ``cfg.actor_fleets``, and the env-worker
    budget (per host) split across the fleets."""
    F = cfg.actor_fleets
    bounds = np.linspace(0, cfg.num_actors, F + 1).astype(int)
    shards = [(int(lo), int(hi))
              for lo, hi in zip(bounds[:-1], bounds[1:]) if lo < hi]
    workers = (cfg.env_workers + F - 1) // F if cfg.env_workers else 0
    return shards, workers


def _resolve_act_device(spec: str, device=None) -> torch.device:
    """The device acting runs on.  An explicit ``device`` wins; otherwise
    ``cfg.act_device``: ``"cpu"`` → the CPU, ``"auto"``/``"default"`` → the
    current CUDA device (raises when there is none)."""
    if device is not None:
        return torch.device(device)
    if spec == "cpu":
        return torch.device("cpu")
    if spec not in ("auto", "default"):
        raise ValueError(f"unknown act_device {spec!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"act_device={spec!r} needs a CUDA device and none is visible; "
            "pass device='cpu' (or act_device='cpu') to act on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def make_act_fn(net: R2D2Network) -> ActFn:
    """Batched single-step inference:
    ``act(params, obs (B,*obs) u8, last_action (B,A) f32, last_reward (B,)
    f32, hidden (B,2,layers,H) f32) -> (q (B,A) f32, new hidden)``, all
    tensors on ``net``'s device.  ``params`` is a state dict of ``net``
    (what :meth:`ContinuousBatcher.publish` holds), so a new snapshot is a
    new dict, never an in-place write under a running batch."""

    def act(params: Mapping[str, torch.Tensor], obs, last_action,
            last_reward, hidden):
        with torch.inference_mode():
            return functional_call(net, params,
                                   (obs, last_action, last_reward, hidden))

    return act


def make_host_act_fn(net: R2D2Network, name: str = ACTOR_ACT) -> ActFn:
    """:func:`make_act_fn` for callers that hold numpy arrays (the vector
    actor, the evaluator): the four inputs go to ``net``'s device, and
    ``(q, new hidden)`` come back as numpy in ONE device→host copy, counted
    under ``HOST_TRANSFERS[name]`` (one per act, so a run can count its
    acts).  ``params`` must already be on that device."""
    act = make_act_fn(net)
    device = next(net.parameters()).device

    def act_host(params, obs, last_action, last_reward, hidden):
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in (obs, last_action, last_reward, hidden)]
        q, new_hidden = act(params, *args)
        B, A = q.shape
        with HOST_TRANSFERS.allowed(name):
            flat = torch.cat([q, new_hidden.reshape(B, -1)], 1).cpu().numpy()
        return flat[:, :A], flat[:, A:].reshape(new_hidden.shape)

    return act_host


class VectorActor:
    """Steps ``num_envs`` environments in lockstep with batched inference.

    ``epsilons`` gives each lane its ladder ε; lanes run independent
    episode lifecycles (reset, block cut, episode-step cap) exactly as N
    reference actors would (worker.py:516-561).  ``act_fn`` takes and
    returns numpy (:func:`make_host_act_fn`) and acts where
    ``cfg.act_device`` says (:func:`_resolve_act_device`); the published
    params are placed there for it.
    """

    def __init__(self, cfg: Config, envs: Sequence[Any],
                 epsilons: Sequence[float], act_fn: ActFn,
                 param_store: ParamStore, sink: BlockSink,
                 rng: Optional[np.random.Generator] = None,
                 env_workers: Optional[int] = None):
        assert len(envs) == len(epsilons)
        self.cfg = cfg
        self.envs = list(envs)
        self.epsilons = np.asarray(epsilons, np.float64)
        self.act_fn = act_fn
        # serve mode (parallel/inference_service.RemoteActClient): params
        # and recurrent state live in the trainer's service, so lane resets
        # must reach it, and the episode-step-cap bootstrap must not
        # advance its state (``peek``); local act fns are pure, so the
        # plain call doubles as the peek
        self._act_client = act_fn if hasattr(act_fn, "note_reset") else None
        self._peek_fn = getattr(act_fn, "peek", act_fn)
        self.param_store = param_store
        self.sink = sink
        self.rng = rng or np.random.default_rng(cfg.seed)
        self.act_device = _resolve_act_device(cfg.act_device)

        self.N = len(envs)
        if env_workers is None:
            env_workers = cfg.env_workers
        self._pool: Optional[ThreadPoolExecutor] = None
        self._shards: List[range] = [range(self.N)]
        if env_workers > 1 and self.N > 1:
            w = min(env_workers, self.N)
            bounds = np.linspace(0, self.N, w + 1).astype(int)
            self._shards = [range(bounds[j], bounds[j + 1])
                            for j in range(w) if bounds[j] < bounds[j + 1]]
            self._pool = ThreadPoolExecutor(max_workers=len(self._shards),
                                            thread_name_prefix="env")
        self.action_dim = envs[0].action_space.n
        # one preallocated array set for all lanes: per-step recording is a
        # few vectorized writes instead of N×(list appends + array builds)
        self.vbuf = VectorLocalBuffer(cfg, self.action_dim, self.N)
        self.episode_steps = np.zeros(self.N, np.int64)
        self.finish_pending = np.zeros(self.N, bool)  # deferred boundary cut
        # per-lane block start (perf_counter), for the lineage cut event
        self._block_start = np.full(self.N, time.perf_counter())
        self.actor_steps = 0
        self._param_version = 0
        self._params = None

        # batched AgentState
        self.obs = np.zeros((self.N, *cfg.stored_obs_shape), np.uint8)
        self.last_action = np.zeros((self.N, self.action_dim), np.float32)
        self.last_reward = np.zeros(self.N, np.float32)
        self.hidden = np.zeros((self.N, 2, cfg.lstm_layers, cfg.hidden_dim),
                               np.float32)
        # per-iteration env-step scratch, filled by the (possibly pooled)
        # env stepping and consumed by the vectorized batched update
        self._step_reward = np.zeros(self.N, np.float32)
        self._step_done = np.zeros(self.N, bool)
        for i in range(self.N):
            self._reset_lane(i)

    def _reset_lane(self, i: int) -> None:
        obs, _ = self.envs[i].reset()
        self.obs[i] = np.asarray(obs, np.uint8)
        self.last_action[i] = 0.0
        self.last_reward[i] = 0.0
        self.hidden[i] = 0.0
        self.vbuf.reset_lane(i, self.obs[i])
        self.episode_steps[i] = 0
        self.finish_pending[i] = False
        self._block_start[i] = time.perf_counter()
        if self._act_client is not None:
            self._act_client.note_reset(i)

    def _refresh_params(self) -> None:
        if self._act_client is not None:
            return  # serve mode: weights never leave the trainer
        # the placed copy is cached per published version and device, so
        # fleets acting on one device share one copy
        version, params = self.param_store.get_placed(self.act_device)
        if params is not None and version != self._param_version:
            self._params = params
            self._param_version = version

    # ------------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        """Resumable actor state: exploration RNG, per-lane episode
        lifecycle, batched agent state, the local block-assembly buffers,
        and — for envs that support ``clone_state()`` — the env state.
        Call only while the actor is quiescent."""
        env_states = []
        for e in self.envs:
            fn = getattr(e, "clone_state", None)
            try:
                env_states.append(fn() if callable(fn) else None)
            except Exception:  # this lane resumes by reset instead
                env_states.append(None)
        return dict(
            num_lanes=self.N,
            rng=self.rng.bit_generator.state,
            actor_steps=int(self.actor_steps),
            episode_steps=self.episode_steps.copy(),
            finish_pending=self.finish_pending.copy(),
            agent=dict(obs=self.obs.copy(), last_action=self.last_action.copy(),
                       last_reward=self.last_reward.copy(),
                       hidden=self.hidden.copy()),
            vbuf=self.vbuf.snapshot(),
            env_states=env_states,
        )

    def restore(self, snap: dict) -> None:
        """Resume from a :meth:`snapshot`.  Lanes with a captured env state
        continue their episode (and in-progress block) mid-stream; the
        rest are reset.  Raises ValueError on a lane-count mismatch."""
        if int(snap["num_lanes"]) != self.N:
            raise ValueError(
                f"actor snapshot has {snap['num_lanes']} lanes, this actor "
                f"has {self.N} — resuming cold")
        if self._act_client is not None:
            # lanes resuming mid-episode must not zero the server hidden the
            # snapshot restored; non-resumable lanes re-note via their reset
            self._act_client.clear_reset_notes()
        self.rng.bit_generator.state = snap["rng"]
        self.actor_steps = int(snap["actor_steps"])
        self.episode_steps[:] = snap["episode_steps"]
        self.finish_pending[:] = snap["finish_pending"]
        # a deferred cut is only meaningful for a lane with an unfinished
        # block
        self.finish_pending &= np.asarray(snap["vbuf"]["size"]) > 0
        agent = snap["agent"]
        self.obs[:] = agent["obs"]
        self.last_action[:] = agent["last_action"]
        self.last_reward[:] = agent["last_reward"]
        self.hidden[:] = agent["hidden"]
        self.vbuf.load_snapshot(snap["vbuf"])
        for i, st in enumerate(snap["env_states"]):
            fn = getattr(self.envs[i], "restore_state", None)
            if st is not None and callable(fn):
                fn(st)
            else:
                self._reset_lane(i)  # env can't resume: fresh episode

    def _note_cut(self, i: int, block: Block) -> None:
        """Block-lineage hook at every cut: under an armed capture window
        the block gets a fabric-unique trace id and its env steps one
        slice, the start of its flow (telemetry/tracing.py)."""
        now = time.perf_counter()
        if EVENTS.armed:
            block.trace_id = EVENTS.next_trace_id()
            EVENTS.complete("block.env_steps+cut",
                            float(self._block_start[i]),
                            now - float(self._block_start[i]),
                            flow=block.trace_id, fph="s", arg=i)
        self._block_start[i] = now

    def _step_shard(self, lanes: range, actions: np.ndarray) -> None:
        """Env-step a contiguous lane shard; results land in the batched
        scratch arrays, all bookkeeping is vectorized later."""
        for i in lanes:
            obs, reward, terminated, truncated, _ = self.envs[i].step(
                int(actions[i]))
            self.obs[i] = np.asarray(obs, np.uint8)
            self._step_reward[i] = reward
            self._step_done[i] = terminated or truncated

    def close(self) -> None:
        """Shut down the env-worker pool (no-op for serial actors)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
            self._shards = [range(self.N)]

    def run(self, max_steps: int, stop: Optional[Callable[[], bool]] = None
            ) -> None:
        """Run ``max_steps`` lockstep iterations (= per-actor env steps)."""
        cfg = self.cfg
        self._refresh_params()
        assert self._params is not None or self._act_client is not None, \
            "ParamStore must hold initial params"

        for _ in range(max_steps):
            if stop is not None and stop():
                return
            q, new_hidden = self.act_fn(self._params, self.obs,
                                        self.last_action, self.last_reward,
                                        self.hidden)

            # deferred block-boundary cuts: this iteration's Q at the new
            # state is the bootstrap value (worker.py:550-554 semantics,
            # without the second forward)
            for i in np.nonzero(self.finish_pending)[0]:
                # clear BEFORE the sink call: a sink that unwinds
                # mid-delivery must leave the lane consistent
                self.finish_pending[i] = False
                item = self.vbuf.finish(i, q[i])
                self._note_cut(i, item[0])
                self.sink(*item)

            explore = self.rng.random(self.N) < self.epsilons
            actions = np.where(explore,
                               self.rng.integers(self.action_dim, size=self.N),
                               q.argmax(axis=1)).astype(np.int64)

            if self._pool is None:
                self._step_shard(self._shards[0], actions)
            else:
                futures = [self._pool.submit(self._step_shard, shard, actions)
                           for shard in self._shards]
                for f in futures:
                    f.result()

            # all per-step bookkeeping, vectorized over the whole fleet
            # (reference actor body worker.py:537-554, batched)
            lanes = np.arange(self.N)
            self.last_action[:] = 0.0
            self.last_action[lanes, actions] = 1.0
            self.last_reward[:] = self._step_reward
            np.copyto(self.hidden, new_hidden)
            self.episode_steps += 1
            self.vbuf.add_batch(lanes, actions, self._step_reward, self.obs,
                                q, new_hidden)

            for i in np.nonzero(self._step_done)[0]:
                # reset BEFORE the sink call (the finished Block owns
                # copies, never vbuf storage)
                item = self.vbuf.finish(i, None)
                self._note_cut(i, item[0])
                self._reset_lane(i)
                self.sink(*item)

            capped = np.nonzero(~self._step_done
                                & (self.episode_steps >= cfg.max_episode_steps)
                                )[0]
            boundary = ~self._step_done & (self.vbuf.sizes()
                                           == cfg.block_length)
            self.finish_pending |= boundary & (self.episode_steps
                                               < cfg.max_episode_steps)
            self._step_done[:] = False

            if capped.size:
                # episode-step cap (rare): the bootstrap must be Q at the
                # post-step state; one extra batched forward covers all
                # capped lanes (serve mode: a peek, no state advance)
                q_fresh, _ = self._peek_fn(self._params, self.obs,
                                           self.last_action,
                                           self.last_reward, self.hidden)
                for i in capped:
                    item = self.vbuf.finish(i, q_fresh[i])
                    self._note_cut(i, item[0])
                    self._reset_lane(i)  # before the sink; see above
                    self.sink(*item)

            self.actor_steps += 1
            if self.actor_steps % cfg.actor_update_interval == 0:
                self._refresh_params()


class Actor(VectorActor):
    """A single-env actor — the reference's unit of deployment
    (worker.py:500-515), as a 1-lane vector actor.  Used by tests."""

    def __init__(self, cfg: Config, env: Any, epsilon: float, act_fn,
                 param_store: ParamStore, sink: BlockSink,
                 rng: Optional[np.random.Generator] = None):
        super().__init__(cfg, [env], [epsilon], act_fn, param_store, sink,
                         rng=rng)
