"""Offline evaluation: greedy rollouts and the checkpoint sweep.

Port of ``run_episodes``, ``evaluate_params`` and ``evaluate_sweep`` from
``r2d2_tpu/evaluate.py``, with the sweep's follow mode and its plot.
Capability-parity with the reference evaluator
(test.py:14-88): ``eval_episodes`` rollouts at ``test_epsilon`` per
checkpoint, reporting env frames (env_steps × frameskip), wall minutes and
mean reward.  The episodes run in lockstep as one batched act per step, on
the network's device: through the fused LSTM kernel on a CUDA device.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from r2d2_tpu_torch.actor import _resolve_act_device, make_host_act_fn
from r2d2_tpu_torch.checkpoint import Checkpointer, check_arch_compat
from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.models.network import R2D2Network, create_network

# HOST_TRANSFERS name of the evaluator's acts (one per lockstep step)
EVAL_ACT = "eval.act_fetch"


def run_episodes(cfg: Config, net: R2D2Network,
                 params: Mapping[str, torch.Tensor], envs: List[Any],
                 epsilon: Optional[float] = None,
                 rng: Optional[np.random.Generator] = None,
                 act_fn=None) -> List[float]:
    """One episode per env, stepped in lockstep with batched inference
    (the batched analogue of test.py:60-81).  Returns per-env returns."""
    epsilon = cfg.test_epsilon if epsilon is None else epsilon
    rng = rng or np.random.default_rng(cfg.seed)
    act_fn = act_fn or make_host_act_fn(net, EVAL_ACT)
    device = next(net.parameters()).device
    params = {k: v.to(device) for k, v in params.items()}
    N = len(envs)
    action_dim = envs[0].action_space.n

    obs = np.zeros((N, *cfg.stored_obs_shape), np.uint8)
    last_action = np.zeros((N, action_dim), np.float32)
    last_reward = np.zeros(N, np.float32)
    hidden = np.zeros((N, 2, cfg.lstm_layers, cfg.hidden_dim), np.float32)
    for i, env in enumerate(envs):
        o, _ = env.reset()
        obs[i] = np.asarray(o, np.uint8)

    returns = np.zeros(N, np.float64)
    done = np.zeros(N, bool)
    steps = 0
    while not done.all() and steps < cfg.max_episode_steps:
        q, new_hidden = act_fn(params, obs, last_action, last_reward, hidden)
        explore = rng.random(N) < epsilon
        actions = np.where(explore, rng.integers(action_dim, size=N),
                           q.argmax(axis=1))
        for i, env in enumerate(envs):
            if done[i]:
                continue
            a = int(actions[i])
            o, r, terminated, truncated, _ = env.step(a)
            obs[i] = np.asarray(o, np.uint8)
            last_action[i] = 0.0
            last_action[i, a] = 1.0
            last_reward[i] = r
            hidden[i] = new_hidden[i]
            returns[i] += r
            done[i] = bool(terminated or truncated)
        steps += 1
    return [float(x) for x in returns]


def evaluate_params(cfg: Config, net: R2D2Network,
                    params: Mapping[str, torch.Tensor],
                    env_factory: Callable[[Config, int], Any],
                    episodes: Optional[int] = None,
                    epsilon: Optional[float] = None,
                    seed: int = 0, act_fn=None) -> float:
    """Mean return over ``episodes`` rollouts (test.py:33,38 semantics)."""
    episodes = episodes or cfg.eval_episodes
    envs = [env_factory(cfg, seed + i) for i in range(episodes)]
    returns = run_episodes(cfg, net, params, envs, epsilon=epsilon,
                           rng=np.random.default_rng(seed), act_fn=act_fn)
    return float(np.mean(returns))


def evaluate_sweep(cfg: Config, checkpoint_dir: str,
                   env_factory: Callable[[Config, int], Any],
                   episodes: Optional[int] = None,
                   out_json: Optional[str] = None,
                   out_plot: Optional[str] = None,
                   action_dim: Optional[int] = None,
                   follow: bool = False,
                   follow_timeout: Any = "default",
                   poll_interval: float = 2.0,
                   stop: Optional[Callable[[], bool]] = None,
                   device=None) -> List[Dict[str, float]]:
    """Walk every complete checkpoint in save order (test.py:26-40) and
    produce the learning curve: one record per checkpoint with training
    step, env frames (env_steps × frameskip), wall-clock minutes, mean
    reward.  The rollouts act on ``device``, by default where
    ``cfg.act_device`` says (the CUDA device for ``"auto"``; raises without
    one).

    With ``follow=True`` the sweep trails a concurrent training run the way
    the reference evaluator does (test.py:26-27's poll-the-next-file walk):
    after draining the checkpoints already on disk it keeps polling for new
    ones, evaluating each as it appears, and exits when ``stop()`` reports
    training finished (with one final drain) or when no new checkpoint has
    appeared for ``follow_timeout`` seconds.  The timeout defaults to 600
    when no ``stop`` callback is given (a bare follow call must not poll
    forever) and to ``None`` — poll until ``stop()`` — when one is.
    ``out_json`` is replaced atomically, after every record in follow mode
    so the curve file trails the run too; ``out_plot`` gets the
    reward-vs-frames and reward-vs-hours image (:func:`_plot_curve`).  A
    step is picked up only once its metadata sidecar exists: the
    checkpointer writes that last, so it marks a finished save."""
    if follow_timeout == "default":
        follow_timeout = 600.0 if stop is None else None
    ckpt = Checkpointer(checkpoint_dir)
    if action_dim is None:
        action_dim = env_factory(cfg, 0).action_space.n
    device = _resolve_act_device(cfg.act_device, device)
    # its own parameters are never read: each checkpoint's are passed in
    net = create_network(cfg, action_dim, device=device,
                         generator=torch.Generator().manual_seed(cfg.seed))
    act_fn = make_host_act_fn(net, EVAL_ACT)

    def _eval_step(step: int) -> Dict[str, float]:
        check_arch_compat(cfg, ckpt.peek_meta(step))
        state, meta = ckpt.restore(step)
        mean_reward = evaluate_params(cfg, net, state.params, env_factory,
                                      episodes=episodes, seed=cfg.seed,
                                      act_fn=act_fn)
        return dict(
            step=step,
            env_frames=int(meta.get("env_steps", 0)) * cfg.frameskip,
            minutes=float(meta.get("minutes", 0.0)),
            mean_reward=mean_reward,
        )

    def _write(curve: List[Dict[str, float]]) -> None:
        if out_json:
            # atomic replace: follow mode invites concurrent readers, who
            # must never observe a truncated file mid-rewrite
            tmp = f"{out_json}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(curve, f, indent=2)
            os.replace(tmp, out_json)

    curve: List[Dict[str, float]] = []
    seen: set = set()
    last_new = time.monotonic()
    while True:
        stopping = stop() if (follow and stop is not None) else False
        fresh = [s for s in ckpt.steps() if s not in seen]
        for step in fresh:
            seen.add(step)
            curve.append(_eval_step(step))
            if follow:
                _write(curve)
        if fresh:
            last_new = time.monotonic()
        if not follow:
            break
        if stopping and not fresh:
            break  # training done and the final drain found nothing new
        if (follow_timeout is not None and not fresh
                and time.monotonic() - last_new > follow_timeout):
            break
        if not fresh:
            time.sleep(poll_interval)

    _write(curve)
    if out_plot:
        _plot_curve(cfg, curve, out_plot)
    return curve


def _plot_curve(cfg: Config, curve: List[Dict[str, float]],
                path: str) -> bool:
    """Reward-vs-frames and reward-vs-hours dual plot (test.py:42-58).
    Matplotlib is optional: without it nothing is written.  Returns whether
    the image was written."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    frames = [c["env_frames"] for c in curve]
    hours = [c["minutes"] / 60.0 for c in curve]
    rewards = [c["mean_reward"] for c in curve]
    fig, axes = plt.subplots(1, 2, figsize=(12, 6))
    fig.suptitle(cfg.game_name)
    axes[0].plot(frames, rewards)
    axes[0].set_xlabel("environment frames")
    axes[0].set_ylabel("average reward")
    axes[1].plot(hours, rewards)
    axes[1].set_xlabel("wall-clock hours")
    axes[1].set_ylabel("average reward")
    fig.savefig(path)
    plt.close(fig)
    return True
