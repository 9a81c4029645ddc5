"""Benchmark-ladder sweep orchestration (BASELINE.json configs[3]).

Port of ``r2d2_tpu/sweep.py``.  The reference has no multi-game story —
one `config.py` edit per run (README.md:6).  This module runs the
Atari-57 ladder (or any game list) as a sequence of isolated runs:
per-game config, per-game checkpoint directory, training followed by the
evaluator's checkpoint sweep, and a machine-readable summary
(`sweep.json`, the JAX package's keys) accumulating learning curves —
resumable per game, so a killed sweep continues where it stopped.  Both
training and the sweep run on ``device`` (default: the CUDA device).
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional

from r2d2_tpu_torch.config import Config

# The canonical Atari-57 benchmark set (paper list; ALE v5 names).
ATARI_57: List[str] = [
    "Alien", "Amidar", "Assault", "Asterix", "Asteroids", "Atlantis",
    "BankHeist", "BattleZone", "BeamRider", "Berzerk", "Bowling", "Boxing",
    "Breakout", "Centipede", "ChopperCommand", "CrazyClimber", "Defender",
    "DemonAttack", "DoubleDunk", "Enduro", "FishingDerby", "Freeway",
    "Frostbite", "Gopher", "Gravitar", "Hero", "IceHockey", "Jamesbond",
    "Kangaroo", "Krull", "KungFuMaster", "MontezumaRevenge", "MsPacman",
    "NameThisGame", "Phoenix", "Pitfall", "Pong", "PrivateEye", "Qbert",
    "Riverraid", "RoadRunner", "Robotank", "Seaquest", "Skiing", "Solaris",
    "SpaceInvaders", "StarGunner", "Surround", "Tennis", "TimePilot",
    "Tutankham", "UpNDown", "Venture", "VideoPinball", "WizardOfWor",
    "YarsRevenge", "Zaxxon",
]


def run_sweep(games: List[str], base_cfg: Config, out_dir: str,
              env_factory: Optional[Callable[[Config, int], Any]] = None,
              train_fn: Optional[Callable[..., Dict[str, Any]]] = None,
              eval_episodes: Optional[int] = None,
              max_wall_seconds_per_game: Optional[float] = None,
              use_mesh: bool = False, verbose: bool = True,
              device=None) -> Dict[str, Any]:
    """Train + evaluate each game; returns (and writes) the summary.

    Layout: ``out_dir/<game>/`` holds that game's checkpoints;
    ``out_dir/sweep.json`` accumulates per-game results as each finishes.
    A game whose summary entry shows ``num_updates >= training_steps`` is
    skipped; a partially-trained game (e.g. stopped by
    ``max_wall_seconds_per_game``) re-enters training from its checkpoint.
    ``device`` goes to ``train_fn`` and to the evaluator.
    """
    from r2d2_tpu_torch.envs import create_env
    from r2d2_tpu_torch.evaluate import evaluate_sweep
    from r2d2_tpu_torch.train import train

    train_fn = train_fn or train
    env_factory = env_factory or (
        lambda cfg, seed: create_env(cfg, noop_start=True, seed=seed))
    os.makedirs(out_dir, exist_ok=True)
    summary_path = os.path.join(out_dir, "sweep.json")
    summary: Dict[str, Any] = {}
    if os.path.exists(summary_path):
        with open(summary_path) as f:
            summary = json.load(f)

    for game in games:
        # Skip only games that actually reached the training target: a game
        # cut short by max_wall_seconds_per_game records its partial
        # num_updates and re-enters training (resume=True) on the next
        # sweep invocation — time-sliced sweeps keep making progress.
        prior = summary.get(game)
        if (prior is not None
                and prior.get("num_updates", 0) >= base_cfg.training_steps):
            if verbose:
                print(f"[sweep] {game}: already done, skipping", flush=True)
            continue
        cfg = base_cfg.replace(game_name=game)
        ckpt_dir = os.path.join(out_dir, game)
        if verbose:
            print(f"[sweep] {game}: training → {ckpt_dir}", flush=True)
        metrics = train_fn(cfg, env_factory=env_factory,
                           checkpoint_dir=ckpt_dir, resume=True,
                           use_mesh=use_mesh,
                           max_wall_seconds=max_wall_seconds_per_game,
                           verbose=verbose, device=device)
        eval_factory = (
            lambda c, seed: env_factory(c.replace(game_name=game), seed))
        curve = evaluate_sweep(cfg, ckpt_dir, env_factory=eval_factory,
                               episodes=eval_episodes, device=device)
        summary[game] = dict(
            num_updates=int(metrics.get("num_updates", 0)),
            env_steps=int(metrics.get("env_steps", 0)),
            minutes=float(metrics.get("minutes", 0.0)),
            mean_loss=float(metrics.get("mean_loss", float("nan"))),
            curve=curve,
            final_reward=(curve[-1]["mean_reward"] if curve else None),
        )
        with open(summary_path, "w") as f:
            json.dump(summary, f, indent=1)
        if verbose:
            print(f"[sweep] {game}: final reward "
                  f"{summary[game]['final_reward']}", flush=True)
    return summary
