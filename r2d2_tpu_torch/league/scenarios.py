"""Held-out evaluation suites for the league's eval sidecar.

Port of ``r2d2_tpu/league/scenarios.py``.  Training acts on seeds
``cfg.seed + lane`` (plus respawn-incarnation offsets); a standing
evaluation that reused those streams would score memorization of the
training trajectories, so each member's suite comes from a disjoint seed
plane:

- **Seeded env variants**: ``create_env`` under the member's own config
  (its ``game_name``/``noop_max`` overrides shape its suite) at
  ``HELD_OUT_SEED_BASE``-offset seeds training never draws.
- **Any batched device env**: :class:`JittableEnvAdapter` wraps one lane
  of the ``envs/anakin.py`` four-method surface (``init_state`` /
  ``observe`` / ``step`` / ``reset_lanes``) in the gym 5-tuple API the
  batched evaluator (:func:`r2d2_tpu_torch.evaluate.run_episodes`)
  consumes.  The fake suites carry one adapter lane, on the CPU.

Suites are deterministic per (member, episode index): a respawned sidecar
re-evaluating a checkpoint member reproduces the same episodes.

Two divergences from the JAX package, both deliberate:

- **The adapter's reset stream.**  JAX's adapter splits a threefry key
  per reset; the port's device envs draw from counter-hash streams
  (``envs/anakin.py``), so each reset here derives its stream root from
  ``(seed, reset count)``.  ``reset(draws=...)`` replaces the drawn
  values, which is how the tests hold the adapter bitwise to JAX's with
  JAX's draws.
- **A real game without the ALE.**  ``fake = game_name == "Fake" or not
  atari_available()`` is kept as written, but the port's ``create_env``
  refuses a real game when ``ale_py`` is missing instead of substituting
  the fake env (ROADMAP.md C 6), so such a member's suite raises.
  ``train()`` refuses that member at start-up, naming it, before any
  sidecar is spawned.
"""
from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from r2d2_tpu_torch.config import Config

# seed plane disjoint from training's cfg.seed + lane (+ incarnation
# multiples of 1_000_003): a large odd offset per member keeps member
# suites disjoint from each other too
HELD_OUT_SEED_BASE = 0x5EED_0E7A


class _Discrete:
    """Minimal action-space shim (``.n`` + ``sample``) for the adapter."""

    def __init__(self, n: int, seed: int):
        self.n = int(n)
        self._rng = np.random.default_rng(seed)

    def sample(self) -> int:
        return int(self._rng.integers(self.n))


class JittableEnvAdapter:
    """gym-5-tuple shim over one lane of an ``envs/anakin.py`` env.

    ``reset`` draws a fresh state through ``init_state`` (its stream root
    derived from the adapter's seed and how many resets it has done),
    ``step`` applies the env's dynamics and reports ``truncated`` from the
    env's own flag.  ``terminated`` is always False: the four-method
    surface encodes episode ends as truncation.  One dispatch a step: an
    evaluation adapter, not a training transport."""

    def __init__(self, env: Any, seed: int = 0):
        if env.num_lanes != 1:
            raise ValueError("the eval adapter drives one lane "
                             f"(env has {env.num_lanes})")
        self.env = env
        self.action_space = _Discrete(env.action_dim, seed)
        self.observation_space = None  # unused by the evaluator
        self._seed = int(seed)
        self._resets = 0
        self._state = None

    def reset(self, *, seed=None, draws=None, **kwargs):
        """A fresh episode.  ``draws`` (the env's reset draws, e.g.
        ``{"phase": (1,) tensor}``) replaces the stream's values."""
        from r2d2_tpu_torch.envs.anakin import derive

        if seed is not None:
            self._seed, self._resets = int(seed), 0
        root = derive(self._seed, self._resets)
        self._resets += 1
        self._state = self.env.init_state(root, draws)
        return self.env.observe(self._state)[0].cpu().numpy(), {}

    def step(self, action: int):
        if self._state is None:
            raise RuntimeError("step before reset")
        self._state, reward, truncated = self.env.step(
            self._state, torch.tensor([int(action)], dtype=torch.int32,
                                      device=self.env.device))
        obs = self.env.observe(self._state)[0].cpu().numpy()
        return obs, float(reward[0]), False, bool(truncated[0]), {}

    def close(self) -> None:
        pass


def member_suite(mcfg: Config, member_id: int, episodes: int,
                 action_dim: int) -> List[Any]:
    """The held-out env list for one (member, sweep) evaluation:
    ``episodes`` lockstep lanes, seeds disjoint from training's.

    When the member's env resolves to the fake path the last lane is a
    :class:`JittableEnvAdapter` over ``AnakinFakeEnv`` on the CPU (the
    same dynamics, bitwise per tests/test_torch_anakin_env.py); a
    real-game member gets every lane from ``create_env``."""
    from r2d2_tpu_torch.envs import atari_available, create_env

    base = HELD_OUT_SEED_BASE + 7_368_787 * member_id
    fake = (mcfg.game_name == "Fake") or not atari_available()
    envs: List[Any] = [
        create_env(mcfg, noop_start=True, seed=base + i)
        for i in range(episodes)
    ]
    if fake and episodes > 1:
        from r2d2_tpu_torch.envs.anakin import AnakinFakeEnv

        probe = envs.pop()
        envs.append(JittableEnvAdapter(
            AnakinFakeEnv(obs_shape=mcfg.stored_obs_shape,
                          action_dim=probe.action_space.n,
                          episode_len=probe.episode_len, num_lanes=1,
                          device="cpu"),
            seed=base + episodes - 1))
        close_suite([probe])   # replaced, not kept: must not leak
    return envs


def close_suite(envs: List[Any]) -> None:
    """Close every env of a suite: the sidecar builds one suite per
    (checkpoint, member) for the life of the run, and unclosed ALE
    emulators would pile up in the long-lived subprocess."""
    for e in envs:
        try:
            close = getattr(e, "close", None)
            if callable(close):
                close()
        except Exception:
            pass
