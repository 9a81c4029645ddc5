"""Deterministic fake Atari-shaped environment.

A copy of ``r2d2_tpu/envs/fake.py``.  The reference has no test story at
all (SURVEY.md §4); this env is the framework's substitute for ALE in
tests, smoke runs, and actor benchmarks.
It follows the gymnasium 5-tuple step API that the real wrappers produce
and emits uint8 observations of ``cfg.obs_shape``.

The dynamics are a tiny learnable POMDP so end-to-end training can
demonstrably reduce loss and improve return:

- A hidden phase counter advances each step; the rewarded action is
  ``phase % action_dim``.
- The observation encodes the phase as a bright horizontal band, so a
  Q-network (even an MLP torso) can learn the mapping obs → best action.
- Episodes truncate after ``episode_len`` steps; a small terminal bonus
  exercises the γ-zero terminal tail path in the replay format.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class _Box:
    def __init__(self, shape, dtype):
        self.shape = shape
        self.dtype = dtype


class _Discrete:
    def __init__(self, n: int, rng: np.random.Generator):
        self.n = n
        self._rng = rng

    def sample(self) -> int:
        return int(self._rng.integers(self.n))


class FakeAtariEnv:
    """Deterministic-by-seed fake env with the wrapped-ALE interface."""

    def __init__(self, obs_shape: Tuple[int, ...] = (84, 84, 1),
                 action_dim: int = 4, episode_len: int = 32, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self.observation_space = _Box(obs_shape, np.uint8)
        self.action_space = _Discrete(action_dim, self._rng)
        self.episode_len = episode_len
        self._phase = 0
        self._t = 0

    def _obs(self) -> np.ndarray:
        h = self.observation_space.shape[0]
        obs = np.zeros(self.observation_space.shape, np.uint8)
        band = self._phase % self.action_space.n
        rows_per_band = max(1, h // self.action_space.n)
        r0 = band * rows_per_band
        obs[r0:r0 + rows_per_band] = 255
        return obs

    def reset(self, *, seed: Optional[int] = None, **kwargs):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
            # the action space samples from the SAME generator: rebinding
            # only self._rng would leave action_space._rng on the old
            # stream, so exploration sampling would not be reseeded
            self.action_space._rng = self._rng
        self._phase = int(self._rng.integers(self.action_space.n))
        self._t = 0
        return self._obs(), {}

    def step(self, action: int):
        target = self._phase % self.action_space.n
        reward = 1.0 if int(action) == target else 0.0
        self._phase += 1
        self._t += 1
        terminated = False
        truncated = self._t >= self.episode_len
        if truncated:
            reward += 2.0  # exercises episode-end accounting distinctly
        return self._obs(), reward, terminated, truncated, {}

    def clone_state(self) -> dict:
        """ALE-style resumable emulator state (actor full-state snapshots
        — VectorActor.snapshot): RNG + phase + step counter is the whole
        dynamics, so restore continues the episode bit-exactly."""
        return dict(rng=self._rng.bit_generator.state, phase=self._phase,
                    t=self._t)

    def restore_state(self, state: dict) -> None:
        self._rng.bit_generator.state = state["rng"]
        self._phase = int(state["phase"])
        self._t = int(state["t"])

    def close(self):
        pass
