"""Deterministic gridworld environment — the second device-env oracle.

A copy of ``r2d2_tpu/envs/grid.py``.  The anakin transport's claim is that
ANY env written as batched tensor ops inherits the fused on-device loop
unchanged.  This module is the host-numpy half of that proof: a tiny
goal-seeking gridworld with the wrapped-ALE interface (gymnasium 5-tuple,
``clone_state``/``restore_state``), whose device twin
:class:`~r2d2_tpu_torch.envs.anakin.AnakinGridEnv` runs through the
unchanged fused loop.  The parity contract mirrors the fake env's
(tests/test_torch_anakin_env.py): given the same reset draws, every
observation byte, reward and truncation flag is bit-exact — the dynamics
are integer arithmetic plus the constants {0.0, 1.0}, so float equality
is exact.

Dynamics (deliberately REACTIVE where the fake env is open-loop — the
fake env's phase advances regardless of the action, this one's state is
the action's consequence, so it exercises the policy-dependent
trajectory path the fake env cannot):

- A ``GRID x GRID`` board (:data:`GRID` = 4).  The agent occupies one
  cell (rendered as a bright 255 block), the goal another (a dim 128
  block) — both fully observable, so even an MLP torso can learn
  "move toward the goal".
- Actions 0/1/2/3 move up/down/left/right, clamped at the borders.
- Stepping onto the goal pays +1.0 and the goal relocates
  DETERMINISTICALLY to the next cell in scan order that is not the
  agent's (randomness only at reset, exactly the fake env's RNG
  discipline — which is what keeps the device/numpy parity test's
  replay-the-reset-draws scheme sufficient).
- Episodes truncate after ``episode_len`` steps; ``terminated`` is
  always False (the anakin loop's truncation-only episode contract).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from r2d2_tpu_torch.envs.fake import _Box, _Discrete

# board side; cells render as (H // GRID) x (W // GRID) pixel blocks
# (rows/cols past GRID * (dim // GRID) stay black — no divisibility
# requirement on the observation shape)
GRID = 4
AGENT_PIXEL = 255
GOAL_PIXEL = 128


def next_goal(goal: int, agent: int) -> int:
    """The deterministic goal relocation rule, shared with the device
    twin: the next cell in scan order, skipping the agent's cell."""
    g = (goal + 1) % (GRID * GRID)
    if g == agent:
        g = (g + 1) % (GRID * GRID)
    return g


class GridWorldEnv:
    """Deterministic-by-seed gridworld with the wrapped-ALE interface."""

    def __init__(self, obs_shape: Tuple[int, ...] = (84, 84, 1),
                 action_dim: int = 4, episode_len: int = 32, seed: int = 0):
        if action_dim != 4:
            raise ValueError(
                f"GridWorldEnv has exactly 4 move actions, got action_dim "
                f"{action_dim}")
        self._rng = np.random.default_rng(seed)
        self.observation_space = _Box(obs_shape, np.uint8)
        self.action_space = _Discrete(action_dim, self._rng)
        self.episode_len = episode_len
        self._agent = 0
        self._goal = 1
        self._t = 0

    def _obs(self) -> np.ndarray:
        h, w = self.observation_space.shape[:2]
        ch, cw = max(1, h // GRID), max(1, w // GRID)
        obs = np.zeros(self.observation_space.shape, np.uint8)
        for idx, val in ((self._goal, GOAL_PIXEL),
                         (self._agent, AGENT_PIXEL)):
            r, c = divmod(idx, GRID)
            obs[r * ch:(r + 1) * ch, c * cw:(c + 1) * cw] = val
        return obs

    def reset(self, *, seed: Optional[int] = None, **kwargs):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
            self.action_space._rng = self._rng  # fake.py reseed contract
        m = GRID * GRID
        self._agent = int(self._rng.integers(m))
        # goal drawn uniformly over the other m-1 cells
        d = int(self._rng.integers(m - 1))
        self._goal = d + (1 if d >= self._agent else 0)
        self._t = 0
        return self._obs(), {}

    def step(self, action: int):
        r, c = divmod(self._agent, GRID)
        a = int(action)
        dr = (-1, 1, 0, 0)[a]
        dc = (0, 0, -1, 1)[a]
        r = min(max(r + dr, 0), GRID - 1)
        c = min(max(c + dc, 0), GRID - 1)
        self._agent = r * GRID + c
        reached = self._agent == self._goal
        reward = 1.0 if reached else 0.0
        if reached:
            self._goal = next_goal(self._goal, self._agent)
        self._t += 1
        terminated = False
        truncated = self._t >= self.episode_len
        return self._obs(), reward, terminated, truncated, {}

    def clone_state(self) -> dict:
        return dict(rng=self._rng.bit_generator.state, agent=self._agent,
                    goal=self._goal, t=self._t)

    def restore_state(self, state: dict) -> None:
        self._rng.bit_generator.state = state["rng"]
        self._agent = int(state["agent"])
        self._goal = int(state["goal"])
        self._t = int(state["t"])

    def close(self):
        pass
