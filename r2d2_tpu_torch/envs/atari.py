"""The env factory and the space-to-depth wrapper.

Port of ``create_env`` and ``SpaceToDepth`` from ``r2d2_tpu/envs/atari.py``.
The ALE wrappers (grayscale warp, no-op starts) are not ported yet: ALE is
not installed where the port runs, so ``create_env`` serves the fake env
and refuses any other game.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.envs.fake import FakeAtariEnv, _Box


class SpaceToDepth:
    """Fold 4×4 pixel blocks into channels: (H, W, C) uint8 →
    (H/4, W/4, 16C) uint8.

    Applied host-side at emission so the device never pays the relayout.
    A ~7 KB numpy transpose per env step.
    """

    def __init__(self, env):
        self.env = env
        h, w, c = env.observation_space.shape
        self.observation_space = _Box((h // 4, w // 4, 16 * c), np.uint8)

    def __getattr__(self, name):
        return getattr(self.env, name)

    @staticmethod
    def fold(obs: np.ndarray) -> np.ndarray:
        h, w, c = obs.shape
        obs = obs.reshape(h // 4, 4, w // 4, 4, c)
        return np.ascontiguousarray(
            obs.transpose(0, 2, 1, 3, 4)).reshape(h // 4, w // 4, 16 * c)

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        return self.fold(obs), info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return self.fold(obs), reward, terminated, truncated, info


def create_env(cfg: Config, noop_start: bool = True,
               seed: Optional[int] = None):
    """The single env factory (reference: environment.py:66-74).

    ``cfg.game_name == "Fake"`` → :class:`FakeAtariEnv` emitting
    ``cfg.stored_obs_shape`` directly (21×21×16 at the flagship width), as
    the JAX package does.  Any other game needs the ALE wrappers, which are
    not ported yet, and raises.  ``noop_start`` is the ALE wrappers'
    option; the fake env ignores it.
    """
    if cfg.game_name != "Fake":
        raise NotImplementedError(
            f"game {cfg.game_name!r}: the ALE wrappers are not ported yet "
            "(r2d2_tpu_torch serves game_name='Fake' only)")
    return FakeAtariEnv(obs_shape=cfg.stored_obs_shape, action_dim=4,
                        seed=0 if seed is None else seed)
