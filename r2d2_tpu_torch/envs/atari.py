"""ALE Atari wrappers (gymnasium API) and the env factory.

Port of ``r2d2_tpu/envs/atari.py``.  Behavioural parity with the reference
stack (environment.py:8-74): grayscale obs, frameskip 4, no sticky
actions, minimal action set, cv2 INTER_AREA warp to 84×84, 1-30 random
no-ops at reset, **no frame stacking** (the LSTM supplies memory);
observations are NHWC uint8 ``(84, 84, 1)``, and the step API is
gymnasium's 5-tuple.

``gymnasium`` and the ALE plugin (``ale_py``) are optional: without them
``import r2d2_tpu_torch`` still works, ``atari_available()`` is False, and
``create_env`` serves the fake env for ``game_name="Fake"`` and refuses
any other game.  ``cv2`` is imported by :class:`WarpFrame` when one is
built.

One deliberate divergence from the JAX package (ROADMAP.md C6): without
ALE, the reference warns and substitutes the fake env for a real game
(``r2d2_tpu/envs/atari.py:173-181``), so a run trains on noise under the
game's name with a warning as its only signal.  The port raises instead.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.envs.fake import FakeAtariEnv, _Box

try:  # gymnasium may be installed without the ALE plugin, or not at all
    import gymnasium

    try:
        import ale_py  # noqa: F401  (registers ALE/* envs)

        _HAS_ALE = True
    except ImportError:
        _HAS_ALE = False
except ImportError:
    gymnasium = None
    _HAS_ALE = False


def atari_available() -> bool:
    return _HAS_ALE


class SeedFirstReset:
    """Thread the lane seed into the wrapped env's FIRST ``reset``
    (gymnasium's seeding API is reset-time), so a fixed config seed makes
    real-Atari runs reproducible.  Later resets pass no seed: reseeding
    every episode would replay the identical episode forever."""

    def __init__(self, env, seed: Optional[int]):
        self.env = env
        self._seed = seed

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self, **kwargs):
        if self._seed is not None:
            kwargs.setdefault("seed", self._seed)
            self._seed = None
        return self.env.reset(**kwargs)

    def step(self, action):
        return self.env.step(action)


class NoopResetEnv:
    """1..noop_max random no-op steps at reset (environment.py:8-35).

    Action 0 is asserted to be NOOP, matching the reference's guard
    (environment.py:17).
    """

    def __init__(self, env, noop_max: int = 30,
                 rng: Optional[np.random.Generator] = None):
        self.env = env
        self.noop_max = noop_max
        self.noop_action = 0
        self._rng = rng or np.random.default_rng()
        meanings = env.unwrapped.get_action_meanings()
        assert meanings[0] == "NOOP", meanings

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        noops = int(self._rng.integers(1, self.noop_max + 1))
        for _ in range(noops):
            obs, _, terminated, truncated, info = self.env.step(
                self.noop_action)
            if terminated or truncated:
                obs, info = self.env.reset(**kwargs)
        return obs, info

    def step(self, action):
        return self.env.step(action)


class WarpFrame:
    """cv2 INTER_AREA resize to (height, width, 1) uint8
    (environment.py:39-63), NHWC."""

    def __init__(self, env, width: int = 84, height: int = 84):
        import cv2  # here, not at module import: only ALE games need it

        self._cv2 = cv2
        self.env = env
        self._width = width
        self._height = height
        self.observation_space = _Box((height, width, 1), np.uint8)

    def __getattr__(self, name):
        return getattr(self.env, name)

    def _warp(self, obs):
        obs = self._cv2.resize(obs, (self._width, self._height),
                               interpolation=self._cv2.INTER_AREA)
        return obs[..., None].astype(np.uint8)

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        return self._warp(obs), info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return self._warp(obs), reward, terminated, truncated, info


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
    ``cfg.stored_obs_shape`` directly (21×21×16 at the flagship width).
    Any other game is the ALE env ``ALE/<game>-v5`` behind the wrappers
    above, and raises when ``ale_py`` is missing (see the module
    docstring).
    """
    if cfg.game_name == "Fake":
        return FakeAtariEnv(obs_shape=cfg.stored_obs_shape, action_dim=4,
                            seed=0 if seed is None else seed)
    if not _HAS_ALE:
        raise RuntimeError(
            f"game {cfg.game_name!r} needs the ALE, and ale_py is not "
            "installed; install ale_py (and its ROMs) or pass "
            "game_name='Fake'")
    env = gymnasium.make(
        f"ALE/{cfg.game_name}-v5", obs_type="grayscale",
        frameskip=cfg.frameskip, repeat_action_probability=0.0,
        full_action_space=False)
    env = SeedFirstReset(env, seed)
    env = WarpFrame(env, width=cfg.obs_shape[1], height=cfg.obs_shape[0])
    if noop_start:
        env = NoopResetEnv(env, noop_max=cfg.noop_max,
                           rng=np.random.default_rng(seed))
    if cfg.obs_space_to_depth:
        env = SpaceToDepth(env)
    return env
