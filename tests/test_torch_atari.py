"""The port's ALE wrappers and ``create_env``'s ALE branch against the JAX
package's, on the CPU.

ALE (``ale_py``) and its ROMs are not installed here, so the wrappers run
over a stub env with the ALE surface (gymnasium 5-tuple,
``unwrapped.get_action_meanings``), and the ALE branch of ``create_env``
runs up to ``gymnasium.make``, monkeypatched to build the stub.  Outputs
are bitwise equal between the packages (``cv2`` does the warp in both).
"""
import subprocess
import sys

import numpy as np
import pytest

from r2d2_tpu.config import Config as JaxConfig
from r2d2_tpu.envs import atari as jatari
from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.envs import atari


class StubALE:
    """Grayscale 210×160 frames from a seeded generator; an episode ends
    (terminated) after ``episode_len`` steps.  Records its resets."""

    def __init__(self, episode_len=7):
        self.episode_len = episode_len
        self.unwrapped = self
        self.resets = []
        self._rng = np.random.default_rng(0)
        self._t = 0

    def get_action_meanings(self):
        return ["NOOP", "FIRE", "UP", "DOWN"]

    def _frame(self):
        return self._rng.integers(0, 256, (210, 160), np.uint8)

    def reset(self, seed=None, **kwargs):
        self.resets.append(seed)
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        return self._frame(), {"lives": 3}

    def step(self, action):
        self._t += 1
        return (self._frame(), float(action), self._t >= self.episode_len,
                False, {})


def rollout(env, actions, resets=2):
    """Outputs of ``resets`` resets, each followed by ``actions``."""
    out = []
    for _ in range(resets):
        obs, info = env.reset()
        out.append((obs, info))
        for a in actions:
            out.append(env.step(a))
    return out


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        assert g[1:] == w[1:]


def test_atari_available_matches_jax():
    assert atari.atari_available() == jatari.atari_available()


def test_seed_first_reset_seeds_only_the_first_reset():
    ours, ref = StubALE(), StubALE()
    got = rollout(atari.SeedFirstReset(ours, 17), [1, 2], resets=3)
    want = rollout(jatari.SeedFirstReset(ref, 17), [1, 2], resets=3)
    assert_same(got, want)
    assert ours.resets == ref.resets == [17, None, None]
    assert atari.SeedFirstReset(StubALE(), 3).episode_len == 7  # delegates


@pytest.mark.parametrize("noop_max,episode_len", [(30, 1000), (30, 5),
                                                  (1, 1000)])
def test_noop_reset_matches_jax(noop_max, episode_len):
    """1..noop_max no-ops after each reset from the same generator; an
    episode that ends inside the no-ops resets again."""
    ours, ref = StubALE(episode_len), StubALE(episode_len)
    got = rollout(atari.NoopResetEnv(ours, noop_max,
                                     np.random.default_rng(4)), [3, 1], 4)
    want = rollout(jatari.NoopResetEnv(ref, noop_max,
                                       np.random.default_rng(4)), [3, 1], 4)
    assert_same(got, want)
    assert len(ours.resets) == len(ref.resets) >= 4


def test_noop_reset_requires_noop_first():
    env = StubALE()
    env.get_action_meanings = lambda: ["FIRE", "NOOP"]
    with pytest.raises(AssertionError):
        atari.NoopResetEnv(env)


@pytest.mark.parametrize("size", [(84, 84), (64, 48)])
def test_warp_frame_matches_jax(size):
    h, w = size
    ours = atari.WarpFrame(StubALE(), width=w, height=h)
    ref = jatari.WarpFrame(StubALE(), width=w, height=h)
    assert ours.observation_space.shape == ref.observation_space.shape == (
        h, w, 1)
    got, want = rollout(ours, [0, 1]), rollout(ref, [0, 1])
    assert_same(got, want)
    assert got[0][0].dtype == np.uint8 and got[0][0].shape == (h, w, 1)


def test_create_env_ale_branch_up_to_gymnasium_make(monkeypatch):
    """With ALE present (monkeypatched), both packages make the same env
    (``ALE/<game>-v5``, same keyword arguments) and wrap it alike:
    seeded first reset, warp, no-op starts, space-to-depth."""
    made = []

    class Gym:
        @staticmethod
        def make(name, **kw):
            made.append((name, kw))
            return StubALE()

    for mod in (atari, jatari):
        monkeypatch.setattr(mod, "_HAS_ALE", True)
        monkeypatch.setattr(mod, "gymnasium", Gym)
    ours = atari.create_env(Config(game_name="Pong"), seed=5)
    ref = jatari.create_env(JaxConfig(game_name="Pong"), seed=5)
    assert made[0] == made[1] == ("ALE/Pong-v5", dict(
        obs_type="grayscale", frameskip=4, repeat_action_probability=0.0,
        full_action_space=False))
    chain = []
    env = ours
    while hasattr(env, "env"):
        chain.append(type(env).__name__)
        env = env.env
    assert chain == ["SpaceToDepth", "NoopResetEnv", "WarpFrame",
                     "SeedFirstReset"]
    assert ours.observation_space.shape == (21, 21, 16)
    assert_same(rollout(ours, [1, 0, 2]), rollout(ref, [1, 0, 2]))

    plain = atari.create_env(Config(game_name="Pong",
                                    obs_space_to_depth=False),
                             noop_start=False, seed=5)
    assert type(plain).__name__ == "WarpFrame"
    assert plain.observation_space.shape == (84, 84, 1)


def test_import_without_jax_cv2_or_gymnasium():
    """``import r2d2_tpu_torch`` (and its envs, the league and its three
    modules, the trainer and the anakin loop) works with jax, cv2 and
    gymnasium all blocked, imports nothing of the JAX package, and reports
    no ALE; the league imports without the trainer."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'cv2', 'gymnasium', 'ale_py'):\n"
        "    sys.modules[m] = None\n"
        "import r2d2_tpu_torch, r2d2_tpu_torch.envs\n"
        "import r2d2_tpu_torch.league\n"
        "from r2d2_tpu_torch.league import eval_service, population\n"
        "from r2d2_tpu_torch.league import scenarios\n"
        "assert 'r2d2_tpu_torch.train' not in sys.modules\n"
        "import r2d2_tpu_torch.train\n"
        "import r2d2_tpu_torch.learner.anakin\n"
        "from r2d2_tpu_torch.envs import atari\n"
        "assert not atari.atari_available() and atari.gymnasium is None\n"
        "bad = [m for m in sys.modules if m == 'r2d2_tpu'\n"
        "       or m.startswith('r2d2_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

