"""The port's batched device envs (``r2d2_tpu_torch/envs/anakin.py``) and
the grid env, against the JAX package's and the numpy oracles, on the CPU.

Each lane's reset draws come from JAX's own threefry streams, injected
through ``reset_lanes(..., draws=)`` (the port's streams are its own
counter-based hash, not threefry).  With the same draws, observation
bytes, rewards and truncation flags are bitwise equal to
``r2d2_tpu.envs.anakin`` and to the numpy ``FakeAtariEnv`` /
``GridWorldEnv`` forced to the same reset state, over at least three
episodes per lane.  Mirrors the env half of tests/test_anakin.py.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.envs import grid as jax_grid
from r2d2_tpu.envs.anakin import AnakinFakeEnv as JaxFakeEnv
from r2d2_tpu.envs.anakin import AnakinGridEnv as JaxGridEnv
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.envs import FakeAtariEnv, GridWorldEnv
from r2d2_tpu_torch.envs import anakin as tenv
from r2d2_tpu_torch.envs.grid import next_goal

A = 4
SHAPES = [(12, 12, 1), (21, 21, 16)]


def _draws(kind, jst):
    """The reset values in JAX's state ``jst`` as the port's ``draws``."""
    keys = ("phase",) if kind == "fake" else ("agent", "goal")
    return {k: torch.from_numpy(np.array(jst[k])) for k in keys}


def _force(kind, oracle, tst, lane):
    """Put the numpy oracle in the port lane's freshly reset state."""
    oracle.reset()
    if kind == "fake":
        oracle.restore_state(dict(rng=oracle._rng.bit_generator.state,
                                  phase=int(tst["phase"][lane]), t=0))
    else:
        oracle.restore_state(dict(rng=oracle._rng.bit_generator.state,
                                  agent=int(tst["agent"][lane]),
                                  goal=int(tst["goal"][lane]), t=0))


@pytest.mark.parametrize("obs_shape", SHAPES, ids=["12x12x1", "21x21x16"])
@pytest.mark.parametrize("kind", ["fake", "grid"])
def test_env_bit_exact_vs_jax_and_numpy_oracle(kind, obs_shape):
    N, ep_len = 3, 5
    jcls, tcls, ocls = ((JaxFakeEnv, tenv.AnakinFakeEnv, FakeAtariEnv)
                        if kind == "fake" else
                        (JaxGridEnv, tenv.AnakinGridEnv, GridWorldEnv))
    jenv = jcls(obs_shape=obs_shape, action_dim=A, episode_len=ep_len,
                num_lanes=N)
    env = tcls(obs_shape=obs_shape, action_dim=A, episode_len=ep_len,
               num_lanes=N, device="cpu")
    jst = jenv.init_state(jax.random.PRNGKey(7))
    tst = env.init_state(123, draws=_draws(kind, jst))
    jstep, jreset = jax.jit(jenv.step), jax.jit(jenv.reset_lanes)

    oracles = []
    for lane in range(N):
        o = ocls(obs_shape=obs_shape, action_dim=A, episode_len=ep_len,
                 seed=lane)
        _force(kind, o, tst, lane)
        oracles.append(o)
    obs = env.observe(tst).numpy()
    np.testing.assert_array_equal(obs, np.asarray(jenv.observe(jst)))
    for lane in range(N):
        np.testing.assert_array_equal(obs[lane], oracles[lane]._obs())

    rng = np.random.default_rng(1)
    resets = 0
    for t in range(3 * ep_len + 2):
        actions = rng.integers(0, A, size=N)
        jst, jr, jtr = jstep(jst, jnp.asarray(actions, jnp.int32))
        tst, r, tr = env.step(tst, torch.from_numpy(actions))
        obs = env.observe(tst).numpy()
        np.testing.assert_array_equal(obs, np.asarray(jenv.observe(jst)))
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jtr))
        assert r.dtype == torch.float32 and tr.dtype == torch.bool
        for lane in range(N):
            oo, orr, oterm, otr, _ = oracles[lane].step(int(actions[lane]))
            np.testing.assert_array_equal(obs[lane], oo)
            assert float(r[lane]) == orr and bool(tr[lane]) == otr
            assert not oterm
        if bool(tr.any()):
            resets += 1
            jst = jreset(jst, jtr)
            tst = env.reset_lanes(tst, tr, draws=_draws(kind, jst))
            obs = env.observe(tst).numpy()
            np.testing.assert_array_equal(obs, np.asarray(jenv.observe(jst)))
            for lane in range(N):
                if bool(tr[lane]):
                    _force(kind, oracles[lane], tst, lane)
                    np.testing.assert_array_equal(obs[lane],
                                                  oracles[lane]._obs())
    assert resets >= 3
    for name in env.STATE_KEYS:
        if name != "key":
            np.testing.assert_array_equal(tst[name].numpy(),
                                          np.asarray(jst[name]))


@pytest.mark.parametrize("kind", ["fake", "grid"])
def test_reset_lanes_touches_only_masked_lanes(kind):
    """Masked lanes redraw and advance their stream; the others keep every
    entry, their stream position included.  Draws are a function of the
    root alone."""
    env = tenv.make_anakin_env(
        port_test_config(anakin_env=kind, num_actors=6,
                         anakin_episode_len=9), A, device="cpu")
    st = env.init_state(5)
    again = env.init_state(5)
    for name in env.STATE_KEYS:
        assert torch.equal(st[name], again[name])
    assert (st["key"][:, 1] == 1).all()
    mask = torch.tensor([True, False, True, False, False, True])
    st2 = env.reset_lanes({**st, "t": st["t"] + 4}, mask)
    assert torch.equal(st2["t"], torch.where(mask, 0, 4).int())
    assert torch.equal(st2["key"][:, 1], 1 + mask.long())
    assert torch.equal(st2["key"][:, 0], st["key"][:, 0])
    for name in env.STATE_KEYS[:-2]:
        assert torch.equal(st2[name][~mask], st[name][~mask])
    assert st["key"][:, 0].unique().numel() == 6  # independent lanes
    if kind == "grid":
        assert (st2["agent"] != st2["goal"]).all()


def test_stream_draws_are_uniform_and_stable():
    """The counter-based stream: python ints and int64 tensors hash alike,
    uniforms lie in [0, 1) on a 2^-24 grid, randint covers its range
    evenly, and different roots give different lanes."""
    xs = [0, 1, 2, 0xFFFFFFFF, 123456789]
    assert [tenv.mix32(x) for x in xs] == tenv.mix32(
        torch.tensor(xs, dtype=torch.int64)).tolist()
    key = tenv.lane_keys(3, 4096, "cpu")
    bits = tenv.stream_bits(key, 0)
    assert bits.min() >= 0 and bits.max() < 2 ** 32
    u = tenv.uniform(bits)
    assert u.dtype == torch.float32 and 0 <= u.min() and u.max() < 1
    assert torch.equal(u * 2 ** 24, torch.floor(u * 2 ** 24))
    assert abs(float(u.mean()) - 0.5) < 0.02
    counts = torch.bincount(tenv.randint(tenv.stream_bits(key, 1), 4),
                            minlength=4)
    assert counts.min() > 900 and counts.sum() == 4096
    assert not torch.equal(key[:, 0], tenv.lane_keys(4, 4096, "cpu")[:, 0])
    assert tenv.derive(1, 2) != tenv.derive(1, 3) != tenv.derive(2, 2)
    assert not torch.equal(bits, tenv.stream_bits(tenv.advance(key), 0))


def test_make_anakin_env_selects_and_refuses():
    cfg = port_test_config(anakin_env="grid", num_actors=3,
                           anakin_episode_len=7)
    env = tenv.make_anakin_env(cfg, A, device="cpu")
    assert isinstance(env, tenv.AnakinGridEnv)
    assert (env.num_lanes, env.episode_len, env.obs_shape) == (
        3, 7, cfg.stored_obs_shape)
    assert env.STATE_KEYS == JaxGridEnv.STATE_KEYS
    assert tenv.AnakinFakeEnv.STATE_KEYS == JaxFakeEnv.STATE_KEYS
    with pytest.raises(ValueError, match="exactly 4 move actions"):
        tenv.AnakinGridEnv(action_dim=5, device="cpu")
    # Config refuses an unknown anakin_env itself; the factory too
    with pytest.raises(ValueError, match="unknown anakin_env"):
        tenv.make_anakin_env(SimpleNamespace(
            anakin_env="pong", stored_obs_shape=(4, 4, 1),
            anakin_episode_len=4, num_actors=1), A, device="cpu")


def test_grid_env_copy_matches_jax():
    """The port's grid module is a copy of the JAX package's: constants,
    the relocation rule and a seeded episode."""
    assert (jax_grid.GRID, jax_grid.AGENT_PIXEL, jax_grid.GOAL_PIXEL) == (
        tenv.GRID, tenv.AGENT_PIXEL, tenv.GOAL_PIXEL)
    for g in range(16):
        for a in range(16):
            assert next_goal(g, a) == jax_grid.next_goal(g, a)
    ours = GridWorldEnv(obs_shape=(12, 12, 1), episode_len=6, seed=4)
    ref = jax_grid.GridWorldEnv(obs_shape=(12, 12, 1), episode_len=6, seed=4)
    np.testing.assert_array_equal(ours.reset()[0], ref.reset()[0])
    for a in [0, 3, 3, 1, 2, 1, 1]:
        got, want = ours.step(a), ref.step(a)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:4] == want[1:4]
        if got[3]:
            np.testing.assert_array_equal(ours.reset()[0], ref.reset()[0])
