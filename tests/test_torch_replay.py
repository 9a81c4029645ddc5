"""The port's host core against the JAX package's, bit for bit.

``r2d2_tpu_torch``'s math, sum tree, local buffers, replay buffer and envs
are numpy copies of ``r2d2_tpu``'s; the same inputs and the same rng
seeds must give identical arrays.  Mirrors tests/test_math.py,
test_sum_tree.py, test_local_buffer.py and test_replay_buffer.py.
"""
import warnings

import numpy as np
import pytest

from r2d2_tpu.config import Config as JaxConfig
from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu.envs import FakeAtariEnv as JaxFakeEnv
from r2d2_tpu.envs.atari import create_env as jax_create_env
from r2d2_tpu.envs.atari import SpaceToDepth as JaxSpaceToDepth
from r2d2_tpu.replay import block as jblock
from r2d2_tpu.replay.replay_buffer import ReplayBuffer as JaxReplayBuffer
from r2d2_tpu.replay.sum_tree import SumTree as JaxSumTree
from r2d2_tpu.utils import math as jmath
from r2d2_tpu_torch import native
from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.envs import (
    FakeAtariEnv,
    SpaceToDepth,
    atari_available,
    create_env,
)
from r2d2_tpu_torch.replay import block as tblock
from r2d2_tpu_torch.replay import replay_buffer as trb
from r2d2_tpu_torch.replay.sum_tree import SumTree
from r2d2_tpu_torch.utils import math as tmath

A = 4
LINEAGE = ("cut_ts", "trace_id", "member_id")


def assert_blocks_equal(a, b):
    """Every experience field equal, bit for bit (the lineage stamps are
    telemetry: ``cut_ts`` is a wall clock)."""
    for f in a.__dataclass_fields__:
        if f in LINEAGE:
            continue
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, f


# ----------------------------------------------------------------- math

def test_math_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(scale=50, size=500), [0.0, -0.0, 1e-9]])
    for fn in ("value_rescale", "inverse_value_rescale"):
        np.testing.assert_array_equal(getattr(tmath, fn)(x),
                                      getattr(jmath, fn)(x))
    r = rng.normal(size=37).astype(np.float32)
    for n in (1, 3, 5):
        np.testing.assert_array_equal(tmath.n_step_return(r, n, 0.997),
                                      jmath.n_step_return(r, n, 0.997))
        for size in (1, 3, 40):
            for term in (True, False):
                np.testing.assert_array_equal(
                    tmath.n_step_gamma_tail(size, n, 0.997, term),
                    jmath.n_step_gamma_tail(size, n, 0.997, term))
    for i in range(8):
        assert (tmath.epsilon_ladder(i, 8, 0.4, 7.0)
                == jmath.epsilon_ladder(i, 8, 0.4, 7.0))
    assert tmath.epsilon_ladder(0, 1) == jmath.epsilon_ladder(0, 1)
    td = rng.random(23).astype(np.float32)
    ls = np.array([5, 8, 1, 9])
    np.testing.assert_array_equal(tmath.mixed_td_errors(td, ls),
                                  jmath.mixed_td_errors(td, ls))


# ------------------------------------------------------------- sum tree

@pytest.fixture(params=["native", "numpy"])
def backend(request, monkeypatch):
    """Run a test on the C fast path and on the numpy fallback."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", True)
    elif not native.available():
        pytest.skip("native sumtree library unavailable (no compiler?)")
    return request.param


def test_sum_tree_matches_jax_bit_for_bit(backend):
    rng = np.random.default_rng(11)
    port = SumTree(100, 0.9, 0.6, rng=np.random.default_rng(3))
    ref = JaxSumTree(100, 0.9, 0.6, rng=np.random.default_rng(3))
    for _ in range(20):
        idx = rng.choice(100, size=int(rng.integers(1, 40)), replace=False)
        td = rng.random(idx.size) + 1e-3
        port.update(idx, td)
        ref.update(idx, td)
        np.testing.assert_array_equal(port.nodes, ref.nodes)
        for raw in (False, True):
            for got, want in zip(port.sample(16, raw=raw),
                                 ref.sample(16, raw=raw)):
                np.testing.assert_array_equal(got, want)
        for leaf in (0, 1, 37, 99, 100, 127, 128):
            assert port.prefix_mass(leaf) == ref.prefix_mass(leaf)
        for got, want in zip(port.sample_range(8, 10, 90),
                             ref.sample_range(8, 10, 90)):
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.leaf_values(), ref.leaf_values())


def test_sum_tree_load_leaves_rebuilds_bit_exact(backend):
    rng = np.random.default_rng(2)
    tree = SumTree(64, 0.9, 0.6, rng=np.random.default_rng(0))
    tree.update(np.arange(64), rng.random(64))
    twin = SumTree(64, 0.9, 0.6)
    twin.load_leaves(tree.leaf_values())
    np.testing.assert_array_equal(twin.nodes, tree.nodes)


def test_sum_tree_guards(backend):
    tree = SumTree(8, 0.9, 0.6)
    with pytest.raises(ValueError):
        tree.sample(4)
    with pytest.raises(IndexError):
        tree.update(np.array([8]), np.array([1.0]))
    with pytest.raises(IndexError):
        tree.prefix_mass(-1)


def test_native_cache_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.setenv("R2D2_TORCH_NATIVE_CACHE", str(tmp_path))
    assert native._cache_dir() == str(tmp_path)
    monkeypatch.delenv("R2D2_TORCH_NATIVE_CACHE")
    assert native._cache_dir().endswith("r2d2_tpu_torch")
    assert native._SRC.endswith("r2d2_tpu_torch/native/sumtree.c")


# --------------------------------------------------------- local buffers

def _both_cfgs(**kw):
    return jax_test_config(**kw), port_test_config(**kw)


def _step_inputs(rng, cfg, n):
    return [(int(rng.integers(A)), float(rng.normal()),
             rng.integers(0, 255, cfg.obs_shape, dtype=np.uint8),
             rng.normal(size=A).astype(np.float32),
             rng.normal(size=(2, cfg.lstm_layers, cfg.hidden_dim)
                        ).astype(np.float32)) for _ in range(n)]


@pytest.mark.parametrize("mode", ["burn_in_start", "seq_start"])
def test_local_buffer_matches_jax(mode):
    """Terminal, boundary-bootstrapped and partial blocks, with the
    burn-in prefix carried across blocks of one episode."""
    jcfg, tcfg = _both_cfgs(stored_hidden_mode=mode)
    rng = np.random.default_rng(4)
    ref, port = jblock.LocalBuffer(jcfg, A), tblock.LocalBuffer(tcfg, A)
    obs0 = rng.integers(0, 255, jcfg.obs_shape, dtype=np.uint8)
    ref.reset(obs0)
    port.reset(obs0)
    for n, last_q in ((8, rng.normal(size=A).astype(np.float32)),
                      (8, rng.normal(size=A).astype(np.float32)),
                      (5, None), (3, None)):
        if last_q is None and n == 3:
            o = rng.integers(0, 255, jcfg.obs_shape, dtype=np.uint8)
            ref.reset(o)
            port.reset(o)
        for step in _step_inputs(rng, jcfg, n):
            ref.add(*step)
            port.add(*step)
        (b_ref, p_ref, r_ref), (b_port, p_port, r_port) = (
            ref.finish(last_q), port.finish(last_q))
        assert_blocks_equal(b_ref, b_port)
        np.testing.assert_array_equal(p_ref, p_port)
        assert r_ref == r_port
        assert ref.curr_burn_in_steps == port.curr_burn_in_steps


@pytest.mark.parametrize("mode", ["burn_in_start", "seq_start"])
def test_vector_local_buffer_matches_jax(mode):
    jcfg, tcfg = _both_cfgs(stored_hidden_mode=mode)
    rng = np.random.default_rng(9)
    N = 3
    ref = jblock.VectorLocalBuffer(jcfg, A, N)
    port = tblock.VectorLocalBuffer(tcfg, A, N)
    for i in range(N):
        o = rng.integers(0, 255, jcfg.obs_shape, dtype=np.uint8)
        ref.reset_lane(i, o)
        port.reset_lane(i, o)
    finish_at = {0: [(8, "boundary"), (14, "terminal")],
                 1: [(5, "terminal"), (13, "boundary")],
                 2: [(8, "boundary"), (16, "boundary")]}
    steps = {i: 0 for i in range(N)}
    for _ in range(16):
        args = (np.arange(N), rng.integers(A, size=N),
                rng.normal(size=N).astype(np.float32),
                rng.integers(0, 255, (N, *jcfg.obs_shape), dtype=np.uint8),
                rng.normal(size=(N, A)).astype(np.float32),
                rng.normal(size=(N, 2, jcfg.lstm_layers, jcfg.hidden_dim)
                           ).astype(np.float32))
        ref.add_batch(*args)
        port.add_batch(*args)
        for i in range(N):
            steps[i] += 1
            for at, kind in finish_at[i]:
                if steps[i] != at:
                    continue
                last_q = (None if kind == "terminal"
                          else rng.normal(size=A).astype(np.float32))
                (b_ref, p_ref, r_ref), (b_port, p_port, r_port) = (
                    ref.finish(i, last_q), port.finish(i, last_q))
                assert_blocks_equal(b_ref, b_port)
                np.testing.assert_array_equal(p_ref, p_port)
                assert r_ref == r_port
                if kind == "terminal":
                    o = rng.integers(0, 255, jcfg.obs_shape, dtype=np.uint8)
                    ref.reset_lane(i, o)
                    port.reset_lane(i, o)
                    steps[i] = 0
    for k, v in ref.snapshot().items():
        np.testing.assert_array_equal(port.snapshot()[k], v, err_msg=k)


def test_block_slot_wire_round_trip_matches_jax():
    """write_block/read_block: the port's slot layout and CRC are the JAX
    package's, so one package can read the other's slot."""
    jcfg, tcfg = _both_cfgs()
    assert tblock.block_slot_spec(tcfg, A) == jblock.block_slot_spec(jcfg, A)
    rng = np.random.default_rng(1)
    lb = tblock.LocalBuffer(tcfg, A)
    lb.reset(rng.integers(0, 255, tcfg.obs_shape, dtype=np.uint8))
    for step in _step_inputs(rng, tcfg, 6):
        lb.add(*step)
    blk, prios, _ = lb.finish(None)
    spec = tblock.block_slot_spec(tcfg, A)
    nbytes, offsets = tblock.slot_layout(spec)
    buf = bytearray(nbytes)
    views = tblock.slot_views(buf, spec, offsets, nbytes, 0)
    header = tblock.write_block(views, blk, prios)
    jviews = jblock.slot_views(buf, spec, offsets, nbytes, 0)
    assert jblock.slot_crc(jviews, *header) == int(views["crc32"][0])
    back, back_prios = tblock.read_block(views, *header)
    assert_blocks_equal(blk, back)
    np.testing.assert_array_equal(back_prios, prios)


# --------------------------------------------------------- replay buffer

def _block_pair(jcfg, tcfg, rng, steps, terminal):
    """One block cut by each package's LocalBuffer from the same inputs."""
    ref, port = jblock.LocalBuffer(jcfg, A), tblock.LocalBuffer(tcfg, A)
    o = rng.integers(0, 255, jcfg.obs_shape, dtype=np.uint8)
    ref.reset(o)
    port.reset(o)
    for step in _step_inputs(rng, jcfg, steps):
        ref.add(*step)
        port.add(*step)
    last_q = None if terminal else rng.normal(size=A).astype(np.float32)
    return ref.finish(last_q), port.finish(last_q)


def test_replay_buffer_sampling_and_priorities_match_jax():
    """add → sample_batch → update_priorities with the ring wrapping
    between a draw and its feedback (the stale mask), on both packages
    with the same seeds: every batch field, the tree and the counters
    agree bit for bit."""
    jcfg, tcfg = _both_cfgs()
    rng = np.random.default_rng(3)
    ref = JaxReplayBuffer(jcfg, A, rng=np.random.default_rng(7))
    port = trb.ReplayBuffer(tcfg, A, rng=np.random.default_rng(7))
    pending = []
    for it in range(3 * jcfg.num_blocks):
        steps = int(rng.integers(1, jcfg.block_length + 1))
        (bj, pj, rj), (bt, pt, rt) = _block_pair(jcfg, tcfg, rng, steps,
                                                 terminal=bool(it % 3))
        ref.add(bj, pj, rj)
        port.add(bt, pt, rt)
        assert ref.ready == port.ready
        if it % 4 == 3:
            bref, bport = ref.sample_batch(), port.sample_batch()
            for k in bref:
                if k == "ages":
                    continue
                np.testing.assert_array_equal(np.asarray(bport[k]),
                                              np.asarray(bref[k]), err_msg=k)
            pending.append((bref["idxes"], bref["block_ptr"]))
        if len(pending) > 2:   # feedback two draws late: slots overwritten
            idxes, ptr = pending.pop(0)
            prios = rng.random(idxes.size).astype(np.float32)
            ref.update_priorities(idxes, prios, ptr, 0.5)
            port.update_priorities(idxes, prios, ptr, 0.5)
        np.testing.assert_array_equal(port.tree.nodes, ref.tree.nodes)
    sj, st = ref.stats(), port.stats()
    assert sj == st
    for name, _, _ in trb._ring_spec(tcfg, A):
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(ref, name), err_msg=name)


def test_short_block_clamp_tail_never_reaches_learner_window():
    """The clamp-padding invariant: a short block overwriting a long one
    leaves stale bytes in the slot tail; every index the learner gathers
    (learner/step.py:_window_indices) sits strictly before them."""
    import torch

    from r2d2_tpu_torch.learner.step import _window_indices

    jcfg, cfg = _both_cfgs()
    rng = np.random.default_rng(5)
    buf = trb.ReplayBuffer(cfg, A, rng=np.random.default_rng(5))
    for _ in range(cfg.num_blocks):
        _, (blk, prios, r) = _block_pair(jcfg, cfg, rng, cfg.block_length,
                                         True)
        buf.add(blk, prios, r)
    _, (short, prios, _) = _block_pair(jcfg, cfg, rng, 3, True)
    buf.add(short, prios, None)
    buf.tree.update(np.arange(cfg.num_sequences),
                    np.zeros(cfg.num_sequences))
    buf.tree.update(np.array([0]), np.array([1.0]))
    batch = buf.sample_batch(4)
    assert (batch["idxes"] == 0).all()
    assert (int(batch["burn_in"][0]), int(batch["learning"][0]),
            int(batch["forward"][0])) == (0, 3, 1)
    np.testing.assert_array_equal(batch["obs"][0, :4], short.obs[:4])
    t = {k: torch.from_numpy(batch[k]) for k in ("burn_in", "learning",
                                                 "forward")}
    idx_online, idx_target, mask = _window_indices(
        cfg, t["burn_in"], t["learning"], t["forward"])
    assert int(torch.where(mask, idx_online, 0).max()) < 4
    assert int(torch.where(mask, idx_target, 0).max()) < 4


def test_replay_buffer_guards(monkeypatch):
    cfg = port_test_config()
    with pytest.raises(RuntimeError):
        trb.ReplayBuffer(cfg, A).sample_batch()
    assert trb.data_bytes(cfg, A) < sum(
        int(np.prod(s)) * np.dtype(d).itemsize
        for _, s, d in trb._ring_spec(cfg, A))
    monkeypatch.setattr(trb, "_available_host_bytes", lambda: 1000)
    with pytest.raises(MemoryError):
        trb.ReplayBuffer(cfg, A)


# ------------------------------------------------------------------- envs

def test_fake_env_matches_jax_with_state_round_trip():
    rng = np.random.default_rng(0)
    ref = JaxFakeEnv(obs_shape=(12, 12, 1), action_dim=A, seed=5,
                     episode_len=7)
    port = FakeAtariEnv(obs_shape=(12, 12, 1), action_dim=A, seed=5,
                        episode_len=7)
    for r, p in zip(ref.reset(), port.reset()):
        np.testing.assert_array_equal(np.asarray(p), np.asarray(r))
    for t in range(20):
        a = int(rng.integers(A))
        out_r, out_p = ref.step(a), port.step(a)
        np.testing.assert_array_equal(out_p[0], out_r[0])
        assert out_p[1:4] == out_r[1:4]
        if out_r[3]:
            ref.reset()
            port.reset()
        if t == 9:
            saved = port.clone_state()
            tail = [port.step(1) for _ in range(3)]
            port.restore_state(saved)
            again = [port.step(1) for _ in range(3)]
            assert [x[1:4] for x in tail] == [x[1:4] for x in again]
            ref.step(1), ref.step(1), ref.step(1)


def test_create_env_fake_at_flagship_width_and_ale_refused():
    """The fake env at the flagship width; and the reference divergence of
    ROADMAP.md C6: without ALE the reference warns and trains on the fake
    env under a real game's name (r2d2_tpu/envs/atari.py:173-181), the
    port refuses, naming the missing ale_py."""
    env = create_env(Config(game_name="Fake"), seed=3)
    obs, _ = env.reset()
    assert obs.shape == (21, 21, 16) and obs.dtype == np.uint8
    assert env.action_space.n == 4
    assert not atari_available()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ref = jax_create_env(JaxConfig(game_name="MsPacman"))
    assert type(ref).__name__ == "FakeAtariEnv"
    assert any("substituting FakeAtariEnv" in str(x.message) for x in w)
    with pytest.raises(RuntimeError, match="ale_py is not installed"):
        create_env(Config(game_name="MsPacman"))


def test_space_to_depth_matches_jax():
    obs = np.random.default_rng(0).integers(0, 255, (84, 84, 1), np.uint8)
    np.testing.assert_array_equal(SpaceToDepth.fold(obs),
                                  JaxSpaceToDepth.fold(obs))
