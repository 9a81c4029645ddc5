"""The port's device-resident PER (``cfg.in_graph_per``) against the JAX
package's, on the CPU.

The PER leaves a block commit writes, the stratified in-graph sampler and
the in-graph super-step (sample → gather → step → priority scatter, k
times) hold to ``r2d2_tpu``'s at ``test_config`` size (mlp torso, H=16,
float32).  JAX draws its uniforms from threefry keys
(``split(fold_in(PRNGKey(seed), dispatch), k)``); the port draws them from
a ``torch.Generator``, so the comparisons recompute JAX's uniforms from
the same keys and feed them to the port.  Mirrors
tests/test_in_graph_per.py.

Tolerances: PER leaves, metadata and sampled indices and ints bitwise; the
densities q within 1e-7 relative (one f32 division of the same operands;
JAX's double-float prefix sum and the port's f64 one round to the same
f32 total here); IS weights within 1e-6 relative (an f32 ``pow``); losses
within 1e-5 relative and scattered priorities within 1e-5 relative / 1e-6
absolute (the learner tolerances, tests/test_torch_learner.py).  Which
write wins at a duplicated leaf index is unspecified in both packages, so
there any of the values written there is accepted.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu.learner import step as jstep
from r2d2_tpu.models.network import create_network as jax_create
from r2d2_tpu.models.network import init_params
from r2d2_tpu.parallel.sharding import pjit_train_step
from r2d2_tpu.replay import replay_buffer as jrb
from r2d2_tpu.replay.device_ring import DeviceRing as JaxDeviceRing
from r2d2_tpu.replay.device_ring import gather_batch as jax_gather_batch
from r2d2_tpu_torch import train as ttrain
from r2d2_tpu_torch.checkpoint import Checkpointer
from r2d2_tpu_torch.config import pong_config
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.envs import FakeAtariEnv
from r2d2_tpu_torch.learner import step as tstep
from r2d2_tpu_torch.learner.learner import Learner
from r2d2_tpu_torch.models import create_network, params_from_flax
from r2d2_tpu_torch.replay.block import LocalBuffer
from r2d2_tpu_torch.replay.device_ring import DeviceRing, gather_batch
from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer
from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS

A = 4
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


def scripted_blocks(cfg, n_blocks, seed=0):
    rng = np.random.default_rng(seed)
    local = LocalBuffer(cfg, A)
    out = []
    local.reset(rng.integers(0, 256, cfg.stored_obs_shape, np.uint8))
    while len(out) < n_blocks:
        for _ in range(cfg.block_length):
            local.add(int(rng.integers(A)), float(rng.normal()),
                      rng.integers(0, 256, cfg.stored_obs_shape, np.uint8),
                      rng.normal(size=A).astype(np.float32),
                      rng.normal(size=(2, cfg.lstm_layers, cfg.hidden_dim)
                                 ).astype(np.float32))
        blk, prios, _ = local.finish(rng.normal(size=A).astype(np.float32))
        out.append((blk, prios))
    return out


def make_cfg(**kw):
    return port_test_config(device_replay=True, in_graph_per=True, **kw)


def make_jcfg(**kw):
    return jax_test_config(device_replay=True, in_graph_per=True, **kw)


def filled(n_blocks=3, seed=0, **kw):
    """The port's in-graph-PER buffer (on the CPU) and the JAX package's,
    fed the same blocks."""
    cfg = make_cfg(**kw)
    ring = DeviceRing(cfg, A, device="cpu")
    buf = ReplayBuffer(cfg, A, rng=np.random.default_rng(99),
                       device_ring=ring)
    jring = JaxDeviceRing(make_jcfg(**kw), A)
    jbuf = jrb.ReplayBuffer(make_jcfg(**kw), A, rng=np.random.default_rng(99),
                            device_ring=jring)
    for blk, prios in scripted_blocks(cfg, n_blocks, seed):
        buf.add(blk, prios, None)
        jbuf.add(blk, prios, None)
    return cfg, buf, ring, jbuf, jring


def jax_uniforms(seed, dispatch, k, B):
    """The uniforms JAX's in-graph super-step draws for ``dispatch``."""
    keys = jax.random.split(
        jax.random.fold_in(jax.random.PRNGKey(seed),
                           jnp.asarray(dispatch, jnp.uint32)), k)
    return np.stack([np.asarray(jax.random.uniform(key, (B,)))
                     for key in keys]), keys


def per_state(ring):
    meta = ring.per_meta()
    return ring.take_prios(), meta["seq_meta"], meta["first"]


def flax_to_port(tree):
    return params_from_flax(jax.device_get(tree))


def env_factory(cfg, seed):
    return FakeAtariEnv(obs_shape=cfg.obs_shape, action_dim=A, seed=seed,
                        episode_len=32)


# ------------------------------------------------------------- the leaves

def test_per_leaves_and_metadata_mirror_jax():
    """commit_per stores exactly what JAX's does: td**alpha at the block's
    real sequences, zero past them, and the (burn, learn, fwd) metadata
    and first burn-in per slot; the host tree behind it stays empty."""
    cfg, buf, ring, jbuf, jring = filled(5)
    for got, want in zip(per_state(ring), (jring.take_prios(),
                                           jring.per_meta()["seq_meta"],
                                           jring.per_meta()["first"])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert buf.tree.nodes.sum() == 0.0
    assert buf.size == jbuf.size and buf.ready == jbuf.ready


def test_partial_block_add_keeps_padding_unsampleable():
    """A short episode's partial block (num_sequences < K) commits cleanly:
    its priorities arrive K long, zero past the real sequences, and the
    padding leaves stay 0."""
    cfg = make_cfg()
    K = cfg.seqs_per_block
    ring = DeviceRing(cfg, A, device="cpu")
    buf = ReplayBuffer(cfg, A, rng=np.random.default_rng(1),
                       device_ring=ring)
    rng = np.random.default_rng(5)
    local = LocalBuffer(cfg, A)
    local.reset(rng.integers(0, 256, cfg.stored_obs_shape, np.uint8))
    for _ in range(max(1, cfg.block_length // 2 - 1)):
        local.add(int(rng.integers(A)), 0.5,
                  rng.integers(0, 256, cfg.stored_obs_shape, np.uint8),
                  rng.normal(size=A).astype(np.float32),
                  rng.normal(size=(2, cfg.lstm_layers,
                                   cfg.hidden_dim)).astype(np.float32))
    blk, prios, _ = local.finish(None)
    assert blk.num_sequences < K
    buf.add(blk, prios, 1.0)
    p = ring.take_prios().numpy()
    assert (p[blk.num_sequences:K] == 0).all()
    assert (p[:blk.num_sequences] > 0).all()
    assert (ring.per_meta()["seq_meta"][0, blk.num_sequences:] == 0).all()
    # a sample over this ring never lands on the padding
    idx, _, _ = tstep._in_graph_sample(
        cfg, torch.rand(cfg.batch_size, generator=torch.Generator().
                        manual_seed(0)), *per_state(ring))
    assert (idx < blk.num_sequences).all()


# ---------------------------------------------------------------- sampler

@pytest.mark.parametrize("dispatch", [0, 3, 11])
def test_in_graph_sample_raw_matches_jax(dispatch):
    """JAX's uniforms for a dispatch through both samplers over the same
    leaves: indices and ints bundles bitwise, densities within 1e-7
    relative; the weights of ``_in_graph_sample`` within 1e-6."""
    cfg, buf, ring, jbuf, jring = filled(6, seed=dispatch)
    jcfg = make_jcfg()
    B = cfg.batch_size
    u, keys = jax_uniforms(cfg.seed, dispatch, 2, B)
    jmeta = jring.per_meta()
    for j in range(2):
        jidx, jq, jints = jstep._in_graph_sample_raw(
            jcfg, keys[j], jring.take_prios(), jmeta["seq_meta"],
            jmeta["first"], B)
        idx, q, ints = tstep._in_graph_sample_raw(
            cfg, torch.from_numpy(u[j]), *per_state(ring))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(ints.numpy(), np.asarray(jints))
        assert ints.dtype == torch.int32
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-7)
        _, jw, _ = jstep._in_graph_sample(jcfg, keys[j], jring.take_prios(),
                                          jmeta["seq_meta"], jmeta["first"])
        _, w, _ = tstep._in_graph_sample(cfg, torch.from_numpy(u[j]),
                                         *per_state(ring))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)


def test_in_graph_sample_matches_host_index_arithmetic():
    """The sampled ints bundles reproduce ``sample_meta``'s arithmetic over
    the host count arrays, the weights are the reference formula on exact
    densities, and zero leaves are never drawn."""
    cfg, buf, ring, _, _ = filled(3)
    K, L = cfg.seqs_per_block, cfg.learning_steps
    prios = ring.take_prios().numpy()
    idx, w, ints = tstep._in_graph_sample(
        cfg, torch.rand(cfg.batch_size,
                        generator=torch.Generator().manual_seed(3)),
        *per_state(ring))
    idx, w, ints = idx.numpy(), w.numpy(), ints.numpy()
    assert (prios[idx] > 0).all()
    block_idx, seq_idx = idx // K, idx % K
    burn = buf.burn_in_steps[block_idx, seq_idx]
    start = buf.first_burn_in[block_idx] + seq_idx * L
    np.testing.assert_array_equal(ints, np.stack(
        [block_idx, start - burn, seq_idx, burn,
         buf.learning_steps[block_idx, seq_idx],
         buf.forward_steps[block_idx, seq_idx]], axis=1))
    q = prios[idx] / prios.sum()
    np.testing.assert_allclose(
        w, (q / q.min()) ** (-cfg.importance_sampling_exponent), rtol=1e-5)


def test_in_graph_sampling_distribution_is_proportional():
    """Seeded draw frequencies track the priorities (the sum tree's
    proportional contract) within sampling noise, and zero leaves are
    never drawn."""
    cfg, _, ring, _, _ = filled(3)
    prios, seq_meta, first = per_state(ring)
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros(prios.numel())
    for _ in range(400):
        idx, _, _ = tstep._in_graph_sample(
            cfg, torch.rand(cfg.batch_size, generator=gen), prios, seq_meta,
            first)
        np.add.at(counts, idx.numpy(), 1)
    p = prios.numpy()
    expect = p / p.sum() * counts.sum()
    live = expect > 20
    assert live.any()
    np.testing.assert_allclose(counts[live], expect[live], rtol=0.35)
    assert counts[p == 0].sum() == 0


def test_compensated_cumsum_matches_f64():
    """The prefix sums agree with a float64 oracle at stratum-boundary
    resolution over flagship-scale leaf vectors, where a plain f32 cumsum
    drifts enough to move boundaries."""
    diffs = plain_diffs = 0
    for seed in range(8):
        rng = np.random.default_rng(seed)
        x = (rng.random(50_000) * rng.exponential(1, 50_000)).astype(
            np.float32)
        x[rng.random(50_000) < 0.3] = 0.0
        ref = np.cumsum(x.astype(np.float64))
        hi = tstep._compensated_cumsum(torch.from_numpy(x)).numpy()
        assert hi.dtype == np.float32
        u = rng.random(64)
        t64 = (np.arange(64) + u) * (ref[-1] / 64)
        t32 = ((np.arange(64, dtype=np.float32) + u.astype(np.float32))
               * (hi[-1] / np.float32(64)))
        diffs += int(np.sum(np.searchsorted(ref, t64, side="right")
                            != np.searchsorted(hi, t32, side="right")))
        plain_diffs += int(np.sum(
            np.searchsorted(ref, t64, side="right")
            != np.searchsorted(np.cumsum(x), t32, side="right")))
    assert diffs == 0
    assert plain_diffs > 0


def test_compensated_cumsum_adversarial_spread():
    """The sampler's worst case: the Pong preset's full leaf count (50 000,
    the 2 000 000-transition ring) with 1e-6 leaves among 1e3 leaves and
    padding zeros — 0 stratum disagreements against the f64 oracle."""
    cfg = pong_config(game_name="Fake")
    N = cfg.num_sequences
    assert N == 50_000
    diffs = 0
    for seed in range(8):
        rng = np.random.default_rng(100 + seed)
        x = np.full(N, 1e-6, np.float32)
        x[rng.random(N) < 0.05] = 1e3
        x[rng.random(N) < 0.3] = 0.0
        ref = np.cumsum(x.astype(np.float64))
        hi = tstep._compensated_cumsum(torch.from_numpy(x)).numpy()
        u = rng.random(64)
        t64 = (np.arange(64) + u) * (ref[-1] / 64)
        t32 = ((np.arange(64, dtype=np.float32) + u.astype(np.float32))
               * (hi[-1] / np.float32(64)))
        diffs += int(np.sum(np.searchsorted(ref, t64, side="right")
                            != np.searchsorted(hi, t32, side="right")))
    assert diffs == 0


def test_compensated_cumsum_matches_jax_at_test_size():
    x = np.random.default_rng(4).random(160).astype(np.float32)
    x[::7] = 0
    np.testing.assert_array_equal(
        tstep._compensated_cumsum(torch.from_numpy(x)).numpy(),
        np.asarray(jstep._compensated_cumsum(jnp.asarray(x))))


# ------------------------------------------------------------- super-step

def _jax_reference(jcfg, jring, params, dispatch, k):
    """JAX's in-graph super-step for ``dispatch``, and the same k steps
    replayed one by one (its exact key schedule) to expose each step's
    sampled leaves and written priorities."""
    jnet = jax_create(jcfg, A)
    jmeta = jring.per_meta()
    p0 = np.asarray(jring.take_prios()).copy()
    fused = jax.jit(jstep.make_in_graph_per_super_step_fn(jcfg, jnet, k))
    _, jprios, jlosses = fused(
        jstep.create_train_state(jcfg, params), jring.snapshot(),
        jnp.asarray(p0), jmeta["seq_meta"], jmeta["first"],
        jnp.asarray(dispatch, jnp.uint32))
    _, keys = jax_uniforms(jcfg.seed, dispatch, k, jcfg.batch_size)
    state = jstep.create_train_state(jcfg, params)
    step = pjit_train_step(jcfg, jnet, state_template=state)
    @jax.jit
    def draw(key, p, arrays, seq_meta, first):
        idx, w, ints = jstep._in_graph_sample(jcfg, key, p, seq_meta, first)
        return idx, jax_gather_batch(jcfg, arrays, ints, w)

    @jax.jit
    def scatter(p, idx, new_p):
        vals = new_p ** jcfg.prio_exponent
        return p.at[idx].set(vals), vals

    p = jnp.asarray(p0)
    writes = []
    for j in range(k):
        idx, batch = draw(keys[j], p, jring.snapshot(), jmeta["seq_meta"],
                          jmeta["first"])
        state, _, new_p = step(state, batch)
        p, vals = scatter(p, idx, new_p)
        writes.append((np.asarray(idx), np.asarray(vals)))
    return p0, np.asarray(jprios), np.asarray(jlosses), writes


def test_in_graph_super_step_matches_jax():
    """k=2 from the same params and leaves, the port fed JAX's uniforms:
    the losses, the leaves each step draws, and the scattered priorities.
    A leaf's final value comes from the last step that drew it; where that
    step drew it more than once, any of its written values is accepted."""
    k, dispatch = 2, 7
    cfg, _, ring, _, jring = filled(3)
    jcfg = make_jcfg()
    jnet = jax_create(jcfg, A)
    params = init_params(jcfg, jnet, jax.random.PRNGKey(0))
    p0, jprios, jlosses, writes = _jax_reference(jcfg, jring, params,
                                                 dispatch, k)
    u, _ = jax_uniforms(cfg.seed, dispatch, k, cfg.batch_size)

    drawn = []
    real = tstep._in_graph_sample

    def recording(*a, **kw):
        out = real(*a, **kw)
        drawn.append(out[0].numpy().copy())
        return out

    prios, seq_meta, first = per_state(ring)
    state = tstep.create_train_state(cfg, flax_to_port(params))
    fn = tstep.make_in_graph_per_super_step_fn(
        cfg, create_network(cfg, A, device="cpu"), k)
    tstep._in_graph_sample = recording
    try:
        state, new_p, losses = fn(state, ring.snapshot(), prios, seq_meta,
                                  first, uniforms=torch.from_numpy(u))
    finally:
        tstep._in_graph_sample = real
    assert new_p is prios and state.step == k
    np.testing.assert_allclose(losses.numpy(), jlosses, **LOSS_TOL)
    for got, (want, _) in zip(drawn, writes):
        np.testing.assert_array_equal(got, want)

    new_p = new_p.numpy()
    candidates = {}
    for idx, vals in writes:           # later steps overwrite earlier ones
        step_vals = {}
        for i, v in zip(idx.tolist(), vals.tolist()):
            step_vals.setdefault(i, []).append(v)
        candidates.update(step_vals)
    untouched = np.ones(p0.size, bool)
    untouched[list(candidates)] = False
    np.testing.assert_array_equal(new_p[untouched], p0[untouched])
    np.testing.assert_array_equal(jprios[untouched], p0[untouched])
    for i, vals in candidates.items():
        for got in (new_p[i], jprios[i]):
            assert any(np.isclose(got, v, **LOSS_TOL) for v in vals), (
                i, got, vals)


def test_in_graph_super_step_trains_and_scatters_feedback():
    """From a torch.Generator: finite losses, the step advanced by k, and
    the scatter writes only drawn (positive) leaves; padding and empty
    leaves stay zero."""
    cfg, _, ring, _, _ = filled(3, superstep_k=2)
    net = create_network(cfg, A, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    state = tstep.create_train_state(cfg, net.state_dict())
    prios, seq_meta, first = per_state(ring)
    p0 = prios.clone()
    fn = tstep.make_in_graph_per_super_step_fn(cfg, net, 2)
    state, p1, losses = fn(state, ring.snapshot(), prios, seq_meta, first,
                           generator=torch.Generator().manual_seed(7))
    assert losses.shape == (2,) and torch.isfinite(losses).all()
    assert state.step == 2
    changed = p1 != p0
    assert changed.any() and (p0[changed] > 0).all()
    assert (p1[p0 == 0] == 0).all()


def test_in_graph_super_step_equals_sequential_steps_bitwise():
    """The super-step equals its k steps taken by hand — draw, gather,
    train step, scatter — bit for bit on the CPU."""
    k = 3
    cfg, _, ring, _, _ = filled(4, target_net_update_interval=2)
    net = create_network(cfg, A, device="cpu",
                         generator=torch.Generator().manual_seed(1))
    u = torch.rand((k, cfg.batch_size),
                   generator=torch.Generator().manual_seed(2))
    prios, seq_meta, first = per_state(ring)
    p_seq = prios.clone()

    seq = tstep.create_train_state(cfg, net.state_dict())
    step = tstep.make_train_step(cfg, net)
    seq_losses = []
    for j in range(k):
        idx, w, ints = tstep._in_graph_sample(cfg, u[j], p_seq, seq_meta,
                                              first)
        seq, loss, new_p = step(seq, gather_batch(cfg, ring.snapshot(),
                                                  ints, w))
        p_seq[idx] = new_p ** cfg.prio_exponent
        seq_losses.append(loss)

    fused = tstep.create_train_state(cfg, net.state_dict())
    fused, p_fused, losses = tstep.make_in_graph_per_super_step_fn(
        cfg, net, k)(fused, ring.snapshot(), prios, seq_meta, first,
                     uniforms=u)
    assert torch.equal(losses, torch.stack(seq_losses))
    assert torch.equal(p_fused, p_seq)
    for a, b in ((fused.params, seq.params),
                 (fused.target_params, seq.target_params)):
        for key in a:
            assert torch.equal(a[key], b[key]), key


def test_run_device_in_graph_per_accounting():
    """``Learner.run_device`` under in-graph PER: k updates per dispatch,
    no dispatch put, one result fetch per dispatch, the buffer's update
    counters kept live through note_updates, and the stream seeded from
    cfg.seed at the start of each run (two runs from the same state and
    leaves give the same losses)."""
    runs = []
    for _ in range(2):
        cfg, buf, ring, _, _ = filled(4, training_steps=8, superstep_k=2)
        net = create_network(cfg, A, device="cpu",
                             generator=torch.Generator().manual_seed(4))
        learner = Learner(cfg, net, tstep.create_train_state(
            cfg, net.state_dict()))
        HOST_TRANSFERS.reset()
        m = learner.run_device(buf, ring, priority_sink=lambda *a: 1 / 0)
        assert m["num_updates"] == 8 and buf.training_steps == 8
        assert HOST_TRANSFERS.get("learner.result_fetch") == 4
        assert HOST_TRANSFERS.get("learner.dispatch_put") == 0
        assert learner.tracer.snapshot()[
            "span.learner.dispatch_lock.count"] == 4
        runs.append((m["mean_loss"], ring.take_prios().clone()))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])


def test_in_graph_per_without_ring_fails_fast():
    with pytest.raises(ValueError, match="in_graph_per=False"):
        ReplayBuffer(make_cfg(), A, rng=np.random.default_rng(0),
                     device_ring=None)


# ---------------------------------------------------------------- train()

def cpu_config(**kw):
    base = dict(game_name="Fake", act_device="cpu", log_interval=0.2,
                device_replay=True, in_graph_per=True, superstep_k=2)
    base.update(kw)
    return port_test_config(**base)


def test_train_degrades_in_graph_per_without_ring(monkeypatch):
    """When the device budget rejects the ring, train() warns and goes on
    with host replay and host-sampled PER — the priority thread kept, the
    host tree holding mass, every update's feedback applied (16 updates
    run past the priority queue's depth, where a stripped priority thread
    would wedge the learner)."""
    built = {}
    real = ttrain._build

    def spy(*a, **kw):
        built.update(real(*a, **kw))
        return built

    monkeypatch.setattr(ttrain, "_device_memory_bytes", lambda device: 1)
    monkeypatch.setattr(ttrain, "_build", spy)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        m = ttrain.train(cpu_config(training_steps=16), env_factory=env_factory,
                         verbose=False, device="cpu", max_wall_seconds=120)
    assert any("in_graph_per disabled" in str(x.message) for x in w)
    assert not built["cfg"].in_graph_per and built["ring"] is None
    assert built["buffer"].tree.total > 0.0
    assert m["buffer_training_steps"] == m["num_updates"] == 16
    assert "priority" in m["health"] and not m["fabric_failed"]


@pytest.mark.parametrize("fused", [False, True])
def test_train_end_to_end_in_graph_per(tmp_path, fused):
    """The threaded fabric with device PER, at both loss paths: updates
    advance by k, losses finite, the log plane's counters live through
    note_updates, no sample or priority thread, no replay snapshot; a
    resume over a directory holding a host-ring replay snapshot warns that
    the ring starts cold."""
    ck = str(tmp_path / "ck")
    host = ttrain.train(cpu_config(device_replay=False, in_graph_per=False,
                                   training_steps=4),
                        env_factory=env_factory, checkpoint_dir=ck,
                        verbose=False, device="cpu", max_wall_seconds=120)
    assert host["num_updates"] == 4 and Checkpointer(ck).replay_steps()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        m = ttrain.train(cpu_config(training_steps=12,
                                    fused_double_unroll=fused),
                         env_factory=env_factory, checkpoint_dir=ck,
                         resume=True, verbose=False, device="cpu",
                         max_wall_seconds=120)
    assert any("cold ring" in str(x.message) for x in w)
    assert not m["restored_replay"]
    assert m["num_updates"] == 12 and np.isfinite(m["mean_loss"])
    assert m["buffer_training_steps"] == 8 and not m["fabric_failed"]
    assert "sample" not in m["health"] and "priority" not in m["health"]
    assert m["learnhealth"]["loss_count"] == 8
    assert 12 in Checkpointer(ck).steps()
    assert Checkpointer(ck).replay_steps() == [4]


def test_pong_preset_trains_on_the_cpu(tmp_path):
    """``pong_config`` as users run it — device ring, in-graph PER,
    k = 4, pipeline 2, 8 env workers — trained on the CPU at test sizes."""
    cfg = pong_config(
        game_name="Fake", act_device="cpu", obs_shape=(12, 12, 1),
        torso="mlp", obs_space_to_depth=False, hidden_dim=16,
        compute_dtype="float32", burn_in_steps=4, learning_steps=4,
        forward_steps=2, block_length=8, buffer_capacity=320,
        learning_starts=64, batch_size=8, num_actors=8, env_workers=2,
        training_steps=8, log_interval=0.2)
    assert (cfg.device_replay, cfg.in_graph_per, cfg.superstep_k,
            cfg.superstep_pipeline) == (True, True, 4, 2)
    m = ttrain.train(cfg, env_factory=env_factory,
                     checkpoint_dir=str(tmp_path), verbose=False,
                     device="cpu", max_wall_seconds=120)
    assert m["num_updates"] == 8 == m["buffer_training_steps"]
    assert np.isfinite(m["mean_loss"]) and not m["fabric_failed"]


def test_train_sync_accepts_the_in_graph_preset():
    """train_sync forces host replay, and drops in_graph_per with it."""
    out = ttrain.train_sync(cpu_config(training_steps=3),
                            env_factory=env_factory, device="cpu")
    assert out["num_updates"] == 3 and np.isfinite(out["mean_loss"])
