"""Per-rank replay under the learner mesh, against the JAX package.

Under ``train(cfg, use_mesh=True)`` each rank's replay (host ring or
device ring) is one dp group's slab of the global ring: a ``ReplayBuffer``
over ``ring_slice_config(cfg, dp)``.  A meshed draw takes this rank's
``host_batch_size`` rows with their raw inclusion densities
(``sample_meta(raw_densities=True)``), and the learner normalises the IS
weights by the minimum density over every rank (``global_is_weights``).

Held here, bitwise: two port rank buffers against two JAX buffers fed the
same scripted blocks with the same seeds (the JAX package's two-host
arithmetic), then the global-min IS weights.  And the counterparts of
tests/test_device_ring.py's dp-group tests that apply per rank: the rows
stay in their own slab, an indivisible batch is rejected, stale-priority
masking, per-rank densities, an unbiased estimate at full correction, and
``resolve_layout``.  Last, ``train()`` over two gloo ranks end to end,
host-staged and from the per-rank device ring.
"""
import numpy as np
import pytest

from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu.replay import replay_buffer as jrb
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.learner.learner import global_is_weights
from r2d2_tpu_torch.replay.block import LocalBuffer
from r2d2_tpu_torch.replay.device_ring import (
    DeviceRing,
    resolve_layout,
    ring_slice_config,
)
from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer
from r2d2_tpu_torch.tools.rank_worker import run_ranks

A = 4
DP = 2
GB = 10 ** 9


def scripted_blocks(cfg, n_blocks, seed=0):
    """Deterministic well-formed blocks via the port's LocalBuffer."""
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


def rank_buffers(n_blocks=6, device_ring=False, **kw):
    """Two ranks' slabs (port) and two hosts' buffers (JAX) over the same
    slice of the ring, each pair fed the same blocks with the same
    sampler seeds."""
    cfg = port_test_config(**kw)
    slab = ring_slice_config(cfg, DP)
    jslab = jax_test_config(buffer_capacity=slab.buffer_capacity,
                            learning_starts=slab.learning_starts, **kw)
    port, jax_ = [], []
    for r in range(DP):
        ring = (DeviceRing(slab.replace(device_replay=True), A, device="cpu",
                           layout="dp") if device_ring else None)
        p = ReplayBuffer(slab.replace(device_replay=device_ring), A,
                         rng=np.random.default_rng(50 + r), device_ring=ring)
        j = jrb.ReplayBuffer(jslab, A, rng=np.random.default_rng(50 + r))
        for blk, prios in scripted_blocks(cfg, n_blocks, seed=r):
            p.add(blk, prios, None)
            j.add(blk, prios, None)
        port.append(p)
        jax_.append(j)
    return cfg, slab, port, jax_


@pytest.mark.parametrize("device_ring", [False, True], ids=["host", "ring"])
def test_rank_draws_equal_jax_two_host_arithmetic_bitwise(device_ring):
    cfg, slab, port, jax_ = rank_buffers(device_ring=device_ring)
    k, B_host = 3, cfg.batch_size // DP
    metas = [b.sample_meta(k, batch_size=B_host, raw_densities=True)
             for b in port]
    jmetas = [b.sample_meta(k, batch_size=B_host, raw_densities=True)
              for b in jax_]
    for m, jm in zip(metas, jmetas):
        for key in ("ints", "is_weights", "idxes"):
            assert m[key].dtype == jm[key].dtype
            np.testing.assert_array_equal(m[key], jm[key])
        assert (m["block_ptr"], m["env_steps"]) == (
            jm["block_ptr"], jm["env_steps"])
    # the global min over both ranks' rows, then JAX's learner arithmetic
    gmin = np.minimum(*[m["is_weights"].min(axis=1).astype(np.float64)
                        for m in jmetas])
    beta = cfg.importance_sampling_exponent
    for m, jm in zip(metas, jmetas):
        want = ((jm["is_weights"] / gmin[:, None]) ** (-beta)).astype(
            np.float32)
        np.testing.assert_array_equal(
            global_is_weights(m["is_weights"], beta, gmin=gmin), want)
    # the whole batch's min weight is the minimum-density row's: 1
    w = np.concatenate([global_is_weights(m["is_weights"], beta, gmin)
                        for m in metas], axis=1)
    np.testing.assert_array_equal(w.max(axis=1), np.ones(k, np.float32))


def test_rows_stay_in_their_own_slab():
    """Rank r's rows index only its slab: in the global ring's slot
    coordinates, [r · bpg, (r + 1) · bpg)."""
    cfg, slab, port, _ = rank_buffers(n_blocks=8)
    bpg = slab.num_blocks
    assert bpg * DP == cfg.num_blocks
    for r, buf in enumerate(port):
        meta = buf.sample_meta(3, batch_size=cfg.batch_size // DP,
                               raw_densities=True)
        blocks = meta["ints"][:, :, 0] + r * bpg
        assert np.all((blocks >= r * bpg) & (blocks < (r + 1) * bpg))
        assert np.array_equal(meta["idxes"] // slab.seqs_per_block,
                              meta["ints"][:, :, 0])


def test_an_indivisible_batch_is_rejected():
    from r2d2_tpu_torch.parallel.sharding import ShardingTable, _check_batch

    cfg = port_test_config(batch_size=6)
    with pytest.raises(ValueError, match="divisible"):
        _check_batch(cfg, ShardingTable(sizes=dict(dp=4)))
    with pytest.raises(ValueError, match="divisible"):
        resolve_layout(cfg.replace(device_ring_layout="dp"), dict(dp=4),
                       GB, 16 * GB)
    with pytest.raises(ValueError, match="divide"):
        ring_slice_config(port_test_config(), 3)


def test_ring_slice_config():
    cfg = port_test_config(learning_starts=17)
    assert ring_slice_config(cfg, 1) is cfg
    s = ring_slice_config(cfg, DP)
    assert s.num_blocks * DP == cfg.num_blocks
    assert s.learning_starts == 9 and s.batch_size == cfg.batch_size


def test_stale_priority_masking_per_rank_equals_jax():
    """Feedback for slots a rank overwrote since its draw is dropped by
    its own ring walk, as in the JAX package's buffer over the same
    slice."""
    cfg, slab, port, jax_ = rank_buffers(n_blocks=0)
    NB, K = slab.num_blocks, slab.seqs_per_block
    for p, j in zip(port, jax_):
        for blk, prios in scripted_blocks(cfg, NB, seed=7):
            p.add(blk, prios, None)
            j.add(blk, prios, None)
        old_ptr = p.block_ptr
        for blk, prios in scripted_blocks(cfg, 3, seed=8):
            p.add(blk, prios, None)
            j.add(blk, prios, None)
        idxes = np.arange(NB * K, dtype=np.int64)
        p.update_priorities(idxes, np.full(NB * K, 5.0), old_ptr, 0.0)
        j.update_priorities(idxes, np.full(NB * K, 5.0), old_ptr, 0.0)
        leaves = slice(p.tree.leaf_offset, p.tree.leaf_offset + NB * K)
        np.testing.assert_array_equal(p.tree.nodes[leaves],
                                      j.tree.nodes[leaves])
        fresh = np.arange(3 * K)          # the three overwritten slots
        assert not np.any(p.tree.nodes[leaves][fresh]
                          == 5.0 ** cfg.prio_exponent)
        assert np.all(p.tree.nodes[leaves][3 * K:]
                      == 5.0 ** cfg.prio_exponent)


def test_per_rank_densities_are_prio_over_own_mass():
    """A row's density is its leaf over its OWN rank's mass: a rank whose
    priorities are another's scaled by 4 yields the same density set (the
    cross-group fairness of the JAX package's per-group normalisation)."""
    cfg = port_test_config()
    slab = ring_slice_config(cfg, DP)
    blocks = scripted_blocks(cfg, 2)
    bufs = []
    for r, scale in enumerate((1.0, 4.0)):
        b = ReplayBuffer(slab, A, rng=np.random.default_rng(r))
        b.add(blocks[0][0], np.array([1.0, 3.0]) * scale, None)
        b.add(blocks[1][0], np.array([2.0, 5.0]) * scale, None)
        bufs.append(b)
    qs = []
    for b in bufs:
        meta = b.sample_meta(1, batch_size=cfg.batch_size // DP,
                             raw_densities=True)
        idx, q = meta["idxes"][0], meta["is_weights"][0]
        leaf = b.tree.nodes[b.tree.leaf_offset + idx]
        np.testing.assert_allclose(q, leaf / b.tree.total, rtol=1e-6)
        qs.append(np.unique(np.round(q.astype(np.float64), 6)))
    assert np.intersect1d(*qs).size > 0


def test_rank_sampling_is_unbiased_at_full_correction():
    """At β = 1 the IS-weighted visitation E[count_i / q_i] is the rows a
    rank draws per step for EVERY leaf of both ranks, though one rank's
    mass is ~20x the other's: each rank normalises by its own mass."""
    cfg = port_test_config(importance_sampling_exponent=1.0)
    slab = ring_slice_config(cfg, DP)
    NB, K = slab.num_blocks, slab.seqs_per_block
    B_host, draws = cfg.batch_size // DP, 6000
    rng = np.random.default_rng(11)
    for scale in (1.0, 20.0):
        buf = ReplayBuffer(slab, A, rng=np.random.default_rng(int(scale)))
        buf.tree.update(np.arange(NB * K), (rng.random(NB * K) + 0.5)
                        * scale)
        totals = np.zeros(NB * K)
        for _ in range(draws):
            idx, q = buf._grouped_densities(B_host)
            np.add.at(totals, idx, 1.0 / q)
        np.testing.assert_allclose(totals, draws * B_host, rtol=0.15)


def test_resolve_layout():
    cfg = port_test_config(mesh_shape=(("dp", 4),))
    mesh = dict(dp=4)
    assert resolve_layout(cfg, mesh, GB, 16 * GB) == "replicated"
    assert resolve_layout(cfg, mesh, 15 * GB, 16 * GB) == "dp"
    bad = port_test_config(batch_size=6)
    assert resolve_layout(bad, mesh, 15 * GB, 16 * GB) == "replicated"
    assert resolve_layout(cfg.replace(device_ring_layout="replicated"),
                          mesh, 15 * GB, 16 * GB) == "replicated"
    assert resolve_layout(cfg.replace(device_ring_layout="dp"),
                          mesh, GB, 16 * GB) == "dp"
    with pytest.raises(ValueError, match="dp"):
        resolve_layout(bad.replace(device_ring_layout="dp"), mesh, GB,
                       16 * GB)
    with pytest.raises(ValueError, match="use_mesh"):
        resolve_layout(cfg.replace(device_ring_layout="dp"), None, GB,
                       16 * GB)
    # a rank always holds its own slab: "dp" at dp = 1 is the whole ring
    assert resolve_layout(cfg.replace(device_ring_layout="dp"), dict(dp=1),
                          GB, 16 * GB) == "dp"
    # "auto" never shards a world of one, nor without the card's size
    assert resolve_layout(cfg, dict(dp=1), 15 * GB, 16 * GB) == "replicated"
    assert resolve_layout(cfg, mesh, 15 * GB, None) == "replicated"
    ig = port_test_config(device_replay=True, in_graph_per=True)
    assert resolve_layout(ig, mesh, 15 * GB, 16 * GB) == "dp"


# ------------------------------------------------- two ranks, end to end

TRAIN_KW = dict(training_steps=8, log_interval=0.2)


@pytest.mark.parametrize("kw", [
    dict(), dict(device_replay=True, device_ring_layout="dp",
                 superstep_k=2)], ids=["host_staged", "device_ring"])
def test_two_rank_train_end_to_end(tmp_path, kw):
    """``train(cfg, use_mesh=True)`` on two gloo ranks: both ranks take
    every update together and end with the same params; every priority
    goes back to the rank that drew it; one collective gate per update
    (host-staged) or per dispatch and waits (device ring), and one
    min-density agreement per super-step; the env steps are summed over
    the ranks."""
    r0, r1 = run_ranks("train", 2, str(tmp_path),
                       dict(cfg_kw=dict(TRAIN_KW, **kw)), timeout=150)
    steps = TRAIN_KW["training_steps"]
    for r in (r0, r1):
        assert r["num_updates"] == steps and not r["fabric_failed"]
        assert np.isfinite(r["mean_loss"])
        assert r["healthz"]["status"] == "ok"
        assert r["buffer_training_steps"] == steps
        assert r["threads"] == 1
        # this rank's rows only: half the global batch per feedback
        assert r["fed"] == [port_test_config().batch_size // 2] * steps
        assert r["env_steps"] == r0["env_steps"]
    assert all(np.array_equal(r0["params"][k], r1["params"][k])
               for k in r0["params"])
    # each rank's actors explore their own streams: their first blocks
    # differ (ROADMAP C 11)
    assert r0["first_block"] != r1["first_block"]
    c = r0["collectives"]
    assert c == r1["collectives"]
    if kw:
        k = kw["superstep_k"]
        assert c["min_density"] == steps // k
        assert c["gate"] >= steps // k and c["ring"] == 2
    else:
        assert c["gate"] == steps and "min_density" not in c
    assert c["env_steps"] == 1


def test_two_rank_train_sync_checkpoint_restores_without_a_mesh(tmp_path):
    """``train_sync(cfg, use_mesh=True)`` over two ranks: rank 0 alone
    writes the gathered full state in the meshless byte layout, and a
    meshless restore holds the ranks' final params bit for bit."""
    import torch

    from r2d2_tpu_torch.checkpoint import Checkpointer

    ck = str(tmp_path / "ck")
    steps = 8
    r0, r1 = run_ranks("train", 2, str(tmp_path / "ranks"),
                       dict(cfg_kw=dict(training_steps=steps), sync=True,
                            ckpt_dir=ck), timeout=150)
    for r in (r0, r1):
        assert r["num_updates"] == steps
        assert r["fed"] == [port_test_config().batch_size // 2] * steps
        # each update's rows go to the rank's dp group, here of one
        assert r["collectives"] == {"gate": steps, "group_broadcast": steps,
                                    "env_steps": 1}
    assert r0["first_block"] != r1["first_block"]
    state, meta = Checkpointer(ck).restore()
    assert state.step == steps
    for k, v in state.params.items():
        assert torch.equal(v, torch.from_numpy(r0["params"][k])), k
        assert np.array_equal(r0["params"][k], r1["params"][k]), k
