"""The port's sharded replay plane over shared memory on the CPU, against
the JAX package's where the two must agree.

- bitwise against the JAX package: ``allocate_strata`` over seeded mass
  vectors (skewed, with zero-mass shards) and its zero-total refusal, the
  sample slab's layout (``batch_slot_spec``), the request and response
  CRCs, ``ReplayBuffer.serve_sample`` with and without ``out=``, and the
  port's K = 2 plane against the JAX K = 2 plane fed the same blocks and
  seeds: every batch's rows, indices and IS weights, and the shard masses
  after priority feedback;
- a per-shard snapshot written by one package restores mass-exact in the
  other;
- the plane's own claims, as tests/test_replay_shards.py holds the JAX
  plane to them: mass conserved against the K = 1 oracle, rows bit-exact
  to the oracle's gather, the draw distribution-correct under skew, a
  stalled shard redistributed within the deadline, a garbled response
  retried; respawn with restore (slow, as in JAX);
- a shard child imports neither torch nor JAX;
- the learner stages a sharded batch in one host-to-device copy;
- ``train(device="cpu")`` with ``replay_shards=2`` with thread actors and
  with process fleets.
"""
import os
import signal
import tempfile
import time

import numpy as np
import pytest
import torch

from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu.parallel import replay_net as jrn
from r2d2_tpu.parallel import replay_shards as jrs
from r2d2_tpu.replay import block as jblock
from r2d2_tpu.replay.replay_buffer import ReplayBuffer as JaxReplayBuffer
from r2d2_tpu_torch import train as ttrain
from r2d2_tpu_torch.checkpoint import Checkpointer
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.learner.learner import (
    DEVICE_BATCH_KEYS,
    PACKED_KEY,
    Learner,
)
from r2d2_tpu_torch.learner.step import create_train_state
from r2d2_tpu_torch.models.network import create_network
from r2d2_tpu_torch.parallel import replay_net as trn
from r2d2_tpu_torch.parallel import replay_shards as trs
from r2d2_tpu_torch.replay import block as tblock
from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer
from r2d2_tpu_torch.utils.chaos import ChaosInjector
from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS

A = 4
ROW_FIELDS = ("obs", "last_action", "last_reward", "hidden", "action",
              "n_step_reward", "n_step_gamma", "burn_in", "learning",
              "forward")


def make_cfg(pkg="torch", **kw):
    # burn_in=4, learning=4, forward=2 → T=10; block_length=8 → 2 seqs
    # per block; capacity 160 → 20 blocks, 40 leaves
    kw.setdefault("replay_shards", 2)
    kw.setdefault("replay_sample_timeout", 5.0)
    make = port_test_config if pkg == "torch" else jax_test_config
    return make(**kw)


def make_block(cfg, tag, priority, local_cls=tblock.LocalBuffer):
    """One full-length fresh-episode block whose sequences carry actor
    priority ``priority`` (leaf mass priority**alpha); ``local_cls``
    picks the package that cuts it (the blocks are bitwise equal)."""
    local = local_cls(cfg, A)
    local.reset(np.full(cfg.obs_shape, tag % 256, np.uint8))
    for s in range(cfg.block_length):
        obs = np.full(cfg.obs_shape, (tag + s + 1) % 256, np.uint8)
        q = np.arange(A, dtype=np.float32) + s
        hidden = np.full((2, cfg.lstm_layers, cfg.hidden_dim),
                         ((tag + s) % 100) / 100.0, np.float32)
        local.add(s % A, float(s), obs, q, hidden)
    block, _, ep = local.finish(None)
    prios = np.full(cfg.seqs_per_block, priority, np.float32)
    return block, prios, ep


FILL_WAIT_S = 120.0


def wait_until(pred, timeout=30.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def shards_up(plane) -> bool:
    """Every shard process has published its stats once (its event loop
    runs): over shm a stats-slab reading, over sockets a stats frame."""
    if hasattr(plane, "stats_slab"):
        return all(plane.stats_slab.read(s) is not None
                   for s in range(plane.K))
    return all(link is not None and link.take_stats() is not None
               for link in plane.links)


def fill_plane(plane, cfg, priorities_per_block,
               local_cls=tblock.LocalBuffer):
    # a block sent while a shard child is still starting can wait out the
    # plane's bounded send and be dropped (counted), as designed: add the
    # blocks once every shard serves
    assert wait_until(lambda: shards_up(plane), timeout=FILL_WAIT_S)
    for b, p in enumerate(priorities_per_block):
        block, prios, ep = make_block(cfg, 1000 * b, p, local_cls)
        plane.add(block, prios, episode_reward=ep)
    want = len(priorities_per_block) * cfg.block_length
    assert wait_until(
        lambda: plane.poll_shard_stats()["size_total"] >= want,
        timeout=FILL_WAIT_S), plane.poll_shard_stats()


def oracle_index(cfg, idxes):
    """Global sharded leaf index → the K = 1 oracle's leaf holding the
    same content (block n routes to shard n % K, local slot n // K)."""
    K, kseq = cfg.replay_shards, cfg.seqs_per_block
    lps = cfg.num_sequences // K
    shard, local = idxes // lps, idxes % lps
    return ((local // kseq) * K + shard) * kseq + local % kseq


# ------------------------------------------------------------- unit layer

MASSES = [
    np.array([3.0, 1.0, 0.0, 4.0]),
    np.array([1e6, 1e-3, 1e-3, 2.0]),      # one shard holds ~everything
    np.array([0.0, 0.0, 5.0, 0.0]),        # all mass on one shard
    np.array([1.0, 1.0]),
]


@pytest.mark.parametrize("m", range(len(MASSES)))
@pytest.mark.parametrize("batch", [1, 8, 64])
def test_allocate_strata_bitwise_vs_jax(m, batch):
    masses = MASSES[m]
    for seed in range(5):
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        want = jrs.allocate_strata(masses, batch, rj)
        got = trs.allocate_strata(masses, batch, rt)
        np.testing.assert_array_equal(got, want)
        assert got.sum() == batch and got[masses == 0].sum() == 0
        # the same stream consumed: the next draw agrees too
        assert rj.bit_generator.state == rt.bit_generator.state


def test_allocate_strata_proportional_and_refuses_zero_mass():
    rng = np.random.default_rng(0)
    masses = MASSES[0]
    total = np.zeros(4)
    for _ in range(400):
        total += trs.allocate_strata(masses, 8, rng)
    np.testing.assert_allclose(total / (8 * 400), masses / masses.sum(),
                               atol=0.02)
    for mod in (trs, jrs):
        with pytest.raises(ValueError, match="zero total mass"):
            mod.allocate_strata(np.zeros(2), 8, np.random.default_rng(0))


def test_batch_slot_spec_layout_equals_jax_and_sample_batch():
    """Names, shapes, dtypes and byte offsets of the sample slab equal the
    JAX package's, and the row fields mirror what ``sample_batch``
    assembles."""
    cfg, jcfg = make_cfg(replay_shards=1), make_cfg("jax", replay_shards=1)
    for B in (8, 64):
        tspec = tblock.batch_slot_spec(cfg, A, B)
        jspec = jblock.batch_slot_spec(jcfg, A, B)
        assert [(n, tuple(s), np.dtype(d)) for n, s, d in tspec] \
            == [(n, tuple(s), np.dtype(d)) for n, s, d in jspec]
        assert tblock.slot_layout(tspec) == jblock.slot_layout(jspec)
    assert tblock.BATCH_ROW_FIELDS == jblock.BATCH_ROW_FIELDS
    buf = ReplayBuffer(cfg, A, rng=np.random.default_rng(0))
    for b in range(4):
        buf.add(*make_block(cfg, b, 1.0))
    batch = buf.sample_batch(8)
    spec = {n: (s, np.dtype(d)) for n, s, d in
            tblock.batch_slot_spec(cfg, A, 8)}
    for name in ROW_FIELDS:
        assert (batch[name].shape, batch[name].dtype) == spec[name], name


def test_request_and_response_crcs_equal_jax():
    cfg = make_cfg(replay_shards=1)
    spec = tblock.batch_slot_spec(cfg, A, 8)
    nbytes, offsets = tblock.slot_layout(spec)
    raw = np.random.default_rng(3).integers(0, 256, nbytes, np.uint8)
    views = tblock.slot_views(raw.data, spec, offsets, nbytes, 0)
    for n in (1, 3, 8):
        views["req_n"][0] = n
        views["rsp_n"][0] = n
        for seq in (1, 7, 2 ** 40):
            assert trs.sample_request_crc(views, seq) \
                == jrs.sample_request_crc(views, seq)
            assert trs.sample_response_crc(views, seq) \
                == jrs.sample_response_crc(views, seq)
    # an empty answer (a shard drained under a stale mass vector): its
    # zero-row arrays add no bytes in the port, where the JAX package's
    # memoryview cast raises (ROADMAP.md C 9)
    views["rsp_n"][0] = 0
    assert trs.sample_response_crc(views, 4) == tblock.payload_crc32(
        (4, 0, int(views["rsp_block_ptr"][0]),
         int(views["rsp_env_steps"][0])), [])
    with pytest.raises(TypeError, match="zeros in shape"):
        jrs.sample_response_crc(views, 4)
    views["rsp_n"][0] = 8
    before = trs.sample_response_crc(views, 5)
    views["obs"][0].flat[0] ^= 0xFF
    assert trs.sample_response_crc(views, 5) != before


def _shard_buffers(n_blocks):
    """A port and a JAX shard-slice buffer with the shard RNG key, fed the
    same blocks."""
    cfg = make_cfg(replay_shards=1)
    jcfg = make_cfg("jax", replay_shards=1)
    tb = trs.ReplayBufferForShard(cfg, A, 1, 2)
    jb = jrs.ReplayBufferForShard(jcfg, A, 1, 2)
    for b in range(n_blocks):
        tb.add(*make_block(cfg, 100 * b, 0.5 + b))
        jb.add(*make_block(jcfg, 100 * b, 0.5 + b, jblock.LocalBuffer))
    return cfg, tb, jb


@pytest.mark.parametrize("with_out", [False, True])
def test_serve_sample_bitwise_vs_jax(with_out):
    """Same blocks, same (seed, 0x5A1D, shard, incarnation) RNG: the shard
    draw's rows, indices, raw priorities, FIFO pointer and env steps are
    the JAX package's bit for bit, written into a slab (``out=``) or not;
    an empty buffer answers None in both."""
    cfg, tb, jb = _shard_buffers(0)
    assert tb.serve_sample(4) is None and jb.serve_sample(4) is None
    cfg, tb, jb = _shard_buffers(6)
    spec = tblock.batch_slot_spec(cfg, A, cfg.batch_size)
    for n in (1, 5, cfg.batch_size, 3):
        outs = []
        for _ in (tb, jb):
            if with_out:
                slab = {name: np.zeros(shape, dtype)
                        for name, shape, dtype in spec}
                outs.append({name: slab[name][:n] for name in ROW_FIELDS})
            else:
                outs.append(None)
        got = tb.serve_sample(n, out=outs[0])
        want = jb.serve_sample(n, out=outs[1])
        rows_t, idx_t, pr_t, ptr_t, env_t, ages_t = got
        rows_j, idx_j, pr_j, ptr_j, env_j, ages_j = want
        np.testing.assert_array_equal(idx_t, idx_j)
        np.testing.assert_array_equal(pr_t, pr_j)
        assert (ptr_t, env_t) == (ptr_j, env_j)
        assert ages_t.shape == ages_j.shape == (n, 2)
        for name in ROW_FIELDS:
            np.testing.assert_array_equal(rows_t[name], rows_j[name], name)
            assert rows_t[name].dtype == rows_j[name].dtype, name
        if with_out:
            assert rows_t["obs"] is outs[0]["obs"]
        # the gather into out= equals the plain gather, bit for bit
        with tb.lock:
            plain = tb._gather_rows(idx_t)
        for name in ROW_FIELDS:
            np.testing.assert_array_equal(rows_t[name], plain[name], name)


def test_a_shard_child_imports_neither_torch_nor_jax():
    """What a spawned shard unpickles — both planes' modules and the
    numpy replay core — imports no torch and no JAX: the package inits
    export lazily, so a shard process can hold no CUDA context."""
    import subprocess
    import sys

    code = ("import sys; "
            "import r2d2_tpu_torch.parallel.replay_shards, "
            "r2d2_tpu_torch.parallel.replay_net, "
            "r2d2_tpu_torch.replay.replay_buffer; "
            "bad = [m for m in ('torch', 'jax') if m in sys.modules]; "
            "assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code],
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


# ------------------------------------------------- the plane vs JAX's plane

def test_k2_plane_bitwise_vs_jax_plane_and_snapshots_cross():
    """The port's K = 2 shm plane and the JAX K = 2 shm plane, fed the same
    blocks with the same seeds: every batch's rows, global indices, IS
    weights and feedback pointers agree bit for bit, and so do the shard
    masses after each round of priority feedback.  Then each plane writes
    its per-shard snapshot: a fresh port plane restores the JAX one, and
    the JAX ReplayBuffer reads the port's shards, both mass-exact."""
    cfg, jcfg = make_cfg(), make_cfg("jax")
    prios = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 0.5, 9.0]
    tp = trs.ShardedReplayPlane(cfg, A, rng=np.random.default_rng(11))
    jp = jrs.ShardedReplayPlane(jcfg, A, rng=np.random.default_rng(11))
    tp2 = None
    try:
        tp.start()
        jp.start()
        fill_plane(tp, cfg, prios)
        fill_plane(jp, jcfg, prios, jblock.LocalBuffer)
        fed = 0
        for rnd in range(3):
            np.testing.assert_array_equal(
                tp.poll_shard_stats()["masses"],
                jp.poll_shard_stats()["masses"])
            got, want = tp.sample_batch(8), jp.sample_batch(8)
            assert got is not None and want is not None
            for name in ROW_FIELDS + ("idxes", "is_weights"):
                np.testing.assert_array_equal(got[name], want[name], name)
                assert got[name].dtype == want[name].dtype, name
            assert got["block_ptr"] == want["block_ptr"]
            assert got["env_steps"] == want["env_steps"]
            new = np.linspace(0.25, 3.0 + rnd, 8)
            tp.update_priorities(got["idxes"], new, got["block_ptr"], 0.5)
            jp.update_priorities(want["idxes"], new, want["block_ptr"], 0.5)
            fed += len(got["block_ptr"])
            for p in (tp, jp):
                assert wait_until(lambda p=p: p.poll_shard_stats()[
                    "totals"].get("prio_updates", 0) >= fed)
        masses = tp.poll_shard_stats()["masses"]
        np.testing.assert_array_equal(masses,
                                      jp.poll_shard_stats()["masses"])

        with tempfile.TemporaryDirectory() as d:
            tpath, jpath = os.path.join(d, "t.bin"), os.path.join(d, "j.bin")
            tmeta, jmeta = tp.write_state(tpath), jp.write_state(jpath)
            # the JAX ReplayBuffer reads the port's shard payloads
            for s in range(2):
                jb = JaxReplayBuffer(jp.shard_cfg, A)
                jb.read_state(f"{tpath}.shard{s}", tmeta["shard_metas"][s])
                assert jb.tree.total == masses[s]
            # a fresh port plane restores the JAX snapshot
            tp2 = trs.ShardedReplayPlane(cfg, A)
            tp2.read_state(jpath, jmeta)
            tp2.start()
            assert wait_until(lambda: np.array_equal(
                tp2.poll_shard_stats()["masses"], masses)), (
                tp2.poll_shard_stats()["masses"], masses)
            assert tp2.env_steps == jp.env_steps
    finally:
        for p in (tp, jp, tp2):
            if p is not None:
                p.shutdown()


# ------------------------------------------------------ plane end-to-end

def test_roundtrip_mass_conservation_and_snapshot():
    """Ingest → sample → feedback on K = 2 against the K = 1 oracle fed
    the same stream: the shard masses sum to the oracle total, the rows
    are bit-exact to the oracle's gather for the same content, and the
    per-shard snapshot's leaf multiset equals the oracle's."""
    cfg = make_cfg()
    prios_per_block = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0]
    plane = trs.ShardedReplayPlane(cfg, A, rng=np.random.default_rng(0))
    plane.start()
    try:
        fill_plane(plane, cfg, prios_per_block)
        oracle = ReplayBuffer(cfg.replace(replay_shards=1), A,
                              rng=np.random.default_rng(0))
        for b, p in enumerate(prios_per_block):
            oracle.add(*make_block(cfg, 1000 * b, p))
        st = plane.poll_shard_stats()
        assert np.isclose(st["mass_total"], oracle.tree.total, rtol=1e-12)

        batch = plane.sample_batch(8)
        assert batch is not None and batch["idxes"].shape == (8,)
        oidx = oracle_index(cfg, batch["idxes"])
        with oracle.lock:
            want_rows = oracle._gather_rows(oidx)
        for name, arr in want_rows.items():
            np.testing.assert_array_equal(batch[name], arr, err_msg=name)
        new_prios = np.linspace(0.5, 4.0, 8)
        plane.update_priorities(batch["idxes"], new_prios,
                                batch["block_ptr"], loss=0.25)
        oracle.update_priorities(oidx, new_prios, oracle.block_ptr,
                                 loss=0.25)
        assert wait_until(lambda: plane.poll_shard_stats()["totals"].get(
            "prio_updates", 0) >= 2)
        assert np.isclose(plane.poll_shard_stats()["mass_total"],
                          oracle.tree.total, rtol=1e-12)
        s = plane.stats()
        assert s["training_steps"] == 1 and s["sum_loss"] == 0.25
        assert s["shard_respawns"] == 0

        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "ring.bin")
            meta = plane.write_state(path)
            assert meta["kind"] == "sharded" and meta["shards"] == 2
            leaves = []
            for sh in range(2):
                shard_buf = ReplayBuffer(plane.shard_cfg, A)
                shard_buf.read_state(f"{path}.shard{sh}",
                                     meta["shard_metas"][sh])
                leaves.append(shard_buf.tree.leaf_values())
            np.testing.assert_array_equal(
                np.sort(np.concatenate(leaves)),
                np.sort(oracle.tree.leaf_values()))
    finally:
        plane.shutdown()


def test_cross_shard_draw_is_distribution_correct_under_skew():
    """One shard holds ~all the priority mass; the cross-shard stratified
    draw still matches the exact K = 1 marginal B·p/M (total variation
    under 0.05 over 250 draws)."""
    cfg = make_cfg()
    prios_per_block = [50.0 if b % 2 == 0 else 1e-3 for b in range(8)]
    K, kseq = cfg.replay_shards, cfg.seqs_per_block
    lps = cfg.num_sequences // K
    expected = np.zeros(cfg.num_sequences)
    for n, p in enumerate(prios_per_block):
        lo = (n % K) * lps + (n // K) * kseq
        expected[lo:lo + kseq] = (np.float64(np.float32(p))
                                  ** cfg.prio_exponent)
    expected /= expected.sum()
    plane = trs.ShardedReplayPlane(cfg, A, rng=np.random.default_rng(1))
    plane.start()
    try:
        fill_plane(plane, cfg, prios_per_block)
        share = plane.poll_shard_stats()["masses"]
        assert share[0] / share.sum() > 0.99
        counts = np.zeros(cfg.num_sequences)
        for _ in range(250):
            counts[plane.sample_batch(8)["idxes"]] += 1
    finally:
        plane.shutdown()
    tv = 0.5 * np.abs(counts / counts.sum() - expected).sum()
    assert tv < 0.05, (tv, counts, expected)


def test_stalled_shard_redistributes_within_deadline():
    """SIGSTOP one shard: the sample deadline fires and its rows move to
    the other shard's mass — a full batch, counted as a timeout and
    redraws; after SIGCONT the shard serves again."""
    cfg = make_cfg(replay_sample_timeout=0.5)
    plane = trs.ShardedReplayPlane(cfg, A, rng=np.random.default_rng(4))
    plane.start()
    try:
        fill_plane(plane, cfg, [1.0] * 8)
        os.kill(plane.procs[0].pid, signal.SIGSTOP)
        try:
            t0 = time.time()
            batch = plane.sample_batch(8)
            elapsed = time.time() - t0
        finally:
            os.kill(plane.procs[0].pid, signal.SIGCONT)
        assert batch is not None and batch["idxes"].shape == (8,)
        lps = cfg.num_sequences // cfg.replay_shards
        assert (batch["idxes"] // lps == 1).all()
        assert plane.sample_timeouts >= 1 and plane.redraws >= 1
        assert elapsed < 4 * cfg.replay_sample_timeout + 2.0
        assert wait_until(lambda: plane.sample_batch(8) is not None, 10.0)
        assert plane.health()["degraded"] is False
    finally:
        plane.shutdown()


def _pause(procs, sig):
    """Send ``sig`` (SIGSTOP or SIGCONT) to every shard process and wait
    until each one's state says it took effect."""
    for p in procs:
        os.kill(p.pid, sig)
    want_stopped = sig == signal.SIGSTOP
    for p in procs:
        def settled():
            with open(f"/proc/{p.pid}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
            return (state in ("T", "t")) == want_stopped
        assert wait_until(settled), (p.pid, sig)


@pytest.mark.parametrize("transport", ["shm", "socket"])
def test_a_draw_cut_by_the_stop_counts_apart_from_timeouts(transport):
    """A draw the fabric's stop cuts (ROADMAP C 10): the JAX package's
    plane counts it as K sample timeouts and B redraws that no shard
    caused; the port's counts K sample stops and neither.  Both return no
    batch, and the next draw is whole.

    Every shard has answered (the fill waits on each one's published
    stats) and is then paused for the stop-cut draw, so no response can
    land between the draw's issue and its first wait: the counts do not
    depend on how the host schedules the shard processes (ROADMAP C 15)."""
    counts = {}
    for pkg, mod in (("jax", jrs if transport == "shm" else jrn),
                     ("torch", trs if transport == "shm" else trn)):
        cfg = make_cfg(pkg, replay_transport=transport)
        cls = (mod.ShardedReplayPlane if transport == "shm"
               else mod.NetShardedReplayPlane)
        plane = cls(cfg, A, rng=np.random.default_rng(8))
        plane.start()
        try:
            fill_plane(plane, cfg, [1.0, 2.0, 3.0, 4.0],
                       jblock.LocalBuffer if pkg == "jax"
                       else tblock.LocalBuffer)
            _pause(plane.procs, signal.SIGSTOP)
            try:
                assert plane.sample_batch(8, stop=lambda: True) is None
            finally:
                _pause(plane.procs, signal.SIGCONT)
            counts[pkg] = dict(
                timeouts=plane.sample_timeouts, redraws=plane.redraws,
                stops=getattr(plane, "sample_stops", None))
            if pkg == "torch":
                assert plane.health()["sample_stops"] == 2
            assert plane.sample_batch(8) is not None
        finally:
            plane.shutdown()
    assert counts["jax"] == dict(timeouts=2, redraws=8, stops=None)
    assert counts["torch"] == dict(timeouts=0, redraws=0, stops=2)


def test_garbled_sample_response_is_retried():
    """``garble_sample_response`` flips response bytes after the shard's
    CRC: the receipt check catches each one and the bounded retry still
    assembles full batches."""
    cfg = make_cfg()
    plane = trs.ShardedReplayPlane(cfg, A, rng=np.random.default_rng(5))
    plane.chaos = ChaosInjector("garble_sample_response:every=3", seed=7)
    plane.start()
    try:
        fill_plane(plane, cfg, [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0])
        for _ in range(6):
            batch = plane.sample_batch(8)
            assert batch is not None and batch["idxes"].shape == (8,)
        assert plane.garbled_responses >= 1 and plane.sample_retries >= 1
    finally:
        plane.shutdown()


@pytest.mark.slow
def test_respawn_with_restore_is_mass_exact_and_drops_stale_feedback():
    """Kill a shard: the watchdog respawns it restored from the latest
    committed replay snapshot (mass-exact), and feedback sampled before
    the kill is dropped (generation tag)."""
    cfg = make_cfg(replay_sample_timeout=2.0)
    plane = trs.ShardedReplayPlane(cfg, A, rng=np.random.default_rng(3))
    plane.start()
    try:
        fill_plane(plane, cfg, [4.0, 1.0, 2.0, 3.0, 5.0, 2.5, 1.5, 0.5])
        pre = plane.poll_shard_stats()
        with tempfile.TemporaryDirectory() as d:
            ck = Checkpointer(d)
            ck.save_replay(0, plane.write_state)
            plane.checkpointer = ck
            batch = plane.sample_batch(8)
            assert batch is not None
            plane.procs[0].kill()
            assert wait_until(lambda: not plane.procs[0].is_alive(), 10.0)
            assert plane.watch_once() == 1 and plane.restarts[0] == 1
            plane.update_priorities(batch["idxes"], np.ones(8),
                                    batch["block_ptr"], loss=0.0)
            lps = cfg.num_sequences // cfg.replay_shards
            assert plane.stale_feedback == int(
                (batch["idxes"] // lps == 0).sum())
            assert wait_until(lambda: plane.poll_shard_stats()["masses"][0]
                              == pre["masses"][0], 40.0)
            assert plane.stats()["shard_respawns"] == 1
            b2 = plane.sample_batch(8)
            assert b2 is not None and b2["idxes"].shape == (8,)
    finally:
        plane.shutdown()


# ---------------------------------------------------------- learner layer

def test_learner_stages_a_sharded_batch_in_one_copy():
    """A plane's batch carries its device fields in one packed host buffer:
    the learner moves it in ONE copy (``learner.batch_h2d``) where an
    unpacked batch takes one per field, and both give the same step."""
    cfg = make_cfg(prefetch_batches=0, superstep_pipeline=0)
    plane = trs.ShardedReplayPlane(cfg, A, rng=np.random.default_rng(6))
    plane.start()
    try:
        fill_plane(plane, cfg, [1.0, 2.0, 3.0, 4.0])
        batch = plane.sample_batch(cfg.batch_size)
    finally:
        plane.shutdown()
    host, layout = batch[PACKED_KEY]
    assert isinstance(host, torch.Tensor) and host.dtype == torch.uint8
    assert {name for name, *_ in layout} == set(DEVICE_BATCH_KEYS)
    plain = {k: (np.array(v) if isinstance(v, np.ndarray) else v)
             for k, v in batch.items() if k != PACKED_KEY}

    def one_step(b):
        net = create_network(cfg, A, device="cpu",
                             generator=torch.Generator().manual_seed(0))
        learner = Learner(cfg, net, create_train_state(cfg, net.state_dict()))
        before = HOST_TRANSFERS.get("learner.batch_h2d")
        got = []
        learner.run(lambda: b, lambda i, p, o, loss: got.append((p, loss)),
                    max_steps=1)
        return HOST_TRANSFERS.get("learner.batch_h2d") - before, got[0]

    n_packed, (p_packed, l_packed) = one_step(batch)
    n_plain, (p_plain, l_plain) = one_step(plain)
    assert (n_packed, n_plain) == (1, len(DEVICE_BATCH_KEYS))
    assert l_packed == l_plain
    np.testing.assert_array_equal(p_packed, p_plain)


# --------------------------------------------------------- train() layer

def cpu_config(**kw):
    kw.setdefault("log_interval", 0.5)
    return port_test_config(game_name="Fake", act_device="cpu",
                            replay_shards=2, learning_starts=16,
                            telemetry_port=-1, **kw)


def test_train_sharded_on_the_cpu(tmp_path):
    """``train(device="cpu")`` over two shm shards: every update's
    feedback reaches the plane, both shards hold experience, /healthz says
    ok with the replay_shards block, the log entry carries the plane's
    health, and the drain-then-save exit writes a sharded snapshot."""
    m = ttrain.train(cpu_config(training_steps=12),
                     checkpoint_dir=str(tmp_path), verbose=False,
                     device="cpu", max_wall_seconds=120)
    assert m["num_updates"] == 12 and not m["fabric_failed"]
    assert m["buffer_training_steps"] == m["num_updates"]
    rh = m["replay_shard_health"]
    assert rh["shards"] == 2 and rh["respawns"] == [0, 0]
    assert all(x > 0 for x in rh["sizes"]) and rh["dropped_blocks"] == 0
    assert rh["sample_timeouts"] == 0 and rh["garbled_responses"] == 0
    hz = m["healthz"]
    assert hz["status"] == "ok" and hz["replay_shards"]["alive"] == 2
    assert m["logs"] and m["logs"][-1]["replay_shards"]["shards"] == 2
    meta = Checkpointer(str(tmp_path)).restore_replay()[0]
    assert meta["kind"] == "sharded" and meta["shards"] == 2


def test_train_sharded_with_process_fleets():
    """``actor_transport="process"`` routes the fleets' blocks into the
    sharded plane's ``add``: the learner trains from both shards."""
    m = ttrain.train(cpu_config(training_steps=6, actor_transport="process",
                                num_actors=4, actor_fleets=2),
                     verbose=False, device="cpu", max_wall_seconds=180)
    assert m["num_updates"] == 6 and not m["fabric_failed"]
    rh = m["replay_shard_health"]
    assert rh["blocks_routed"] > 0 and all(x > 0 for x in rh["sizes"])
    assert m["fleet_health"]["blocks_ingested"] == rh["blocks_routed"]
    assert m["healthz"]["status"] == "ok"


@pytest.mark.slow
@pytest.mark.chaos
def test_train_sharded_with_chaos_kill_and_garble(tmp_path):
    """A sharded train() round with ``kill_replay_shard`` and
    ``garble_sample_response`` armed: no learner stall, the watchdog
    respawns the shard, every garbled response retried, every update's
    feedback reaches the plane."""
    cfg = cpu_config(training_steps=40, replay_sample_timeout=1.0,
                     learner_stall_timeout=30.0,
                     chaos_spec=("kill_replay_shard:at=4;"
                                 "garble_sample_response:every=5,"
                                 "n=1000000"))
    m = ttrain.train(cfg, checkpoint_dir=str(tmp_path), verbose=False,
                     device="cpu", max_wall_seconds=120)
    assert m["num_updates"] > 0
    assert not m["learner_stalled"] and not m["fabric_failed"]
    rh = m["replay_shard_health"]
    assert m["chaos"].get("kill_replay_shard", 0) == 1
    assert sum(rh["respawns"]) >= 1 and rh["alive"] == 2
    assert rh["garbled_responses"] >= 1
    assert m["buffer_training_steps"] == m["num_updates"]


@pytest.mark.slow
def test_train_sharded_resume_restores_every_shard(tmp_path):
    """Drain-then-save, then resume: every shard comes back warm, and a
    fresh plane restoring the latest snapshot reproduces each shard's
    recorded tree mass exactly."""
    cfg = cpu_config(training_steps=2000, log_interval=1.0,
                     save_interval=50)
    m1 = ttrain.train(cfg, checkpoint_dir=str(tmp_path), verbose=False,
                      device="cpu", max_wall_seconds=30)
    assert m1["num_updates"] > 0
    m2 = ttrain.train(cfg, checkpoint_dir=str(tmp_path), resume=True,
                      verbose=False, device="cpu", max_wall_seconds=20)
    assert m2["restored_replay"] and m2["num_updates"] > 0
    meta, ring, _ = Checkpointer(str(tmp_path)).restore_replay()
    saved = [sm["tree_total"] for sm in meta["shard_metas"]]
    plane = trs.ShardedReplayPlane(cfg, A)
    plane.read_state(ring, meta)
    plane.start()
    try:
        assert wait_until(lambda: np.array_equal(
            plane.poll_shard_stats()["masses"], saved), 40.0)
    finally:
        plane.shutdown()
