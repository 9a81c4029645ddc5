"""The port's cross-host replay fabric (replay/netwire.py,
parallel/replay_net.py) on the CPU, against the JAX package's where the
two must agree.

- bitwise against the JAX package: every ``NMSG_*`` frame, encoded by
  each package and decoded by the other (bytes equal), the derived specs,
  ``layout_token`` and ``max_net_frame_bytes``;
- live across the packages, in attach mode with the shard servers on
  threads: JAX servers answer the port's coordinator and port servers the
  JAX coordinator, and all four pairings draw the same batches and reach
  the same masses, bit for bit;
- both ends of a link set ``TCP_NODELAY`` (ROADMAP.md C 8);
- the fabric's own claims, as tests/test_replay_net.py holds the JAX one
  to them: rows bit-exact to the K = 1 oracle with mass conserved, the
  partition, SIGSTOP and half-open drills, garbled frames retried, a
  killed shard respawned restored over the sockets with zero stale
  feedback, a drifted geometry refused at the handshake;
- ``train(device="cpu")`` over managed loopback shard servers.
"""
import json
import os
import signal
import socket
import tempfile
import threading
import time

import numpy as np
import pytest

from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu.parallel import replay_net as jrn
from r2d2_tpu.replay import block as jblock
from r2d2_tpu.replay import netwire as jnw
from r2d2_tpu.serving import wire as jwire
from r2d2_tpu_torch import train as ttrain
from r2d2_tpu_torch.checkpoint import Checkpointer
from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.parallel import replay_net as trn
from r2d2_tpu_torch.parallel import replay_shards as trs
from r2d2_tpu_torch.replay import block as tblock
from r2d2_tpu_torch.replay import netwire as tnw
from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer
from r2d2_tpu_torch.serving import wire as twire
from r2d2_tpu_torch.utils.chaos import ChaosInjector

A = 4
ROW_FIELDS = ("obs", "last_action", "last_reward", "hidden", "action",
              "n_step_reward", "n_step_gamma", "burn_in", "learning",
              "forward")
PKG = dict(torch=(port_test_config, trn, tblock.LocalBuffer),
           jax=(jax_test_config, jrn, jblock.LocalBuffer))


def make_cfg(pkg="torch", **kw):
    kw.setdefault("replay_shards", 2)
    kw.setdefault("replay_transport", "socket")
    kw.setdefault("replay_sample_timeout", 5.0)
    return PKG[pkg][0](**kw)


def make_block(cfg, tag, priority, local_cls=tblock.LocalBuffer):
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


def wait_until(pred, timeout=30.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def fill_plane(plane, cfg, priorities_per_block,
               local_cls=tblock.LocalBuffer):
    for b, p in enumerate(priorities_per_block):
        block, prios, ep = make_block(cfg, 1000 * b, p, local_cls)
        plane.add(block, prios, episode_reward=ep)
    want = len(priorities_per_block) * cfg.block_length
    assert wait_until(
        lambda: plane.poll_shard_stats()["size_total"] >= want), \
        plane.poll_shard_stats()


def oracle_index(cfg, idxes):
    K, kseq = cfg.replay_shards, cfg.seqs_per_block
    lps = cfg.num_sequences // K
    shard, local = idxes // lps, idxes % lps
    return ((local // kseq) * K + shard) * kseq + local % kseq


class ThreadServers:
    """K shard servers of one package pumped by threads in this process
    (the attach-mode deployment); stopped, joined and closed with bounded
    waits by :meth:`close`."""

    def __init__(self, pkg, cfg, epochs=(100, 101)):
        mod = PKG[pkg][1]
        scfg = mod.shard_slice_config(cfg)
        self.servers = [mod.ShardServer(scfg, A, s, epoch=epochs[s])
                        for s in range(cfg.replay_shards)]
        self._stop = False
        self.threads = [threading.Thread(
            target=srv.serve_forever, args=(lambda: self._stop,),
            daemon=True) for srv in self.servers]
        for t in self.threads:
            t.start()

    @property
    def hosts(self) -> str:
        return ",".join(f"127.0.0.1:{srv.port}" for srv in self.servers)

    def close(self) -> None:
        self._stop = True
        for t in self.threads:
            t.join(10.0)
        for srv in self.servers:
            srv.close()
        assert not any(t.is_alive() for t in self.threads)


# ------------------------------------------------------------- wire layer

def _fields(spec, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape, dtype in spec:
        if np.issubdtype(np.dtype(dtype), np.floating):
            out[name] = rng.normal(size=shape).astype(dtype)
        else:
            out[name] = rng.integers(0, 100, shape).astype(dtype)
    return out


def _frame_case(mod, nw, cfg, kind):
    """(spec, header, fields) of one frame of ``kind`` in package ``mod``."""
    B = cfg.batch_size
    specs = dict(
        HELLO=nw.net_hello_spec(), WELCOME=(), SAMPLE_REQ=(),
        INGEST=nw.net_ingest_spec(cfg, A),
        SAMPLE_RSP=nw.net_sample_response_spec(cfg, A, B),
        PRIO=nw.net_feedback_spec(B),
        STATS=nw.net_stats_spec(len(mod.NET_STAT_FIELDS)),
        SAVE=nw.net_save_spec(), SAVE_RSP=nw.net_save_response_spec())
    spec = specs[kind]
    fields = _fields(spec, 7)
    if kind == "SAVE":
        nw.put_str(fields, "save_path", "save_path_len", "/x/ring.bin.shard1")
    if kind == "SAVE_RSP":
        nw.put_json(fields, "meta_json", "meta_len",
                    dict(layout=[1, 2], tree_total=3.5))
    header = (getattr(nw, f"NMSG_{kind}"), 3, 11, 1)
    return spec, header, (fields if spec else None)


KINDS = ("HELLO", "WELCOME", "INGEST", "SAMPLE_REQ", "SAMPLE_RSP", "PRIO",
         "STATS", "SAVE", "SAVE_RSP")


@pytest.mark.parametrize("kind", KINDS)
def test_every_frame_crosses_the_packages_bitwise(kind):
    """Each package encodes the same frame to the same bytes, and decodes
    the other's: header and every payload array equal, strings and JSON
    read back."""
    tcfg = trn.shard_slice_config(make_cfg())
    jcfg = jrn.shard_slice_config(make_cfg("jax"))
    tspec, theader, tfields = _frame_case(trn, tnw, tcfg, kind)
    jspec, jheader, jfields = _frame_case(jrn, jnw, jcfg, kind)
    assert theader[0] == jheader[0] == KINDS.index(kind) + 16
    tframe = twire.encode_frame(tspec, theader, tfields)
    jframe = jwire.encode_frame(jspec, jheader, jfields)
    assert tframe == jframe
    for dec, spec, other in ((twire.decode_frame, tspec, jframe),
                             (jwire.decode_frame, jspec, tframe)):
        header, views = dec(spec, other[4:])
        assert tuple(header) == theader
        for name, _, _ in spec:
            np.testing.assert_array_equal(views[name], tfields[name], name)
    if kind == "SAVE":
        _, views = jwire.decode_frame(jspec, tframe[4:])
        assert tnw.get_str(views, "save_path", "save_path_len") \
            == jnw.get_str(views, "save_path", "save_path_len") \
            == "/x/ring.bin.shard1"
    if kind == "SAVE_RSP":
        _, views = twire.decode_frame(tspec, jframe[4:])
        assert tnw.get_json(views, "meta_json", "meta_len") \
            == dict(layout=[1, 2], tree_total=3.5)
    garbled = bytearray(tframe[4:])
    garbled[len(garbled) // 2] ^= 0xFF
    with pytest.raises(twire.WireGarbled):
        twire.decode_frame(tspec, bytes(garbled))


@pytest.mark.parametrize("which", ["test", "flagship"])
def test_specs_token_and_frame_bound_equal_jax(which):
    """The derived specs, the handshake's geometry token and the frame
    bound are the JAX package's for the test geometry and the flagship's
    (K = 4 and nine actions: a 38 897 528-byte bound, the B = 64 sample
    response)."""
    if which == "test":
        tcfg, jcfg = make_cfg(), make_cfg("jax")
    else:
        from r2d2_tpu.config import Config as JaxConfig

        tcfg = Config(game_name="Fake", replay_shards=4)
        jcfg = JaxConfig(game_name="Fake", replay_shards=4)
    tcfg, jcfg = trn.shard_slice_config(tcfg), jrn.shard_slice_config(jcfg)

    def norm(spec):
        return [(n, tuple(s), np.dtype(d)) for n, s, d in spec]

    for fn, args in (("net_ingest_spec", (A,)),
                     ("net_sample_response_spec", (A, tcfg.batch_size))):
        assert norm(getattr(tnw, fn)(tcfg, *args)) \
            == norm(getattr(jnw, fn)(jcfg, *args))
    assert tnw.layout_token(tcfg, A) == jnw.layout_token(jcfg, A)
    assert tnw.layout_token(tcfg, A) != tnw.layout_token(tcfg, A + 1)
    assert tnw.max_net_frame_bytes(tcfg, A) == jnw.max_net_frame_bytes(
        jcfg, A)
    if which == "flagship":
        # nine actions, as the served flagship has
        assert tnw.max_net_frame_bytes(tcfg, 9) == 38_897_528
    assert trn.NET_STAT_FIELDS == jrn.NET_STAT_FIELDS
    assert trs.SHARD_STAT_FIELDS == jrn.SHARD_STAT_FIELDS


# ----------------------------------------------- live, across the packages

PAIRINGS = [("torch", "torch"), ("jax", "torch"), ("torch", "jax"),
            ("jax", "jax")]


def test_attach_mode_across_the_packages_is_bitwise():
    """Shard servers on threads, the coordinator in attach mode, in all
    four (server package, coordinator package) pairings, fed the same
    blocks with the same seeds: every pairing draws the same batches
    (rows, global indices, IS weights) and reaches the same shard masses
    after feedback, bit for bit; rows equal the K = 1 oracle's gather and
    the mass sum its tree total; attach mode refuses a ring resume (remote
    shards restore from their own snapshots) and has nothing to respawn."""
    prios = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0]
    results = []
    for srv_pkg, plane_pkg in PAIRINGS:
        cfg = make_cfg(plane_pkg)
        servers = ThreadServers(srv_pkg, make_cfg(srv_pkg))
        mod, local_cls = PKG[plane_pkg][1], PKG[plane_pkg][2]
        plane = mod.NetShardedReplayPlane(
            cfg.replace(replay_hosts=servers.hosts), A,
            rng=np.random.default_rng(0))
        draws = []
        try:
            plane.start()
            assert not plane.managed and plane.links[0].epoch == 100
            fill_plane(plane, cfg, prios, local_cls)
            for rnd in range(3):
                b = plane.sample_batch(8)
                assert b is not None
                draws.append({k: np.array(b[k]) for k in
                              ROW_FIELDS + ("idxes", "is_weights")})
                plane.update_priorities(b["idxes"],
                                        np.linspace(0.5, 2.0 + rnd, 8),
                                        b["block_ptr"], loss=0.25)
                n_fb = (rnd + 1) * 2
                assert wait_until(lambda: plane.poll_shard_stats()[
                    "totals"].get("prio_updates", 0) >= n_fb)
            masses = plane.poll_shard_stats()["masses"]
            with pytest.raises(ValueError, match="host-local"):
                plane.read_state("x", dict(kind="sharded", shards=2))
            assert plane.watch_once() == 0
        finally:
            plane.shutdown()
            servers.close()
        results.append((draws, masses))

    draws0, masses0 = results[0]
    for (draws, masses), pairing in zip(results[1:], PAIRINGS[1:]):
        for d0, d in zip(draws0, draws):
            for k in d0:
                np.testing.assert_array_equal(d[k], d0[k],
                                              err_msg=f"{pairing} {k}")
        np.testing.assert_array_equal(masses, masses0, err_msg=pairing)

    # the first draw against the K = 1 oracle fed the same stream
    cfg = make_cfg()
    oracle = ReplayBuffer(cfg.replace(replay_shards=1,
                                      replay_transport="shm"), A,
                          rng=np.random.default_rng(0))
    for b, p in enumerate(prios):
        oracle.add(*make_block(cfg, 1000 * b, p))
    with oracle.lock:
        want = oracle._gather_rows(oracle_index(cfg, draws0[0]["idxes"]))
    for name in ROW_FIELDS:
        np.testing.assert_array_equal(draws0[0][name], want[name], name)


def test_both_ends_of_a_replay_link_set_tcp_nodelay():
    """``_tune_socket`` sets TCP_NODELAY: the server's accepted connection
    and the coordinator's socket both carry it (the reference sets
    neither; ROADMAP.md C 8 has the round trip it costs)."""
    cfg = make_cfg()
    servers = ThreadServers("torch", cfg)
    plane = trn.NetShardedReplayPlane(cfg.replace(replay_hosts=servers.hosts),
                                      A)
    try:
        plane.start()
        assert wait_until(lambda: all(
            lk.connected and srv.conn is not None
            for lk, srv in zip(plane.links, servers.servers)))
        for lk, srv in zip(plane.links, servers.servers):
            for sock in (lk.sock, srv.conn):
                assert sock.getsockopt(socket.IPPROTO_TCP,
                                       socket.TCP_NODELAY) != 0
    finally:
        plane.shutdown()
        servers.close()


# ------------------------------------------------------ plane end-to-end

def test_socket_parity_bit_exact_rows_and_mass_conservation():
    """Ingest → sample → feedback over managed loopback servers against
    the K = 1 oracle: rows bit-exact, mass conserved, the next draw
    already in flight, the per-shard snapshot's leaves equal to the
    oracle's, shard-side feedback batching live."""
    cfg = make_cfg()
    prios_per_block = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0]
    plane = trn.NetShardedReplayPlane(cfg, A, rng=np.random.default_rng(0))
    plane.start()
    try:
        fill_plane(plane, cfg, prios_per_block)
        oracle = ReplayBuffer(cfg.replace(replay_shards=1,
                                          replay_transport="shm"), A,
                              rng=np.random.default_rng(0))
        for b, p in enumerate(prios_per_block):
            oracle.add(*make_block(cfg, 1000 * b, p))
        assert np.isclose(plane.poll_shard_stats()["mass_total"],
                          oracle.tree.total, rtol=1e-12)
        batch = plane.sample_batch(8)
        assert batch is not None and batch["idxes"].shape == (8,)
        assert plane._pending_draw is not None
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
        assert plane.health()["net"]["prio_batches"] >= 1
    finally:
        plane.shutdown()


def test_partitioned_link_redistributes_drops_ingest_and_heals():
    """A blackholed link's mass leaves the gossiped view, its strata move
    to the survivor, ingest routed to it drops with a count, and after the
    heal both shards serve again."""
    cfg = make_cfg(replay_sample_timeout=1.0)
    plane = trn.NetShardedReplayPlane(cfg, A, rng=np.random.default_rng(2))
    plane.start()
    lps = cfg.num_sequences // cfg.replay_shards
    try:
        fill_plane(plane, cfg, [1.0] * 8)
        assert plane.sample_batch(8) is not None
        plane.links[0].partition_for(4.5)
        assert wait_until(lambda: not plane.links[0].stats_fresh(), 10.0)

        def survivor_only():
            b = plane.sample_batch(8)
            return b is not None and (b["idxes"] // lps == 1).all()
        assert wait_until(survivor_only, 2.2, interval=0.01)
        drops0 = plane.dropped_blocks
        for b in range(4):
            plane.add(*make_block(cfg, 9000 + b, 1.0))
        assert plane.dropped_blocks >= drops0 + 2
        assert plane.health()["degraded"]
        assert wait_until(lambda: plane.links[0].stats_fresh(), 15.0)

        def both_serve():
            b = plane.sample_batch(8)
            return b is not None and len(np.unique(b["idxes"] // lps)) == 2
        assert wait_until(both_serve, 15.0)
        assert plane.health()["net"]["partitions"] == 0
    finally:
        plane.shutdown()


def test_sigstop_then_half_open_redistribute_and_recover():
    """SIGSTOP a managed server: the deadline fires and its rows move to
    the survivor; after SIGCONT both serve.  Then half-open the recovered
    link: lost requests time out and redistribute, and after the window
    both serve again."""
    cfg = make_cfg(replay_sample_timeout=0.5, replay_net_cooldown=0.5)
    plane = trn.NetShardedReplayPlane(cfg, A, rng=np.random.default_rng(4))
    plane.start()
    lps = cfg.num_sequences // cfg.replay_shards
    try:
        fill_plane(plane, cfg, [1.0] * 8)
        os.kill(plane.procs[0].pid, signal.SIGSTOP)
        try:
            t0 = time.time()
            batch = plane.sample_batch(8) or plane.sample_batch(8)
            elapsed = time.time() - t0
        finally:
            os.kill(plane.procs[0].pid, signal.SIGCONT)
        assert batch is not None and (batch["idxes"] // lps == 1).all()
        assert plane.sample_timeouts + plane.redraws >= 1
        assert elapsed < 8 * cfg.replay_sample_timeout + 4.0

        def both_serve():
            b = plane.sample_batch(8)
            return b is not None and len(np.unique(b["idxes"] // lps)) == 2
        assert wait_until(both_serve, 15.0)
        timeouts0 = plane.sample_timeouts
        plane.links[0].half_open_for(1.5)

        def survivor_only():
            b = plane.sample_batch(8)
            return b is not None and (b["idxes"] // lps == 1).all()
        assert wait_until(survivor_only, 5.0, interval=0.01)
        assert plane.sample_timeouts > timeouts0
        assert wait_until(both_serve, 20.0)
    finally:
        plane.shutdown()


def test_garbled_net_frames_are_caught_and_retried():
    """``garble_net_frame`` flips received bytes ahead of decode: the
    frame CRC catches them and the bounded retry still assembles full
    batches."""
    cfg = make_cfg()
    plane = trn.NetShardedReplayPlane(cfg, A, rng=np.random.default_rng(5))
    plane.chaos = ChaosInjector("garble_net_frame:every=15", seed=7)
    plane.start()
    try:
        fill_plane(plane, cfg, [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0])
        got = 0
        for _ in range(8):
            batch = plane.sample_batch(8)
            if batch is not None:
                got += 1
                assert batch["idxes"].shape == (8,)
        assert got >= 5
        h = plane.health()
        assert (sum(row["garbled"] for row in h["net"]["links"])
                + h["net"]["shard_garbled"]) >= 1
    finally:
        plane.shutdown()


def test_kill_respawn_over_sockets_mass_exact_zero_stale_feedback():
    """Kill a managed server: the watchdog respawns it restored from the
    latest snapshot, the link re-attaches under a new epoch, feedback
    sampled before the kill applies zero rows to the restored ring, and
    its leaves equal the snapshot's."""
    cfg = make_cfg(replay_sample_timeout=2.0)
    plane = trn.NetShardedReplayPlane(cfg, A, rng=np.random.default_rng(3))
    plane.start()
    try:
        fill_plane(plane, cfg, [4.0, 1.0, 2.0, 3.0, 5.0, 2.5, 1.5, 0.5])
        pre = plane.poll_shard_stats()
        with tempfile.TemporaryDirectory() as d:
            ck = Checkpointer(d)
            ck.save_replay(0, plane.write_state)
            plane.checkpointer = ck
            snap_meta, snap_ring, _ = ck.restore_replay()
            batch = plane.sample_batch(8)
            assert batch is not None
            epoch_before = plane.links[0].epoch
            plane.procs[0].kill()
            assert wait_until(lambda: not plane.procs[0].is_alive(), 10.0)
            assert plane.watch_once() == 1 and plane.restarts[0] == 1
            plane.update_priorities(batch["idxes"], np.ones(8),
                                    batch["block_ptr"], loss=0.0)
            lps = cfg.num_sequences // cfg.replay_shards
            assert plane.stale_feedback == int(
                (batch["idxes"] // lps == 0).sum())
            assert wait_until(lambda: plane.links[0].connected, 30.0)
            assert plane.links[0].epoch != epoch_before
            assert wait_until(lambda: plane.poll_shard_stats()["masses"][0]
                              == pre["masses"][0], 40.0)
            assert plane.stats()["shard_respawns"] == 1
            path2 = os.path.join(d, "ring2.bin")
            meta2 = plane.write_state(path2)
            got, want = (ReplayBuffer(plane.shard_cfg, A) for _ in range(2))
            got.read_state(f"{path2}.shard0", meta2["shard_metas"][0])
            want.read_state(f"{snap_ring}.shard0", snap_meta["shard_metas"][0])
            np.testing.assert_array_equal(np.sort(got.tree.leaf_values()),
                                          np.sort(want.tree.leaf_values()))
            b2 = plane.sample_batch(8) or plane.sample_batch(8)
            assert b2 is not None and b2["idxes"].shape == (8,)
            assert plane.health()["net"]["links"][0]["attaches"] >= 2
    finally:
        plane.shutdown()


@pytest.mark.parametrize("server_pkg", ["torch", "jax"])
def test_handshake_rejects_geometry_drift(server_pkg):
    """A coordinator built from a drifted config fails the HELLO handshake
    (WELCOME epoch −1, a fatal link) against either package's server, and
    ``start()`` raises instead of training from a smaller plane."""
    servers = ThreadServers(server_pkg, make_cfg(server_pkg))
    drifted = make_cfg(batch_size=16,
                       replay_hosts=servers.hosts)
    plane = trn.NetShardedReplayPlane(drifted, A)
    try:
        with pytest.raises(RuntimeError, match="rejected the attach"):
            plane.start(wait_ready=20.0)
        assert any(lk.fatal for lk in plane.links)
    finally:
        plane.shutdown()
        servers.close()


# --------------------------------------------------------- train() layer

def test_train_over_loopback_sockets_on_the_cpu():
    """``train(device="cpu")`` over two managed loopback shard servers:
    every update's feedback reaches the plane, every circuit stays closed
    with no epoch drop or dropped block, and /healthz carries the net
    block."""
    cfg = port_test_config(game_name="Fake", act_device="cpu",
                           replay_shards=2, replay_transport="socket",
                           learning_starts=16, training_steps=12,
                           log_interval=0.5, telemetry_port=-1)
    m = ttrain.train(cfg, verbose=False, device="cpu", max_wall_seconds=120)
    assert m["num_updates"] == 12 and not m["fabric_failed"]
    assert m["buffer_training_steps"] == m["num_updates"]
    net = m["replay_shard_health"]["net"]
    assert net["connected"] == 2 and net["epoch_drops"] == 0
    assert [row["circuit"] for row in net["links"]] == ["closed", "closed"]
    assert m["replay_shard_health"]["dropped_blocks"] == 0
    hz = m["healthz"]
    assert hz["status"] == "ok", f"/healthz {json.dumps(hz, default=str)}"
    assert hz["replay_shards"]["net"]["circuits"] == ["closed", "closed"]
    assert m["logs"][-1]["replay_shards"]["net"]["transport"] == "socket"


@pytest.mark.chaos
@pytest.mark.slow
def test_train_socket_replay_with_partition_kill_and_garble(tmp_path):
    """A socket train() round with a partition, a shard kill and frame
    garbling armed: no learner stall, the shard respawned through the
    epoch handshake, the links healed, every update's feedback reached
    the plane."""
    cfg = port_test_config(
        game_name="Fake", act_device="cpu", replay_shards=2,
        replay_transport="socket", training_steps=40, log_interval=0.5,
        learning_starts=16, replay_sample_timeout=1.0,
        replay_net_cooldown=0.5, learner_stall_timeout=60.0,
        telemetry_port=-1,
        chaos_spec=("kill_replay_shard:at=4;"
                    "partition_shard_link:at=6,dur=1.5;"
                    "garble_net_frame:every=40,n=1000000"))
    m = ttrain.train(cfg, checkpoint_dir=str(tmp_path), verbose=False,
                     device="cpu", max_wall_seconds=180)
    assert m["num_updates"] > 0
    assert not m["learner_stalled"] and not m["fabric_failed"]
    rh = m["replay_shard_health"]
    assert m["chaos"].get("kill_replay_shard", 0) == 1
    assert m["chaos"].get("partition_shard_link", 0) == 1
    assert sum(rh["respawns"]) >= 1 and rh["alive"] == 2
    assert rh["net"]["connected"] == 2 and rh["net"]["partitions"] == 1
    assert m["buffer_training_steps"] == m["num_updates"]
