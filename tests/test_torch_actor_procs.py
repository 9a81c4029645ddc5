"""The port's process-fleet actor plane on the CPU, against the JAX
package's where the two must agree.

- the shm block channel: blocks cross it bit for bit, and a slot one
  package writes is read by the other (the wire layouts are equal);
- the weight pump: one pickle per version shared by every fleet queue,
  the bfloat16 wire bits equal ``ml_dtypes``'s, and the payload halves;
- one local-mode fleet's block stream, from params converted with the
  port's flax converter, the same seeds and the same lane shard, against
  the JAX fleet's (both worker entry points run here on threads): obs,
  actions, rewards and integer fields bitwise, q-derived fields within
  1e-5;
- spawned fleets: no JAX and no CUDA context in a child, a SIGKILLed
  fleet respawned while every other segment survives (the child's
  resource-tracker registration unlinks nothing), no segment left after
  shutdown; the escalation once the restart budget is spent (slow);
- ``train()`` end to end with ``actor_transport="process"`` in local mode
  on the CPU, and a drain-then-save resume that restores the fleets.

Mirrors tests/test_actor_procs.py and the pump half of
tests/test_inference_service.py.
"""
import multiprocessing as mp
import os
import queue
import threading
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu.envs.fake import FakeAtariEnv as JaxFakeEnv
from r2d2_tpu.models.network import create_network as jax_create
from r2d2_tpu.models.network import init_params
from r2d2_tpu.parallel import actor_procs as japs
from r2d2_tpu.replay.block import LocalBuffer as JaxLocalBuffer
from r2d2_tpu_torch import train as ttrain
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.models import create_network, params_from_flax
from r2d2_tpu_torch.parallel import actor_procs as taps
from r2d2_tpu_torch.replay.block import LocalBuffer
from r2d2_tpu_torch.utils.store import ParamStore
from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS

# the env factory spawned fleets unpickle: the port's own default
# (module-level, it imports nothing of JAX): fake lanes, 4 actions
make_fake_env = ttrain._default_env_factory
A = 4

BLOCK_FIELDS = ("obs", "last_action", "last_reward", "action",
                "n_step_reward", "n_step_gamma", "hidden", "burn_in_steps",
                "learning_steps", "forward_steps")
# bitwise across the packages: numpy on both sides; the rest derive from q
EXACT_FIELDS = ("obs", "last_action", "last_reward", "action",
                "n_step_reward", "n_step_gamma", "burn_in_steps",
                "learning_steps", "forward_steps")


def cpu_cfg(**kw):
    base = dict(game_name="Fake", num_actors=2, actor_transport="process",
                act_device="cpu")
    base.update(kw)
    return port_test_config(**base)


def scripted_blocks(local_cls, cfg, n_finishes, seed=0):
    """(block, priorities, episode_reward) triples from a scripted local
    buffer; the last one a short terminated chunk (a trimmed header)."""
    rng = np.random.default_rng(seed)
    local = local_cls(cfg, A)
    local.reset(rng.integers(0, 256, cfg.stored_obs_shape, np.uint8))
    out = []
    for j in range(n_finishes):
        partial = j == n_finishes - 1
        steps = cfg.block_length // 2 - 1 if partial else cfg.block_length
        for _ in range(steps):
            local.add(int(rng.integers(A)), float(rng.normal()),
                      rng.integers(0, 256, cfg.stored_obs_shape, np.uint8),
                      rng.normal(size=A).astype(np.float32),
                      rng.normal(size=(2, cfg.lstm_layers, cfg.hidden_dim)
                                 ).astype(np.float32))
        out.append(local.finish(None if partial else
                                rng.normal(size=A).astype(np.float32)))
    return out


def assert_blocks_equal(got, want):
    b2, p2, ep2 = got
    blk, prios, ep = want
    assert b2.num_sequences == blk.num_sequences
    for f in BLOCK_FIELDS:
        a, b = getattr(blk, f), getattr(b2, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(prios, p2)
    assert ep2 == ep


def test_shm_channel_roundtrip_bit_exact():
    """Blocks cross the port's channel bit for bit; only the shape header
    rides the queue, and every slot returns to the free list."""
    cfg = cpu_cfg()
    ctx = mp.get_context("spawn")
    channel = taps.ShmBlockChannel(cfg, A, num_slots=4, ctx=ctx)
    producer = taps.ShmBlockProducer(cfg, A, channel.producer_info(),
                                     ctx.Event(), src=5)
    items = scripted_blocks(LocalBuffer, cfg, 3)
    try:
        for item in items:
            producer.send(*item)
        for item in items:
            got = channel.recv(timeout=10.0)
            assert got is not None, "channel dropped a block"
            block, prios, ep, slot, src = got
            assert src == 5
            assert_blocks_equal((block, prios, ep), item)
            channel.release(slot)
        assert channel.recv(timeout=0.1) is None
        assert producer.blocks_sent == 3 and producer.episodes == 1
    finally:
        producer.close()
        channel.close()


@pytest.mark.parametrize("direction", ["torch->jax", "jax->torch"])
def test_block_slot_crosses_packages_bitwise(direction):
    """A block one package's producer writes is read by the other's
    channel: the same slot layout, CRC convention and shape header."""
    tcfg = cpu_cfg()
    jcfg = jax_test_config(num_actors=2, actor_transport="process")
    ctx = mp.get_context("spawn")
    if direction == "torch->jax":
        channel = japs.ShmBlockChannel(jcfg, A, num_slots=4, ctx=ctx)
        producer = taps.ShmBlockProducer(tcfg, A, channel.producer_info(),
                                         ctx.Event(), src=3)
        items = scripted_blocks(LocalBuffer, tcfg, 3, seed=1)
    else:
        channel = taps.ShmBlockChannel(tcfg, A, num_slots=4, ctx=ctx)
        producer = japs.ShmBlockProducer(jcfg, A, channel.producer_info(),
                                         ctx.Event(), src=3)
        items = scripted_blocks(JaxLocalBuffer, jcfg, 3, seed=1)
    try:
        assert channel.slot_nbytes == taps.slot_layout(
            taps.block_slot_spec(tcfg, A))[0]
        for item in items:
            producer.send(*item)
        for item in items:
            block, prios, ep, slot, src = channel.recv(timeout=10.0)
            assert src == 3
            assert_blocks_equal((block, prios, ep), item)
            channel.release(slot)
        # a garbled in-flight slot is refused by the reading package
        producer.send(*items[0])
        buf = np.frombuffer(channel.shm.buf, np.uint8)
        for slot in range(channel.num_slots):
            lo = slot * channel.slot_nbytes + channel.offsets["obs"]
            buf[lo:lo + 64] ^= 0xFF
        del buf
        with pytest.raises((taps.CorruptBlockError,
                            japs.CorruptBlockError)):
            channel.recv(timeout=10.0)
    finally:
        producer.close()
        channel.close()


# ------------------------------------------------------------ weight pump

def port_params(cfg, seed=0):
    net = create_network(cfg, A, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def test_pump_payload_pickled_once_and_decodes():
    """One ParamStore version is pickled ONCE per pump and every fleet
    queue gets the same bytes; the decode restores every tensor."""
    cfg = cpu_cfg(actor_fleets=2)
    params = port_params(cfg)
    plane = taps.ProcessFleetPlane(cfg, A, make_fake_env, [0.4, 0.3])
    try:
        plane.param_store = ParamStore(params)
        plane.weight_queues = [queue.Queue(), queue.Queue()]
        before = HOST_TRANSFERS.get("pump.param_snapshot")
        assert plane.pump_params_once()
        assert HOST_TRANSFERS.get("pump.param_snapshot") == before + 1
        b0 = plane.weight_queues[0].get_nowait()
        b1 = plane.weight_queues[1].get_nowait()
        assert isinstance(b0, bytes) and b0 is b1
        version, decoded = taps._decode_pump(b0)
        assert version == 1 and list(decoded) == list(params)
        for k, v in params.items():
            assert decoded[k].dtype == torch.float32
            assert torch.equal(decoded[k], v), k
        assert not plane.pump_params_once()     # same version: no re-pump
    finally:
        plane.stats_slab.close()


def test_bf16_pump_bits_equal_ml_dtypes_and_halve_the_payload():
    """bf16 on the wire: the narrowed bits equal ``ml_dtypes``'s
    round-to-nearest-even (exact ties included), the payload is about
    half, and the decode widens back to float32 at the original shapes."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=4096).astype(np.float32) * 10.0 ** rng.integers(
        -30, 30, size=4096)
    ties = (rng.integers(0, 1 << 15, size=512, dtype=np.uint32) << 16
            | 0x8000).view(np.float32)          # exactly half an ulp
    ties = ties[np.isfinite(ties)]   # NaN payloads are not params' concern
    x = np.concatenate([x, ties, np.float32([0.0, -0.0, 1.0, np.inf,
                                             -np.inf, 1e-40, 3.4e38])])
    got = taps.narrow_bf16(torch.from_numpy(x))
    np.testing.assert_array_equal(got, x.astype(ml_dtypes.bfloat16).view(
        np.uint16))

    cfg = cpu_cfg(param_pump_dtype="bfloat16")
    params = port_params(cfg)
    host16 = taps.pack_params(params, "bfloat16")
    host32 = taps.pack_params(params, "float32")
    blob16 = taps.ProcessFleetPlane._encode_pump(1, host16)
    blob32 = taps.ProcessFleetPlane._encode_pump(1, host32)
    assert len(blob16) < 0.6 * len(blob32)
    _, decoded = taps._decode_pump(blob16)
    for k, v in params.items():
        assert decoded[k].dtype == torch.float32 and decoded[k].shape == v.shape
        want = v.numpy().astype(ml_dtypes.bfloat16).astype(np.float32)
        np.testing.assert_array_equal(decoded[k].numpy(), want, err_msg=k)


# ---------------------------------------------- a fleet against JAX's

def _run_worker(main, args, stop, err):
    try:
        main(*args)
    except BaseException as e:  # surface in the test, never hang it
        err.append(e)
        stop.set()


def _drain(channel, n, deadline, err):
    out = []
    while len(out) < n and time.time() < deadline and not err:
        got = channel.recv(timeout=0.2)
        if got is None:
            continue
        block, prios, ep, slot, _ = got
        out.append(({f: np.array(getattr(block, f)) for f in BLOCK_FIELDS},
                    np.array(prios), ep))
        channel.release(slot)
    return out


def test_local_fleet_block_stream_matches_jax_fleet(monkeypatch):
    """Both packages' fleet entry points, each on a thread with its own
    channel: the same seeds, lane shard and (converted) params give the
    same block stream."""
    # the port's worker hides the CUDA devices from its process: restore
    # this process's setting afterwards
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    jcfg = jax_test_config(num_actors=2, actor_transport="process",
                           max_episode_steps=20)
    tcfg = cpu_cfg(max_episode_steps=20)
    jparams = init_params(jcfg, jax_create(jcfg, A), jax.random.PRNGKey(0))
    host = jax.device_get(jparams)
    tparams = params_from_flax(host)
    eps = (0.4, 0.3)
    ctx = mp.get_context("spawn")

    def jax_env(cfg, seed):
        return JaxFakeEnv(obs_shape=cfg.stored_obs_shape, action_dim=A,
                          seed=seed, episode_len=32)

    runs = []
    for mod, cfg, env, payload, spec in (
            (japs, jcfg, jax_env,
             japs.ProcessFleetPlane._encode_pump(1, host),
             japs._FleetSpec(0, 0, 2, eps, 0)),
            (taps, tcfg, make_fake_env,
             taps.ProcessFleetPlane._encode_pump(
                 1, taps.pack_params(tparams, "float32")),
             taps._FleetSpec(0, 0, 2, eps, 0))):
        channel = mod.ShmBlockChannel(cfg, A, 4, ctx)
        weights = queue.Queue()
        weights.put(payload)
        stop, err = threading.Event(), []
        t = threading.Thread(target=_run_worker, args=(
            mod._fleet_worker_main,
            (cfg, A, env, spec, channel.producer_info(), weights, stop),
            stop, err), daemon=True)
        t.start()
        runs.append((channel, stop, err, t))
    try:
        deadline = time.time() + 120
        streams = [_drain(ch, 8, deadline, err) for ch, _, err, _ in runs]
        for _, _, err, _ in runs:
            if err:
                raise err[0]
        want, got = streams
        assert len(want) == len(got) == 8
        for (bw, pw, ew), (bg, pg, eg) in zip(want, got):
            for f in EXACT_FIELDS:
                assert bw[f].dtype == bg[f].dtype, f
                np.testing.assert_array_equal(bg[f], bw[f], err_msg=f)
            np.testing.assert_allclose(bg["hidden"], bw["hidden"],
                                       atol=1e-5, rtol=0)
            np.testing.assert_allclose(pg, pw, atol=1e-5, rtol=0)
            assert eg == ew
    finally:
        for channel, stop, _, t in runs:
            stop.set()
        for channel, stop, _, t in runs:
            # the worker parks on a free slot until the stop flag
            t.join(30)
            assert not t.is_alive()
            channel.close()


def test_a_reply_of_another_kind_is_kept_for_its_caller():
    """A probe and the shutdown snapshot can wait on one fleet's reply
    queue at once: a reply read by the caller waiting for the other kind
    is kept for its own caller, never dropped."""
    cfg = cpu_cfg()
    plane = taps.ProcessFleetPlane(cfg, A, make_fake_env, [0.4, 0.3])
    try:
        plane.snap_queues[0] = queue.Queue()
        plane._replies[0] = {}
        plane.snap_queues[0].put(("probe", 0, {"pid": 7}))
        plane.snap_queues[0].put(("snapshot", 0, {"num_lanes": 2}))
        deadline = time.time() + 5
        assert plane._reply(0, "snapshot", deadline) == {"num_lanes": 2}
        assert plane._reply(0, "probe", deadline) == {"pid": 7}
        assert plane.snap_queues[0].empty() and plane._replies[0] == {}
    finally:
        plane.stats_slab.close()


# ------------------------------------------------------- spawned fleets

def _shm_exists(name):
    return os.path.exists(os.path.join("/dev/shm", name.lstrip("/")))


def _ingest_until(plane, pred, seconds):
    deadline = time.time() + seconds
    while not pred() and time.time() < deadline:
        plane.ingest_once(lambda *item: None, timeout=0.05)
    return pred()


def _probe(plane):
    """The fleets' reports, ingesting meanwhile: a fleet answers between
    run bursts, and a burst parks on a full channel until it is drained."""
    out = []
    t = threading.Thread(target=lambda: out.append(plane.probe_fleets(60)))
    t.start()
    while t.is_alive():
        plane.ingest_once(lambda *item: None, timeout=0.05)
    t.join()
    return out[0]


def test_killed_fleet_respawns_and_shared_memory_survives():
    """Two spawned local-mode fleets report no JAX, no CUDA context and
    their share of the cores; a SIGKILLed fleet is respawned on a fresh
    channel while the other fleet's slab and the stats slab stay linked
    (a child's exit unlinks nothing), the respawn produces blocks again,
    and shutdown leaves no segment behind."""
    cfg = cpu_cfg(num_actors=4, actor_fleets=2)
    plane = taps.ProcessFleetPlane(cfg, A, make_fake_env,
                                   [0.4, 0.3, 0.2, 0.1])
    names = [plane.stats_slab.shm.name]
    try:
        plane.start(ParamStore(port_params(cfg)))
        assert _ingest_until(
            plane, lambda: min(plane.blocks_per_fleet) > 0, 90)
        reports = _probe(plane)
        assert all(r is not None for r in reports), reports
        threads = max(1, (os.cpu_count() or 1) // 2)
        for f, r in enumerate(reports):
            assert r["pid"] == plane.procs[f].pid
            assert not r["cuda_initialized"]
            assert not r["jax_loaded"] and not r["r2d2_tpu_loaded"]
            assert r["num_threads"] == threads
            assert r["param_version"] == 1
        old, other = plane.channels[0].shm.name, plane.channels[1].shm.name
        names += [old, other]
        plane.procs[0].kill()
        plane.procs[0].join(10)
        assert _shm_exists(old) and _shm_exists(other)
        assert _shm_exists(plane.stats_slab.shm.name)
        assert plane.watch_once() == 1
        assert plane.restarts == [1, 0]
        assert not _shm_exists(old)           # the retired channel
        names.append(plane.channels[0].shm.name)
        before = plane.blocks_per_fleet[0]
        assert _ingest_until(
            plane, lambda: plane.blocks_per_fleet[0] > before, 90)
        assert _shm_exists(other)
        assert plane.registry.get_counter("fleet.respawns", fleet="0") == 1
        stats = plane.poll_fleet_stats()
        assert stats["per_fleet"][0]["incarnation"] in (0.0, 1.0)
    finally:
        plane.shutdown()
    assert all(not p.is_alive() for p in plane.procs)
    assert not [n for n in names if _shm_exists(n)]


@pytest.mark.slow
@pytest.mark.timeout(600)
def test_fleet_process_killed_is_restarted_then_escalates():
    """Past its restart budget a dying fleet raises out of the watchdog
    and marks the plane failed (the supervisor's fabric stop)."""
    cfg = cpu_cfg(num_actors=2, actor_fleets=1)
    plane = taps.ProcessFleetPlane(cfg, A, make_fake_env, [0.4, 0.3],
                                   max_restarts=1)
    try:
        plane.start(ParamStore(port_params(cfg)))
        for _ in range(2):
            assert _ingest_until(plane, lambda: plane.procs[0].is_alive(),
                                 60)
            plane.procs[0].kill()
            plane.procs[0].join(10)
            if plane.restarts[0] < plane.max_restarts:
                assert plane.watch_once() == 1
        with pytest.raises(RuntimeError, match="restart budget"):
            plane.watch_once()
        assert plane.failed
    finally:
        plane.shutdown()


# ------------------------------------------------------------ train()

def train_until_every_fleet_fed(monkeypatch, cfg, updates, **kw):
    """``train()`` that stops once the learner made ``updates`` updates
    AND every fleet's blocks reached the buffer (fleets spawn at their own
    pace, so a short run could otherwise end before a slow one arrives)."""
    real_build, got = ttrain._build, {}

    def build(*a, **k):
        got.update(real_build(*a, **k))
        return got

    def fed():
        return (got["learner"].num_updates >= updates
                and min(got["plane"].blocks_per_fleet) > 0)

    monkeypatch.setattr(ttrain, "_build", build)
    m = ttrain.train(cfg.replace(training_steps=100_000),
                     env_factory=make_fake_env, max_wall_seconds=120,
                     verbose=False, device="cpu", stop_fn=fed, **kw)
    assert fed(), "the run ended before every fleet fed the buffer"
    return m, got


def test_train_process_local_end_to_end(monkeypatch):
    """``train()`` with two local-mode fleet subprocesses on the CPU:
    blocks flow over the channels into the buffer, the learner trains,
    every fleet acts on pumped weights, ``/healthz`` carries the fleet
    section and says ok, and each block crossed once."""
    ingests = HOST_TRANSFERS.get("ingest.block")
    cfg = cpu_cfg(num_actors=4, actor_fleets=2,
                  log_interval=0.2)
    m, _ = train_until_every_fleet_fed(monkeypatch, cfg, 6)
    assert m["num_updates"] >= 6
    assert np.isfinite(m["mean_loss"]) and not m["fabric_failed"]
    fleet = m["fleet_health"]
    assert fleet["fleets"] == 2 and fleet["alive"] == 0
    assert fleet["restarts"] == [0, 0] and fleet["blocks_corrupt"] == 0
    assert all(c > 0 for c in fleet["blocks_per_fleet"])
    assert "service" not in fleet
    rows = fleet["stats"]["per_fleet"]
    assert all(r["param_version"] >= 1 for r in rows)
    assert fleet["stats"]["totals"]["local_acts"] == 0
    assert HOST_TRANSFERS.get("ingest.block") - ingests \
        == fleet["blocks_ingested"]
    hz = m["healthz"]
    assert hz["status"] == "ok" and hz["fleet"]["alive"] == 2
    assert not hz["fleet"]["resilience"]["degraded"]


def test_train_process_drain_then_save_resumes_the_fleets(monkeypatch,
                                                         tmp_path):
    """The drain-then-save exit collects every fleet's actor snapshot into
    the replay snapshot; a resume restores the ring and hands the
    snapshots to the respawned fleets, whose counters continue."""
    from r2d2_tpu_torch.checkpoint import Checkpointer

    ck = str(tmp_path / "ck")
    cfg = cpu_cfg(num_actors=4, actor_fleets=2,
                  log_interval=0.2)
    m1, _ = train_until_every_fleet_fed(monkeypatch, cfg, 6,
                                        checkpoint_dir=ck)
    _, _, snaps = Checkpointer(ck).restore_replay()
    assert len(snaps) == 2 and all(s is not None for s in snaps)
    assert all(s["num_lanes"] == 2 and s["actor_steps"] > 0 for s in snaps)
    m2, got = train_until_every_fleet_fed(
        monkeypatch, cfg, m1["num_updates"] + 4, checkpoint_dir=ck,
        resume=True)
    assert m2["restored_replay"] and not m2["fabric_failed"]
    assert m2["env_steps"] >= m1["env_steps"]
    rows = m2["fleet_health"]["stats"]["per_fleet"]
    # the restored fleets resumed their actor counters
    assert all(r["env_steps"] >= s["actor_steps"] * 2
               for r, s in zip(rows, snaps))


@pytest.mark.chaos
def test_train_kill_fleet_and_garble_block_drills(monkeypatch):
    """The ``kill_fleet`` and ``garble_block`` sites fire from train()'s
    chaos loop: the killed fleet is respawned (counted, its incarnation
    bumped) and feeds the buffer again, a garbled in-flight block is
    dropped and counted rather than trained on, and the fabric stays up."""
    real_build, got, fed_after = ttrain._build, {}, {}

    def build(*a, **k):
        got.update(real_build(*a, **k))
        return got

    def done():
        plane = got["plane"]
        if sum(plane.restarts) == 0:
            return False
        base = fed_after.setdefault("blocks", list(plane.blocks_per_fleet))
        return (got["learner"].num_updates >= 6
                and all(n > b for n, b in zip(plane.blocks_per_fleet, base)))

    monkeypatch.setattr(ttrain, "_build", build)
    cfg = cpu_cfg(num_actors=4, actor_fleets=2,
                  training_steps=100_000, log_interval=0.2,
                  chaos_spec="kill_fleet:at=40;garble_block:every=5")
    m = ttrain.train(cfg, env_factory=make_fake_env, max_wall_seconds=120,
                     verbose=False, device="cpu", stop_fn=done)
    assert done(), "the killed fleet was not respawned and fed again"
    assert not m["fabric_failed"]
    fleet = m["fleet_health"]
    assert sum(fleet["restarts"]) == 1 and m["chaos"]["kill_fleet"] == 1
    assert m["chaos"]["garble_block"] >= 1
    assert got["buffer"].corrupt_blocks == fleet["blocks_corrupt"]
    assert max(fleet["stats"]["incarnations"]) <= 1
