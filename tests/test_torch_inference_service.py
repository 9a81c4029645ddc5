"""The port's centralized inference service and its act client on the
CPU, against the JAX package's where the two must agree.

- the act slab: its layout equals the reference's, and an RPC crosses the
  packages in both directions — a JAX fleet's client acting through the
  port's service and the port's client through JAX's — in commit, peek
  and resync modes, so both CRCs and every region are bitwise compatible;
- serve mode's block stream equals local mode's bit for bit (the service
  acts through the fleets' CPU twin here), including the episode-step-cap
  bootstrap answered as a no-commit peek;
- the failover cycle (attached → service frozen → circuit open, local
  twin → thawed → half-open resync probe re-attaches) stays bit-exact;
- a dropped and a garbled response are recovered by the bounded retry,
  a garbled request is dropped, a partial batch is counted;
- the server hidden: zeroed per shard on respawn, restored from a fleet
  snapshot at the first spawn;
- ``start`` warms the act at the full batch and raises on a failure;
- ``train()`` end to end with ``actor_inference="serve"``: one fetch per
  batch, every lane served.

Mirrors tests/test_inference_service.py and the serve half of
tests/test_resilience.py.
"""
import multiprocessing as mp
import threading
import time

import jax
import numpy as np
import pytest
import torch

from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu.envs.fake import FakeAtariEnv as JaxFakeEnv
from r2d2_tpu.models.network import create_network as jax_create
from r2d2_tpu.models.network import init_params
from r2d2_tpu.parallel import actor_procs as japs
from r2d2_tpu.parallel import inference_service as jis
from r2d2_tpu.utils.store import ParamStore as JaxParamStore
from r2d2_tpu_torch import train as ttrain
from r2d2_tpu_torch.actor import VectorActor, make_host_act_fn
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.envs import FakeAtariEnv
from r2d2_tpu_torch.models import create_network, params_from_flax
from r2d2_tpu_torch.parallel import actor_procs as taps
from r2d2_tpu_torch.parallel import inference_service as tis
from r2d2_tpu_torch.utils.chaos import ChaosInjector
from r2d2_tpu_torch.utils.resilience import CLOSED, HALF_OPEN, OPEN
from r2d2_tpu_torch.utils.store import ParamStore
from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS

# the env factory spawned fleets unpickle: the port's own default
# (module-level, it imports nothing of JAX): fake lanes, 4 actions
make_fake_env = ttrain._default_env_factory
A = 4

FIELDS = ("obs", "last_action", "last_reward", "action", "n_step_reward",
          "n_step_gamma", "hidden", "burn_in_steps", "learning_steps",
          "forward_steps")


def serve_cfg(**kw):
    base = dict(game_name="Fake", num_actors=2, actor_transport="process",
                actor_inference="serve", act_device="cpu")
    base.update(kw)
    return port_test_config(**base)


def port_params(cfg, seed=0):
    net = create_network(cfg, A, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def long_envs(cfg, n):
    return [FakeAtariEnv(obs_shape=cfg.stored_obs_shape, action_dim=A,
                         seed=i, episode_len=500) for i in range(n)]


def started_service(cfg, params, eps=(0.4, 0.3)):
    plane = taps.ProcessFleetPlane(cfg, A, make_fake_env, list(eps))
    plane.service.start(ParamStore(params))
    plane.stats_slab.close()
    return plane.service


def pump_while(svc, fn, seconds=120):
    """Run ``fn`` on a thread while pumping the service from this one
    (the in-process stand-in for the fabric's ``inference_serve`` loop)."""
    done, out, err = threading.Event(), [], []

    def run():
        try:
            out.append(fn())
        except BaseException as e:  # surface in the test, never hang it
            err.append(e)
        finally:
            done.set()

    t = threading.Thread(target=run)
    t.start()
    deadline = time.time() + seconds
    while not done.is_set() and time.time() < deadline:
        svc.serve_once(idle_sleep=0.0)
    t.join(10)
    assert done.is_set(), "the actor never finished"
    if err:
        raise err[0]
    return out[0]


def assert_streams_equal(got_local, got_serve, fields=FIELDS):
    assert len(got_local) == len(got_serve) > 0
    for (b1, p1, e1), (b2, p2, e2) in zip(got_local, got_serve):
        for f in fields:
            np.testing.assert_array_equal(getattr(b1, f), getattr(b2, f),
                                          err_msg=f)
        np.testing.assert_array_equal(p1, p2)
        assert e1 == e2


def local_twin(cfg):
    return make_host_act_fn(taps.fleet_act_net(cfg, A))


# ------------------------------------------------------------ wire

@pytest.mark.parametrize("lanes", [1, 2, 8])
def test_act_slot_layout_equals_jax(lanes):
    tcfg = serve_cfg(num_actors=max(2, lanes))
    jcfg = jax_test_config(num_actors=max(2, lanes),
                           actor_transport="process",
                           actor_inference="serve")
    ours = tis.act_slot_spec(tcfg, A, lanes)
    ref = jis.act_slot_spec(jcfg, A, lanes)
    assert [(n, tuple(s), np.dtype(d)) for n, s, d in ours] == [
        (n, tuple(s), np.dtype(d)) for n, s, d in ref]
    assert (tis.MODE_PEEK, tis.MODE_COMMIT, tis.MODE_RESYNC) == (
        jis.MODE_PEEK, jis.MODE_COMMIT, jis.MODE_RESYNC)


def _rpc_script(client, cfg):
    """Commit (all lanes reset), commit, peek, then a resync commit that
    ships a hidden carry: every mode and both CRC coverages."""
    rng = np.random.default_rng(4)
    hid = (2, 2, cfg.lstm_layers, cfg.hidden_dim)
    out = []
    hidden = np.zeros(hid, np.float32)
    for mode in ("commit", "commit", "peek", "resync"):
        obs = rng.integers(0, 256, (2, *cfg.stored_obs_shape), np.uint8)
        la = np.eye(A, dtype=np.float32)[rng.integers(A, size=2)]
        lr = rng.normal(size=2).astype(np.float32)
        if mode == "resync":
            hidden = (rng.normal(size=hid) * 0.3).astype(np.float32)
            q, new = client._attempt(obs, la, lr, hidden, tis.MODE_RESYNC)
        elif mode == "peek":
            q, new = client.peek(None, obs, la, lr, hidden)
        else:
            q, new = client(None, obs, la, lr, hidden)
        out.append((mode, (obs, la, lr, hidden.copy()), np.array(q),
                    None if new is None else np.array(new)))
        if new is not None:
            hidden = np.array(new)
    return out


@pytest.mark.parametrize("direction", ["jax client -> torch service",
                                       "torch client -> jax service"])
def test_act_rpc_crosses_packages(direction):
    """One package's fleet client acting through the other's service:
    the requests pass the server's CRC, the replies the client's, and q
    and the new hidden equal the port's own act on the same inputs
    (bitwise through the port's service, within 1e-5 through JAX's)."""
    tcfg = serve_cfg()
    jcfg = jax_test_config(num_actors=2, actor_transport="process",
                           actor_inference="serve")
    jparams = init_params(jcfg, jax_create(jcfg, A), jax.random.PRNGKey(0))
    tparams = params_from_flax(jax.device_get(jparams))
    ctx = mp.get_context("spawn")
    if direction.startswith("jax"):
        svc = started_service(tcfg, tparams)
        ch = svc.make_channel(0)
        client = jis.RemoteActClient(jcfg, A, 2, ch.producer_info(),
                                     ctx.Event())
        tol = 0.0
    else:
        jplane = japs.ProcessFleetPlane(
            jcfg, A, lambda c, s: JaxFakeEnv(c.stored_obs_shape, A, 32, s),
            [0.4, 0.3])
        svc = jplane.service
        svc.start(JaxParamStore(jparams))
        jplane.stats_slab.close()
        ch = svc.make_channel(0)
        client = tis.RemoteActClient(tcfg, A, 2, ch.producer_info(),
                                     ctx.Event())
        tol = 1e-5
    try:
        script = pump_while(svc, lambda: _rpc_script(client, tcfg))
        assert svc.requests_corrupt == 0 and svc.resyncs == 1
        assert svc.peeks == 1 and svc.batches == 4
        assert client.stats["act_retries"] == 0
        act = local_twin(tcfg)
        server_hidden = np.zeros((2, 2, tcfg.lstm_layers, tcfg.hidden_dim),
                                 np.float32)
        for mode, (obs, la, lr, hidden), q, new in script:
            if mode == "resync":
                server_hidden = hidden
            want_q, want_h = act(tparams, obs, la, lr, server_hidden)
            np.testing.assert_allclose(q, want_q, atol=tol, rtol=0,
                                       err_msg=mode)
            if mode != "peek":
                np.testing.assert_allclose(new, want_h, atol=tol, rtol=0,
                                           err_msg=mode)
                server_hidden = want_h
        np.testing.assert_allclose(svc.hidden, server_hidden, atol=tol,
                                   rtol=0)
    finally:
        client.close()
        svc.close()


# ---------------------------------------------------------- parity

def test_serve_mode_blocks_bit_exact_vs_local():
    """A VectorActor acting through the client → service path produces
    the block stream the local twin produces, bit for bit — the
    episode-step-cap bootstrap included, answered as peeks — and the
    server hidden ends equal to the actor's own."""
    cfg = serve_cfg(max_episode_steps=20)        # caps at 20, 40: peeks
    params = port_params(cfg)
    got_local, got_serve = [], []
    a1 = VectorActor(taps.fleet_act_config(cfg), long_envs(cfg, 2),
                     [0.4, 0.3], local_twin(cfg), ParamStore(params),
                     sink=lambda b, p, e: got_local.append((b, p.copy(), e)),
                     rng=np.random.default_rng(5))
    a1.run(max_steps=57)   # ends mid-episode: no cap on the last step

    svc = started_service(cfg, params)
    ch = svc.make_channel(0)
    client = tis.RemoteActClient(cfg, A, 2, ch.producer_info(),
                                 mp.get_context("spawn").Event())
    a2 = VectorActor(taps.fleet_act_config(cfg), long_envs(cfg, 2),
                     [0.4, 0.3], client, ParamStore(),
                     sink=lambda b, p, e: got_serve.append((b, p.copy(), e)),
                     rng=np.random.default_rng(5))
    try:
        pump_while(svc, lambda: a2.run(max_steps=57))
        assert_streams_equal(got_local, got_serve)
        assert svc.peeks > 0
        np.testing.assert_array_equal(a1.hidden, a2.hidden)
        assert not client._pending_resets
        np.testing.assert_array_equal(svc.hidden, a2.hidden)
        h = svc.health()
        assert h["batches"] > 0 and h["mean_batch_lanes"] == 2.0
        assert h["warmups"] == 1
    finally:
        client.close()
        svc.close()


def test_failover_cycle_blocks_bit_exact_and_reattach():
    """Attached → frozen (nobody serves: retries, circuit opens, acting
    degrades to the local twin on the pumped params) → thawed (the
    half-open probe re-attaches with a hidden resync).  The whole block
    stream equals a pure local run's, and the server hidden re-converges
    to the fleet's carry."""
    cfg = serve_cfg(max_episode_steps=20, act_response_timeout=0.3)
    params = port_params(cfg)
    svc = started_service(cfg, params)
    ch = svc.make_channel(0)
    got_local, got_serve = [], []
    client = tis.RemoteActClient(
        cfg, A, 2, ch.producer_info(), mp.get_context("spawn").Event(),
        param_store=ParamStore(params),
        local_act_factory=lambda: local_twin(cfg))
    a2 = VectorActor(taps.fleet_act_config(cfg), long_envs(cfg, 2),
                     [0.4, 0.3], client, ParamStore(),
                     sink=lambda b, p, e: got_serve.append((b, p.copy(), e)),
                     rng=np.random.default_rng(5))
    try:
        # phase A — attached: bursts until one runs wholly remote (a
        # loaded host can time out one 0.3 s attempt against a live
        # service; the circuit opening then is the design working)
        steps_a, deadline = 0, time.time() + 120
        while True:
            la0 = client.stats["local_acts"]
            pump_while(svc, lambda: a2.run(max_steps=5))
            steps_a += 5
            if (steps_a >= 20 and client.breaker.state == CLOSED
                    and client.stats["local_acts"] == la0):
                break
            assert time.time() < deadline, "never fully attached (A)"
        # phase B — frozen service
        la_b0 = client.stats["local_acts"]
        a2.run(max_steps=17)
        assert client.stats["circuit_opens"] >= 1
        assert client.breaker.state != CLOSED
        assert client.stats["local_acts"] == la_b0 + 17
        assert client.stats["act_retries"] >= 1
        # phase C — thawed: the probe re-attaches
        steps_c, deadline = 0, time.time() + 120
        while True:
            la0 = client.stats["local_acts"]
            pump_while(svc, lambda: a2.run(max_steps=5))
            steps_c += 5
            if (client.breaker.state == CLOSED
                    and client.stats["local_acts"] == la0):
                break
            assert time.time() < deadline, "never re-attached (C)"
            time.sleep(0.05)
        assert svc.resyncs >= 1 and svc.stale_requests >= 1
        a1 = VectorActor(taps.fleet_act_config(cfg), long_envs(cfg, 2),
                         [0.4, 0.3], local_twin(cfg), ParamStore(params),
                         sink=lambda b, p, e: got_local.append(
                             (b, p.copy(), e)),
                         rng=np.random.default_rng(5))
        a1.run(max_steps=steps_a + 17 + steps_c)
        assert_streams_equal(got_local, got_serve)
        np.testing.assert_array_equal(a1.hidden, a2.hidden)
        np.testing.assert_array_equal(svc.hidden, a2.hidden)
    finally:
        client.close()
        svc.close()


def test_circuit_transitions_are_published_when_they_happen():
    """ROADMAP.md C 17: the client calls ``on_state_change`` after every
    circuit transition, with ``stats`` already carrying the new state, so
    a fleet publishes an open circuit when it opens and a closed one when
    it re-attaches — not only at the end of its burst."""
    cfg = serve_cfg(act_response_timeout=0.2)
    params = port_params(cfg)
    svc = started_service(cfg, params)
    ch = svc.make_channel(0)
    published = []
    client = tis.RemoteActClient(
        cfg, A, 2, ch.producer_info(), mp.get_context("spawn").Event(),
        param_store=ParamStore(params),
        local_act_factory=lambda: local_twin(cfg),
        on_state_change=lambda: published.append(
            (client.stats["circuit_state"], client.stats["circuit_opens"])))
    actor = VectorActor(taps.fleet_act_config(cfg), long_envs(cfg, 2),
                        [0.4, 0.3], client, ParamStore(),
                        sink=lambda b, p, e: None,
                        rng=np.random.default_rng(5))
    try:
        actor.run(max_steps=3)             # nobody serves: the circuit opens
        assert published and published[0] == (float(OPEN), 1)
        assert client.breaker.state != CLOSED
        deadline = time.time() + 120
        while client.breaker.state != CLOSED:
            pump_while(svc, lambda: actor.run(max_steps=2))
            assert time.time() < deadline, "never re-attached"
            time.sleep(0.05)
        assert published[-1][0] == float(CLOSED)
        assert len(published) >= 2
        assert all(p[0] == float(OPEN) for p in published[:-1]
                   if p[0] != float(HALF_OPEN))
    finally:
        client.close()
        svc.close()


def test_drop_and_garble_response_recovered_by_bounded_retry():
    """A lost response token and a garbled response are absorbed by the
    bounded retry (counted, circuit stays closed) and the block stream
    stays bit-exact (each retry resyncs the server hidden)."""
    cfg = serve_cfg(act_response_timeout=0.25)
    params = port_params(cfg)
    got_local, got_serve = [], []
    a1 = VectorActor(taps.fleet_act_config(cfg), long_envs(cfg, 2),
                     [0.4, 0.3], local_twin(cfg), ParamStore(params),
                     sink=lambda b, p, e: got_local.append((b, p.copy(), e)),
                     rng=np.random.default_rng(5))
    a1.run(max_steps=41)
    svc = started_service(cfg, params)
    svc.chaos = ChaosInjector(
        "drop_act_response:at=7;garble_act_response:at=15", seed=0)
    ch = svc.make_channel(0)
    client = tis.RemoteActClient(
        cfg, A, 2, ch.producer_info(), mp.get_context("spawn").Event(),
        param_store=ParamStore(params),
        local_act_factory=lambda: local_twin(cfg))
    a2 = VectorActor(taps.fleet_act_config(cfg), long_envs(cfg, 2),
                     [0.4, 0.3], client, ParamStore(),
                     sink=lambda b, p, e: got_serve.append((b, p.copy(), e)),
                     rng=np.random.default_rng(5))
    try:
        pump_while(svc, lambda: a2.run(max_steps=41))
        assert svc.dropped_responses == 1 and svc.garbled_responses == 1
        assert client.stats["act_retries"] >= 2
        assert client.breaker.state == CLOSED
        assert client.stats["circuit_opens"] == 0
        assert_streams_equal(got_local, got_serve,
                             ("obs", "action", "n_step_reward", "hidden"))
        np.testing.assert_array_equal(a1.hidden, a2.hidden)
    finally:
        client.close()
        svc.close()


# ----------------------------------------------------- service hardening

def _post(ch, seq, obs_fill=7, reset=1):
    v = ch.views
    v["obs"][:] = obs_fill
    v["last_action"][:] = 0.0
    v["last_reward"][:] = 0.0
    v["reset_mask"][:] = reset
    v["req_seq"][0] = seq
    v["req_crc"][0] = tis.act_request_crc(v, seq, tis.MODE_COMMIT)


def test_serve_request_crc_drops_garbled_slab():
    """A garbled request is counted and dropped — never served — and the
    clean resend with a new seq is answered."""
    cfg = serve_cfg()
    svc = started_service(cfg, port_params(cfg))
    ch = svc.make_channel(0)
    try:
        _post(ch, 1)
        ch.views["obs"][0, 0] ^= 0xFF          # garble AFTER the CRC
        ch.req_q.put((1, tis.MODE_COMMIT))
        hidden_before = svc.hidden.copy()
        deadline = time.time() + 30
        while svc.requests_corrupt == 0 and time.time() < deadline:
            svc.serve_once(idle_sleep=0.001)
        assert svc.requests_corrupt == 1 and svc.batches == 0
        assert svc.health()["requests_corrupt"] == 1
        assert ch.rsp_q.empty()
        np.testing.assert_array_equal(svc.hidden, hidden_before)
        _post(ch, 2)
        ch.req_q.put((2, tis.MODE_COMMIT))
        deadline = time.time() + 30
        while svc.batches == 0 and time.time() < deadline:
            svc.serve_once(idle_sleep=0.0)
        assert svc.batches == 1 and ch.rsp_q.get(timeout=10) == 2
    finally:
        svc.close()


def test_partial_batch_counted_when_a_fleet_never_posts():
    """One fleet posts, the other never does: after the window the act
    dispatches anyway and counts a partial batch."""
    cfg = serve_cfg(num_actors=4, actor_fleets=2,
                    inference_batch_window=0.05)
    svc = started_service(cfg, port_params(cfg), eps=(0.4, 0.3, 0.2, 0.1))
    ch0 = svc.make_channel(0)
    svc.make_channel(1)                         # attached but silent
    try:
        _post(ch0, 1, reset=0)
        ch0.req_q.put((1, tis.MODE_COMMIT))
        t0 = time.monotonic()
        deadline = time.time() + 60
        while svc.batches == 0 and time.time() < deadline:
            svc.serve_once(idle_sleep=0.0)
        assert svc.batches == 1 and svc.partial_batches == 1
        assert svc.health()["partial_batches"] == 1
        assert ch0.rsp_q.get(timeout=10) == 1
        assert time.monotonic() - t0 < 30
    finally:
        svc.close()


class _NoProcess:
    """A stand-in for ``ctx.Process`` that records the spawn and starts
    nothing (the plane's provisioning runs, no child does)."""

    def __init__(self, target=None, name=None, args=(), daemon=None):
        self.args, self.pid, self.exitcode = args, None, None

    def start(self):
        pass

    def is_alive(self):
        return False

    def join(self, timeout=None):
        pass


def test_server_hidden_reset_per_shard_on_respawn_and_restored():
    """The plane's provisioning of fleet ``f``: the first spawn loads its
    shard of the server hidden from the armed actor snapshot (and hands
    the snapshot to the child), a respawn zeroes exactly that shard, and a
    snapshot of the wrong geometry resumes the shard cold."""
    cfg = serve_cfg(num_actors=4, actor_fleets=2)
    plane = taps.ProcessFleetPlane(cfg, A, make_fake_env,
                                   [0.4, 0.3, 0.2, 0.1])
    plane.ctx = type("Ctx", (), dict(Process=_NoProcess,
                                     Queue=mp.get_context("spawn").Queue))()
    plane.param_store = ParamStore(port_params(cfg))
    svc = plane.service
    rng = np.random.default_rng(3)
    shape = (2, 2, cfg.lstm_layers, cfg.hidden_dim)
    snaps = [{"agent": {"hidden": rng.normal(size=shape).astype(
        np.float32)}} for _ in range(2)]
    snaps[1]["agent"]["hidden"] = np.zeros((3, 2, 1, 1), np.float32)
    plane.set_restore_snapshots(snaps)
    try:
        svc.hidden[:] = 5.0
        plane._spawn(0)
        np.testing.assert_array_equal(svc.hidden[:2],
                                      snaps[0]["agent"]["hidden"])
        assert plane.procs[0].args[9] is snaps[0]      # restore_snap
        np.testing.assert_array_equal(svc.hidden[2:], 5.0)
        plane._spawn(1)                         # geometry mismatch: cold
        np.testing.assert_array_equal(svc.hidden[2:], 0.0)
        resets = svc.shard_resets
        plane.restarts[0] += 1
        plane._spawn(0)                         # a watchdog respawn
        np.testing.assert_array_equal(svc.hidden[:2], 0.0)
        assert svc.shard_resets == resets + 1
        assert plane.procs[0].args[9] is None   # respawns start fresh
        assert plane.procs[0].args[3].incarnation == 1
    finally:
        plane.shutdown(timeout=1.0)


def test_service_start_warms_at_full_batch_and_raises_on_failure(
        monkeypatch):
    """``start`` acts once on zeros at the full batch (counted as a
    warm-up, fetched under its own name, not a served batch), raises
    without a published snapshot, and lets an act failure out."""
    cfg = serve_cfg(num_actors=4, actor_fleets=2)
    fetches = HOST_TRANSFERS.get("serve.act_fetch")
    warm = HOST_TRANSFERS.get("serve.warm_fetch")
    svc = started_service(cfg, port_params(cfg), eps=(0.4, 0.3, 0.2, 0.1))
    assert svc.warmups == 1 and svc.batches == 0
    assert HOST_TRANSFERS.get("serve.warm_fetch") == warm + 1
    assert HOST_TRANSFERS.get("serve.act_fetch") == fetches
    assert svc.obs.shape[0] == cfg.num_actors
    plane = taps.ProcessFleetPlane(cfg, A, make_fake_env,
                                   [0.4, 0.3, 0.2, 0.1])
    plane.stats_slab.close()
    with pytest.raises(RuntimeError, match="published"):
        plane.service.start(ParamStore())

    def broken(*a, **k):
        raise RuntimeError("kernel build failed")

    monkeypatch.setattr("r2d2_tpu_torch.actor.make_act_fn",
                        lambda net: broken)
    plane = taps.ProcessFleetPlane(cfg, A, make_fake_env,
                                   [0.4, 0.3, 0.2, 0.1])
    plane.stats_slab.close()
    with pytest.raises(RuntimeError, match="kernel build failed"):
        plane.service.start(ParamStore(port_params(cfg)))


# ------------------------------------------------------------ train()

def test_train_serve_mode_end_to_end(monkeypatch):
    """``train()`` with two serve-mode fleet subprocesses on the CPU:
    every act an RPC to the service thread, one fetch per cross-fleet
    batch, the served lanes covering every fleet's env steps, no circuit
    opened and ``/healthz`` ok."""
    real_build, got = ttrain._build, {}

    def build(*a, **k):
        got.update(real_build(*a, **k))
        return got

    def fed():
        return (got["learner"].num_updates >= 6
                and min(got["plane"].blocks_per_fleet) > 0)

    monkeypatch.setattr(ttrain, "_build", build)
    before = {k: HOST_TRANSFERS.get(k) for k in (
        "serve.act_fetch", "serve.act_put", "serve.warm_fetch",
        "ingest.block")}
    cfg = serve_cfg(num_actors=4, actor_fleets=2,
                    training_steps=100_000, log_interval=0.2)
    m = ttrain.train(cfg, env_factory=make_fake_env, max_wall_seconds=120,
                     verbose=False, device="cpu", stop_fn=fed)
    assert fed() and np.isfinite(m["mean_loss"])
    assert not m["fabric_failed"]
    fleet = m["fleet_health"]
    svc = fleet["service"]
    delta = {k: HOST_TRANSFERS.get(k) - v for k, v in before.items()}
    assert svc["batches"] > 0 and svc["warmups"] == 1
    assert delta["serve.act_fetch"] == svc["batches"]
    assert delta["serve.act_put"] == svc["batches"] + svc["warmups"]
    assert delta["serve.warm_fetch"] == 1
    assert delta["ingest.block"] == fleet["blocks_ingested"]
    steps = sum(r["env_steps"] for r in fleet["stats"]["per_fleet"])
    # each fleet's last served iteration may be cut by the drain
    assert 0 <= svc["lanes_served"] - steps <= cfg.num_actors
    assert svc["requests_corrupt"] == 0 and svc["shard_resets"] == 2
    res = fleet["resilience"]
    assert res["circuit_opens"] == 0 and res["local_acts"] == 0
    assert fleet["restarts"] == [0, 0]
    spans = m["trace"]
    for stage in ("serve.assemble", "serve.act", "serve.scatter"):
        assert spans[f"span.{stage}.count"] > 0
    hz = m["healthz"]
    assert hz["status"] == "ok" and hz["fleet"]["alive"] == 2


@pytest.mark.chaos
def test_train_serve_freeze_service_degrades_and_reattaches(monkeypatch):
    """``freeze_service`` through train(): the frozen service opens the
    fleets' circuits (``/healthz`` degraded, local acts counted) while the
    learner trains on, and after the thaw every circuit closes again —
    with no fleet death."""
    real_build, got, seen = ttrain._build, {}, {}

    def build(*a, **k):
        got.update(real_build(*a, **k))
        return got

    def reattached():
        plane = got["plane"]
        res = plane.resilience_health()
        if res["circuit_opens"] >= 1 and res["degraded"]:
            seen["degraded"] = True
        return (seen.get("degraded", False) and not res["degraded"]
                and got["learner"].num_updates >= 6)

    monkeypatch.setattr(ttrain, "_build", build)
    cfg = serve_cfg(num_actors=4, actor_fleets=2,
                    training_steps=100_000, log_interval=0.2,
                    act_response_timeout=0.5,
                    chaos_spec="freeze_service:at=40,dur=4")
    m = ttrain.train(cfg, env_factory=make_fake_env, max_wall_seconds=150,
                     verbose=False, device="cpu", stop_fn=reattached)
    assert reattached(), "the fleets never degraded and re-attached"
    assert not m["fabric_failed"] and m["chaos"]["freeze_service"] == 1
    fleet = m["fleet_health"]
    res = fleet["resilience"]
    assert res["circuit_opens"] >= 1 and res["local_acts"] > 0
    assert res["circuits_open"] == 0 and fleet["restarts"] == [0, 0]
    assert fleet["service"]["resyncs"] >= 1
    assert m["healthz"]["status"] == "ok"
