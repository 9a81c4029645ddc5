"""The port's session-serving tier (r2d2_tpu_torch/serving) against the
JAX package's, on the CPU.

- the wire is byte-identical to ``r2d2_tpu.serving.wire``;
- the SessionStore keeps its LRU / reap / accounting contract;
- the ContinuousBatcher's bucket padding is bit-exact vs the direct act
  and makes one put and one fetch per batch;
- a port SessionServer on loopback serves sessions (with a reset) whose q
  matches the JAX SessionServer's on the same params (float32, 1e-5);
- bf16 quantized serving keeps greedy parity;
- acting goes to the CUDA device unless the CPU is asked for, and the
  port imports without JAX.

Everything runs at the tiny ``test_config`` geometry, ``device="cpu"``.
"""
import contextlib
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu.models.network import create_network as jax_create
from r2d2_tpu.models.network import init_params
from r2d2_tpu.serving import SessionClient as JaxClient
from r2d2_tpu.serving import SessionServer as JaxServer
from r2d2_tpu.serving import wire as jax_wire
from r2d2_tpu_torch.actor import _resolve_act_device, make_act_fn
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.models import create_network, params_from_flax
from r2d2_tpu_torch.serving import (
    ContinuousBatcher,
    SessionClient,
    SessionServer,
    SessionStore,
    bucket_sizes,
)
from r2d2_tpu_torch.serving import wire
from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS, RETRACES

A = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(**kw):
    base = dict(serve_max_sessions=8, serve_max_batch=8,
                serve_session_idle_s=30.0)
    base.update(kw)
    return port_test_config(**base)


def _flax_params(seed=0, **kw):
    cfg = jax_test_config(serve_max_sessions=8, serve_max_batch=8, **kw)
    net = jax_create(cfg, A)
    return init_params(cfg, net, jax.random.PRNGKey(seed))


def _port_params(seed=0, **kw):
    return params_from_flax(jax.device_get(_flax_params(seed, **kw)))


def _rows(cfg, n, rng):
    obs = rng.integers(0, 256, (n, *cfg.stored_obs_shape)).astype(np.uint8)
    la = rng.random((n, A)).astype(np.float32)
    lr = rng.random(n).astype(np.float32)
    h = (rng.normal(size=(n, 2, cfg.lstm_layers, cfg.hidden_dim))
         * 0.1).astype(np.float32)
    return obs, la, lr, h


def _assert_accounting(c):
    assert c["admitted"] == (c["completed"] + c["reaped"] + c["evicted"]
                             + c["live"]), c


@contextlib.contextmanager
def _serving(server, params):
    server.publish_params(params)
    server.start()
    try:
        yield server
    finally:
        server.stop()
        server.close()


# ------------------------------------------------------------------- wire

def test_wire_bytes_identical_to_jax():
    cfg = _cfg()
    rng = np.random.default_rng(1)
    obs = rng.integers(0, 256, cfg.stored_obs_shape).astype(np.uint8)
    la = rng.random(A).astype(np.float32)
    fields = dict(obs=obs, last_action=la,
                  last_reward=np.asarray([0.5], np.float32))
    header = (wire.MSG_ACT, 42, 7, wire.FLAG_RESET)
    ours = wire.encode_frame(wire.session_request_spec(cfg, A), header,
                             fields)
    theirs = jax_wire.encode_frame(
        jax_wire.session_request_spec(jax_test_config(), A), header, fields)
    assert ours == theirs
    q = rng.normal(size=A).astype(np.float32)
    rsp = (wire.MSG_RSP, 42, 7, wire.STATUS_OK)
    assert (wire.encode_frame(wire.session_response_spec(cfg, A), rsp,
                              dict(q=q))
            == jax_wire.encode_frame(
                jax_wire.session_response_spec(jax_test_config(), A), rsp,
                dict(q=q)))
    for status in (wire.STATUS_SHED, wire.STATUS_GONE, wire.STATUS_EXPIRED):
        h = (wire.MSG_RSP, 3, 9, status)
        assert (wire.encode_frame(wire.EMPTY_SPEC, h)
                == jax_wire.encode_frame(jax_wire.EMPTY_SPEC, h))
    # and the port decodes what JAX encodes, CRC gate included
    header2, views = wire.decode_frame(wire.session_request_spec(cfg, A),
                                       theirs[4:])
    assert header2 == header
    np.testing.assert_array_equal(views["obs"], obs)
    garbled = bytearray(theirs[4:])
    garbled[40] ^= 0xFF
    with pytest.raises(wire.WireGarbled):
        wire.decode_frame(wire.session_request_spec(cfg, A), bytes(garbled))


# ------------------------------------------------------------------ store

def test_store_lru_eviction_respects_reuse_and_pending():
    store = SessionStore(_cfg(serve_max_sessions=3))
    for sid in (1, 2, 3):
        assert store.admit(sid)[0] == "ok"
    store.gather([1], np.array([False]))          # order now 2, 3, 1
    assert store.admit(4) == ("ok", 2)
    assert store.mark_pending(3)                  # 3 is pinned in flight
    assert store.admit(5) == ("ok", 1)            # skips 3, takes 1
    assert store.mark_pending(4) and store.mark_pending(5)
    assert store.admit(6) == ("shed", None)       # nothing evictable
    _assert_accounting(store.counts())


def test_store_reap_idle_owner_and_accounting():
    store = SessionStore(_cfg(serve_max_sessions=4))
    for sid, owner in ((1, 7), (2, 7), (3, 8)):
        store.admit(sid, owner=owner, now=0.0)
    store.gather([1], np.array([False]), now=100.0)   # 1 is active
    store.mark_pending(2)                             # 2 is in flight
    assert store.reap_idle(10.0, now=101.0) == [3]
    store.clear_pending(2)
    assert sorted(store.reap_owner(7)) == [1, 2]
    assert store.release(99, "completed") is False
    store.admit(4)
    assert store.release(4, "completed")
    c = store.counts()
    assert (c["admitted"], c["completed"], c["reaped"], c["live"]) \
        == (4, 1, 3, 0)
    _assert_accounting(c)


def test_store_hidden_zeroed_on_reset_and_reuse():
    cfg = _cfg(serve_max_sessions=1)
    store = SessionStore(cfg)
    store.admit(1)
    row = np.ones((1, 2, cfg.lstm_layers, cfg.hidden_dim), np.float32)
    store.scatter([1], row)
    _, got = store.gather([1], np.array([False]))
    np.testing.assert_array_equal(got, row)
    _, got = store.gather([1], np.array([True]))      # episode reset
    assert not got.any()
    store.scatter([1], row)
    assert store.admit(2) == ("ok", 1)                # evicts 1's slot
    _, got = store.gather([2], np.array([False]))
    assert not got.any()                              # no state leaks


# ---------------------------------------------------------------- batcher

def test_bucket_sizes_cover_and_cap():
    assert bucket_sizes(1) == (1,)
    assert bucket_sizes(6) == (1, 2, 4, 6)
    assert bucket_sizes(256)[-1] == 256 and len(bucket_sizes(256)) == 9


def test_batcher_bucket_padding_bit_exact_one_put_one_fetch():
    """A ragged batch served through bucket padding equals, bit for bit,
    the direct act on the same rows zero-padded to the bucket, and each
    batch makes one put and one fetch whatever its size.  Against the
    direct act on exactly its n rows it agrees to 1e-6: the CPU BLAS may
    sum a product in another order at another row count.  Driving every
    bucket stays inside the declared retrace budgets (the direct act is
    deliberately called at each ragged size, and budgeted for it, as the
    reference's test does)."""
    cfg = _cfg(serve_max_batch=8)
    params = _port_params()
    b = ContinuousBatcher(cfg, A, device="cpu")
    b.publish(params)
    act = make_act_fn(create_network(cfg, A, device="cpu"),
                      retrace_budget=8)
    rng = np.random.default_rng(0)
    put0 = HOST_TRANSFERS.get("serving.act_put")
    fetch0 = HOST_TRANSFERS.get("serving.act_fetch")
    sizes = (1, 3, 5, 8)
    for n in sizes:
        rows = _rows(cfg, n, rng)
        q1, h1 = b.act(*rows)
        assert q1.shape == (n, A) and h1.shape == rows[3].shape
        pad = b.bucket(n)
        padded = [np.concatenate([r, np.zeros((pad - n, *r.shape[1:]),
                                              r.dtype)]) for r in rows]
        q2, h2 = act(params, *(torch.from_numpy(r) for r in padded))
        np.testing.assert_array_equal(q1, q2[:n].numpy())
        np.testing.assert_array_equal(h1, h2[:n].numpy())
        q3, h3 = act(params, *(torch.from_numpy(r) for r in rows))
        np.testing.assert_allclose(q1, q3.numpy(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(h1, h3.numpy(), atol=1e-6, rtol=0)
    assert HOST_TRANSFERS.get("serving.act_put") - put0 == len(sizes)
    assert HOST_TRANSFERS.get("serving.act_fetch") - fetch0 == len(sizes)
    with pytest.raises(ValueError, match="exceeds serve_max_batch"):
        b.bucket(9)
    RETRACES.assert_within_budgets()


def test_batcher_pad_rows_are_zeroed():
    """A small batch after a full one must not see the full batch's tail
    rows: the scratch pads with zeros, so a row's result does not depend
    on what an earlier batch left behind."""
    cfg = _cfg(serve_max_batch=4)
    b = ContinuousBatcher(cfg, A, device="cpu")
    b.publish(_port_params())
    rng = np.random.default_rng(5)
    rows = _rows(cfg, 3, rng)
    q_fresh, _ = b.act(*rows)
    b.act(*_rows(cfg, 4, rng))
    q_after, _ = b.act(*rows)
    np.testing.assert_array_equal(q_fresh, q_after)
    assert not b._scratch[4].views["hidden"][3].any()


def test_batcher_rejects_params_that_do_not_fit():
    b = ContinuousBatcher(_cfg(), A, device="cpu")
    params = _port_params()
    with pytest.raises(RuntimeError, match="no params"):
        b.act(*_rows(_cfg(), 1, np.random.default_rng(0)))
    bad = dict(params)
    bad.pop("head.val_out.bias")
    with pytest.raises(ValueError, match="missing"):
        b.publish(bad)
    bad = dict(params)
    bad["lstm_layers.0.wh"] = bad["lstm_layers.0.wh"][:, :8]
    with pytest.raises(ValueError, match="shape"):
        b.publish(bad)


def _flip_params(net, w0):
    """``net``'s params with a head whose greedy action hangs on action
    0's weight ``w0`` against action 1's 1.0 + 2^-10: at w0 = 1 + 2^-9 the
    full-precision head picks action 0 and the bf16-quantized one action
    1 (1 + 2^-9 rounds to 1.0 in bf16); at w0 = 1.5 both pick action 0."""
    p = {k: v.detach().clone() for k, v in net.state_dict().items()}
    for k in ("adv_hidden", "adv_out", "val_hidden", "val_out"):
        p[f"head.{k}.weight"].zero_()
        p[f"head.{k}.bias"].zero_()
    p["head.adv_hidden.bias"][0] = 1.0          # the head's input: e0
    p["head.adv_out.weight"][0, 0] = w0
    p["head.adv_out.weight"][1, 0] = 1.0
    p["head.adv_out.bias"][:] = torch.tensor(
        [0.0, 2.0 ** -10] + [-1.0] * (p["head.adv_out.bias"].numel() - 2))
    return p


@pytest.mark.parametrize("w0,parity", [(1 + 2 ** -9, False), (1.5, True)])
def test_greedy_parity_gate_sees_a_quantization_that_flips_an_action(
        w0, parity):
    """The gate compares the greedy actions of the full-precision and the
    bf16-quantized params (f32 compute, so the quantization is all that
    differs): a head whose quantization flips an action fails it, the
    same head with a wide margin passes."""
    cfg = _cfg(serve_dtype="bfloat16")
    net = create_network(cfg, A, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    b = ContinuousBatcher(cfg, A, device="cpu")
    assert b.greedy_parity_ok(_flip_params(net, w0)) is parity


def test_serve_dtype_bf16_quantizes_with_greedy_parity():
    cfg32 = _cfg()
    cfg16 = _cfg(serve_dtype="bfloat16")
    params = _port_params()
    b32 = ContinuousBatcher(cfg32, A, device="cpu")
    b16 = ContinuousBatcher(cfg16, A, device="cpu")
    b32.publish(params)
    b16.publish(params)
    assert any(not torch.equal(b32._params[k], b16._params[k])
               for k in params)
    for k, v in b16._params.items():
        assert torch.equal(v, v.to(torch.bfloat16).float()), k
    assert b16.greedy_parity_ok(params)
    assert b32.greedy_parity_ok(params)           # f32: trivially true
    rows = _rows(cfg32, 8, np.random.default_rng(7))
    q32, _ = b32.act(*rows)
    q16, _ = b16.act(*rows)
    np.testing.assert_allclose(q32, q16, atol=5e-2, rtol=5e-2)
    np.testing.assert_array_equal(q32.argmax(1), q16.argmax(1))


# ----------------------------------------------------------------- server

def _drive(server_cls, client_cls, cfg, params, streams, steps,
           **server_kw):
    """Open every session, act ``steps`` steps each (step 0 resets),
    feeding back the greedy action; returns {sid: [q per step]}."""
    out = {sid: [] for sid in streams}
    srv = server_cls(cfg, A, **server_kw)
    with _serving(srv, params):
        cl = client_cls(cfg, A, srv.host, srv.port, timeout=30)
        try:
            for sid in streams:
                assert cl.open_session(sid) == wire.STATUS_OK
            la = {sid: np.zeros(A, np.float32) for sid in streams}
            for t in range(steps):
                for sid in streams:
                    st, q = cl.act(sid, streams[sid][t], la[sid],
                                   0.25 * t, reset=t == 0)
                    assert st == wire.STATUS_OK
                    out[sid].append(q)
                    la[sid] = np.zeros(A, np.float32)
                    la[sid][int(np.argmax(q))] = 1.0
            for sid in streams:
                assert cl.close_session(sid) == wire.STATUS_OK
        finally:
            cl.close()
        stats = srv.stats()
        _assert_accounting(srv.store.counts())
    return out, stats


def test_server_matches_jax_server_on_same_params():
    """Two sessions × 3 steps over real loopback sockets through both
    packages' servers on the same params: the q streams agree to 1e-5
    (float32), so the session state the port carries is the reference's."""
    jcfg = jax_test_config(serve_max_sessions=8, serve_max_batch=8,
                           serve_session_idle_s=30.0)
    cfg = _cfg()
    flax_params = _flax_params()
    rng = np.random.default_rng(3)
    streams = {sid: [rng.integers(0, 256, cfg.stored_obs_shape)
                     .astype(np.uint8) for _ in range(3)] for sid in (1, 2)}
    ours, stats = _drive(SessionServer, SessionClient, cfg,
                         params_from_flax(jax.device_get(flax_params)),
                         streams, 3, device="cpu")
    theirs, _ = _drive(JaxServer, JaxClient, jcfg, flax_params, streams, 3)
    for sid in streams:
        np.testing.assert_allclose(np.stack(ours[sid]),
                                   np.stack(theirs[sid]), atol=1e-5, rtol=0)
    assert stats["requests"] == 6 and stats["act_failures"] == 0


def test_server_sessions_bit_exact_vs_local_act():
    """The server-resident hidden is the client-side unroll's, reset
    included, to the bit (same port network on both sides)."""
    cfg = _cfg()
    params = _port_params()
    act = make_act_fn(create_network(cfg, A, device="cpu"))
    rng = np.random.default_rng(4)
    steps = 4
    streams = {sid: [rng.integers(0, 256, cfg.stored_obs_shape)
                     .astype(np.uint8) for _ in range(steps)]
               for sid in (5, 6)}
    served, _ = _drive(SessionServer, SessionClient, cfg, params, streams,
                       steps, device="cpu")
    for sid, qs in served.items():
        hid = torch.zeros(1, 2, cfg.lstm_layers, cfg.hidden_dim)
        la = np.zeros(A, np.float32)
        for t in range(steps):
            q, hid = act(params, torch.from_numpy(streams[sid][t][None]),
                         torch.from_numpy(la[None]),
                         torch.tensor([0.25 * t]), hid)
            np.testing.assert_array_equal(qs[t], q[0].numpy())
            la = np.zeros(A, np.float32)
            la[int(np.argmax(qs[t]))] = 1.0


def test_server_answers_gone_for_unknown_session():
    cfg = _cfg()
    srv = SessionServer(cfg, A, device="cpu")
    with _serving(srv, _port_params()):
        cl = SessionClient(cfg, A, srv.host, srv.port, timeout=30)
        try:
            obs = np.zeros(cfg.stored_obs_shape, np.uint8)
            st, q = cl.act(77, obs, np.zeros(A, np.float32), 0.0)
            assert st == wire.STATUS_GONE and q is None
        finally:
            cl.close()
        assert srv.stats()["gone"] == 1


def test_server_disconnect_reaps_and_health_degrades():
    """A client that drops its connection mid-episode gets its sessions
    reaped (never leaked), the health verdict goes ok → degraded (HTTP
    200 class, the tier degrading by design), and the registry's counters
    track the served requests."""
    cfg = _cfg()
    srv = SessionServer(cfg, A, device="cpu")
    with _serving(srv, _port_params()):
        assert srv.healthz()["status"] == "ok"
        cl = SessionClient(cfg, A, srv.host, srv.port, timeout=30)
        obs = np.zeros(cfg.stored_obs_shape, np.uint8)
        for sid in (1, 2):
            assert cl.open_session(sid) == wire.STATUS_OK
            st, _ = cl.act(sid, obs, np.zeros(A, np.float32), 0.0,
                           reset=True)
            assert st == wire.STATUS_OK
        cl.close()                       # no CLOSE for either session
        deadline = time.monotonic() + 20
        while srv.store.counts()["reaped"] < 2:
            assert time.monotonic() < deadline, srv.store.counts()
            time.sleep(0.01)
        c = srv.store.counts()
        assert c["live"] == 0
        _assert_accounting(c)
        h = srv.healthz()
        assert h["ok"] and h["status"] == "degraded"
        # the batch loop counts a batch's requests after its replies go
        # out, so the count can trail the client's last reply
        while srv.registry.get_counter("serving.requests") < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert srv.registry.get_counter("serving.requests") == 2


def test_server_and_client_sockets_disable_nagle():
    """Small frames must not wait for the peer's delayed ACK: both ends
    set TCP_NODELAY (the reference's sockets do not; ROADMAP.md C)."""
    import socket

    cfg = _cfg()
    srv = SessionServer(cfg, A, device="cpu")
    with _serving(srv, _port_params()):
        cl = SessionClient(cfg, A, srv.host, srv.port, timeout=30)
        try:
            assert cl.open_session(1) == wire.STATUS_OK
            assert cl.sock.getsockopt(socket.IPPROTO_TCP,
                                      socket.TCP_NODELAY)
            with srv._conns_lock:
                conns = list(srv._conns.values())
            assert conns and all(
                c.sock.getsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY)
                for c in conns)
        finally:
            cl.close()


# --------------------------------------------------------- device, imports

def test_act_device_resolution_never_moves_to_cpu_silently(monkeypatch):
    assert _resolve_act_device("cpu") == torch.device("cpu")
    assert _resolve_act_device("auto", device="cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for spec in ("auto", "default"):
        with pytest.raises(RuntimeError, match="CUDA"):
            _resolve_act_device(spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatcher(_cfg(), A)        # act_device="auto" by default
    with pytest.raises(ValueError):
        _resolve_act_device("tpu")


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import r2d2_tpu_torch, r2d2_tpu_torch.serving.server, "
            "r2d2_tpu_torch.models, r2d2_tpu_torch.actor, "
            "r2d2_tpu_torch.utils.math, r2d2_tpu_torch.native, "
            "r2d2_tpu_torch.replay.sum_tree, r2d2_tpu_torch.replay.block, "
            "r2d2_tpu_torch.replay.replay_buffer, r2d2_tpu_torch.envs, "
            "r2d2_tpu_torch.utils.store, r2d2_tpu_torch.learner.step, "
            "r2d2_tpu_torch.learner.learner, r2d2_tpu_torch.checkpoint, "
            "r2d2_tpu_torch.train, r2d2_tpu_torch.evaluate, "
            "r2d2_tpu_torch.models.convert, "
            "r2d2_tpu_torch.telemetry.tracing; "
            "bad = [m for m in sys.modules if m == 'r2d2_tpu' "
            "or m.startswith('r2d2_tpu.') or m.split('.')[0] in "
            "('flax', 'optax', 'orbax')]; "
            "assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_port_sources_never_import_the_jax_package():
    """No module of the port, and nothing in chip_smoke.py, imports
    ``r2d2_tpu`` or JAX — not even lazily inside a function."""
    import re

    pat = re.compile(r"^\s*(from|import)\s+(r2d2_tpu|jax|flax|optax|orbax)"
                     r"(\.|\s|$)")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "r2d2_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = []
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if pat.match(line):
                    bad.append(f"{os.path.relpath(path, REPO)}:{i}")
    assert not bad, bad


# ------------------------------------------------ run_server on checkpoints

def _save_checkpoint(ckdir, cfg, step, params, **meta):
    """One complete port checkpoint of ``params`` at ``step``, with the
    architecture meta the trainer writes (overridden by ``meta``)."""
    from r2d2_tpu_torch.checkpoint import Checkpointer, arch_meta
    from r2d2_tpu_torch.learner.step import create_train_state

    state = create_train_state(cfg, {k: v.clone() for k, v in params.items()})
    Checkpointer(ckdir).save(step, state,
                             meta=dict(arch_meta(cfg), env_steps=0, **meta))


@contextlib.contextmanager
def _run_server(monkeypatch, cfg, ckdir, **kw):
    """run_server in a worker thread (signals reach only the main one);
    yields (the server it built, a dict that receives its summary), and
    stops it through ``stop_fn`` on exit."""
    import threading

    from r2d2_tpu_torch.serving import server as server_mod

    built, result = {}, {}
    real = server_mod.SessionServer

    class Recorded(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            built["server"] = self

    monkeypatch.setattr(server_mod, "SessionServer", Recorded)
    done = threading.Event()

    def body():
        try:
            result.update(server_mod.run_server(
                cfg, ckdir, action_dim=A, verbose=False, stop_fn=done.is_set,
                max_wall_seconds=120, **kw))
        except BaseException as e:
            result["error"] = e

    t = threading.Thread(target=body)
    t.start()
    deadline = time.time() + 60
    while not ("error" in result or (built.get("server") is not None
                                     and built["server"]._started)):
        assert time.time() < deadline, "run_server did not start"
        time.sleep(0.01)
    try:
        yield built.get("server"), result
    finally:
        done.set()
        t.join(timeout=60)
        assert not t.is_alive()


def _act_steps(cl, sid, stream, lo, hi, la):
    out = []
    for t in range(lo, hi):
        st, q = cl.act(sid, stream[t], la, 0.25 * t, reset=t == 0)
        assert st == wire.STATUS_OK
        out.append(np.array(q))
        la = np.zeros(A, np.float32)
        la[int(np.argmax(q))] = 1.0
    return out, la


def _local_qs(cfg, params, stream, steps):
    """The client-side unroll of one session on the port network."""
    act = make_act_fn(create_network(cfg, A, device="cpu"))
    hid = torch.zeros(1, 2, cfg.lstm_layers, cfg.hidden_dim)
    la, out = np.zeros(A, np.float32), []
    for t in range(steps):
        q, hid = act(params, torch.from_numpy(stream[t][None]),
                     torch.from_numpy(la[None]), torch.tensor([0.25 * t]),
                     hid)
        out.append(q[0].numpy())
        la = np.zeros(A, np.float32)
        la[int(np.argmax(out[-1]))] = 1.0
    return out


def test_run_server_serves_a_port_checkpoint(monkeypatch, tmp_path):
    """The newest complete step is restored and served: the served q
    stream is the local act's on its params, bit for bit; at shutdown the
    live sessions are snapshotted with the store's counters."""
    cfg = _cfg(telemetry_port=-1, act_device="cpu")
    ck = str(tmp_path / "ck")
    old, params = _port_params(seed=1), _port_params(seed=2)
    _save_checkpoint(ck, cfg, 3, old)
    _save_checkpoint(ck, cfg, 6, params)
    rng = np.random.default_rng(8)
    stream = [rng.integers(0, 256, cfg.stored_obs_shape).astype(np.uint8)
              for _ in range(4)]
    with _run_server(monkeypatch, cfg, ck) as (srv, result):
        assert srv.batcher.device.type == "cpu"
        status, body = _http_get(srv.exporter.port, "/healthz")
        assert status == 200 and '"ok"' in body
        cl = SessionClient(cfg, A, srv.host, srv.port, timeout=30)
        assert cl.open_session(11) == wire.STATUS_OK
        assert cl.open_session(12) == wire.STATUS_OK
        got, _ = _act_steps(cl, 11, stream, 0, 4, np.zeros(A, np.float32))
        assert cl.close_session(12) == wire.STATUS_OK
    # the client leaves after the server stopped: session 11 is live in
    # the shutdown snapshot, not reaped as an abandoned one
    cl.close()
    assert "error" not in result, result.get("error")
    assert srv.exporter.closed     # its loop ended with the server
    assert result["step"] == 6 and result["health"] == "ok"
    _assert_accounting(result)
    for a, b in zip(got, _local_qs(cfg, params, stream, 4)):
        np.testing.assert_array_equal(a, b)
    from r2d2_tpu_torch.checkpoint import Checkpointer

    meta, _ = Checkpointer(ck).restore_sessions()
    assert meta["counters"] == {k: result[k] for k in (
        "admitted", "completed", "reaped", "evicted")}
    assert meta["live"] == result["live"] == 1


def _http_get(port, path):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read().decode()
    finally:
        conn.close()


def test_run_server_refuses_an_architecture_mismatch(tmp_path):
    from r2d2_tpu_torch.serving import run_server

    cfg = _cfg(act_device="cpu")
    ck = str(tmp_path / "ck")
    _save_checkpoint(ck, cfg, 2, _port_params(), hidden_dim=64,
                     lstm_layers=2)
    with pytest.raises(ValueError, match="architecture mismatch") as e:
        run_server(cfg, ck, action_dim=A, verbose=False)
    assert "hidden_dim" in str(e.value) and "lstm_layers" in str(e.value)


def test_run_server_without_a_checkpoint_raises(tmp_path):
    from r2d2_tpu_torch.serving import run_server

    with pytest.raises(FileNotFoundError, match="no complete checkpoint"):
        run_server(_cfg(act_device="cpu"), str(tmp_path), action_dim=A)
    # follow mode waits for the first save, within the wall budget
    with pytest.raises(FileNotFoundError, match="within the wall budget"):
        run_server(_cfg(act_device="cpu"), str(tmp_path), action_dim=A,
                   follow=True,
                   max_wall_seconds=0.3)


def test_run_server_acts_on_the_card_by_default(monkeypatch, tmp_path):
    from r2d2_tpu_torch.serving import run_server

    ck = str(tmp_path / "ck")
    _save_checkpoint(ck, _cfg(), 1, _port_params())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_server(port_test_config(), ck, action_dim=A, verbose=False)


def test_follow_republishes_new_steps_and_skips_a_failed_gate(tmp_path):
    """follow_params_once: a new complete step is republished; a step
    whose greedy-parity gate fails is skipped (serving stays on the last
    good params) and never retried; an arch-drifted step is skipped; a
    torn step (no sidecar) is not a candidate at all."""
    from r2d2_tpu_torch.checkpoint import Checkpointer
    from r2d2_tpu_torch.serving import follow_params_once

    cfg = _cfg()
    ck = str(tmp_path / "ck")
    srv = SessionServer(cfg, A, device="cpu")
    try:
        srv.publish_params(_port_params(seed=0))
        followed = dict(step=1, republishes=0, parity_failures=0)
        ckpt = Checkpointer(ck)
        assert not follow_params_once(srv, ckpt, cfg, followed)
        _save_checkpoint(ck, cfg, 2, _port_params(seed=2))
        assert follow_params_once(srv, ckpt, cfg, followed)
        assert followed == dict(step=2, republishes=1, parity_failures=0)
        assert srv.batcher.version == 2
        v2 = {k: v.clone() for k, v in srv.batcher._params.items()}
        srv.batcher.greedy_parity_ok = lambda params: False
        _save_checkpoint(ck, cfg, 3, _port_params(seed=3))
        assert not follow_params_once(srv, ckpt, cfg, followed)
        assert followed == dict(step=3, republishes=1, parity_failures=1)
        assert not follow_params_once(srv, ckpt, cfg, followed)
        assert all(torch.equal(v2[k], srv.batcher._params[k]) for k in v2)
        del srv.batcher.greedy_parity_ok
        os.makedirs(os.path.join(ck, "step_9"))          # torn: no sidecar
        _save_checkpoint(ck, cfg, 4, _port_params(seed=4), hidden_dim=99)
        assert not follow_params_once(srv, ckpt, cfg, followed)
        assert followed["step"] == 4 and srv.batcher.version == 2
        assert srv.registry.get_counter("serving.republishes") == 1
        assert srv.registry.get_counter(
            "serving.follow_parity_failures") == 1
    finally:
        srv.close()


def test_run_server_follow_mode_republishes(monkeypatch, tmp_path):
    cfg = _cfg(act_device="cpu")
    ck = str(tmp_path / "ck")
    _save_checkpoint(ck, cfg, 1, _port_params(seed=1))
    with _run_server(monkeypatch, cfg, ck, follow=True,
                     follow_poll=0.05) as (srv, result):
        _save_checkpoint(ck, cfg, 5, _port_params(seed=5))
        deadline = time.time() + 30
        while srv.batcher.version < 2:
            assert time.time() < deadline, "step 5 was not republished"
            time.sleep(0.02)
    assert result["followed_step"] == 5 and result["republishes"] == 1
    assert result["follow_parity_failures"] == 0


def test_run_server_resume_sessions_restores_hidden_bit_exact(
        monkeypatch, tmp_path):
    """Serve two steps, shut down (the live session is snapshotted),
    serve again with resume_sessions: the session continues by id, and its
    q stream equals an uninterrupted unroll's, bit for bit."""
    cfg = _cfg(act_device="cpu")
    ck = str(tmp_path / "ck")
    params = _port_params(seed=4)
    _save_checkpoint(ck, cfg, 2, params)
    rng = np.random.default_rng(3)
    stream = [rng.integers(0, 256, cfg.stored_obs_shape).astype(np.uint8)
              for _ in range(5)]
    with _run_server(monkeypatch, cfg, ck) as (srv, result):
        cl = SessionClient(cfg, A, srv.host, srv.port, timeout=30)
        assert cl.open_session(7) == wire.STATUS_OK
        got, la = _act_steps(cl, 7, stream, 0, 2, np.zeros(A, np.float32))
    cl.close()
    assert result["live"] == 1
    hidden = srv.store.hidden[srv.store._sessions[7].slot].copy()
    with _run_server(monkeypatch, cfg, ck, resume_sessions=True) as (
            srv2, result2):
        assert srv2.store.live() == 1
        np.testing.assert_array_equal(
            srv2.store.hidden[srv2.store._sessions[7].slot], hidden)
        cl = SessionClient(cfg, A, srv2.host, srv2.port, timeout=30)
        try:
            more, _ = _act_steps(cl, 7, stream, 2, 5, la)
            assert cl.close_session(7) == wire.STATUS_OK
        finally:
            cl.close()
    assert result2["completed"] == 1 and result2["live"] == 0
    _assert_accounting(result2)
    for a, b in zip(got + more, _local_qs(cfg, params, stream, 5)):
        np.testing.assert_array_equal(a, b)
