"""The port's actor against the JAX package's, on the CPU.

The vector actor is host numpy around one act call per lockstep step, so
with the same act (a numpy stub both sides call), the same envs and the
same rng seeds, the two packages' block streams must be identical, bit for
bit.  The port's real act (``make_host_act_fn``) is held to JAX's
``make_act_fn`` on the same params within float32 tolerance.
"""
import jax
import numpy as np
import pytest
import torch

from r2d2_tpu import actor as jactor
from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu.envs import FakeAtariEnv as JaxFakeEnv
from r2d2_tpu.models.network import create_network as jax_create
from r2d2_tpu.models.network import init_params
from r2d2_tpu.utils.store import ParamStore as JaxParamStore
from r2d2_tpu_torch import actor as tactor
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.envs import FakeAtariEnv
from r2d2_tpu_torch.models import create_network, params_from_flax
from r2d2_tpu_torch.utils.math import epsilon_ladder
from r2d2_tpu_torch.utils.store import ParamStore
from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS

A = 4
N = 3
# episodes of 10 steps end inside and across blocks of 8; the 13-step cap
# never binds on them, so it gets its own lane config below
KW = dict(num_actors=N, max_episode_steps=13, actor_update_interval=5)


def stub_act(params, obs, last_action, last_reward, hidden):
    """A deterministic numpy act: q and the new hidden from the inputs."""
    n = obs.shape[0]
    feat = obs.reshape(n, -1)[:, :A].astype(np.float32) / 255.0
    q = (feat + last_action * 0.25 + last_reward[:, None] * 0.1
         + hidden[:, 0, 0, :A]).astype(np.float32)
    new_hidden = (hidden * 0.5 + feat.mean(1)[:, None, None, None]
                  ).astype(np.float32)
    return q, new_hidden


def make_pair(episode_len=10, **kw):
    jcfg = jax_test_config(**KW, **kw)
    tcfg = port_test_config(act_device="cpu", **KW, **kw)
    eps = [epsilon_ladder(i, N) for i in range(N)]
    sinks = ([], [])
    jstore = JaxParamStore()
    jstore.publish({"w": np.zeros(1, np.float32)})
    store = ParamStore()
    store.publish({"w": torch.zeros(1)})
    ref = jactor.VectorActor(
        jcfg, [JaxFakeEnv(jcfg.obs_shape, A, episode_len, seed=i)
               for i in range(N)], eps, stub_act, jstore,
        sink=lambda *item: sinks[0].append(item),
        rng=np.random.default_rng(5))
    port = tactor.VectorActor(
        tcfg, [FakeAtariEnv(tcfg.obs_shape, A, episode_len, seed=i)
               for i in range(N)], eps, stub_act, store,
        sink=lambda *item: sinks[1].append(item),
        rng=np.random.default_rng(5))
    return ref, port, sinks


def assert_streams_equal(got, want):
    assert len(got) == len(want) > 0
    for (b, p, r), (bw, pw, rw) in zip(got, want):
        for f in bw.__dataclass_fields__:
            if f in ("cut_ts", "trace_id", "member_id"):
                continue
            x, y = getattr(b, f), getattr(bw, f)
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype, f
                np.testing.assert_array_equal(x, y, err_msg=f)
            else:
                assert x == y, f
        np.testing.assert_array_equal(p, pw)
        assert r == rw


@pytest.mark.parametrize("episode_len", [10, 40])
def test_block_stream_matches_jax(episode_len):
    """Terminal cuts, deferred boundary cuts with their bootstrap Q and
    (at episode_len 40) the 13-step episode cap, over 60 iterations."""
    ref, port, (want, got) = make_pair(episode_len)
    for burst in (7, 23, 30):
        ref.run(burst)
        port.run(burst)
    assert_streams_equal(got, want)
    assert port.actor_steps == ref.actor_steps == 60
    np.testing.assert_array_equal(port.hidden, ref.hidden)
    np.testing.assert_array_equal(port.episode_steps, ref.episode_steps)


def test_snapshot_restore_round_trip():
    """A fresh actor restored from a snapshot goes on exactly as the
    actor it was taken from, mid-episode and mid-block."""
    _, a, (_, got_a) = make_pair()
    a.run(17)
    snap = a.snapshot()
    a.run(25)
    _, b, (_, got_b) = make_pair()
    b.restore(snap)
    b.run(25)
    tail = got_a[len(got_a) - len(got_b):]
    assert_streams_equal(got_b, tail)
    np.testing.assert_array_equal(a.hidden, b.hidden)
    assert a.snapshot()["rng"] == b.snapshot()["rng"]
    _, c, _ = make_pair()
    snap["num_lanes"] = N + 1
    with pytest.raises(ValueError):
        c.restore(snap)


def test_snapshot_matches_jax():
    ref, port, _ = make_pair()
    ref.run(11)
    port.run(11)
    sj, st = ref.snapshot(), port.snapshot()
    assert sj["rng"] == st["rng"] and sj["env_states"] == st["env_states"]
    for group in ("agent", "vbuf"):
        for k in sj[group]:
            np.testing.assert_array_equal(st[group][k], sj[group][k])


def test_host_act_matches_jax_act():
    """Same params on both sides: q within 1e-5, the new hidden within
    1e-6, the same greedy actions; one counted device→host fetch a call."""
    jcfg = jax_test_config()
    cfg = port_test_config(act_device="cpu")
    jnet = jax_create(jcfg, A)
    params = init_params(jcfg, jnet, jax.random.PRNGKey(1))
    jact = jactor.make_act_fn(jcfg, jnet)
    net = create_network(cfg, A, device="cpu")
    act = tactor.make_host_act_fn(net, name="test.act_fetch")
    tparams = params_from_flax(jax.device_get(params))
    rng = np.random.default_rng(0)
    B = 7
    args = (rng.integers(0, 255, (B, *cfg.obs_shape), dtype=np.uint8),
            np.eye(A, dtype=np.float32)[rng.integers(A, size=B)],
            rng.normal(size=B).astype(np.float32),
            rng.normal(size=(B, 2, cfg.lstm_layers, cfg.hidden_dim)
                       ).astype(np.float32))
    before = HOST_TRANSFERS.get("test.act_fetch")
    q, h = act(tparams, *args)
    assert HOST_TRANSFERS.get("test.act_fetch") == before + 1
    jq, jh = (np.asarray(x) for x in jact(params, *args))
    assert isinstance(q, np.ndarray) and q.shape == (B, A)
    np.testing.assert_allclose(q, jq, rtol=0, atol=1e-5)
    np.testing.assert_allclose(h, jh, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(q.argmax(1), jq.argmax(1))


def test_agent_state_and_fleet_shards_match_jax():
    jcfg = jax_test_config(num_actors=7, actor_fleets=3, env_workers=4)
    cfg = port_test_config(num_actors=7, actor_fleets=3, env_workers=4)
    assert tactor.fleet_shards(cfg) == jactor.fleet_shards(jcfg)
    obs = np.ones(cfg.obs_shape, np.uint8)
    a = tactor.AgentState.initial(cfg, obs, A)
    b = jactor.AgentState.initial(jcfg, obs, A)
    a.update(obs, 2, 1.5, np.ones_like(a.hidden))
    b.update(obs, 2, 1.5, np.ones_like(b.hidden))
    for f in ("obs", "last_action", "hidden"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.last_reward == b.last_reward


def test_act_device_never_falls_back_silently(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tactor._resolve_act_device("auto")
    assert tactor._resolve_act_device("cpu") == torch.device("cpu")
    assert tactor._resolve_act_device("auto", "cpu") == torch.device("cpu")


def test_param_store_places_once_per_version():
    store = ParamStore()
    assert store.get() == (0, None)
    snap = {"w": torch.arange(3.0)}
    assert store.publish(snap) == 1
    v, placed = store.get_placed("cpu")
    assert v == 1 and placed["w"] is snap["w"]   # already there: no copy
    assert store.get_placed("cpu")[1] is placed  # cached per version
    store.publish({"w": torch.zeros(3)})
    assert store.get_placed("cpu")[1] is not placed
