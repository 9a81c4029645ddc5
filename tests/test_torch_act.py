"""The act's params adopted in place (``actor.GraphedAct``), on the CPU.

Every act instance owns one set of param tensors and copies each new
params dict into them once, keyed by the dict's identity; on a card it
then replays the CUDA graph of the input shape (``tests/test_torch_cuda.py``
holds the graphs bit for bit against the eager act there).  Here:

- an adopted dict computes bitwise what an eager ``functional_call`` on
  that dict computes, and the dict itself is never written;
- the same dict again copies nothing, even when its values changed in
  place (the key is the identity: a published dict is never written in
  place, a publish is a new dict);
- a dict with a missing or unexpected key, a wrong shape or, after the
  first, another dtype raises;
- over three publishes the act equals JAX's ``make_act_fn`` on the
  converted params at the network tolerance (1e-5);
- a vector actor adopts once per published version;
- ``PROFILER_LOCK``'s gate lets graphs of many threads launch at once and
  a profiler's start or stop run alone.

Small: the mlp torso at the test config's tiny widths.
"""
import jax
import numpy as np
import pytest
import torch
from torch.func import functional_call

from r2d2_tpu import actor as jactor
from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu.models.network import create_network as jax_create
from r2d2_tpu.models.network import init_params
from r2d2_tpu_torch import actor as tactor
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.envs import FakeAtariEnv
from r2d2_tpu_torch.models import create_network, params_from_flax
from r2d2_tpu_torch.utils.store import ParamStore
from r2d2_tpu_torch.utils.trace import RetraceGuard

A = 4
# the network tolerance against JAX (tests/test_torch_actor.py)
NET_TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(autouse=True)
def private_guard(monkeypatch):
    """Acts built here count in a guard of their own, never in the
    process-wide one later tests of this worker assert on."""
    guard = RetraceGuard()
    monkeypatch.setattr(tactor, "RETRACES", guard)
    return guard


def _net(cfg, seed=0):
    return create_network(cfg, A, device="cpu",
                          generator=torch.Generator().manual_seed(seed))


def _params(cfg, seed):
    return {k: v.detach().clone() for k, v in _net(cfg, seed).state_dict()
            .items()}


def _inputs(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (B, *cfg.stored_obs_shape),
                                          dtype=np.uint8)),
            torch.from_numpy(np.eye(A, dtype=np.float32)[
                rng.integers(A, size=B)]),
            torch.from_numpy(rng.normal(size=B).astype(np.float32)),
            torch.from_numpy((rng.normal(size=(
                B, 2, cfg.lstm_layers, cfg.hidden_dim)) * 0.3)
                .astype(np.float32)))


def _eager(net, params, x):
    with torch.inference_mode():
        return functional_call(net, params, x)


def _same(a, b) -> bool:
    return all(torch.equal(u, v) for u, v in zip(a, b))


def test_adopted_params_act_bitwise_as_eager_functional_call():
    """Three dicts in turn: each act after an adoption is bitwise the
    eager ``functional_call`` on that dict; the act's tensors are its own,
    and no adopted dict is written."""
    cfg = port_test_config(act_device="cpu")
    net = _net(cfg)
    act = tactor.make_act_fn(net)
    dicts = [_params(cfg, s) for s in (1, 2, 3)]
    kept = [{k: v.clone() for k, v in d.items()} for d in dicts]
    for i, d in enumerate(dicts):
        for B in (3, 5):
            x = _inputs(cfg, B, 10 * i + B)
            assert _same(act(d, *x), _eager(net, kept[i], x))
        assert act.adoptions == i + 1
        assert all(act.params[k].data_ptr() != v.data_ptr()
                   for k, v in d.items())
    for d, k in zip(dicts, kept):
        assert _same(d.values(), k.values())
    # the module's own parameters were never written either
    assert _same(net.state_dict().values(), _params(cfg, 0).values())


def test_the_same_dict_again_copies_nothing():
    """The key is the dict's identity: calling with the adopted dict
    copies nothing, even after its values were changed in place; a new
    dict with the changed values is adopted."""
    cfg = port_test_config(act_device="cpu")
    net = _net(cfg)
    act = tactor.make_act_fn(net)
    d = _params(cfg, 1)
    before = {k: v.clone() for k, v in d.items()}
    x = _inputs(cfg, 4, 0)
    first = act(d, *x)
    for _ in range(3):
        assert _same(act(d, *x), first)
    assert act.adoptions == 1
    with torch.no_grad():
        d["head.adv_out.bias"].add_(1.0)
    assert _same(act(d, *x), _eager(net, before, x))
    assert act.adoptions == 1
    moved = dict(d)
    assert _same(act(moved, *x), _eager(net, moved, x))
    assert act.adoptions == 2


@pytest.mark.parametrize("fault", ["missing", "unexpected", "shape",
                                   "dtype"])
def test_a_dict_that_does_not_fit_raises(fault):
    cfg = port_test_config(act_device="cpu")
    act = tactor.make_act_fn(_net(cfg))
    x = _inputs(cfg, 2, 0)
    act(_params(cfg, 1), *x)
    bad = _params(cfg, 2)
    key = "head.adv_out.weight"
    if fault == "missing":
        del bad[key]
    elif fault == "unexpected":
        bad["extra"] = torch.zeros(1)
    elif fault == "shape":
        bad[key] = bad[key][:, :-1].clone()
    else:
        bad[key] = bad[key].double()
    with pytest.raises(ValueError, match="network" if fault in (
            "missing", "unexpected") else key):
        act(bad, *x)
    assert act.adoptions == 1


def test_act_matches_jax_across_three_publishes():
    """JAX's jitted act and the port's adopting act over the same
    sequence of publishes and batch shapes: q and the new hidden within
    1e-5, the same greedy actions; one adoption a publish."""
    jcfg = jax_test_config()
    cfg = port_test_config(act_device="cpu")
    jnet = jax_create(jcfg, A)
    jact = jactor.make_act_fn(jcfg, jnet)
    act = tactor.make_act_fn(create_network(cfg, A, device="cpu"))
    for p in range(3):
        jparams = init_params(jcfg, jnet, jax.random.PRNGKey(p))
        tparams = params_from_flax(jax.device_get(jparams))
        for B in (3, 5, 3):
            x = _inputs(cfg, B, 7 * p + B)
            q, h = act(tparams, *x)
            jq, jh = (np.asarray(a) for a in jact(
                jparams, *(a.numpy() for a in x)))
            np.testing.assert_allclose(q.numpy(), jq, **NET_TOL)
            np.testing.assert_allclose(h.numpy(), jh, **NET_TOL)
            np.testing.assert_array_equal(q.numpy().argmax(1),
                                          jq.argmax(1))
        assert act.adoptions == p + 1


def test_vector_actor_adopts_once_per_published_version():
    """A thread fleet's host act across publishes: one adoption per
    version the actor picks up (``run`` refreshes at its start and every
    ``actor_update_interval`` steps), none between, one trace."""
    cfg = port_test_config(act_device="cpu", num_actors=2,
                           actor_update_interval=4)
    act = tactor.make_host_act_fn(_net(cfg))
    store = ParamStore(_params(cfg, 1))
    actor = tactor.VectorActor(
        cfg, [FakeAtariEnv(obs_shape=cfg.stored_obs_shape, action_dim=A,
                           episode_len=10, seed=i) for i in range(2)],
        [0.4, 0.1], act, store, sink=lambda *item: None,
        rng=np.random.default_rng(0))
    actor.run(3)
    assert act.act.adoptions == 1
    store.publish(_params(cfg, 2))
    actor.run(3)
    assert act.act.adoptions == 2
    actor.run(3)      # no new version: nothing copied
    store.publish(_params(cfg, 3))
    actor.run(3)
    assert act.act.adoptions == 3
    assert act.act.entry.traces == 1


def test_profiler_gate_lets_graphs_overlap_and_a_profiler_run_alone():
    """``PROFILER_LOCK`` (``utils/trace.ProfilerGate``) under contention:
    eight threads entering shared (graph launches and captures) overlap
    one another, and two threads entering exclusive (a profiler's start
    and stop) each find no shared holder inside for the whole of their
    hold and are not starved; every thread finishes in time."""
    import sys
    import threading
    import time

    from r2d2_tpu_torch.utils.trace import ProfilerGate

    gate, lock = ProfilerGate(), threading.Lock()
    inside, most, seen_inside = [0], [0], []
    stop = threading.Event()

    def launcher():
        while not stop.is_set():
            with gate.shared():
                with lock:
                    inside[0] += 1
                    most[0] = max(most[0], inside[0])
                time.sleep(0.0005)
                with lock:
                    inside[0] -= 1

    def profiler():
        for _ in range(20):
            with gate.exclusive():
                for _ in range(2):
                    with lock:
                        if inside[0]:
                            seen_inside.append(inside[0])
                    time.sleep(0.001)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        launchers = [threading.Thread(target=launcher) for _ in range(8)]
        profilers = [threading.Thread(target=profiler) for _ in range(2)]
        for t in launchers + profilers:
            t.start()
        for t in profilers:
            t.join(60)
        stop.set()
        for t in launchers:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in launchers + profilers)
    assert seen_inside == [] and most[0] > 1
