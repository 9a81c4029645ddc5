"""The meshless anakin entries as CUDA graphs (learner/graphs.py:
``graphed_super_step``, ``graphed_rollout``), checked on the CPU, where
their graph-ready bodies run eagerly.

A CUDA graph repeats the kernel arguments of its capture, so nothing a
dispatch derives from the python dispatch index may reach a kernel as an
argument: the PER uniforms and the eval episodes' root derive from a 0-d
int64 tensor on the device.  These tests pin:

1. **The device roots** — ``derive``, ``sample_uniforms``, ``lane_keys``
   and the envs' ``init_state`` from a tensor index equal the host's
   python-int derivation bit for bit, at 0 and 0xFFFFFFFF among others.
2. **The graph-ready bodies** — a plane whose entries write the carry,
   the ring and the PER state in place, the index a tensor, against a
   plane running today's eager ``make_anakin_super_step`` and
   ``make_anakin_rollout``: every warm-up rollout and three dispatches
   (the eval lane on the first and third) bit for bit in the result
   vector, the carry, the ring, the PER state and the train state, with
   the eval lane on and with the learnhealth diagnostic armed; the carry
   keeps its addresses.
3. **The trace counts** — one trace of each entry on the CPU, as JAX's
   ``jax.jit`` compiles each once.
"""
import jax
import numpy as np
import pytest
import torch

from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu.learner import anakin as janakin
from r2d2_tpu.learner import step as jstep
from r2d2_tpu.models.network import create_network as jax_create
from r2d2_tpu.models.network import init_params
from r2d2_tpu.replay.device_ring import DeviceRing as JaxDeviceRing
from r2d2_tpu.utils import trace as jtrace
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.envs import anakin as tenv
from r2d2_tpu_torch.learner import anakin as tanakin
from r2d2_tpu_torch.learner import step as tstep
from r2d2_tpu_torch.learner.learner import Learner
from r2d2_tpu_torch.models import create_network
from r2d2_tpu_torch.replay.device_ring import DeviceRing

A = 4
BASE = dict(game_name="Fake", actor_transport="anakin", device_replay=True,
            in_graph_per=True, num_actors=2, superstep_k=2,
            anakin_episode_len=12, training_steps=10 ** 9,
            learning_starts=16)
INDICES = (0, 1, 2, 977, 0x7FFFFFFF, 0xFFFFFFFE, 0xFFFFFFFF)


def anakin_config(**kw):
    return port_test_config(**{**BASE, **kw})


def build(cfg, seed=0):
    net = create_network(cfg, A, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    plane = tanakin.AnakinPlane(cfg, net, A, DeviceRing(cfg, A, device="cpu"))
    learner = Learner(cfg, net, tstep.create_train_state(cfg,
                                                         net.state_dict()))
    return net, plane, learner


def state_arrays(state):
    return ([state.step_t, state.opt_state.count_t]
            + [t for d in (state.params, state.target_params,
                           state.opt_state.mu, state.opt_state.nu)
               for _, t in sorted(d.items())])


# ------------------------------------------------------------ device roots

@pytest.mark.parametrize("idx", INDICES)
def test_device_roots_are_the_host_derivation(idx):
    """The dispatch index as a 0-d int64 tensor gives the python int's
    roots, uniforms, lane keys and env resets bit for bit."""
    cfg = anakin_config()
    t = torch.tensor(idx, dtype=torch.int64)
    for salt in (tanakin._SAMPLE_SALT, tanakin._EVAL_SALT):
        host = tenv.derive(cfg.seed, salt, idx)
        dev = tenv.derive(cfg.seed, salt, t)
        assert isinstance(host, int) and dev.shape == ()
        assert dev.dtype == torch.int64 and int(dev) == host
        assert torch.equal(tenv.lane_keys(host, 5, "cpu"),
                           tenv.lane_keys(dev, 5, "cpu"))
    for k, B in ((2, 8), (8, 64)):
        assert torch.equal(tanakin.sample_uniforms(cfg.seed, idx, k, B, "cpu"),
                           tanakin.sample_uniforms(cfg.seed, t, k, B, "cpu"))
    root = tenv.derive(cfg.seed, tanakin._EVAL_SALT, idx)
    root_t = tenv.derive(cfg.seed, tanakin._EVAL_SALT, t)
    for kind in ("fake", "grid"):
        env = tenv.make_anakin_env(cfg.replace(anakin_env=kind, num_actors=6),
                                   A, device="cpu")
        a, b = env.init_state(root), env.init_state(root_t)
        assert a.keys() == b.keys()
        for key in a:
            assert torch.equal(a[key], b[key]), (kind, key)


# ----------------------------------------------------- graph-ready bodies

@pytest.mark.parametrize("kw", [
    dict(anakin_eval_interval=2),
    dict(anakin_eval_interval=2, learnhealth_interval=2),
    dict(learnhealth_interval=3, superstep_k=3, anakin_env_steps_per_update=2),
], ids=["eval", "eval-learnhealth", "learnhealth-k3"])
def test_graph_ready_bodies_are_the_eager_dispatch(kw):
    """The plane's entries (the carry written in place, the index a tensor)
    against today's eager functions on a twin plane, from the same state:
    each warm-up rollout and dispatches 0, 1, 2 bit for bit."""
    cfg = anakin_config(**kw)
    net_g, graphed, lg = build(cfg)
    net_e, eager, le = build(cfg)
    eager.super_step = tanakin.make_anakin_super_step(cfg, net_e, eager.env,
                                                      A)
    eager.rollout = tanakin.make_anakin_rollout(cfg, net_e, eager.env, A,
                                                eager.roll_steps)
    carry = {k: v.data_ptr() for k, v in graphed.state.items()}

    def same_planes():
        pg, pe = graphed._payload(), eager._payload()
        assert sorted(pg) == sorted(pe)
        for k in pg:
            np.testing.assert_array_equal(pg[k], pe[k], err_msg=k)
        for f in graphed._COUNTER_FIELDS:
            assert getattr(graphed, f) == getattr(eager, f), f
        assert lg.state.step == le.state.step
        assert lg.state.opt_state.count == le.state.opt_state.count
        for a, b in zip(state_arrays(lg.state), state_arrays(le.state)):
            assert torch.equal(a, b)

    rollouts = 0
    while not graphed.ready:
        graphed.rollout_step(lg.state.params)
        eager.rollout_step(le.state.params)
        rollouts += 1
        same_planes()
    assert rollouts >= 2 and eager.ready
    for d in range(3):
        lg.state, rg = graphed.dispatch(lg.state)
        le.state, re_ = eager.dispatch(le.state)
        vg, ve = rg.fetch(), re_.fetch()
        np.testing.assert_array_equal(vg, ve)
        graphed.harvest(rg)
        eager.harvest(re_)
        same_planes()
    if cfg.anakin_eval_interval:
        assert graphed.eval_episodes_total == 2 * cfg.num_actors
    if cfg.learnhealth_interval:
        assert vg.size == (cfg.superstep_k + len(tanakin.STATS_FIELDS)
                           + (2 if cfg.anakin_eval_interval else 0)
                           + cfg.superstep_k * 28)
    assert lg.state.step == 3 * cfg.superstep_k
    assert {k: v.data_ptr() for k, v in graphed.state.items()} == carry


def test_restore_writes_into_the_tensors_the_entries_read(tmp_path):
    """A restored plane holds the written plane's carry, ring and PER
    state at its own addresses, which its entries read (the resume's
    continuation is ``test_torch_anakin.py``'s bitwise resume test)."""
    cfg = anakin_config(anakin_eval_interval=2)
    _, a, la = build(cfg)
    while not a.ready:
        a.rollout_step(la.state.params)
    la.state, r = a.dispatch(la.state)
    a.harvest(r)
    path = str(tmp_path / "anakin.bin")
    meta = a.write_state(path)

    _, b, _ = build(cfg, seed=1)
    ptrs = {k: v.data_ptr() for k, v in b._payload_tensors().items()}
    b.read_state(path, meta)
    assert {k: v.data_ptr() for k, v in b._payload_tensors().items()} == ptrs
    pa, pb = a._payload(), b._payload()
    assert sorted(pa) == sorted(pb)
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
    assert b.dispatch_no == a.dispatch_no == 1


# ------------------------------------------------------------ trace counts

def test_trace_counts_equal_jax(monkeypatch):
    """The rollout and the super-step trace once each over the warm-up
    rollouts and three dispatches (the eval lane on and off), in the port
    on the CPU and in the JAX package."""
    cfg = anakin_config(anakin_eval_interval=2)
    _, plane, learner = build(cfg)
    while not plane.ready:
        plane.rollout_step(learner.state.params)
    for _ in range(3):
        learner.state, r = plane.dispatch(learner.state)
        plane.harvest(r)
    port = {"learner.anakin_super_step": plane.super_step.graphs.entry.traces,
            "learner.anakin_rollout": plane.rollout.graphs.entry.traces}

    guard = jtrace.RetraceGuard()
    monkeypatch.setattr(janakin, "RETRACES", guard)
    jcfg = jax_test_config(**{**BASE, "anakin_eval_interval": 2})
    jnet = jax_create(jcfg, A)
    jplane = janakin.AnakinPlane(jcfg, jnet, A, JaxDeviceRing(jcfg, A))
    state = jstep.create_train_state(
        jcfg, init_params(jcfg, jnet, jax.random.PRNGKey(0)))
    while not jplane.ready:
        jplane.rollout_step(state.params)
    for _ in range(3):
        state, flat = jplane.dispatch(state)
        jplane.harvest(flat)
    assert port == guard.counts() == {"learner.anakin_super_step": 1,
                                      "learner.anakin_rollout": 1}
