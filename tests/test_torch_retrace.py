"""The retrace guard (``r2d2_tpu_torch/utils/trace.py``: ``RetraceGuard``,
``RETRACES``) and the step it counts, against the JAX package.

- The guard call for call against JAX's: the port counts a trace on the
  first call with each new input signature, JAX's ``jax.jit`` traces once
  per signature, so the same calls give the same ``counts()``,
  ``over_budget()`` and exception text.
- Eight same-shape meshless updates trace ``learner.train_step`` once in
  both packages (JAX's pattern, ``tests/test_sharding.py``); with the
  learnhealth diagnostics the port's step has an armed and a disarmed
  program (on a card two CUDA graphs), within the budget of 2.
- The serving batcher over several bucket sizes counts ``serving.act`` as
  JAX's batcher does; ``actor.act``, ``serving.act`` and the inference
  service's act count the same traces as JAX's across publishes, call for
  call: a publish is not a trace in either package (the port adopts the
  new dict into the act's own param tensors, actor.py:GraphedAct).
- The step with its counters on the device against JAX's ``train_step``
  over 12 steps across a target sync at interval 8 (loss 1e-5 relative,
  params 1e-4 relative).
- The telemetry plane's ``retraces.max_traces`` gauges equal JAX's for
  the same counts.

Small: the mlp torso at the test config's tiny widths, on the CPU, where
a trace is a new signature.  The CUDA-graph captures are checked on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phases 4, 5 and 7).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu import actor as jactor
from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu.learner import step as jstep
from r2d2_tpu.serving.batcher import ContinuousBatcher as JaxBatcher
from r2d2_tpu.telemetry import Telemetry as JaxTelemetry
from r2d2_tpu.utils import trace as jtrace
from r2d2_tpu_torch import actor as tactor
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.learner import step as tstep
from r2d2_tpu_torch.learner.graphs import make_learner_step
from r2d2_tpu_torch.learner.learner import Learner
from r2d2_tpu_torch.models import create_network
from r2d2_tpu_torch.serving import ContinuousBatcher
from r2d2_tpu_torch.telemetry.plane import Telemetry
from r2d2_tpu_torch.utils import trace as ttrace
from test_torch_fabric import _entry
from test_torch_learner import (
    A,
    LOSS_TOL,
    assert_params_close,
    flax_to_port,
    jax_setup,
    make_batch,
    port_state_from_jax,
    scripted_batches,
    to_torch,
)

# 12 steps across the target sync at 8: the learner tolerances
PARAM_RTOL = dict(rtol=1e-4, atol=1e-6)


def _calls(guard, wrap, arg):
    """The same call sequence through a guard: two entries, one of them
    built twice (instances count apart), shapes and dtypes drifting."""
    a = wrap(guard, "test.a", 1)
    b1 = wrap(guard, "test.b", None)
    b2 = wrap(guard, "test.b", None)
    for shape, dtype in (((4,), "f"), ((4,), "f"), ((8,), "f"),
                         ((4,), "i"), ((4,), "f")):
        a(arg(shape, dtype), 2.5)
    for n in (1, 2, 3):
        b1(arg((n,), "f"), 1.0 * n)     # a Python scalar's value: no trace
    b2(arg((2,), "f"), 0.5)
    return guard


def test_retrace_guard_matches_jax_call_for_call():
    def jwrap(guard, name, budget):
        return jax.jit(guard.wrap(name, lambda x, s: x * s, budget=budget))

    def twrap(guard, name, budget):
        return guard.wrap(name, lambda x, s: x * s, budget=budget)

    dt = {"f": (np.float32, torch.float32), "i": (np.int32, torch.int32)}
    ref = _calls(jtrace.RetraceGuard(), jwrap,
                 lambda s, d: jnp.zeros(s, dt[d][0]))
    port = _calls(ttrace.RetraceGuard(), twrap,
                  lambda s, d: torch.zeros(s, dtype=dt[d][1]))
    assert port.counts() == ref.counts() == {"test.a": 3, "test.b": 3}
    assert port.over_budget() == ref.over_budget() == [
        ("test.a", 3, 1), ("test.b", 3, 2)]
    with pytest.raises(jtrace.RetraceBudgetExceeded) as jerr:
        ref.assert_within_budgets()
    with pytest.raises(ttrace.RetraceBudgetExceeded) as terr:
        port.assert_within_budgets()
    assert str(terr.value) == str(jerr.value)
    assert isinstance(terr.value, AssertionError)
    for g in (ref, port):
        g.reset()
        assert g.counts() == {} and g.over_budget() == []
        g.assert_within_budgets()


def test_signature_is_what_jit_retraces_on():
    sig = ttrace.signature
    x = torch.zeros(2, 3)
    assert sig((x, 1)) == sig((torch.ones(2, 3), 7))
    assert sig((x, 1)) != sig((x, 1.0))          # int vs float
    assert sig((x,)) != sig((x.double(),))
    assert sig({"a": x}) != sig({"b": x})
    assert sig([x]) != sig([x, x])
    assert sig(np.zeros(3, np.int32)) == sig(np.ones(3, np.int32))
    assert sig(None) is None


@pytest.mark.parametrize("lh", [0, 4])
def test_same_shape_updates_trace_the_step_once_in_both_packages(lh):
    """8 same-shape meshless updates: one trace of the train step in both
    packages; the port's step with the diagnostics has two programs,
    the armed and the disarmed step, where JAX's ``lax.cond`` keeps one."""
    jcfg = jax_test_config(learnhealth_interval=lh)
    cfg = port_test_config(learnhealth_interval=lh)
    jnet, params, _ = jax_setup(jcfg)
    jguard, tguard = jtrace.RetraceGuard(), ttrace.RetraceGuard()
    jfn = jax.jit(jguard.wrap("learner.train_step", jstep.make_train_step(
        jcfg, jnet, learnhealth=lh > 0)))
    tfn = make_learner_step(cfg, create_network(cfg, A, device="cpu"),
                            learnhealth=lh > 0, guard=tguard)
    jstate = jstep.create_train_state(jcfg, params)
    state = tstep.create_train_state(cfg, flax_to_port(params))
    rng = np.random.default_rng(3)
    for _ in range(8):
        batch = make_batch(jcfg, rng, B=jcfg.batch_size)
        jout = jfn(jstate, batch)
        tout = tfn(state, to_torch(batch))
        jstate, state = jout[0], tout[0]
        np.testing.assert_allclose(tout[1].item(), float(jout[1]),
                                   **LOSS_TOL)
    assert jguard.counts() == {"learner.train_step": 1}
    assert tguard.counts() == {"learner.train_step": 2 if lh else 1}
    assert state.step == int(jstate.step) == 8
    jguard.assert_within_budgets()
    tguard.assert_within_budgets()


def test_learner_run_counts_one_trace_and_stays_within_budgets():
    """The learner's own step, under the process-wide guard, as JAX's
    learner e2e asserts it (``tests/test_train_end_to_end.py``)."""
    cfg = port_test_config()
    net = create_network(cfg, A, device="cpu")
    learner = Learner(cfg, net, tstep.create_train_state(cfg,
                                                         net.state_dict()))
    it = iter(scripted_batches(cfg, 7))
    m = learner.run(lambda: next(it, None))
    assert m["num_updates"] == 7 == learner.state.step
    assert learner._step_fn.graphs.entry.traces == 1
    assert learner._step_fn.graphs.entry in ttrace.RETRACES._entries
    ttrace.RETRACES.assert_within_budgets()


def _rows(cfg, n, rng):
    return (rng.integers(0, 256, (n, *cfg.stored_obs_shape)).astype(np.uint8),
            rng.random((n, A)).astype(np.float32),
            rng.random(n).astype(np.float32),
            (rng.normal(size=(n, 2, cfg.lstm_layers, cfg.hidden_dim))
             * 0.1).astype(np.float32))


def test_serving_act_counts_as_jax_batcher(monkeypatch):
    """Ragged batches over several bucket sizes: one ``serving.act`` trace
    a bucket in both batchers, inside the bucket-count budget."""
    jguard, tguard = jtrace.RetraceGuard(), ttrace.RetraceGuard()
    monkeypatch.setattr(jtrace, "RETRACES", jguard)
    monkeypatch.setattr(tactor, "RETRACES", tguard)
    kw = dict(serve_max_batch=8, serve_max_sessions=8,
              serve_session_idle_s=30.0)
    jcfg, cfg = jax_test_config(**kw), port_test_config(**kw)
    jnet, params, _ = jax_setup(jcfg)
    jb = JaxBatcher(jcfg, A)
    tb = ContinuousBatcher(cfg, A, device="cpu")
    jb.publish(params)
    tb.publish(flax_to_port(params))
    rng = np.random.default_rng(0)
    for n in (1, 3, 5, 8, 2, 7, 3):
        rows = _rows(cfg, n, rng)
        jq, _ = jb.act(*rows)
        tq, _ = tb.act(*rows)
        np.testing.assert_allclose(tq, np.asarray(jq), rtol=1e-5, atol=1e-5)
    # buckets 1, 4, 8, 2: four of the five shapes, budget five + 1
    assert tguard.counts() == jguard.counts() == {"serving.act": 4}
    assert [e.budget for e in tguard._entries] == [
        e.budget for e in jguard._entries] == [len(tb.buckets) + 1]
    tguard.assert_within_budgets()


def _guards(monkeypatch):
    """Private guards for both packages' acts, so that the counts below
    are these calls' alone."""
    jguard, tguard = jtrace.RetraceGuard(), ttrace.RetraceGuard()
    monkeypatch.setattr(jtrace, "RETRACES", jguard)
    monkeypatch.setattr(tactor, "RETRACES", tguard)
    return jguard, tguard


def test_act_publishes_are_not_traces_in_either_package(monkeypatch):
    """``actor.act`` over three publishes and two batch shapes: JAX's
    jitted act and the port's adopting act count the same traces, call
    for call (a publish is none); the port adopts once a publish."""
    jguard, tguard = _guards(monkeypatch)
    jcfg, cfg = jax_test_config(), port_test_config(act_device="cpu")
    jact = jactor.make_act_fn(jcfg, jax_setup(jcfg)[0])
    act = tactor.make_act_fn(create_network(cfg, A, device="cpu"))
    rng = np.random.default_rng(3)
    for p, sizes in ((0, (4, 4)), (1, (4, 8)), (2, (8, 4, 8))):
        jparams = jax_setup(jcfg, seed=p)[1]
        tparams = flax_to_port(jparams)
        for n in sizes:
            rows = _rows(cfg, n, rng)
            jq, _ = jact(jparams, *rows)
            tq, _ = act(tparams, *(torch.from_numpy(r) for r in rows))
            np.testing.assert_allclose(tq.numpy(), np.asarray(jq),
                                       rtol=1e-5, atol=1e-5)
            assert tguard.counts() == jguard.counts()
    assert tguard.counts() == {"actor.act": 2}
    assert act.adoptions == 3
    tguard.assert_within_budgets()


def test_serving_act_publishes_are_not_traces(monkeypatch):
    """The session batcher across three publishes: one ``serving.act``
    trace a bucket in both packages, call for call, and none a publish;
    the port's act adopts each published dict once."""
    jguard, tguard = _guards(monkeypatch)
    kw = dict(serve_max_batch=8, serve_max_sessions=8,
              serve_session_idle_s=30.0)
    jcfg, cfg = jax_test_config(**kw), port_test_config(**kw)
    jb, tb = JaxBatcher(jcfg, A), ContinuousBatcher(cfg, A, device="cpu")
    rng = np.random.default_rng(1)
    for p, sizes in ((0, (1, 1)), (1, (1, 3)), (2, (3, 8, 2))):
        params = jax_setup(jcfg, seed=p)[1]
        jb.publish(params)
        tb.publish(flax_to_port(params))
        for n in sizes:
            rows = _rows(cfg, n, rng)
            jq, _ = jb.act(*rows)
            tq, _ = tb.act(*rows)
            np.testing.assert_allclose(tq, np.asarray(jq), rtol=1e-5,
                                       atol=1e-5)
            assert tguard.counts() == jguard.counts()
    # buckets 1, 4, 8 and 2
    assert tguard.counts() == {"serving.act": 4}
    assert tb._act.adoptions == 3
    tguard.assert_within_budgets()


def test_inference_service_act_traces_equal_jax_across_publishes(
        monkeypatch):
    """Each package's service answering its own fleet client over three
    ParamStore publishes: one ``actor.act`` trace in both (the port's at
    ``start``'s warm-up act, JAX's at its first batch), none a publish;
    the port's act adopts each version once, on the serve thread; q
    within 1e-5 of JAX's service, batch for batch."""
    import multiprocessing as mp

    from r2d2_tpu.parallel import actor_procs as japs
    from r2d2_tpu.parallel import inference_service as jis
    from r2d2_tpu.utils.store import ParamStore as JaxParamStore
    from r2d2_tpu_torch.parallel import actor_procs as taps
    from r2d2_tpu_torch.parallel import inference_service as tis
    from r2d2_tpu_torch.utils.store import ParamStore
    from test_torch_inference_service import (
        make_fake_env,
        pump_while,
        serve_cfg,
    )

    jguard, tguard = _guards(monkeypatch)
    cfg = serve_cfg()
    jcfg = jax_test_config(num_actors=2, actor_transport="process",
                           actor_inference="serve")
    params = [jax_setup(jcfg, seed=p)[1] for p in range(3)]
    jstore, tstore = (JaxParamStore(params[0]),
                      ParamStore(flax_to_port(params[0])))
    jplane = japs.ProcessFleetPlane(jcfg, A, make_fake_env, [0.4, 0.3])
    tplane = taps.ProcessFleetPlane(cfg, A, make_fake_env, [0.4, 0.3])
    jplane.stats_slab.close()
    tplane.stats_slab.close()
    ctx = mp.get_context("spawn")
    sides = []
    for svc, store, client_cls, c in ((jplane.service, jstore,
                                       jis.RemoteActClient, jcfg),
                                      (tplane.service, tstore,
                                       tis.RemoteActClient, cfg)):
        svc.start(store)
        ch = svc.make_channel(0)
        sides.append((svc, store, client_cls(c, A, 2, ch.producer_info(),
                                             ctx.Event())))
    rng = np.random.default_rng(2)
    hidden = np.zeros((2, 2, cfg.lstm_layers, cfg.hidden_dim), np.float32)
    qs = ([], [])
    try:
        for p in range(3):
            if p:
                jstore.publish(params[p])
                tstore.publish(flax_to_port(params[p]))
            for _ in range(2):
                obs = rng.integers(0, 256, (2, *cfg.stored_obs_shape),
                                   np.uint8)
                la = np.eye(A, dtype=np.float32)[rng.integers(A, size=2)]
                lr = rng.normal(size=2).astype(np.float32)
                for i, (svc, _, client) in enumerate(sides):
                    q, _ = pump_while(svc, lambda: client(
                        None, obs, la, lr, hidden))
                    qs[i].append(np.array(q))
                assert tguard.counts() == jguard.counts() == {
                    "actor.act": 1}
        for jq, tq in zip(*qs):
            np.testing.assert_allclose(tq, jq, rtol=1e-5, atol=1e-5)
        assert tplane.service._act.adoptions == 3
        assert tplane.service.batches == jplane.service.batches == 6
        tguard.assert_within_budgets()
    finally:
        for svc, _, client in sides:
            client.close()
            svc.close()


def test_device_counter_step_matches_jax_across_a_target_sync():
    """The step's counter and Adam's count on the device, the bias
    corrections computed there and the target sync a ``torch.where`` on
    the counter: 12 steps against JAX's ``train_step`` across the sync at
    8, at the learner tolerances, the counters exact."""
    jcfg = jax_test_config(target_net_update_interval=8)
    cfg = port_test_config(target_net_update_interval=8)
    jnet, params, _ = jax_setup(jcfg)
    jfn = jax.jit(jstep.make_train_step(jcfg, jnet))
    jstate = jstep.create_train_state(jcfg, params)
    state = tstep.place_counters(
        tstep.create_train_state(cfg, flax_to_port(params)),
        torch.device("cpu"))
    assert state.step_t.dtype == state.opt_state.count_t.dtype == torch.int32
    assert int(state.step_t) == int(state.opt_state.count_t) == 0
    step = tstep.make_train_step(cfg, create_network(cfg, A, device="cpu"))
    rng = np.random.default_rng(12)
    for i in range(12):
        batch = make_batch(jcfg, rng, B=jcfg.batch_size)
        jstate, jloss, jprios = jfn(jstate, batch)
        state, loss, prios = step(state, to_torch(batch))
        np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
        np.testing.assert_allclose(prios.numpy(), np.asarray(jprios),
                                   **LOSS_TOL)
        ref = port_state_from_jax(jstate)
        assert (state.step, state.opt_state.count) == (ref.step, i + 1)
        assert int(state.step_t) == int(state.opt_state.count_t) == i + 1
        assert_params_close(state.params, ref.params, **PARAM_RTOL)
        assert_params_close(state.target_params, ref.target_params,
                            **PARAM_RTOL)
        synced = all(torch.equal(state.params[k], state.target_params[k])
                     for k in state.params)
        assert synced == (i + 1 == 8)
    assert_params_close(state.opt_state.mu, ref.opt_state.mu, **PARAM_RTOL)


def test_a_state_from_host_mirrors_gets_its_device_counters():
    """A restored or converted state carries only the host mirrors: the
    step places its counters from them, and a copy in the state's place
    (the learner's ``place_state``) keeps them."""
    cfg = port_test_config(target_net_update_interval=4)
    net = create_network(cfg, A, device="cpu")
    fresh = tstep.create_train_state(cfg, net.state_dict())
    state = tstep.TrainState(
        step=3, params=fresh.params, target_params=fresh.target_params,
        opt_state=tstep.AdamState(count=3, mu=fresh.opt_state.mu,
                                  nu=fresh.opt_state.nu))
    batch = to_torch(make_batch(cfg, np.random.default_rng(0), B=8))
    state, _, _ = tstep.make_train_step(cfg, net)(state, batch)
    assert (state.step, int(state.step_t), int(state.opt_state.count_t)) \
        == (4, 4, 4)
    assert all(torch.equal(state.params[k], state.target_params[k])
               for k in state.params)


def test_plane_retrace_gauges_equal_jax(tmp_path, monkeypatch):
    """The same counts in both packages' guards: the same
    ``retraces.max_traces{entry_point}`` gauges in both planes."""
    jguard, tguard = jtrace.RetraceGuard(), ttrace.RetraceGuard()
    monkeypatch.setattr(jtrace, "RETRACES", jguard)
    monkeypatch.setattr(ttrace, "RETRACES", tguard)
    for g in (jguard, tguard):
        for name, traces in (("learner.train_step", 1), ("actor.act", 2),
                             ("actor.act", 1), ("serving.act", 0)):
            g.wrap(name, lambda: None)
            g._entries[-1].traces = traces
    port = Telemetry(port_test_config(), str(tmp_path / "port"))
    ref = JaxTelemetry(jax_test_config(), str(tmp_path / "jax"))
    for t in (port, ref):
        t.record(_entry())
        t.close()

    def gauges(tel):
        return {k: v for k, v in tel.registry.snapshot()["gauges"].items()
                if k.startswith("retraces.")}

    got = gauges(port)
    assert got == gauges(ref)
    assert got == {"retraces.max_traces{entry_point=learner.train_step}": 1,
                   "retraces.max_traces{entry_point=actor.act}": 2,
                   "retraces.max_traces{entry_point=serving.act}": 0}
