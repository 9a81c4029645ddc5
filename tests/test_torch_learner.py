"""The port's learner against the JAX package's, on the CPU.

Same params (converted with ``params_from_flax``) and the same numpy
batches through ``r2d2_tpu.learner`` and ``r2d2_tpu_torch.learner``, at
``test_config`` size (mlp torso, H=16, float32).  Mirrors
tests/test_learner_step.py and the learner half of
tests/test_train_end_to_end.py.

Tolerances (float32; both sides sum in other orders, nothing else
differs): loss and priorities within 1e-5 relative / 1e-6 absolute,
gradients within 1e-4 relative / 1e-6 absolute (measured: loss 7e-9,
priorities 1.2e-7, grads 2e-8 at these shapes).  Parameters after Adam
steps within 1e-6 absolute: Adam divides by sqrt(nu) + 1e-3, so a
last-bit difference in a gradient moves the update by far less than that.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.checkpoint import Checkpointer as JaxCheckpointer
from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu.learner import step as jstep
from r2d2_tpu.learner.learner import Learner as JaxLearner
from r2d2_tpu.models.network import create_network as jax_create
from r2d2_tpu.models.network import init_params
from r2d2_tpu.parallel.sharding import pjit_train_step
from r2d2_tpu_torch.checkpoint import Checkpointer
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.learner import step as tstep
from r2d2_tpu_torch.learner.learner import Learner
from r2d2_tpu_torch.models import create_network, params_from_flax
from r2d2_tpu_torch.models.convert import train_state_from_jax
from r2d2_tpu_torch.utils.store import ParamStore

A = 4
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=0, atol=1e-6)


def make_batch(cfg, rng, B):
    """A batch with ragged windows (the learner-step test's generator)."""
    T, L, n = cfg.seq_len, cfg.learning_steps, cfg.forward_steps
    learning = rng.integers(1, L + 1, B).astype(np.int32)
    burn_in = rng.integers(0, cfg.burn_in_steps + 1, B).astype(np.int32)
    forward = np.where(learning == L, rng.integers(1, n + 1, B),
                       1).astype(np.int32)
    return dict(
        obs=rng.integers(0, 255, (B, T, *cfg.obs_shape), dtype=np.uint8),
        last_action=rng.random((B, T, A)).astype(np.float32),
        last_reward=rng.random((B, T)).astype(np.float32),
        hidden=rng.normal(size=(B, 2, cfg.lstm_layers, cfg.hidden_dim)
                          ).astype(np.float32),
        action=rng.integers(0, A, (B, L)).astype(np.int32),
        n_step_reward=rng.normal(size=(B, L)).astype(np.float32),
        n_step_gamma=np.full((B, L), cfg.gamma ** n, np.float32),
        burn_in=burn_in, learning=learning, forward=forward,
        is_weights=rng.uniform(0.2, 1.0, B).astype(np.float32),
    )


def scripted_batches(cfg, n, seed=0):
    """The end-to-end tests' scripted learner batches, with bookkeeping."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = make_batch(cfg, rng, cfg.batch_size)
        b.update(idxes=np.arange(cfg.batch_size), block_ptr=0,
                 env_steps=1000)
        out.append(b)
    return out


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()
            if isinstance(v, np.ndarray)}


def flax_to_port(tree):
    return params_from_flax(jax.device_get(tree))


def jax_setup(cfg, seed=0, target_seed=1):
    net = jax_create(cfg, A)
    return (net, init_params(cfg, net, jax.random.PRNGKey(seed)),
            init_params(cfg, net, jax.random.PRNGKey(target_seed)))


def assert_params_close(port, ref, **tol):
    assert set(port) == set(ref)
    for k in ref:
        np.testing.assert_allclose(port[k].detach().numpy(),
                                   ref[k].numpy(), err_msg=k, **tol)


def port_state_from_jax(state):
    s = jax.device_get(state)
    adam = s.opt_state[1][0]
    return train_state_from_jax(s.params, s.target_params, adam.mu, adam.nu,
                                int(adam.count), int(s.step))


# ------------------------------------------------------------ step pieces

def test_value_rescale_matches_jax():
    x = np.linspace(-100, 100, 201, dtype=np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_allclose(tstep.value_rescale(t).numpy(),
                               np.asarray(jstep.value_rescale(x)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tstep.inverse_value_rescale(t).numpy(),
                               np.asarray(jstep.inverse_value_rescale(x)),
                               rtol=1e-5, atol=1e-5)


def test_window_indices_and_mixed_priorities_match_jax():
    cfg = port_test_config()
    jcfg = jax_test_config()
    cases = [(b, l, f) for b in range(cfg.burn_in_steps + 1)
             for l in range(1, cfg.learning_steps + 1)
             for f in range(1, cfg.forward_steps + 1)]
    burn, learn, fwd = (np.array(c, np.int32) for c in zip(*cases))
    got = tstep._window_indices(cfg, *(torch.from_numpy(a)
                                       for a in (burn, learn, fwd)))
    want = jstep._window_indices(jcfg, *(jnp.asarray(a)
                                         for a in (burn, learn, fwd)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    td = np.random.default_rng(0).random((len(cases), cfg.learning_steps)
                                         ).astype(np.float32)
    np.testing.assert_allclose(
        tstep.mixed_priorities(torch.from_numpy(td), got[2],
                               torch.from_numpy(learn)).numpy(),
        np.asarray(jstep.mixed_priorities(jnp.asarray(td), want[2],
                                          jnp.asarray(learn))),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("zero_row", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_loss_priorities_and_grads_match_jax(fused, zero_row):
    """``zero_row``: one row drawn from a zero-priority leaf (a descent's
    float error lands on a block's unused sequence slot), whose meta is
    all zeros, so its last valid target index is -1: JAX's gather counts
    it from the end, the port's must too (ROADMAP.md C 20)."""
    jcfg = jax_test_config(fused_double_unroll=fused)
    cfg = port_test_config(fused_double_unroll=fused)
    jnet, params, target = jax_setup(jcfg)
    batch = make_batch(jcfg, np.random.default_rng(7), B=8)
    if zero_row:
        for k in ("burn_in", "learning", "forward"):
            batch[k][0] = 0
    (jloss, jprios), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jstep.loss_and_priorities(
            jcfg, jnet, p, target, {k: jnp.asarray(v)
                                    for k, v in batch.items()}),
        has_aux=True))(params)

    net = create_network(cfg, A, device="cpu")
    tp = {k: v.requires_grad_(True) for k, v in flax_to_port(params).items()}
    tt = {k: v.requires_grad_(True) for k, v in flax_to_port(target).items()}
    loss, prios = tstep.loss_and_priorities(cfg, net, tp, tt,
                                            to_torch(batch))
    grads = torch.autograd.grad(loss, list(tp.values()) + list(tt.values()),
                                allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    np.testing.assert_allclose(prios.numpy(), np.asarray(jprios), **LOSS_TOL)
    assert not prios.requires_grad
    assert_params_close(dict(zip(tp, grads[:len(tp)])), flax_to_port(jgrads),
                        **GRAD_TOL)
    # the target side carries no gradient (online argmax and target
    # evaluation both stop it)
    assert all(g is None or not g.abs().max() for g in grads[len(tp):])


def test_optimizer_matches_optax_over_five_steps():
    """Five clip + Adam steps from the same params on the same batches,
    with the norm clip engaged (grad_norm 0.05, below these batches'
    gradient norms of 0.2–0.4)."""
    jcfg = jax_test_config(grad_norm=0.05, target_net_update_interval=3)
    cfg = port_test_config(grad_norm=0.05, target_net_update_interval=3)
    jnet, params, _ = jax_setup(jcfg)
    jstate = jstep.create_train_state(jcfg, params)
    step_fn = pjit_train_step(jcfg, jnet, state_template=jstate)
    state = tstep.create_train_state(cfg, flax_to_port(params))
    train_step = tstep.make_train_step(cfg, create_network(cfg, A,
                                                           device="cpu"))
    rng = np.random.default_rng(8)
    for i in range(5):
        batch = make_batch(jcfg, rng, B=8)
        jstate, jloss, jprios = step_fn(jstate, batch)
        state, loss, prios = train_step(state, to_torch(batch))
        np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
        np.testing.assert_allclose(prios.numpy(), np.asarray(jprios),
                                   **LOSS_TOL)
    ref = port_state_from_jax(jstate)
    assert state.step == ref.step == 5
    assert state.opt_state.count == ref.opt_state.count == 5
    assert_params_close(state.params, ref.params, **PARAM_TOL)
    # synced at step 3, not since
    assert_params_close(state.target_params, ref.target_params, **PARAM_TOL)
    assert_params_close(state.opt_state.mu, ref.opt_state.mu, **PARAM_TOL)
    assert_params_close(state.opt_state.nu, ref.opt_state.nu,
                        rtol=1e-5, atol=1e-12)


def test_target_sync_at_interval_and_loss_falls():
    cfg = port_test_config(target_net_update_interval=5)
    net = create_network(cfg, A, device="cpu",
                         generator=torch.Generator().manual_seed(2))
    state = tstep.create_train_state(cfg, net.state_dict())
    train_step = tstep.make_train_step(cfg, net)
    batch = to_torch(make_batch(cfg, np.random.default_rng(8), B=8))
    losses = []
    for i in range(10):
        state, loss, prios = train_step(state, batch)
        losses.append(loss.item())
        same = all(torch.equal(state.params[k], state.target_params[k])
                   for k in state.params)
        assert same == (i + 1 in (5, 10))
        assert prios.shape == (8,)
    assert losses[-1] < losses[0]
    assert state.step == 10


def test_loss_net_is_a_scan_twin_with_the_same_names():
    cfg = port_test_config(lstm_impl="pallas")
    net = create_network(cfg, A, device="cpu")
    twin = tstep._loss_net(net)
    assert twin is not net
    assert [l.impl for l in twin.lstm_layers] == ["scan"]
    assert [l.impl for l in net.lstm_layers] == ["pallas"]
    assert list(twin.state_dict()) == list(net.state_dict())
    assert tstep._loss_net(twin) is twin


# --------------------------------------------------------------- learner

@pytest.mark.parametrize("depth", [0, 3])
def test_learner_run_matches_jax(depth):
    """The same JAX params and 6 scripted batches through JAX's
    Learner.run and the port's: losses, priorities (each delivered once,
    in order) and final params."""
    jcfg = jax_test_config(training_steps=6, superstep_pipeline=depth)
    cfg = port_test_config(training_steps=6, superstep_pipeline=depth)
    jnet, params, _ = jax_setup(jcfg, seed=3)
    batches = scripted_batches(jcfg, 6)

    def drive(learner):
        it = iter(batches)
        sunk = []
        m = learner.run(lambda: next(it, None),
                        priority_sink=lambda i, p, ptr, l: sunk.append(
                            (l, np.array(p))))
        return m, sunk

    jlearner = JaxLearner(jcfg, jnet, jstep.create_train_state(jcfg, params))
    jm, jsunk = drive(jlearner)
    store = ParamStore()
    learner = Learner(cfg, create_network(cfg, A, device="cpu"),
                      tstep.create_train_state(cfg, flax_to_port(params)),
                      param_store=store)
    m, sunk = drive(learner)
    assert m["num_updates"] == jm["num_updates"] == 6
    assert m["env_steps"] == jm["env_steps"] == 1000
    assert len(sunk) == len(jsunk) == 6
    for (l, p), (jl, jp) in zip(sunk, jsunk):
        np.testing.assert_allclose(l, jl, **LOSS_TOL)
        np.testing.assert_allclose(p, jp, **LOSS_TOL)
    np.testing.assert_allclose(m["mean_loss"], jm["mean_loss"], **LOSS_TOL)
    ref = port_state_from_jax(jlearner.state)
    assert_params_close(learner.state.params, ref.params, **PARAM_TOL)
    assert_params_close(learner.state.opt_state.mu, ref.opt_state.mu,
                        **PARAM_TOL)
    # published at construction and every 4 updates
    # (weight_publish_interval), always as a copy of the live params
    version, published = store.get()
    assert version == 2
    assert all(published[k].data_ptr() != learner.state.params[k].data_ptr()
               for k in published)


def test_learner_run_with_prefetch_thread_matches_synchronous_staging():
    """prefetch_batches > 0 stages on the supervised thread: the same
    batches in the same order give the same losses and params, and the
    thread is gone when run returns."""
    import threading

    runs = []
    for prefetch in (0, 2):
        cfg = port_test_config(training_steps=5, prefetch_batches=prefetch)
        net = create_network(cfg, A, device="cpu",
                             generator=torch.Generator().manual_seed(5))
        learner = Learner(cfg, net, tstep.create_train_state(
            cfg, net.state_dict()))
        it = iter(scripted_batches(cfg, 5))
        sunk = []
        learner.run(lambda: next(it, None),
                    priority_sink=lambda i, p, ptr, l: sunk.append(l))
        runs.append((sunk, learner.state.params))
    assert runs[0][0] == runs[1][0] and len(runs[0][0]) == 5
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k])
    assert not any(t.name == "learner_prefetch" and t.is_alive()
                   for t in threading.enumerate())


def test_jax_orbax_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX checkpoint (read with orbax by the JAX package) carried
    across with ``train_state_from_jax`` resumes in the port with the next
    step's loss, priorities and params of the JAX run that resumes it."""
    jcfg = jax_test_config(training_steps=3, save_interval=3)
    cfg = port_test_config(training_steps=4, save_interval=100)
    jnet, params, _ = jax_setup(jcfg, seed=4)
    batches = scripted_batches(jcfg, 4, seed=1)
    ck_dir = os.path.join(tmp_path, "ck")
    it = iter(batches[:3])
    JaxLearner(jcfg, jnet, jstep.create_train_state(jcfg, params),
               checkpointer=JaxCheckpointer(ck_dir)).run(lambda: next(it, None))
    template = jax.device_get(jstep.create_train_state(jcfg, params))
    restored, meta = JaxCheckpointer(ck_dir).restore(template, step=3)
    assert meta["env_steps"] == 1000

    # the JAX run resumed from it, one more update
    jlearner = JaxLearner(jcfg.replace(training_steps=4), jnet, restored)
    jsunk = []
    it = iter(batches[3:])
    jlearner.run(lambda: next(it, None),
                 priority_sink=lambda i, p, ptr, l: jsunk.append((l, p)))
    # the port resumed from the same checkpoint
    learner = Learner(cfg, create_network(cfg, A, device="cpu"),
                      port_state_from_jax(restored))
    assert learner.num_updates == 3
    sunk = []
    it = iter(batches[3:])
    learner.run(lambda: next(it, None),
                priority_sink=lambda i, p, ptr, l: sunk.append((l, p)))
    assert learner.num_updates == 4
    np.testing.assert_allclose(sunk[0][0], jsunk[0][0], **LOSS_TOL)
    np.testing.assert_allclose(sunk[0][1], np.asarray(jsunk[0][1]),
                               **LOSS_TOL)
    assert_params_close(learner.state.params,
                        port_state_from_jax(jlearner.state).params,
                        **PARAM_TOL)


def test_checkpoint_resume_bit_exact(tmp_path):
    """6 updates with a checkpoint at 3; a fresh learner restored from
    step 3 replays updates 4-6 and ends bitwise equal to the
    uninterrupted run (on the CPU: the CUDA backward of gather is not
    deterministic)."""
    cfg = port_test_config(save_interval=3, training_steps=6)
    net = create_network(cfg, A, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    params = net.state_dict()
    batches = scripted_batches(cfg, 6)

    full = Learner(cfg, net, tstep.create_train_state(cfg, params))
    it = iter(list(batches))
    full.run(lambda: next(it, None))
    assert full.num_updates == 6

    ck_dir = os.path.join(tmp_path, "ck")
    part = Learner(cfg, net, tstep.create_train_state(cfg, params),
                   checkpointer=Checkpointer(ck_dir))
    it = iter(list(batches[:3]))
    part.run(lambda: next(it, None))
    assert Checkpointer(ck_dir).steps() == [3]

    restored, meta = Checkpointer(ck_dir).restore(step=3)
    assert meta["env_steps"] == 1000 and meta["step"] == 3
    assert meta["hidden_dim"] == cfg.hidden_dim
    resumed = Learner(cfg, net, restored)
    assert resumed.num_updates == 3
    it = iter(list(batches[3:]))
    resumed.run(lambda: next(it, None))
    assert resumed.num_updates == 6
    a, b = full.state, resumed.state
    assert a.opt_state.count == b.opt_state.count == 6
    for x, y in ((a.params, b.params), (a.target_params, b.target_params),
                 (a.opt_state.mu, b.opt_state.mu),
                 (a.opt_state.nu, b.opt_state.nu)):
        for k in x:
            assert torch.equal(x[k], y[k]), k


def test_checkpointer_selects_complete_saves_and_collects(tmp_path):
    cfg = port_test_config()
    net = create_network(cfg, A, device="cpu")
    state = tstep.create_train_state(cfg, net.state_dict())
    ck = Checkpointer(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        state.step = step
        ck.save(step, state, meta=dict(env_steps=step * 10))
    assert ck.steps() == [2, 3]
    # a save cut before its sidecar landed is never selected
    os.makedirs(os.path.join(tmp_path, "step_9"))
    assert ck.latest_step() == 3 and ck.steps(complete=False) == [2, 3, 9]
    restored, meta = ck.restore()
    assert restored.step == 3 and meta["env_steps"] == 30
    assert ck.peek_meta(9) == {}
