"""The port's in-graph learnhealth diagnostics against the JAX package's,
on the CPU.

Same params (``params_from_flax``), same numpy batches, ``test_config``
sizes (mlp torso, H = 16, float32).  Tolerances: the diag's scalars within
1e-5 relative (1e-7 absolute for values near 0): both sides sum in other
orders, nothing else differs; the |TD| and IS-weight bucket counts exact.
A train step's and a super-step's rows at the learner tolerances (loss
1e-5 relative), disarmed rows exactly zero on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu.learner import anakin as janakin
from r2d2_tpu.learner import step as jstep
from r2d2_tpu.models.network import create_network as jax_create
from r2d2_tpu.models.network import init_params
from r2d2_tpu.parallel.sharding import pjit_train_step
from r2d2_tpu.replay import replay_buffer as jrb
from r2d2_tpu.replay.device_ring import DeviceRing as JaxDeviceRing
from r2d2_tpu.telemetry import learnhealth as jlh
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.learner import anakin as tanakin
from r2d2_tpu_torch.learner import step as tstep
from r2d2_tpu_torch.models import create_network, params_from_flax
from r2d2_tpu_torch.replay.device_ring import DeviceRing
from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer
from r2d2_tpu_torch.telemetry import learnhealth as tlh
from r2d2_tpu_torch.tools.rank_worker import run_ranks

from test_torch_anakin import (
    jax_draws,
    jax_rollout,
    port_carry,
    port_ring,
)
from test_torch_anakin import jax_setup as anakin_setup
from test_torch_in_graph_per import (
    filled,
    jax_uniforms,
    make_jcfg,
    per_state,
    scripted_blocks,
)

A = 4
N_SCALARS = len(tlh.DIAG_SCALARS)
SCALAR_TOL = dict(rtol=1e-5, atol=1e-7)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


def make_batch(cfg, rng, B):
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
        is_weights=rng.uniform(0.05, 1.0, B).astype(np.float32),
    )


def to_port(tree):
    return params_from_flax(jax.device_get(tree))


def assert_diag_close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape == (tlh.DIAG_SIZE,), what
    np.testing.assert_allclose(got[:N_SCALARS], want[:N_SCALARS],
                               err_msg=f"{what} scalars", **SCALAR_TOL)
    np.testing.assert_array_equal(got[N_SCALARS:], want[N_SCALARS:],
                                  err_msg=f"{what} buckets")


def assert_rows(got, want, armed):
    """Armed rows close, disarmed rows exactly zero on both sides."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for i, a in enumerate(armed):
        if a:
            assert got[i][0] == want[i][0] == 1.0
            assert_diag_close(got[i], want[i], f"row {i}")
        else:
            assert not got[i].any() and not want[i].any(), i


def test_layout_and_buckets_match_the_reference():
    assert tlh.DIAG_SCALARS == jlh.DIAG_SCALARS
    assert (tlh.TD_ABS_EDGES, tlh.IS_WEIGHT_EDGES) == (
        jlh.TD_ABS_EDGES, jlh.IS_WEIGHT_EDGES)
    assert tlh.DIAG_SIZE == jlh.DIAG_SIZE == 28
    np.testing.assert_array_equal(tlh.empty_diag(), jlh.empty_diag())


@pytest.mark.parametrize("seed", [0, 1])
def test_make_diag_fn_matches_jax(seed):
    """The diag of one step's pieces (pre-update params, batch, loss,
    grads, Adam updates, new params and target, the loss's aux) through
    both packages' ``make_diag_fn``."""
    jcfg = jax_test_config()
    cfg = port_test_config()
    jnet = jax_create(jcfg, A)
    params = init_params(jcfg, jnet, jax.random.PRNGKey(seed))
    target = init_params(jcfg, jnet, jax.random.PRNGKey(seed + 10))
    batch = make_batch(jcfg, np.random.default_rng(seed), 8)
    # an IS weight on an edge and a |TD| far past the last one exercise
    # the side="left" rule and the +Inf bucket
    batch["is_weights"][0] = 0.4
    batch["n_step_reward"][1] = 1e4
    jloss_net = jstep._loss_net(jcfg, jnet)
    (loss, (_, aux)), grads = jax.value_and_grad(
        lambda p: jstep.loss_and_priorities(jcfg, jloss_net, p, target,
                                            batch, with_aux=True),
        has_aux=True)(params)
    opt = jstep.make_optimizer(jcfg)
    updates, _ = opt.update(grads, opt.init(params), params)
    new_params = optax.apply_updates(params, updates)
    want = np.asarray(jlh.make_diag_fn(jcfg, jloss_net)(
        params, batch, loss, grads, updates, new_params, target, aux))

    net = tstep._loss_net(create_network(cfg, A, device="cpu"))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    taux = tuple(torch.from_numpy(np.asarray(a)) for a in aux)
    with torch.no_grad():
        got = tlh.make_diag_fn(cfg, net)(
            to_port(params), tb, torch.tensor(float(loss)),
            to_port(grads), to_port(updates), to_port(new_params),
            to_port(target), taux)
    assert got.dtype == torch.float32
    assert_diag_close(got.numpy(), want)
    assert want[N_SCALARS + len(tlh.TD_ABS_EDGES)] > 0   # +Inf |TD| bucket


def test_nonfinite_sentry_counts_every_leaf():
    """A NaN in one gradient leaf and an Inf in another: the sentry counts
    each element, as JAX's does."""
    cfg = port_test_config()
    net = tstep._loss_net(create_network(cfg, A, device="cpu"))
    params = dict(net.state_dict())
    names = list(params)
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    grads[names[0]].view(-1)[:3] = float("nan")
    grads[names[-1]].view(-1)[0] = float("inf")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(
        cfg, np.random.default_rng(3), 8).items()}
    _, _, aux = tstep.loss_and_priorities(cfg, net, params, params, batch,
                                          with_aux=True)
    with torch.no_grad():
        d = tlh.make_diag_fn(cfg, net)(
            params, batch, torch.tensor(float("nan")), grads, grads,
            params, params, aux)
    assert d[tlh.DIAG_SCALARS.index("nonfinite")] == 5.0


@pytest.mark.parametrize("interval", [1, 2, 3])
def test_train_step_rows_match_jax(interval):
    """Five steps from the same state: the armed rows (every interval-th
    step) against JAX's ``pjit_train_step`` with the diagnostics on, the
    disarmed rows exactly zero, the losses at the learner tolerance."""
    jcfg = jax_test_config(learnhealth_interval=interval,
                           target_net_update_interval=2)
    cfg = port_test_config(learnhealth_interval=interval,
                           target_net_update_interval=2)
    jnet = jax_create(jcfg, A)
    params = init_params(jcfg, jnet, jax.random.PRNGKey(0))
    jstate = jstep.create_train_state(jcfg, params)
    jfn = pjit_train_step(jcfg, jnet, state_template=jstate)
    state = tstep.create_train_state(cfg, to_port(params))
    fn = tstep.make_train_step(cfg, create_network(cfg, A, device="cpu"),
                               learnhealth=True)
    rng = np.random.default_rng(4)
    got, want = [], []
    for _ in range(5):
        batch = make_batch(jcfg, rng, 8)
        jstate, jloss, _, jdiag = jfn(jstate, batch)
        state, loss, _, diag = fn(state, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
        np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
        got.append(diag.numpy())
        want.append(np.asarray(jdiag))
    assert_rows(got, want, [(i + 1) % interval == 0 for i in range(5)])


def test_disarmed_step_signature_is_unchanged():
    """Without ``learnhealth`` (or at interval 0) the step keeps its
    three outputs, and its results are the armed step's bit for bit."""
    cfg = port_test_config(learnhealth_interval=1)
    net = create_network(cfg, A, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(
        cfg, np.random.default_rng(5), 8).items()}
    a = tstep.make_train_step(cfg, net)(
        tstep.create_train_state(cfg, net.state_dict()), batch)
    b = tstep.make_train_step(cfg, net, learnhealth=True)(
        tstep.create_train_state(cfg, net.state_dict()), batch)
    c = tstep.make_train_step(cfg.replace(learnhealth_interval=0), net,
                              learnhealth=True)(
        tstep.create_train_state(cfg, net.state_dict()), batch)
    assert len(a) == 3 and len(b) == 4 and len(c) == 3
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    for k in a[0].params:
        assert torch.equal(a[0].params[k], b[0].params[k])


def test_host_sampled_super_step_rows_match_jax():
    """k = 3 steps of the host-sampled super-step over the same ring and
    index bundle: JAX's ``make_super_step_fn(learnhealth=True)`` rows."""
    k = 3
    cfg = port_test_config(device_replay=True, learnhealth_interval=2)
    jcfg = jax_test_config(device_replay=True, learnhealth_interval=2)
    ring = DeviceRing(cfg, A, device="cpu")
    buf = ReplayBuffer(cfg, A, rng=np.random.default_rng(99),
                       device_ring=ring)
    jring = JaxDeviceRing(jcfg, A)
    jbuf = jrb.ReplayBuffer(jcfg, A, rng=np.random.default_rng(99),
                            device_ring=jring)
    for blk, prios in scripted_blocks(cfg, 3):
        buf.add(blk, prios, None)
        jbuf.add(blk, prios, None)
    jnet = jax_create(jcfg, A)
    params = init_params(jcfg, jnet, jax.random.PRNGKey(0))
    meta = buf.sample_meta(k)
    ints, w = meta["ints"], meta["is_weights"]
    jfn = jax.jit(jstep.make_super_step_fn(jcfg, jnet, k, learnhealth=True))
    _, jlosses, _, jdiags = jfn(jstep.create_train_state(jcfg, params),
                                jring.snapshot(), jnp.asarray(ints),
                                jnp.asarray(w))
    ss = tstep.make_super_step_fn(cfg, create_network(cfg, A, device="cpu"),
                                  k, learnhealth=True)
    state, losses, _, diags = ss(
        tstep.create_train_state(cfg, to_port(params)), ring.snapshot(),
        torch.from_numpy(ints), torch.from_numpy(w))
    assert state.step == k and diags.shape == (k, tlh.DIAG_SIZE)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               **LOSS_TOL)
    assert_rows(diags.numpy(), np.asarray(jdiags), [False, True, False])


def test_in_graph_super_step_rows_match_jax():
    """k = 2 in-graph PER steps fed JAX's uniforms: the rows against
    ``make_in_graph_per_super_step_fn(learnhealth=True)``'s."""
    k, dispatch = 2, 3
    kw = dict(learnhealth_interval=1)
    cfg, _, ring, _, jring = filled(3, **kw)
    jcfg = make_jcfg(**kw)
    jnet = jax_create(jcfg, A)
    params = init_params(jcfg, jnet, jax.random.PRNGKey(0))
    jmeta = jring.per_meta()
    jfn = jax.jit(jstep.make_in_graph_per_super_step_fn(
        jcfg, jnet, k, learnhealth=True))
    _, _, jlosses, jdiags = jfn(
        jstep.create_train_state(jcfg, params), jring.snapshot(),
        jring.take_prios(), jmeta["seq_meta"], jmeta["first"],
        jnp.asarray(dispatch, jnp.uint32))
    u, _ = jax_uniforms(cfg.seed, dispatch, k, cfg.batch_size)
    fn = tstep.make_in_graph_per_super_step_fn(
        cfg, create_network(cfg, A, device="cpu"), k, learnhealth=True)
    prios, seq_meta, first = per_state(ring)
    _, _, losses, diags = fn(
        tstep.create_train_state(cfg, to_port(params)), ring.snapshot(),
        prios, seq_meta, first, uniforms=torch.from_numpy(u))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               **LOSS_TOL)
    assert_rows(diags.numpy(), np.asarray(jdiags), [True, True])


def test_anakin_rows_match_jax():
    """One fused dispatch (k = 2) from JAX's carry, the port fed JAX's
    uniforms and draws: the flat vector's diag rows (after the losses and
    the stats) against JAX's."""
    k, E, d = 2, 2, 5
    jcfg, cfg, jnet, params, jenv, env, net = anakin_setup(
        "fake", num_actors=3, anakin_episode_len=13, buffer_capacity=30 * 8,
        superstep_k=k, anakin_env_steps_per_update=E,
        learnhealth_interval=2)
    _, jast1, jring, _ = jax_rollout(jcfg, jnet, params, jenv, 40)
    draws, init = jax_draws(jenv, "fake", jast1, k * E,
                            cfg.anakin_episode_len)
    jss = janakin.make_anakin_super_step(jcfg, jnet, jenv, A)
    *_, jflat = jss(
        jstep.create_train_state(jcfg, params),
        {k_: jnp.asarray(v) for k_, v in jast1.items()},
        {k_: jnp.asarray(v) for k_, v in jring["arrays"].items()},
        jnp.asarray(jring["prios"]), jnp.asarray(jring["seq_meta"]),
        jnp.asarray(jring["first"]), jnp.asarray(d, jnp.uint32))
    jflat = np.asarray(jflat)
    keys = jax.random.split(jax.random.fold_in(
        jax.random.PRNGKey(cfg.seed), jnp.asarray(d, jnp.uint32)), k)
    u = np.stack([np.asarray(jax.random.uniform(key, (cfg.batch_size,)))
                  for key in keys])
    ring = port_ring(cfg, jring)
    ast = port_carry(cfg, env, jast1, init)
    ss = tanakin.make_anakin_super_step(cfg, net, env, A)
    meta = ring.per_meta()
    *_, flat = ss(tstep.create_train_state(cfg, to_port(params)), ast,
                  ring.snapshot(), ring.take_prios(), meta["seq_meta"],
                  meta["first"], d, uniforms=torch.from_numpy(u),
                  draws=draws)
    flat = flat.numpy()
    assert flat.shape == jflat.shape
    n = k * tlh.DIAG_SIZE
    np.testing.assert_allclose(flat[:k], jflat[:k], **LOSS_TOL)
    np.testing.assert_array_equal(flat[k:-n], jflat[k:-n])
    assert_rows(flat[-n:].reshape(k, -1), jflat[-n:].reshape(k, -1),
                [False, True])


def test_anakin_plane_feeds_the_monitor():
    """The plane's harvest absorbs the dispatch's armed rows."""
    cfg = port_test_config(game_name="Fake", actor_transport="anakin",
                           device_replay=True, in_graph_per=True,
                           num_actors=2, superstep_k=2,
                           anakin_episode_len=12, learning_starts=16,
                           learnhealth_interval=1)
    net = create_network(cfg, A, device="cpu")
    plane = tanakin.AnakinPlane(cfg, net, A, DeviceRing(cfg, A,
                                                        device="cpu"))
    plane.monitor = tlh.LearnHealthMonitor(cfg)
    state = tstep.create_train_state(cfg, net.state_dict())
    while not plane.ready:
        plane.rollout_step(state.params)
    state, result = plane.dispatch(state)
    plane.harvest(result)
    snap = plane.monitor.snapshot()
    assert snap["armed_steps"] == 2 and snap["loss_count"] == 2
    assert sum(snap["is_hist"]) == 2 * cfg.batch_size


# ------------------------------------------------------------------ mesh

MESH_LAYOUTS = ((("dp", 2),), (("fsdp", 2),))


def test_meshed_diag_over_two_ranks_matches_dp1(tmp_path):
    """Two gloo ranks at dp = 2 and fsdp = 2: every rank's diag equals the
    meshless step's at 1e-5 relative (the norms and the non-finite count
    cover every shard, the histograms the global batch)."""
    cfg = port_test_config(learnhealth_interval=1, grad_norm=0.05)
    net = create_network(cfg, A, device="cpu", lstm_impl="scan")
    params = {k: v.detach().numpy().copy()
              for k, v in net.state_dict().items()}
    batches = [make_batch(cfg, np.random.default_rng(20 + i), 8)
               for i in range(2)]
    state = tstep.create_train_state(cfg, {k: torch.from_numpy(v)
                                           for k, v in params.items()})
    step = tstep.make_train_step(cfg, net, learnhealth=True)
    ref = []
    for b in batches:
        state, _, _, diag = step(state, {k: torch.from_numpy(v)
                                         for k, v in b.items()})
        ref.append(diag.numpy())
    out = run_ranks("step", 2, str(tmp_path), dict(
        params=params, batches=batches,
        cfg_kw=dict(learnhealth_interval=1, grad_norm=0.05),
        layouts=MESH_LAYOUTS), timeout=240)
    for lay in MESH_LAYOUTS:
        for rank in (0, 1):
            got = out[rank][lay]["diags"]
            assert len(got) == len(ref)
            for g, w in zip(got, ref):
                np.testing.assert_allclose(g[:N_SCALARS], w[:N_SCALARS],
                                           rtol=1e-5, atol=1e-7,
                                           err_msg=str(lay))
                np.testing.assert_array_equal(g[N_SCALARS:], w[N_SCALARS:])


# ------------------------------------------------- the one result fetch

def _drive(mode, interval):
    """One learner run of 8 updates at ``interval`` (0: diagnostics off):
    the result fetches, the dispatch puts, the losses and the monitor."""
    from r2d2_tpu_torch.learner.learner import Learner
    from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS

    kw = dict(training_steps=8, superstep_k=2, learnhealth_interval=interval)
    if mode == "host_staged":
        cfg = port_test_config(**kw)
        rng = np.random.default_rng(6)
        batches = []
        for _ in range(8):
            b = make_batch(cfg, rng, cfg.batch_size)
            b.update(idxes=np.arange(cfg.batch_size), block_ptr=0,
                     env_steps=100)
            batches.append(b)
        it = iter(batches)
        source = lambda: next(it, None)             # noqa: E731
    elif mode == "in_graph":
        cfg, buf, ring, _, _ = filled(4, **kw)
    else:
        cfg = port_test_config(device_replay=True, **kw)
        ring = DeviceRing(cfg, A, device="cpu")
        buf = ReplayBuffer(cfg, A, rng=np.random.default_rng(99),
                           device_ring=ring)
        for blk, prios in scripted_blocks(cfg, 4):
            buf.add(blk, prios, None)
    net = create_network(cfg, A, device="cpu",
                         generator=torch.Generator().manual_seed(4))
    learner = Learner(cfg, net, tstep.create_train_state(
        cfg, net.state_dict()))
    learner.monitor = tlh.LearnHealthMonitor(cfg)
    HOST_TRANSFERS.reset()
    if mode == "host_staged":
        m = learner.run(source, lambda *a: None)
    else:
        m = learner.run_device(buf, ring, priority_sink=lambda *a: None)
    return dict(fetch=HOST_TRANSFERS.get("learner.result_fetch"),
                put=HOST_TRANSFERS.get("learner.dispatch_put"),
                loss=m["mean_loss"], updates=m["num_updates"],
                lh=learner.monitor.snapshot())


@pytest.mark.parametrize("mode", ["host_staged", "host_sampled",
                                  "in_graph"])
def test_diagnostics_ride_the_one_result_fetch(mode):
    """Each drivetrain's result fetches and dispatch puts are the same
    with the diagnostics on and off (one fetch an update host-staged, one
    a dispatch on the device ring), and so are its losses; the monitor
    absorbs one armed row every 2nd update."""
    off, on = _drive(mode, 0), _drive(mode, 2)
    per = 1 if mode == "host_staged" else 2
    assert off["updates"] == on["updates"] == 8
    assert off["fetch"] == on["fetch"] == 8 // per
    assert off["put"] == on["put"]
    assert off["loss"] == on["loss"]
    assert off["lh"]["armed_steps"] == 0 and on["lh"]["armed_steps"] == 4
    assert on["lh"]["loss_count"] == 8
