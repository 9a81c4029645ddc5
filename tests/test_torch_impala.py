"""The port's IMPALA-deep network against the JAX package's, on the CPU.

``impala_deep_config``'s architecture — the IMPALA residual CNN
(channels 16, 32, 32, two residual blocks a stage), two LSTM layers,
raw frames, remat — at small widths: the same flax params (converted
with ``params_from_flax``) and the same numpy inputs made from a seed go
through both packages.  The frame sizes are picked for flax's SAME
max-pool, which pads asymmetrically with -inf: 12 → 6 → 3 → 2 pads (0, 1),
(0, 1), (1, 1); 21 → 11 → 6 → 3 pads (1, 1), (1, 1), (0, 1); and the full
84 → 42 → 21 → 11.

Tolerances: float32 1e-5 max-abs; bfloat16 ``BF16_ATOL`` = 2^-8 (one bf16
ulp at |q| < 1, as tests/test_torch_network.py) on q and the new hidden;
the learner's loss 1e-5 relative and gradients 1e-4 relative
(tests/test_torch_learner.py).  The bf16 torso output alone is held to
two bf16 ulps of each value (``TORSO_BF16``): it is a bf16 activation
over 1 in places, behind 15 rounded convolutions that XLA and PyTorch sum
in different orders, and 2 of its 80 values at (21, 21) land two ulps
apart; the LSTM widens it to float32 and q holds to 2^-8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.config import impala_deep_config as jax_impala_config
from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu.learner import step as jstep
from r2d2_tpu.models.network import R2D2Network as JaxNet
from r2d2_tpu.models.network import create_network as jax_create
from r2d2_tpu.models.network import init_params
from r2d2_tpu_torch import train as ttrain
from r2d2_tpu_torch.config import impala_deep_config
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.envs import FakeAtariEnv
from r2d2_tpu_torch.learner import step as tstep
from r2d2_tpu_torch.models import create_network, params_from_flax
from r2d2_tpu_torch.models.network import _same_pads, max_pool_same

A = 4
BF16_ATOL = 2.0 ** -8
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
TORSO_BF16 = dict(rtol=2.0 ** -7, atol=2.0 ** -8)

# impala_deep_config's architecture at test widths
IMPALA = dict(torso="impala", lstm_layers=2, remat=True,
              obs_space_to_depth=False, hidden_dim=16)


def _pair(obs_shape, dtype="float32", impl="pallas", **extra):
    kw = dict(IMPALA, obs_shape=obs_shape, compute_dtype=dtype, **extra)
    jcfg = jax_test_config(lstm_impl=impl, pallas_interpret=True, **kw)
    tcfg = port_test_config(lstm_impl=impl, **kw)
    jnet = jax_create(jcfg, A)
    params = init_params(jcfg, jnet, jax.random.PRNGKey(3))
    tnet = create_network(tcfg, A, device="cpu")
    tnet.load_state_dict(params_from_flax(jax.device_get(params)))
    return jcfg, jnet, params, tcfg, tnet


def _batch(cfg, B, T, seed=0):
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 256, (B, T, *cfg.stored_obs_shape), np.uint8)
    la = np.zeros((B, T, A), np.float32)
    la[np.arange(B)[:, None], np.arange(T)[None],
       rng.integers(A, size=(B, T))] = 1.0
    lr = rng.normal(size=(B, T)).astype(np.float32)
    hid = (rng.normal(size=(B, 2, cfg.lstm_layers, cfg.hidden_dim))
           * 0.5).astype(np.float32)
    return obs, la, lr, hid


def _check(got, want, dtype):
    atol = 1e-5 if dtype == "float32" else BF16_ATOL
    for g, w in zip(got, want):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


@pytest.mark.parametrize("n,pads", [(84, (0, 1)), (42, (0, 1)),
                                    (21, (1, 1)), (12, (0, 1)),
                                    (6, (0, 1)), (3, (1, 1)), (11, (1, 1))])
def test_same_pool_pads_follow_lax(n, pads):
    assert _same_pads(n, 3, 2) == pads == jax.lax.padtype_to_pads(
        (n,), (3,), (2,), "SAME")[0]


@pytest.mark.parametrize("n", [12, 21, 84])
def test_max_pool_matches_flax(n):
    x = np.random.default_rng(n).normal(size=(2, n, n, 3)).astype(
        np.float32)
    from flax import linen as nn

    want = nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                       padding="SAME")
    got = max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("obs_shape", [(12, 12, 1), (21, 21, 1)])
def test_impala_torso_matches_flax(obs_shape, dtype):
    jcfg, jnet, params, _, tnet = _pair(obs_shape, dtype)
    x = np.random.default_rng(1).random((5, *obs_shape)).astype(np.float32)
    cd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    torso = jax.device_get(params)["params"]["torso"]
    from r2d2_tpu.models.network import ImpalaTorso as JaxTorso

    want = JaxTorso(out_dim=jcfg.hidden_dim, compute_dtype=cd).apply(
        {"params": torso}, jnp.asarray(x, cd))
    got = tnet.torso(torch.from_numpy(x).to(tnet.compute_dtype))
    tol = dict(rtol=0, atol=1e-5) if dtype == "float32" else TORSO_BF16
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("obs_shape", [(12, 12, 1), (21, 21, 1)])
def test_two_layer_unroll_matches_jax(obs_shape, dtype):
    """q and the new hidden of both layers over a 6-step unroll."""
    jcfg, jnet, params, tcfg, tnet = _pair(obs_shape, dtype)
    obs, la, lr, hid = _batch(tcfg, B=3, T=6)
    want = jnet.apply(params, obs, la, lr, hid, method=JaxNet.unroll)
    with torch.no_grad():
        got = tnet.unroll(*(torch.from_numpy(a) for a in (obs, la, lr, hid)))
    assert got[1].shape == (3, 2, 2, tcfg.hidden_dim)
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_size_frame_act_matches_jax(dtype):
    """One (84, 84, 1) act at B = 2: the torso's flatten is 11×11×32."""
    jcfg, jnet, params, tcfg, tnet = _pair((84, 84, 1), dtype)
    assert tnet.torso.dense.weight.shape[1] == 11 * 11 * 32
    obs, la, lr, hid = _batch(tcfg, B=2, T=1)
    obs, la, lr = obs[:, 0], la[:, 0], lr[:, 0]
    want = jnet.apply(params, obs, la, lr, hid, method=JaxNet.act)
    with torch.no_grad():
        got = tnet.act(*(torch.from_numpy(a) for a in (obs, la, lr, hid)))
    _check(got, want, dtype)


def test_params_from_flax_maps_the_impala_tree():
    """Conv_0 … Conv_14 in flax's creation order, then Dense_0: every
    port parameter is covered once, with the right shape."""
    jcfg, _, params, tcfg, tnet = _pair((12, 12, 1))
    torso = jax.device_get(params)["params"]["torso"]
    assert sorted(torso) == sorted([f"Conv_{i}" for i in range(15)]
                                   + ["Dense_0"])
    sd = params_from_flax(jax.device_get(params))
    want = tnet.state_dict()
    assert set(sd) == set(want)
    assert all(sd[k].shape == want[k].shape for k in sd)
    # stage convs sit at 0, 5, 10 and change the channel count
    assert [tnet.torso.convs[i].weight.shape[:2] for i in (0, 5, 10)] == [
        (16, 1), (32, 16), (32, 32)]
    np.testing.assert_array_equal(
        sd["torso.convs.7.weight"].numpy(),
        np.asarray(torso["Conv_7"]["kernel"]).transpose(3, 2, 0, 1))


def test_impala_deep_config_builds_at_full_width():
    cfg = impala_deep_config(game_name="Fake")
    jcfg = jax_impala_config(game="Fake")
    for f in ("torso", "lstm_layers", "hidden_dim", "obs_shape",
              "stored_obs_shape", "seq_len", "block_length", "remat",
              "batch_size", "compute_dtype"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    net = create_network(cfg, A, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    assert len(net.lstm_layers) == 2
    assert all(layer.remat for layer in net.lstm_layers)


def _loss_batch(cfg, seed=7, B=4):
    rng = np.random.default_rng(seed)
    T, L, n = cfg.seq_len, cfg.learning_steps, cfg.forward_steps
    learning = rng.integers(1, L + 1, B).astype(np.int32)
    return dict(
        obs=rng.integers(0, 255, (B, T, *cfg.obs_shape), dtype=np.uint8),
        last_action=rng.random((B, T, A)).astype(np.float32),
        last_reward=rng.random((B, T)).astype(np.float32),
        hidden=rng.normal(size=(B, 2, cfg.lstm_layers, cfg.hidden_dim)
                          ).astype(np.float32),
        action=rng.integers(0, A, (B, L)).astype(np.int32),
        n_step_reward=rng.normal(size=(B, L)).astype(np.float32),
        n_step_gamma=np.full((B, L), cfg.gamma ** n, np.float32),
        burn_in=rng.integers(0, cfg.burn_in_steps + 1, B).astype(np.int32),
        learning=learning,
        forward=np.where(learning == L, rng.integers(1, n + 1, B),
                         1).astype(np.int32),
        is_weights=rng.uniform(0.2, 1.0, B).astype(np.float32))


def _port_loss_grads(cfg, params, target, batch):
    net = create_network(cfg, A, device="cpu")
    tp = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss, prios = tstep.loss_and_priorities(
        cfg, net, tp, target, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(tp.values()))
    return loss, prios, dict(zip(tp, grads))


def test_remat_loss_and_grads_match_jax_and_the_plain_scan():
    """remat=True: loss and grads equal JAX's remat=True at the learner
    tolerances, and the port's own remat=False bit for bit (the
    checkpointed step recomputes the same ops)."""
    kw = dict(IMPALA, obs_shape=(12, 12, 1))
    jcfg = jax_test_config(**kw)
    cfg = port_test_config(**kw)
    jnet = jax_create(jcfg, A)
    params = init_params(jcfg, jnet, jax.random.PRNGKey(0))
    target = init_params(jcfg, jnet, jax.random.PRNGKey(1))
    batch = _loss_batch(cfg)
    (jloss, jprios), jgrads = jax.value_and_grad(
        lambda p: jstep.loss_and_priorities(
            jcfg, jnet, p, target, {k: jnp.asarray(v)
                                    for k, v in batch.items()}),
        has_aux=True)(params)

    tparams = params_from_flax(jax.device_get(params))
    ttarget = params_from_flax(jax.device_get(target))
    loss, prios, grads = _port_loss_grads(cfg, tparams, ttarget, batch)
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    np.testing.assert_allclose(prios.numpy(), np.asarray(jprios), **LOSS_TOL)
    want = params_from_flax(jax.device_get(jgrads))
    for k in want:
        np.testing.assert_allclose(grads[k].numpy(), want[k].numpy(),
                                   err_msg=k, **GRAD_TOL)

    loss0, prios0, grads0 = _port_loss_grads(cfg.replace(remat=False),
                                             tparams, ttarget, batch)
    assert torch.equal(loss, loss0) and torch.equal(prios, prios0)
    assert all(torch.equal(grads[k], grads0[k]) for k in grads)


def test_remat_checkpoints_each_scan_step(monkeypatch):
    """With autograd recording, every step of the training scan runs
    under torch.utils.checkpoint; a no-grad unroll never does."""
    from r2d2_tpu_torch.models import network

    calls = []
    real = network.checkpoint

    def counting(*a, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(*a, **kw)

    monkeypatch.setattr(network, "checkpoint", counting)
    _, _, _, tcfg, tnet = _pair((12, 12, 1), impl="scan")
    args = [torch.from_numpy(a) for a in _batch(tcfg, B=2, T=5)]
    with torch.no_grad():
        tnet.unroll(*args)
    assert calls == []
    q, _ = tnet.unroll(*args)
    q.sum().backward()
    assert calls == [False] * (5 * tcfg.lstm_layers)


def test_train_sync_at_the_impala_composition():
    """tests/test_train_end_to_end.py's seq-25 impala composition: IMPALA
    torso + 2-layer LSTM + remat through the replay → learner path."""
    cfg = port_test_config(
        game_name="Fake", act_device="cpu", torso="impala", lstm_layers=2,
        remat=True, obs_shape=(16, 16, 1),
        burn_in_steps=8, learning_steps=15, forward_steps=2,
        block_length=30, buffer_capacity=600, learning_starts=60,
        training_steps=10)
    assert cfg.seq_len == 25
    m = ttrain.train_sync(cfg, env_factory=lambda c, seed: FakeAtariEnv(
        obs_shape=c.obs_shape, action_dim=A, seed=seed, episode_len=32),
        device="cpu")
    assert m["num_updates"] == 10
    assert np.isfinite(np.asarray(m["losses"])).all()
