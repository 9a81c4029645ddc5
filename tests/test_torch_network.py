"""The port's R2D2Network (r2d2_tpu_torch/models) against the JAX
package's on the same params and inputs.

Params come from the JAX ``init_params`` (a seeded key) and reach the
port through ``params_from_flax``; inputs are made with numpy from a
seed.  The JAX network runs ``lstm_impl="pallas"`` in interpret mode; the
port's ``"pallas"`` impl on CPU tensors is the kernel's plain version with
the same numerics.  Three torsos: the mlp ``test_config()``; the nature
torso over a (44, 44, 1) frame space-to-depth folded (11 → 10 → 4 → 2,
so the flatten before the torso Dense is 2×2×64 and its NHWC order
matters); and the raw 8×8/4 conv1 (``obs_space_to_depth=False``).

Tolerances: float32 1e-5 (the same arithmetic in another summation
order).  bfloat16 ``BF16_ATOL`` = 2^-8, one bf16 ulp at |q| < 1, with
equal greedy actions: both sides round at the same points (on these
inputs q comes out bit-identical and the f32 hidden within 2e-5), but
XLA's and PyTorch's CPU bf16 products sum in different orders, so an
activation that lands on a rounding boundary may round one ulp apart.
"""
import jax
import numpy as np
import pytest
import torch

from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu.models.network import R2D2Network as JaxNet
from r2d2_tpu.models.network import create_network as jax_create
from r2d2_tpu.models.network import init_params
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.models import (
    create_network,
    params_from_flax,
    resolve_lstm_impl,
)

A = 5
BF16_ATOL = 2.0 ** -8

CASES = {
    "mlp": dict(),
    "nature_s2d": dict(torso="nature", obs_shape=(44, 44, 1),
                       obs_space_to_depth=True, hidden_dim=32),
    "nature_raw": dict(torso="nature", obs_shape=(44, 44, 1),
                       obs_space_to_depth=False, hidden_dim=32),
}


def _pair(case, dtype, **extra):
    kw = dict(CASES[case], compute_dtype=dtype, **extra)
    jcfg = jax_test_config(lstm_impl="pallas", pallas_interpret=True, **kw)
    tcfg = port_test_config(lstm_impl="pallas", **kw)
    jnet = jax_create(jcfg, A)
    params = init_params(jcfg, jnet, jax.random.PRNGKey(7))
    tnet = create_network(tcfg, A, device="cpu")
    tnet.load_state_dict(params_from_flax(jax.device_get(params)))
    return jcfg, jnet, params, tnet


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


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _check(q_t, h_t, q_j, h_j, dtype):
    q_t, h_t = q_t.detach().numpy(), h_t.detach().numpy()
    q_j, h_j = np.asarray(q_j), np.asarray(h_j)
    assert q_t.dtype == np.float32 and q_t.shape == q_j.shape
    assert h_t.shape == h_j.shape
    atol = 1e-5 if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(q_t, q_j, atol=atol, rtol=0)
    np.testing.assert_allclose(h_t, h_j, atol=atol, rtol=0)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(q_t.argmax(-1), q_j.argmax(-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_act_matches_jax(case, dtype):
    cfg, jnet, params, tnet = _pair(case, dtype)
    obs, la, lr, hid = _batch(cfg, B=6, T=1)
    q_j, h_j = jnet.apply(params, obs[:, 0], la[:, 0], lr[:, 0], hid,
                          method=JaxNet.act)
    with torch.no_grad():
        q_t, h_t = tnet.act(*_t(obs[:, 0], la[:, 0], lr[:, 0], hid))
    _check(q_t, h_t, q_j, h_j, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_unroll_matches_jax(case, dtype):
    cfg, jnet, params, tnet = _pair(case, dtype)
    obs, la, lr, hid = _batch(cfg, B=3, T=5, seed=1)
    q_j, h_j = jnet.apply(params, obs, la, lr, hid, method=JaxNet.unroll)
    with torch.no_grad():
        q_t, h_t = tnet.unroll(*_t(obs, la, lr, hid))
    _check(q_t, h_t, q_j, h_j, dtype)


def test_stacked_layers_match_jax():
    cfg, jnet, params, tnet = _pair("mlp", "float32", lstm_layers=2)
    obs, la, lr, hid = _batch(cfg, B=4, T=3, seed=2)
    q_j, h_j = jnet.apply(params, obs, la, lr, hid, method=JaxNet.unroll)
    with torch.no_grad():
        q_t, h_t = tnet.unroll(*_t(obs, la, lr, hid))
    _check(q_t, h_t, q_j, h_j, "float32")


def _to_flax(sd):
    """The inverse layout map, written out independently of the converter:
    OIHW → HWIO, (out, in) → (in, out), LSTM leaves as they are."""
    names = {"conv1": "Conv_0", "conv2": "Conv_1", "conv3": "Conv_2",
             "dense": "Dense_0"}
    tree = {}
    for key, t in sd.items():
        a = t.numpy()
        parts = key.split(".")
        if parts[0] == "lstm_layers":
            tree.setdefault(f"lstm_{parts[1]}", {})[parts[2]] = a
            continue
        scope, layer, leaf = parts
        name = names[layer] if scope == "torso" else layer
        if leaf == "weight":
            leaf, a = "kernel", (a.transpose(2, 3, 1, 0) if a.ndim == 4
                                 else a.T)
        tree.setdefault(scope, {}).setdefault(name, {})[leaf] = a
    return {"params": tree}


@pytest.mark.parametrize("case", sorted(CASES))
def test_params_from_flax_round_trip(case):
    """flax → port → flax is the identity, every port parameter is
    covered, and the conv/dense layouts are the torch ones."""
    _, _, params, tnet = _pair(case, "float32")
    flax_np = jax.tree.map(np.asarray, jax.device_get(params))
    sd = params_from_flax(flax_np)
    assert set(sd) == set(tnet.state_dict())
    for k, v in tnet.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
        assert sd[k].dtype == torch.float32
    back = _to_flax(sd)
    assert jax.tree.structure(back) == jax.tree.structure(flax_np)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(flax_np)):
        np.testing.assert_array_equal(a, b)


def test_lstm_keeps_one_bias_in_reference_layout():
    _, _, params, tnet = _pair("mlp", "float32")
    layer = tnet.lstm_layers[0]
    np.testing.assert_array_equal(layer.b.detach().numpy(),
                                  np.asarray(params["params"]["lstm_0"]["b"]))
    assert not any("bias_hh" in k or "bias_ih" in k for k in tnet.state_dict())


def test_nhwc_flatten_order_is_pinned():
    """Permuting the conv3 output's spatial positions changes q: the
    flatten order is load-bearing, and the port matches JAX only with
    the NHWC order (checked in the act test); here a port network with
    its Dense rows reordered to NCHW order disagrees."""
    cfg, jnet, params, tnet = _pair("nature_s2d", "float32")
    obs, la, lr, hid = _batch(cfg, B=2, T=1, seed=3)
    q_j, _ = jnet.apply(params, obs[:, 0], la[:, 0], lr[:, 0], hid,
                        method=JaxNet.act)
    w = tnet.torso.dense.weight.detach()          # (out, 2*2*64) NHWC rows
    nchw = w.reshape(-1, 2, 2, 64).permute(0, 3, 1, 2).reshape(w.shape)
    with torch.no_grad():
        tnet.torso.dense.weight.copy_(nchw)
        q_bad, _ = tnet.act(*_t(obs[:, 0], la[:, 0], lr[:, 0], hid))
    assert np.abs(q_bad.numpy() - np.asarray(q_j)).max() > 1e-3


def test_seeded_init_is_deterministic_and_flax_shaped():
    cfg = port_test_config(**CASES["nature_s2d"])
    nets = [create_network(cfg, A, device="cpu",
                           generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    for (k, a), b in zip(nets[0].state_dict().items(),
                         nets[1].state_dict().values()):
        assert torch.equal(a, b), k
    layer = nets[0].lstm_layers[0]
    H = cfg.hidden_dim
    assert torch.all(layer.b[H:2 * H] == 1.0)
    assert torch.all(layer.b[:H] == 0.0)
    # orthogonal recurrent kernel: wh @ wh.T is the identity (rows)
    wh = layer.wh.detach()
    torch.testing.assert_close(wh @ wh.T, torch.eye(H), atol=1e-5, rtol=0)


def test_resolve_lstm_impl():
    cfg = port_test_config()
    assert resolve_lstm_impl(cfg, "cuda") == "pallas"
    assert resolve_lstm_impl(cfg, "cpu") == "scan"
    assert resolve_lstm_impl(cfg.replace(lstm_impl="pallas"), "cpu") \
        == "pallas"
    assert resolve_lstm_impl(cfg.replace(lstm_impl="scan"), "cuda") == "scan"


def test_scan_impl_is_differentiable_and_matches_pallas_in_f32():
    """The scan is the differentiable recurrence (for the training
    slice); in float32 it and the inference impl are the same function."""
    cfg, _, params, tnet = _pair("mlp", "float32")
    scan = create_network(cfg.replace(lstm_impl="scan"), A, device="cpu")
    scan.load_state_dict(tnet.state_dict())
    obs, la, lr, hid = _t(*_batch(cfg, B=2, T=4, seed=4))
    q_s, _ = scan.unroll(obs, la, lr, hid)
    with torch.no_grad():
        q_p, _ = tnet.unroll(obs, la, lr, hid)
    torch.testing.assert_close(q_s.detach(), q_p, atol=1e-6, rtol=0)
    q_s.sum().backward()
    assert scan.lstm_layers[0].wh.grad is not None
    assert torch.isfinite(scan.lstm_layers[0].wh.grad).all()
