"""The reference against the port's CPU path at small sizes, in float32:
the network for each torso, the loss and its gradient, Adam after the
clip; then whole runs of the harness on host replay and on the replay
ring, whose check must find the port correct."""
from __future__ import annotations

import pytest
import torch

import tiny
from gpu_bench import cells
from gpu_bench.harness import run_loaded
from gpu_bench.reference import learn, network
from gpu_bench.reference.precision import Ops
from gpu_bench.weights import make_weights

TORSOS = {
    "mlp": dict(obs_shape=(12, 12, 1), obs_space_to_depth=False),
    "nature_s2d": dict(obs_shape=(84, 84, 1), obs_space_to_depth=True),
    "nature_raw": dict(obs_shape=(44, 44, 1), obs_space_to_depth=False),
    "impala": dict(obs_shape=(13, 11, 1), obs_space_to_depth=False,
                   lstm_layers=2),
}


def _port(kind):
    from r2d2_tpu_torch.config import test_config
    from r2d2_tpu_torch.models.network import create_network

    kw = dict(TORSOS[kind])
    cfg = test_config(game_name="Fake", torso=kind.split("_")[0],
                      act_device="cpu", compute_dtype="float32", **kw)
    arch = cells.arch_of(cfg, 4)
    w = make_weights(arch, 2 ** 33 + 5, "cpu")
    net = create_network(cfg, 4, device="cpu", lstm_impl="scan")
    with torch.no_grad():
        for k, v in net.named_parameters():
            v.copy_(w[k])
    return cfg, arch, w, net


def _inputs(cfg, B=3, T=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    obs = torch.randint(0, 256, (B, T, *cfg.stored_obs_shape),
                        generator=g, dtype=torch.uint8)
    la = torch.nn.functional.one_hot(torch.randint(0, 4, (B, T), generator=g),
                                     4).float()
    lr = torch.randn(B, T, generator=g)
    hidden = torch.randn(B, 2, cfg.lstm_layers, cfg.hidden_dim, generator=g)
    return obs, la, lr, hidden


@pytest.mark.parametrize("kind", sorted(TORSOS))
def test_network_matches_the_port(kind):
    cfg, arch, w, net = _port(kind)
    args = _inputs(cfg)
    with torch.no_grad():
        q, h = net.unroll(*args)
        q_ref, h_ref = network.unroll(w, arch, *args, Ops("f32"))
    torch.testing.assert_close(q_ref, q, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h_ref, h, rtol=1e-5, atol=1e-5)


def _batch(cfg, B=6, seed=1):
    g = torch.Generator().manual_seed(seed)
    obs, la, lr, hidden = _inputs(cfg, B, cfg.seq_len, seed)
    L = cfg.learning_steps
    learning = torch.randint(1, L + 1, (B,), generator=g, dtype=torch.int32)
    return dict(obs=obs, last_action=la, last_reward=lr, hidden=hidden,
                action=torch.randint(0, 4, (B, L), generator=g),
                n_step_reward=torch.randn(B, L, generator=g),
                n_step_gamma=torch.rand(B, L, generator=g),
                burn_in=torch.full((B,), cfg.burn_in_steps,
                                   dtype=torch.int32),
                learning=learning,
                forward=torch.full((B,), cfg.forward_steps,
                                   dtype=torch.int32),
                is_weights=torch.rand(B, generator=g) + 0.5)


@pytest.mark.parametrize("rows", [6, 4, 1])
def test_loss_and_grads_match_the_port(rows):
    from r2d2_tpu_torch.learner.step import loss_and_priorities

    cfg, arch, w, net = _port("mlp")
    batch = _batch(cfg)
    target = {k: v + 0.01 for k, v in w.items()}
    params = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    loss, prios = loss_and_priorities(cfg, net, params, target, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    r_loss, r_prios, r_grads = learn.loss_and_grads(
        w, target, arch, batch, cfg.forward_steps, cfg.learning_steps,
        Ops("f32"), rows)
    torch.testing.assert_close(r_loss, loss.detach(), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(r_prios, prios, rtol=1e-5, atol=1e-6)
    for k, g in zip(params, grads):
        torch.testing.assert_close(r_grads[k], g, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("scale", [1.0, 1e4])
def test_adam_after_clip_matches_the_port(scale):
    from r2d2_tpu_torch.learner.step import create_train_state, \
        make_optimizer

    cfg, arch, w, _ = _port("mlp")
    g = torch.Generator().manual_seed(3)
    state = create_train_state(cfg, w)
    opt = make_optimizer(cfg)
    state.opt_state.count_t = torch.zeros((), dtype=torch.int32)
    p = {k: v.clone() for k, v in w.items()}
    ref = learn.Adam(p, cfg.lr, cfg.adam_eps, cfg.grad_norm)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) * scale
                 for k, v in w.items()}
        opt.update(grads, state.opt_state, state.params)
        ref.step(p, grads)
    for k in w:
        torch.testing.assert_close(p[k], state.params[k], rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("ring", [False, True], ids=["host", "ring"])
def test_harness_finds_the_port_correct_on_the_cpu(ring):
    res = run_loaded(tiny.cell(ring), 2 ** 31 + 11, 1.5, False,
                     device="cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0
    e2e = res["e2e"]
    assert e2e["learner_frames_per_s"] > 0 and e2e["env_frames_per_s"] > 0
    assert e2e["dispatch_ms_p90"] > 0 and e2e["setup_s"] > 0
