"""The port's training path end to end, on the CPU.

``train_sync`` at ``test_config`` size (mlp torso, H=16, float32) with
``device="cpu"`` and ``act_device="cpu"``: the whole loop — actors →
local buffers → replay → learner step → priority feedback → publication →
checkpoints — and the evaluator.  Mirrors tests/test_train_end_to_end.py
(its learning e2es are slow-marked there and here).
"""
import os

import numpy as np
import pytest
import torch

from r2d2_tpu_torch import train as ttrain
from r2d2_tpu_torch.checkpoint import Checkpointer
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.envs import FakeAtariEnv
from r2d2_tpu_torch.evaluate import evaluate_params, evaluate_sweep
from r2d2_tpu_torch.models import create_network
from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer
from r2d2_tpu_torch.utils.trace import RETRACES

A = 4


def env_factory(cfg, seed):
    return FakeAtariEnv(obs_shape=cfg.obs_shape, action_dim=A, seed=seed,
                        episode_len=32)


def cpu_config(**kw):
    return port_test_config(game_name="Fake", act_device="cpu", **kw)


def test_train_sync_short_run_feeds_every_priority_back(monkeypatch,
                                                        tmp_path):
    """Eight updates: every update's priorities reach the buffer (the
    feedback count is conserved), every loss is finite, the learner
    publishes and checkpoints on its cadences."""
    fed = []
    real = ReplayBuffer.update_priorities

    def counting(self, idxes, priorities, old_ptr, loss):
        fed.append(len(idxes))
        return real(self, idxes, priorities, old_ptr, loss)

    monkeypatch.setattr(ReplayBuffer, "update_priorities", counting)
    cfg = cpu_config(training_steps=8, save_interval=4)
    ck = os.path.join(tmp_path, "ck")
    m = ttrain.train_sync(cfg, env_factory=env_factory, checkpoint_dir=ck,
                          device="cpu")
    assert set(m) == {"num_updates", "env_steps", "minutes", "mean_loss",
                      "losses", "episode_returns", "buffer_size",
                      "final_params"}
    assert m["num_updates"] == 8 == len(m["losses"])
    assert fed == [cfg.batch_size] * 8
    assert np.isfinite(m["losses"]).all() and np.isfinite(m["mean_loss"])
    assert m["env_steps"] >= cfg.learning_starts
    assert m["buffer_size"] >= cfg.learning_starts
    assert Checkpointer(ck).steps() == [4, 8]
    assert all(v.device.type == "cpu" for v in m["final_params"].values())
    # the run's entry points kept within their retrace budgets (a per-step
    # retrace here, or in any earlier test, fails), as JAX's e2e asserts
    RETRACES.assert_within_budgets()


def test_train_sync_resumes_from_its_checkpoint(tmp_path):
    ck = os.path.join(tmp_path, "ck")
    cfg = cpu_config(training_steps=4, save_interval=4)
    first = ttrain.train_sync(cfg, env_factory=env_factory,
                              checkpoint_dir=ck, device="cpu")
    m = ttrain.train_sync(cfg.replace(training_steps=6),
                          env_factory=env_factory, checkpoint_dir=ck,
                          resume=True, device="cpu")
    assert m["num_updates"] == 6 and len(m["losses"]) == 2
    state, meta = Checkpointer(ck).restore()
    assert state.step == 6 and meta["env_steps"] >= first["env_steps"]
    for k, v in m["final_params"].items():
        assert torch.equal(state.params[k], v)


def test_train_sync_needs_a_device_or_cuda(monkeypatch):
    """No device and no CUDA: the trainer raises; it never moves to the
    CPU on its own (nor does acting under act_device='auto')."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.train_sync(cpu_config(), env_factory=env_factory)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.train_sync(port_test_config(game_name="Fake"),
                          env_factory=env_factory, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.resolve_device(None)
    assert ttrain.resolve_device("cpu") == torch.device("cpu")


def test_default_env_factory_is_the_fake_env():
    cfg = cpu_config(training_steps=1)
    env = ttrain._default_env_factory(cfg, 0)
    assert env.reset()[0].shape == tuple(cfg.stored_obs_shape)


def test_evaluate_params_and_sweep(tmp_path):
    ck = os.path.join(tmp_path, "ck")
    cfg = cpu_config(training_steps=6, save_interval=3)
    ttrain.train_sync(cfg, env_factory=env_factory, checkpoint_dir=ck,
                      device="cpu")
    out = os.path.join(tmp_path, "curve.json")
    curve = evaluate_sweep(cfg, ck, env_factory, episodes=2, out_json=out,
                           action_dim=A, device="cpu")
    assert [c["step"] for c in curve] == [3, 6]
    assert all(np.isfinite(c["mean_reward"]) and c["env_frames"] > 0
               for c in curve)
    assert os.path.exists(out)
    net = create_network(cfg, A, device="cpu")
    score = evaluate_params(cfg, net, net.state_dict(), env_factory,
                            episodes=3, epsilon=1.0, seed=11)
    assert np.isfinite(score)


@pytest.mark.slow
def test_train_sync_learns():
    """150 updates: loss finite and decreasing, episode returns logged."""
    cfg = cpu_config(training_steps=150)
    m = ttrain.train_sync(cfg, env_factory=env_factory, device="cpu")
    losses = np.asarray(m["losses"])
    assert m["num_updates"] == 150 == losses.shape[0]
    assert np.isfinite(losses).all()
    assert losses[-40:].mean() < losses[:40].mean()
    assert len(m["episode_returns"]) > 0


@pytest.mark.slow
def test_trained_policy_beats_random():
    cfg = cpu_config(training_steps=300)
    m = ttrain.train_sync(cfg, env_factory=env_factory, device="cpu")
    net = create_network(cfg, A, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    rand_score = evaluate_params(cfg, net, net.state_dict(), env_factory,
                                 episodes=5, epsilon=1.0, seed=11)
    score = evaluate_params(cfg, net, m["final_params"], env_factory,
                            episodes=5, epsilon=cfg.test_epsilon, seed=11)
    assert score > rand_score, (score, rand_score)
