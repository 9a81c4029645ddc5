"""Synthetic training-batch construction (the replay wire format).

Copied from ``r2d2_tpu/utils/batch.py`` (the port imports nothing of the
JAX package); the numpy draws are the same line for line, so both
packages build the same bits from the same generator.  One builder for
every consumer that needs a train-step batch without a live replay
buffer: the benchmark and tests.  Keys must stay in sync with
``ReplayBuffer.sample_batch`` and ``parallel.sharding.DEVICE_BATCH_KEYS``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from r2d2_tpu_torch.config import Config


def synthetic_batch(cfg: Config, action_dim: int,
                    rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """A full-size host batch with every sample at maximal window sizes."""
    B, T, L = cfg.batch_size, cfg.seq_len, cfg.learning_steps
    return dict(
        obs=rng.integers(0, 256, (B, T, *cfg.stored_obs_shape), dtype=np.uint8),
        last_action=np.eye(action_dim, dtype=np.float32)[
            rng.integers(0, action_dim, (B, T))],
        last_reward=rng.standard_normal((B, T)).astype(np.float32),
        hidden=(0.1 * rng.standard_normal(
            (B, 2, cfg.lstm_layers, cfg.hidden_dim))).astype(np.float32),
        action=rng.integers(0, action_dim, (B, L)).astype(np.int32),
        n_step_reward=rng.standard_normal((B, L)).astype(np.float32),
        n_step_gamma=np.full((B, L), cfg.gamma ** cfg.forward_steps,
                             np.float32),
        burn_in=np.full((B,), cfg.burn_in_steps, np.int32),
        learning=np.full((B,), L, np.int32),
        forward=np.full((B,), cfg.forward_steps, np.int32),
        is_weights=np.ones((B,), np.float32),
    )
