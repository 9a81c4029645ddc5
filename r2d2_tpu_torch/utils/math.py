"""Pure host-side math used across the framework (numpy).

Copied from ``r2d2_tpu/utils/math.py`` (the port imports nothing of the
JAX package); the numpy arithmetic is the same line for line, so both
packages give the same bits.  Torch twins of the rescale functions live
in ``r2d2_tpu_torch.learner.step``.
"""
from __future__ import annotations

import numpy as np


def value_rescale(x: np.ndarray, eps: float = 1e-3) -> np.ndarray:
    """h(x) = sign(x)(sqrt(|x|+1)-1) + eps*x  (reference: worker.py:383-385)."""
    x = np.asarray(x)
    return np.sign(x) * (np.sqrt(np.abs(x) + 1.0) - 1.0) + eps * x


def inverse_value_rescale(x: np.ndarray, eps: float = 1e-3) -> np.ndarray:
    """Closed-form inverse of ``value_rescale`` (reference: worker.py:387-390)."""
    x = np.asarray(x)
    t = (np.sqrt(1.0 + 4.0 * eps * (np.abs(x) + 1.0 + eps)) - 1.0) / (2.0 * eps)
    return np.sign(x) * (np.square(t) - 1.0)


def n_step_return(rewards: np.ndarray, n: int, gamma: float) -> np.ndarray:
    """Discounted n-step forward returns for every step of an episode chunk.

    ``out[t] = sum_{i<n} gamma^i * rewards[t+i]`` with rewards treated as zero
    past the end.  Matches the reference's convolution construction
    (worker.py:466-469) but is a plain function instead of inline buffer code.
    """
    rewards = np.asarray(rewards, dtype=np.float64)
    padded = np.concatenate([rewards, np.zeros(n - 1, dtype=np.float64)])
    kernel = gamma ** np.arange(n - 1, -1, -1, dtype=np.float64)
    return np.convolve(padded, kernel, mode="valid").astype(np.float32)


def n_step_gamma_tail(size: int, n: int, gamma: float, terminal: bool) -> np.ndarray:
    """Per-step bootstrap discount ``gamma^k`` for an episode chunk of ``size``.

    Interior steps get ``gamma**n``; the last ``min(size, n)`` steps have fewer
    than ``n`` real rewards, so they get decreasing exponents — or exactly 0
    when the chunk ends the episode, which encodes terminality without a done
    flag (reference: worker.py:443-453).
    """
    m = min(size, n)
    tail = np.zeros(m, dtype=np.float32) if terminal else gamma ** np.arange(m, 0, -1, dtype=np.float32)
    return np.concatenate([np.full(size - m, gamma ** n, dtype=np.float32), tail])


def epsilon_ladder(actor_id: int, num_actors: int, base_eps: float = 0.4,
                   alpha: float = 7.0) -> float:
    """Ape-X per-actor epsilon: base^(1 + i/(N-1) * alpha) (reference: train.py:15-17)."""
    if num_actors == 1:
        return base_eps
    return float(base_eps ** (1.0 + actor_id / (num_actors - 1) * alpha))


def mixed_td_errors(td_error: np.ndarray, learning_steps: np.ndarray,
                    eta: float = 0.9) -> np.ndarray:
    """Per-sequence priority ``eta*max + (1-eta)*mean`` of |TD| over a ragged
    concatenation (reference: worker.py:268-276), vectorised with ``reduceat``
    instead of the reference's Python loop.
    """
    learning_steps = np.asarray(learning_steps, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(learning_steps)[:-1]])
    maxes = np.maximum.reduceat(td_error, starts)
    means = np.add.reduceat(td_error, starts) / learning_steps
    return (eta * maxes + (1.0 - eta) * means).astype(td_error.dtype)
