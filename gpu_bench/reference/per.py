"""Prioritized replay, written out plainly: the stratified proportional
draw (Schaul et al., 2016; one uniform per stratum of the total mass), its
importance weights (p / min p)^-beta over the drawn rows, and the
sequence gather from a replay slot.

A slot (a block of ``block_length`` steps, cut into ``K = block_length /
learning`` sequences) holds: obs (MS, H, W, C) uint8 with MS =
block_length + burn_in + 1 (the burn-in prefix carried from the previous
block, then the steps, then the last observation), last_action (MS, A),
last_reward (MS,), action, n_step_reward and n_step_gamma (block_length,)
and hidden (K, 2, layers, H), the recurrent state at each sequence's
burn-in start.  ``seq_meta`` (slots, K, 3) gives each sequence's
(burn_in, learning, forward) and ``first`` (slots,) the position of the
first sequence's burn-in start in the slot."""
from __future__ import annotations

from typing import Dict

import torch


def bad_draws(prios: torch.Tensor, u: torch.Tensor, idx: torch.Tensor,
              rel_tol: float = 1e-6) -> int:
    """How many of the drawn leaves ``idx`` (n,) are not the stratified
    draw of ``u`` (n,) over the leaf masses ``prios``: draw j must land in
    stratum j, ``(j + u_j) / n`` of the total mass, within ``rel_tol`` of
    the total (the rounding of a float32 target), on a leaf with mass."""
    n = u.shape[0]
    cum = torch.cumsum(prios.double(), 0)
    total = cum[-1]
    target = (torch.arange(n, dtype=torch.float64, device=u.device)
              + u.double()) * total / n
    hi = cum[idx]
    lo = hi - prios[idx].double()
    tol = rel_tol * total
    ok = (prios[idx] > 0) & (lo - tol <= target) & (target <= hi + tol)
    return int((~ok).sum())


def last_rows(idx: torch.Tensor) -> torch.Tensor:
    """For each row, the last row that drew the same leaf: a leaf drawn
    twice in one batch keeps the priority of its last row."""
    same = idx[:, None] == idx[None, :]
    pos = torch.arange(idx.shape[0], device=idx.device)
    return torch.where(same, pos[None, :], -1).amax(dim=1)


def is_weights(prios: torch.Tensor, idx: torch.Tensor,
               beta: float) -> torch.Tensor:
    q = prios[idx].double() / prios.double().sum()
    return ((q / q.min()) ** (-beta)).float()


def gather(slots: Dict[str, torch.Tensor], slot: torch.Tensor,
           seq: torch.Tensor, meta: torch.Tensor, first: torch.Tensor,
           is_w: torch.Tensor, seq_len: int, learning: int,
           block_length: int) -> Dict[str, torch.Tensor]:
    """The batch of sequences ``seq`` (B,) of slots ``slot`` (B,) (rows of
    ``slots``), with their ``meta`` (B, 3) and slots' ``first`` (B,), each
    ``seq_len`` steps from its burn-in start.  Positions past a slot's end
    repeat its last step: they fall outside the sequence's valid window
    and are masked."""
    burn = meta[:, 0].long()
    T_max = slots["obs"].shape[1]
    dev = slot.device
    T = seq_len
    t0 = first.long() + seq.long() * learning - burn
    t = torch.clamp(t0[:, None] + torch.arange(T, device=dev),
                    max=T_max - 1)
    w = torch.clamp(seq.long()[:, None] * learning
                    + torch.arange(learning, device=dev),
                    max=block_length - 1)
    s = slot.long()[:, None]
    return dict(
        obs=slots["obs"][s, t],
        last_action=slots["last_action"][s, t].float(),
        last_reward=slots["last_reward"][s, t],
        hidden=slots["hidden"][slot.long(), seq.long()],
        action=slots["action"][s, w].long(),
        n_step_reward=slots["n_step_reward"][s, w],
        n_step_gamma=slots["n_step_gamma"][s, w],
        burn_in=meta[:, 0],
        learning=meta[:, 1],
        forward=meta[:, 2],
        is_weights=is_w,
    )
