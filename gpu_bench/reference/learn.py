"""The R2D2 update, written out plainly: the double-Q n-step loss with the
invertible value rescaling over each sequence's learning window, the
mixed max/mean priorities, and Adam after a clip of the global gradient
norm (Kapturowski et al., ICLR 2019, section 2 and Table 2).

A batch is a dict of tensors: obs (B, T, H, W, C) uint8, last_action
(B, T, A), last_reward (B, T), hidden (B, 2, layers, H) — the recurrent
state at the burn-in start —, action (B, L), n_step_reward (B, L),
n_step_gamma (B, L), burn_in, learning, forward (B,) and is_weights (B,).
The sequence is [burn_in | learning | forward] from t = 0.

The loss is summed over the batch's rows and divided by the batch's
count of valid learning steps, so it can be taken over blocks of rows
(``rows``) and their gradients added: the same sum as one pass."""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from gpu_bench.reference.network import Params, unroll
from gpu_bench.reference.precision import Ops

RESCALE_EPS = 1e-3
PRIORITY_ETA = 0.9


def h(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.sqrt(torch.abs(x) + 1.0) - 1.0) \
        + RESCALE_EPS * x


def h_inv(x: torch.Tensor) -> torch.Tensor:
    e = RESCALE_EPS
    t = (torch.sqrt(1.0 + 4.0 * e * (torch.abs(x) + 1.0 + e)) - 1.0) / (2 * e)
    return torch.sign(x) * (t * t - 1.0)


def _at(q: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """q (B, T, A) at time idx (B, L); a negative index counts from the
    end (a row with no valid step: masked out of everything)."""
    idx = torch.where(idx < 0, idx + q.shape[1], idx)
    return torch.gather(q, 1, idx[:, :, None].expand(-1, -1, q.shape[2]))


def td_errors(q_online: torch.Tensor, q_target: torch.Tensor, batch,
              n: int, L: int):
    """(td (B, L), mask (B, L)): the rescaled double-Q n-step error over
    each row's learning window."""
    burn = batch["burn_in"].long()
    learn = batch["learning"].long()
    fwd = batch["forward"].long()
    steps = torch.arange(L, device=burn.device)[None, :]
    idx_online = burn[:, None] + steps
    idx_target = torch.minimum(burn[:, None] + n + steps,
                               (burn + learn + fwd - 1)[:, None])
    mask = steps < learn[:, None]
    q_taken = torch.gather(_at(q_online, idx_online), 2,
                           batch["action"].long()[:, :, None])[:, :, 0]
    a_star = _at(q_online.detach(), idx_target).argmax(dim=-1)
    q_boot = torch.gather(_at(q_target, idx_target), 2,
                          a_star[:, :, None])[:, :, 0]
    target = h(batch["n_step_reward"]
               + batch["n_step_gamma"] * h_inv(q_boot))
    return target - q_taken, mask


def priorities(td: torch.Tensor, mask: torch.Tensor,
               learning: torch.Tensor) -> torch.Tensor:
    a = torch.where(mask, td.abs(), torch.zeros_like(td))
    return PRIORITY_ETA * a.max(dim=1).values + (1 - PRIORITY_ETA) * (
        a.sum(dim=1) / torch.clamp(learning.float(), min=1.0))


def rows_of(batch, lo: int, hi: int):
    return {k: v[lo:hi] for k, v in batch.items()}


def loss_and_grads(p: Params, target_p: Params, arch: dict, batch, n: int,
                   L: int, ops: Ops, rows: int):
    """(loss, priorities (B,), grads) of one batch, ``rows`` rows at a
    time; ``p`` must not require grad (leaves are made here)."""
    B = batch["learning"].shape[0]
    valid = torch.clamp((torch.arange(L, device=batch["learning"].device)
                         [None, :] < batch["learning"][:, None].long()
                         ).sum(), min=1).float()
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    loss = torch.zeros((), device=valid.device)
    prios = []
    for lo in range(0, B, rows):
        b = rows_of(batch, lo, min(B, lo + rows))
        q_on, _ = unroll(leaves, arch, b["obs"], b["last_action"],
                         b["last_reward"], b["hidden"], ops)
        with torch.no_grad():
            q_tg, _ = unroll(target_p, arch, b["obs"], b["last_action"],
                             b["last_reward"], b["hidden"], ops)
        td, mask = td_errors(q_on, q_tg, b, n, L)
        part = torch.where(mask, b["is_weights"][:, None] * td * td,
                           torch.zeros_like(td)).sum() / valid
        g = torch.autograd.grad(part, list(leaves.values()),
                                allow_unused=True)
        for (k, acc), gk in zip(grads.items(), g):
            if gk is not None:
                acc += gk
        loss = loss + part.detach()
        prios.append(priorities(td.detach(), mask, b["learning"]))
    return loss, torch.cat(prios), grads


class Adam:
    """Adam (b1 0.9, b2 0.999) after ``clip_by_global_norm(max_norm)``,
    as the R2D2 paper's learner; float32 moments."""

    def __init__(self, params: Params, lr: float, eps: float,
                 max_norm: float, b1: float = 0.9, b2: float = 0.999):
        self.lr, self.eps, self.max_norm = lr, eps, max_norm
        self.b1, self.b2 = b1, b2
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: Params, grads: Params) -> Params:
        """Update ``params`` in place; returns the clipped gradient."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())
                          ).float()
        scale = torch.where(norm < self.max_norm, torch.ones_like(norm),
                            self.max_norm / norm)
        self.count += 1
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        clipped = {}
        for k, g in grads.items():
            g = g * scale
            clipped[k] = g
            self.mu[k].mul_(self.b1).add_((1 - self.b1) * g)
            self.nu[k].mul_(self.b2).add_((1 - self.b2) * g * g)
            params[k] -= self.lr * (self.mu[k] / c1) / (
                torch.sqrt(self.nu[k] / c2) + self.eps)
        return clipped


def follow(weights: Params, arch: dict, hyper: dict, batches: List[dict],
           ops: Ops, rows: int, half: bool = False) -> Dict[str, object]:
    """Train a copy of ``weights`` on ``batches`` in order, the target
    network held at ``weights`` (no target sync falls inside them).
    Returns the losses, the priorities, the first clipped gradient and
    each parameter's change after the last batch.  ``half`` is a planted
    fault: each batch loses its second half of rows, the loss a mean over
    the rest."""
    p = {k: v.detach().clone().float() for k, v in weights.items()}
    target = {k: v.detach().clone().float() for k, v in weights.items()}
    opt = Adam(p, hyper["lr"], hyper["adam_eps"], hyper["grad_norm"])
    losses, prios, first_grad = [], [], None
    for batch in batches:
        if half:
            batch = rows_of(batch, 0, batch["learning"].shape[0] // 2)
        loss, pr, grads = loss_and_grads(
            p, target, arch, batch, hyper["forward_steps"],
            hyper["learning_steps"], ops, rows)
        clipped = opt.step(p, grads)
        if first_grad is None:
            first_grad = clipped
        losses.append(float(loss))
        prios.append(pr)
    change = {k: p[k] - weights[k].float() for k in p}
    return dict(losses=losses, priorities=prios, first_grad=first_grad,
                change=change)


def norms(tree: Params) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def leaf_gaps(prog: Params, ref: Params, keep: Optional[set] = None
              ) -> Dict[str, float]:
    """Each leaf's gap between the two sides' norms, against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger.  ``keep`` limits the leaves compared."""
    a, b = norms(prog), norms(ref)
    names = [k for k in b if keep is None or k in keep]
    med = float(torch.tensor([b[k] for k in names]).median())
    return {k: abs(a[k] - b[k]) / max(b[k], med) for k in names}



def moving_leaves(first_grad: Params, floor: float = 1e-3) -> set:
    """The leaves whose reference gradient is not nought to rounding:
    norm at least ``floor`` times the median leaf's (a dueling head's
    advantage bias, for one, gets an exactly cancelling gradient)."""
    n = norms(first_grad)
    med = float(torch.tensor(list(n.values())).median())
    return {k for k, v in n.items() if v >= floor * med}
