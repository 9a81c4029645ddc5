"""The R2D2 train step, and the k-fused super-steps over the device ring.

Port of ``r2d2_tpu/learner/step.py`` (the learnhealth diagnostics wait for
the telemetry slice, ROADMAP.md A item 10).  Capability-parity with the reference
learner's gradient path (worker.py:318-390): burn-in + stored-state LSTM
unroll, n-step **double-Q** targets under value rescaling,
importance-weighted MSE over the learning window, grad-clip-40 Adam, mixed
max/mean per-sequence priorities, periodic hard target-net sync.

As in the JAX package, one unroll per network serves the whole loss: the
full-T Q sequence is gathered at the online window indices (grad path) and
at the n-step-shifted target indices (no-grad path); window selection is
static-shape (indices + a validity mask); priorities are a masked segment
max/mean computed on the device.

The optimizer is written by hand with optax's arithmetic: the global-norm
clip scales by ``max_norm / norm`` with no ``+1e-6`` (unlike
``torch.nn.utils.clip_grad_norm_``), and Adam has ``eps`` outside the
square root, ``eps_root = 0`` and bias correction on both moments.  The
step updates the state's tensors in place; a caller that hands parameters
to another thread publishes a copy (``learner.Learner._publish``).

The super-steps (:class:`SuperStep`, :func:`make_in_graph_per_super_step_fn`)
run k train steps on batches gathered on the device from the replay ring
(replay/device_ring.py).  JAX fuses them into one ``lax.scan`` dispatch;
here they are k calls of the same train step, issued back to back with no
synchronisation, so the card still sees one stream of work per dispatch.
The in-graph PER sampler draws its uniforms from an explicit
``torch.Generator``: the same stratified scheme as JAX's
``fold_in(PRNGKey(seed), dispatch)`` stream, not the same bits.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch.func import functional_call, vmap

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.models.network import R2D2Network
from r2d2_tpu_torch.replay.device_ring import gather_batch

Params = Dict[str, torch.Tensor]
Batch = Dict[str, torch.Tensor]


def value_rescale(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """h(x) = sign(x)(sqrt(|x|+1)-1) + eps*x (worker.py:383-385)."""
    return torch.sign(x) * (torch.sqrt(torch.abs(x) + 1.0) - 1.0) + eps * x


def inverse_value_rescale(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    t = (torch.sqrt(1.0 + 4.0 * eps * (torch.abs(x) + 1.0 + eps)) - 1.0) / (
        2.0 * eps)
    return torch.sign(x) * (torch.square(t) - 1.0)


@dataclasses.dataclass
class AdamState:
    """optax ``ScaleByAdamState``: the step count and both moments."""
    count: int
    mu: Params
    nu: Params


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params
    target_params: Params
    opt_state: AdamState


class Optimizer:
    """``optax.chain(clip_by_global_norm(max_norm), adam(lr, eps=eps))``
    (worker.py:289,364), in place on the parameter tensors."""

    def __init__(self, lr: float, eps: float, max_norm: float,
                 b1: float = 0.9, b2: float = 0.999):
        self.lr, self.eps, self.max_norm = lr, eps, max_norm
        self.b1, self.b2 = b1, b2

    def init(self, params: Params) -> AdamState:
        return AdamState(
            count=0, mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()})

    @torch.no_grad()
    def update(self, grads: Params, state: AdamState,
               params: Params) -> None:
        """Clip ``grads`` by their global norm, advance ``state`` and
        apply the Adam step to ``params``, all in place."""
        b1, b2 = self.b1, self.b2
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = g_norm < self.max_norm
        state.count += 1
        bc1 = 1.0 - b1 ** state.count
        bc2 = 1.0 - b2 ** state.count
        for k, g in grads.items():
            g = torch.where(keep, g, (g / g_norm) * self.max_norm)
            mu = (1.0 - b1) * g + b1 * state.mu[k]
            nu = (1.0 - b2) * (g * g) + b2 * state.nu[k]
            state.mu[k].copy_(mu)
            state.nu[k].copy_(nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            params[k].add_(update * -self.lr)


def make_optimizer(cfg: Config) -> Optimizer:
    """Adam(lr, eps) + global-norm clip 40 (worker.py:289,364)."""
    return Optimizer(cfg.lr, cfg.adam_eps, cfg.grad_norm)


def create_train_state(cfg: Config, params: Params) -> TrainState:
    """A fresh state: the step at 0, copies of ``params`` (so the state
    never aliases tensors the caller holds) as online and target params,
    zero moments."""
    params = {k: v.detach().clone() for k, v in params.items()}
    return TrainState(
        step=0, params=params,
        target_params={k: v.clone() for k, v in params.items()},
        opt_state=make_optimizer(cfg).init(params))


def _window_indices(cfg: Config, burn_in, learning, forward):
    """Gather indices into the unrolled (B, T, A) Q sequence.

    Sample layout along T is [burn_in | learning | forward] from t=0.

    - online index for learning step i:  burn_in + i
    - target index for learning step i:  min(burn_in + n + i,
                                             burn_in + learning + forward - 1)
      reproducing model.py:102-109 (start at burn_in + max_forward_steps,
      edge-pad when the episode ended inside the forward window).
    """
    L, n = cfg.learning_steps, cfg.forward_steps
    steps = torch.arange(L, device=burn_in.device)[None, :]     # (1, L)
    b = burn_in[:, None].long()
    idx_online = b + steps                                        # (B, L)
    last_valid = (burn_in + learning + forward - 1)[:, None].long()
    idx_target = torch.minimum(b + n + steps, last_valid)
    mask = steps < learning[:, None]                              # (B, L)
    return idx_online, idx_target, mask


def _gather_time(q_seq: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    # q_seq: (B, T, A); idx: (B, L) int64 → (B, L, A)
    return torch.gather(q_seq, 1,
                        idx[:, :, None].expand(-1, -1, q_seq.shape[2]))


def mixed_priorities(abs_td, mask, learning, eta: float = 0.9):
    """Masked per-sequence 0.9·max + 0.1·mean of |TD| (worker.py:268-276)."""
    masked = torch.where(mask, abs_td, torch.zeros_like(abs_td))
    seg_max = masked.max(dim=1).values
    seg_mean = masked.sum(dim=1) / torch.clamp(learning, min=1)
    return eta * seg_max + (1.0 - eta) * seg_mean


def _unroll(net: R2D2Network, params: Params, batch: Batch) -> torch.Tensor:
    q, _ = functional_call(net, params, (batch["obs"], batch["last_action"],
                                         batch["last_reward"],
                                         batch["hidden"]),
                           {"method": "unroll"})
    return q


def _double_unroll(cfg: Config, net: R2D2Network, params: Params,
                   target_params: Params, batch: Batch) -> tuple:
    """(q_online, q_target_seq), each (B, T, A); the target side carries
    no gradient.

    Default: two independent unrolls (reference semantics).  With
    ``cfg.fused_double_unroll``, ONE unroll vmapped over the stacked
    (online, target) parameters: the recurrence walks T steps once at
    double batch instead of twice.  ``net`` must be a scan-recurrence
    network (:func:`_loss_net`)."""
    if not cfg.fused_double_unroll:
        q_online = _unroll(net, params, batch)
        with torch.no_grad():
            q_target_seq = _unroll(net, target_params, batch)
        return q_online, q_target_seq
    stacked = {k: torch.stack([params[k], target_params[k].detach()])
               for k in params}
    q_both = vmap(lambda p: _unroll(net, p, batch))(stacked)
    return q_both[0], q_both[1].detach()


def _loss_net(net: R2D2Network) -> R2D2Network:
    """The network the LOSS unrolls: the scan recurrence, always.  The
    fused inference kernel has no backward (ops/lstm.py); every impl
    declares the same parameters, so a copy with the scan engine runs the
    same params by the same names."""
    if all(layer.impl == "scan" for layer in net.lstm_layers):
        return net
    twin = copy.deepcopy(net)
    for layer in twin.lstm_layers:
        layer.impl = "scan"
    return twin


def loss_and_priorities(cfg: Config, net: R2D2Network, params: Params,
                        target_params: Params, batch: Batch
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, per-sequence priorities) for one batch; the loss carries the
    gradient to ``params``, the priorities none."""
    q_online, q_target_seq = _double_unroll(cfg, net, params, target_params,
                                            batch)
    idx_online, idx_target, mask = _window_indices(
        cfg, batch["burn_in"], batch["learning"], batch["forward"])

    # online Q(s_t, a_t) over the learning window — the grad path
    q_learn = _gather_time(q_online, idx_online)                  # (B, L, A)
    q_taken = torch.gather(q_learn, 2,
                           batch["action"][:, :, None].long())[:, :, 0]

    # double-Q: online argmax at t+n (first maximum, as jnp.argmax), the
    # target evaluates (worker.py:345-347)
    q_online_tn = _gather_time(q_online, idx_target).detach()
    a_star = q_online_tn.argmax(dim=-1)                           # (B, L)
    q_boot = torch.gather(_gather_time(q_target_seq, idx_target), 2,
                          a_star[:, :, None])[:, :, 0]             # (B, L)

    # rescaled n-step target (worker.py:349)
    target = value_rescale(batch["n_step_reward"] + batch["n_step_gamma"]
                           * inverse_value_rescale(q_boot))

    td = target - q_taken
    weighted_sq = batch["is_weights"][:, None] * torch.square(td)
    valid = mask.sum()
    loss = torch.where(mask, weighted_sq, torch.zeros_like(weighted_sq)
                       ).sum() / torch.clamp(valid, min=1)
    priorities = mixed_priorities(td.detach().abs(), mask, batch["learning"])
    return loss, priorities


def make_train_step(cfg: Config, net: R2D2Network):
    """Returns ``train_step(state, batch) -> (state, loss, priorities)``:
    loss and gradient through the scan network, the clip + Adam step in
    place, the step counter, and the hard target sync when
    ``step % target_net_update_interval == 0``.  ``loss`` (a 0-d tensor)
    and ``priorities`` (B,) stay on the device; nothing waits for it."""
    opt = make_optimizer(cfg)
    net = _loss_net(net)  # grad paths always run the scan recurrence

    def train_step(state: TrainState, batch: Batch):
        names = list(state.params)
        params = {k: state.params[k].detach().requires_grad_(True)
                  for k in names}
        loss, priorities = loss_and_priorities(cfg, net, params,
                                               state.target_params, batch)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        opt.update(dict(zip(names, grads)), state.opt_state, state.params)
        state.step += 1
        if state.step % cfg.target_net_update_interval == 0:
            with torch.no_grad():
                for k in names:
                    state.target_params[k].copy_(state.params[k])
        return state, loss.detach(), priorities

    return train_step


class SuperStep:
    """``k`` train steps on ``k`` batches gathered from the device ring —
    the port of ``make_super_step_fn``.  One small H2D (the (k, B, 6) index
    bundle and its weights) and one small D2H (losses and priorities, in
    the learner) serve k optimizer steps, and batch bytes never cross PCIe.
    The inner step is exactly :func:`make_train_step`'s: the step counter
    and the target sync advance per inner step, so a super-step equals k
    plain steps.

    Callable as ``super_step(state, arrays, ints (k,B,6), is_weights (k,B))
    -> (state, losses (k,), priorities (k,B))``.  The learner calls the two
    halves apart: :meth:`gather` enqueues the k gathers under the buffer
    lock (ordering them before any later ring write), :meth:`run` the k
    steps after the lock is released."""

    def __init__(self, cfg: Config, net: R2D2Network, k: int):
        self.cfg, self.k = cfg, k
        self._step = make_train_step(cfg, net)

    def gather(self, arrays, ints: torch.Tensor,
               is_weights: torch.Tensor) -> List[Batch]:
        return [gather_batch(self.cfg, arrays, ints[j], is_weights[j])
                for j in range(self.k)]

    def run(self, state: TrainState, batches: List[Batch]):
        losses, priorities = [], []
        for batch in batches:
            state, loss, p = self._step(state, batch)
            losses.append(loss)
            priorities.append(p)
        return state, torch.stack(losses), torch.stack(priorities)

    def __call__(self, state: TrainState, arrays, ints: torch.Tensor,
                 is_weights: torch.Tensor):
        return self.run(state, self.gather(arrays, ints, is_weights))


def make_super_step_fn(cfg: Config, net: R2D2Network, k: int) -> SuperStep:
    """The host-sampled super-step (see :class:`SuperStep`), by the JAX
    package's name."""
    return SuperStep(cfg, net, k)


def _compensated_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Prefix sums of ``x`` (f32) at f64 accuracy, rounded to f32.

    The host SumTree accumulates in float64 (replay/sum_tree.py); a plain
    f32 cumsum over the ~50 000 leaves of the flagship ring drifts by
    O(n·eps) and shifts stratum boundaries against the host tree's.  JAX
    carries the rounding error in a second f32 lane (a double-float scan)
    because TPUs lack f64; CUDA cards and CPUs have it, so the port sums
    in f64 and rounds once."""
    return torch.cumsum(x.double(), 0).float()


def _in_graph_sample_raw(cfg: Config, u: torch.Tensor, prios: torch.Tensor,
                         seq_meta: torch.Tensor, first_burn: torch.Tensor):
    """``n = len(u)`` stratified proportional draws from the leaves, one
    per uniform in ``u`` (n,) f32: (idx (n,) i64, q (n,) f32 inclusion
    densities prio/mass, ints (n, 6) i32).  JAX's f32 order of operations
    for the targets, ``searchsorted(side="right")``, the snap of a
    zero-leaf hit to the first maximum and ``q``; the host twin is
    ``SumTree.sample`` (same scheme, f64 descent)."""
    K, L = cfg.seqs_per_block, cfg.learning_steps
    n = u.shape[0]
    cum = _compensated_cumsum(prios)
    total = cum[-1]
    targets = (torch.arange(n, dtype=torch.float32, device=u.device) + u) * (
        total / n)
    idx = torch.searchsorted(cum, targets, right=True)
    idx = torch.clamp(idx, max=prios.shape[0] - 1)
    idx = torch.where(prios[idx] > 0, idx, torch.argmax(prios))
    block_idx = idx // K
    seq_idx = idx % K
    meta = seq_meta[block_idx, seq_idx]                         # (n, 3)
    burn = meta[:, 0]
    start = first_burn[block_idx] + (seq_idx * L).int()
    ints = torch.stack([block_idx.int(), start - burn, seq_idx.int(), burn,
                        meta[:, 1], meta[:, 2]], dim=1)
    # an all-zero leaf vector (violates the ready gate) must not give NaN
    # densities: clamp to 1.0; the gathered rows are zero padding whose
    # loss the window masks bound anyway
    q = torch.where(total > 0, prios[idx] / total, torch.ones_like(total))
    return idx, q, ints


def _in_graph_sample(cfg: Config, u: torch.Tensor, prios: torch.Tensor,
                     seq_meta: torch.Tensor, first_burn: torch.Tensor):
    """One prioritized batch draw on the device: (idx (B,), is_weights (B,)
    f32, ints (B, 6) i32).  Stratified proportional sampling — the host
    sum tree's joint scheme — as cumsum + searchsorted; zero leaves (empty
    slots, block padding) are zero-width bins, unreachable with
    ``right=True``.  IS weights are the reference's (p / min p)^-beta."""
    idx, q, ints = _in_graph_sample_raw(cfg, u, prios, seq_meta, first_burn)
    w = (q / q.min()) ** (-cfg.importance_sampling_exponent)
    return idx, w.float(), ints


def scatter_last(leaves: torch.Tensor, idx: torch.Tensor,
                 vals: torch.Tensor) -> None:
    """``leaves[idx] = vals`` in place, where an index drawn more than once
    takes the value of its last occurrence.  Every write to one leaf then
    carries the same value, so the result does not depend on which of the
    card's threads lands last: the scatter is deterministic, and equal to
    the sequential (CPU) order."""
    same = idx[:, None] == idx[None, :]
    pos = torch.arange(idx.shape[0], device=idx.device)
    last = torch.where(same, pos[None, :], -1).amax(dim=1)
    leaves[idx] = vals[last]


def make_in_graph_per_super_step_fn(cfg: Config, net: R2D2Network, k: int):
    """``k`` steps with device-side PER: sample → gather → step → priority
    scatter, k times, with no host round trip.  Step j+1 samples from the
    priorities step j scattered.

    Signature: ``super_step(state, arrays, prios (NB*K,) f32, seq_meta
    (NB,K,3) i32, first_burn (NB,) i32, generator=None, uniforms=None) ->
    (state, prios, losses (k,))``.  ``prios`` is updated in place
    (``prios[idx] = new_p ** prio_exponent``; at a duplicated index the
    last write wins, :func:`scatter_last` — JAX's ``.at[idx].set`` leaves
    it unspecified).  The
    uniforms are ``uniforms`` (k, B) when given — the tests feed JAX's own
    draws — else drawn from ``generator`` on ``prios``' device.  The caller
    holds the buffer lock for the whole call, so no actor commit lands
    between a step's draw and its scatter."""
    step = make_train_step(cfg, net)
    B = cfg.batch_size

    def super_step(state: TrainState, arrays, prios: torch.Tensor,
                   seq_meta: torch.Tensor, first_burn: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   uniforms: Optional[torch.Tensor] = None):
        if uniforms is None:
            uniforms = torch.rand((k, B), generator=generator,
                                  device=prios.device)
        losses = []
        for j in range(k):
            idx, w, ints = _in_graph_sample(cfg, uniforms[j], prios,
                                            seq_meta, first_burn)
            batch = gather_batch(cfg, arrays, ints, w)
            state, loss, new_p = step(state, batch)
            # feedback: the exponent the host tree applies (sum_tree.py)
            scatter_last(prios, idx, new_p ** cfg.prio_exponent)
            losses.append(loss)
        return state, prios, torch.stack(losses)

    return super_step
