"""The R2D2 train step, and the k-fused super-steps over the device ring.

Port of ``r2d2_tpu/learner/step.py``, with the learnhealth diagnostic
vector (telemetry/learnhealth.py).  Capability-parity with the reference
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
square root, ``eps_root = 0`` and bias correction on both moments,
computed in float32 on the device from its int32 count and cast to each
moment's dtype, as optax computes it.  The
moments keep the params' dtype (optax's ``mu_dtype=None``), and every
Python scalar meets a tensor rounded to that dtype first, as JAX's weak
types are, so bf16 params (``cfg.param_dtype``) round where optax's do
(float32 is unchanged: torch casts a scalar to the op's float32).  The
step updates the state's tensors in place; a caller that hands parameters
to another thread publishes a copy (``learner.Learner._publish``).

The step counter and Adam's count live on the device (``TrainState.
step_t``, ``AdamState.count_t``, int32 as JAX's), and the hard target sync
is a ``torch.where`` on the device counter, as JAX's ``jnp.where(sync,
...)``: the step reads no host state, so a CUDA graph can replay it
(learner/graphs.py).  ``TrainState.step`` and ``AdamState.count`` are
their host mirrors, advanced with them, for checkpoints, the learner's
cadences and the tests.  A state is built from the mirrors alone (fresh,
restored or converted) and gets its device counters from them when it is
placed (:func:`place_counters`, at the latest at its first step).

With ``learnhealth`` (and ``cfg.learnhealth_interval > 0``) the step also
returns the ``(DIAG_SIZE,)`` diagnostic vector: armed when the new step
count is a multiple of the interval — decided from the host mirror, so
the predicate costs no sync — and zeros otherwise; the ΔQ zero-state
re-unroll runs on armed steps only.

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
from r2d2_tpu_torch.models.network import R2D2Network, unshard
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
    """optax ``ScaleByAdamState``: the step count and both moments.
    ``count`` is the host mirror of the device count ``count_t``."""
    count: int
    mu: Params
    nu: Params
    count_t: Optional[torch.Tensor] = None


@dataclasses.dataclass
class TrainState:
    """``step`` is the host mirror of the device counter ``step_t``."""
    step: int
    params: Params
    target_params: Params
    opt_state: AdamState
    step_t: Optional[torch.Tensor] = None


def place_counters(state: TrainState, device: torch.device) -> TrainState:
    """``state`` with its device counters on ``device``: made from the
    host mirrors where missing, moved where elsewhere."""
    opt = state.opt_state
    if state.step_t is None:
        state.step_t = torch.full((), state.step, dtype=torch.int32,
                                  device=device)
    if opt.count_t is None:
        opt.count_t = torch.full((), opt.count, dtype=torch.int32,
                                 device=device)
    state.step_t = state.step_t.to(device)
    opt.count_t = opt.count_t.to(device)
    return state


class Optimizer:
    """``optax.chain(clip_by_global_norm(max_norm), adam(lr, eps=eps))``
    (worker.py:289,364), in place on the parameter tensors."""

    def __init__(self, lr: float, eps: float, max_norm: float,
                 b1: float = 0.9, b2: float = 0.999):
        self.lr, self.eps, self.max_norm = lr, eps, max_norm
        self.b1, self.b2 = b1, b2
        self._rounded: dict = {}

    def _constants(self, dtype: torch.dtype) -> list:
        """The step-independent scalars, rounded to ``dtype`` once."""
        if dtype not in self._rounded:
            self._rounded[dtype] = [
                _round_to(c, dtype) for c in (
                    self.max_norm, 1.0 - self.b1, self.b1, 1.0 - self.b2,
                    self.b2, self.eps, -self.lr)]
        return self._rounded[dtype]

    def init(self, params: Params) -> AdamState:
        return AdamState(
            count=0, mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()})

    @torch.no_grad()
    def update(self, grads: Params, state: AdamState,
               params: Params, updates: Optional[Params] = None) -> None:
        """Clip ``grads`` by their global norm, advance ``state`` (the
        device count and its host mirror) and apply the Adam step to
        ``params``, all in place.  ``updates``, when given, collects each
        parameter's step (optax's ``updates``: the values added to the
        parameters)."""
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = g_norm < self.max_norm
        state.count += 1
        state.count_t.add_(1)
        # optax's bias_correction: 1 - decay ** count in float32, cast to
        # the moment's dtype
        count = state.count_t.float()
        bias = (1.0 - torch.pow(self.b1, count),
                1.0 - torch.pow(self.b2, count))
        rounded = {}
        for k, g in grads.items():
            if g.dtype not in rounded:
                rounded[g.dtype] = (self._constants(g.dtype)
                                    + [c.to(g.dtype) for c in bias])
            max_norm, c1, b1_, c2, b2_, eps, neg_lr, bc1, bc2 = rounded[
                g.dtype]
            g = torch.where(keep, g, (g / g_norm.to(g.dtype)) * max_norm)
            mu = c1 * g + b1_ * state.mu[k]
            nu = c2 * (g * g) + b2_ * state.nu[k]
            state.mu[k].copy_(mu)
            state.nu[k].copy_(nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            step = update * neg_lr
            params[k].add_(step)
            if updates is not None:
                updates[k] = step


def _round_to(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` (a JAX weak-typed scalar meeting an
    array of that dtype)."""
    return float(torch.tensor(x, dtype=dtype))


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
    # q_seq: (B, T, A); idx: (B, L) int64 → (B, L, A).  A negative index
    # counts from the end, as in jnp.take_along_axis: a row drawn from a
    # zero-priority leaf (a descent's float error) has burn_in = learning
    # = forward = 0, so its last valid target index is -1; the row is
    # masked out of the loss and the priorities (ROADMAP.md C 20)
    idx = torch.where(idx < 0, idx + q_seq.shape[1], idx)
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
                        target_params: Params, batch: Batch,
                        with_aux: bool = False):
    """(loss, per-sequence priorities) for one batch; the loss carries the
    gradient to ``params``, the priorities none.  ``with_aux`` adds the
    forward's intermediates the learnhealth diagnostics read, ``(td, mask,
    q_learn, max_abs_q)``, detached: ``(loss, priorities, aux)``."""
    q_online, q_target_seq = _double_unroll(cfg, net, params, target_params,
                                            batch)
    # on the mesh a tp-split head leaves the action dim sharded, and
    # DTensor's gather along a sharded dim cannot serve the two action
    # gathers below: keep only the dp split of the (B, T, A) q
    q_online, q_target_seq = unshard(q_online, -1), unshard(q_target_seq, -1)
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
    if not with_aux:
        return loss, priorities
    aux = (td.detach(), mask, q_learn.detach(), q_online.detach().abs().max())
    return loss, priorities, aux


def make_train_step(cfg: Config, net: R2D2Network,
                    learnhealth: bool = False):
    """Returns ``train_step(state, batch) -> (state, loss, priorities)``:
    loss and gradient through the scan network, the clip + Adam step in
    place, the step counters, and the hard target sync where the device
    counter ``step % target_net_update_interval == 0``.  ``loss`` (a 0-d
    tensor) and ``priorities`` (B,) stay on the device; nothing waits for
    it.  This is the plain step: the CPU, the mesh and the comparisons
    call it, and a card's learner replays it as a CUDA graph
    (learner/graphs.py).

    ``learnhealth`` (with ``cfg.learnhealth_interval > 0``) appends the
    diagnostic vector: ``-> (state, loss, priorities, diag (DIAG_SIZE,)
    f32)``, armed when the NEW step count is a multiple of the interval
    and zeros otherwise (the JAX package's ``lax.cond``).  The predicate
    reads the host step counter; the ΔQ re-unroll, norms and histograms
    run on armed steps only; the re-unroll runs before the in-place
    update, on the pre-update parameters."""
    opt = make_optimizer(cfg)
    net = _loss_net(net)  # grad paths always run the scan recurrence
    lh = learnhealth and cfg.learnhealth_interval > 0
    if lh:
        from r2d2_tpu_torch.telemetry.learnhealth import DIAG_SIZE, make_diag_fn

        diag_fn = make_diag_fn(cfg, net)

    def train_step(state: TrainState, batch: Batch):
        names = list(state.params)
        place_counters(state, state.params[names[0]].device)
        params = {k: state.params[k].detach().requires_grad_(True)
                  for k in names}
        armed = lh and (state.step + 1) % cfg.learnhealth_interval == 0
        out = loss_and_priorities(cfg, net, params, state.target_params,
                                  batch, with_aux=armed)
        loss, priorities = out[0], out[1]
        grads = dict(zip(names, torch.autograd.grad(
            loss, [params[k] for k in names])))
        q_zero = updates = None
        if armed:
            # the ΔQ re-unroll reads the PRE-update params: run it before
            # the in-place update
            q_zero = diag_fn.zero_state_unroll(state.params, batch)
            updates = {}
        opt.update(grads, state.opt_state, state.params, updates)
        state.step += 1
        state.step_t.add_(1)
        sync = (state.step_t % cfg.target_net_update_interval) == 0
        with torch.no_grad():
            for k in names:
                state.target_params[k].copy_(torch.where(
                    sync, state.params[k], state.target_params[k]))
        if not lh:
            return state, loss.detach(), priorities
        if armed:
            with torch.no_grad():
                diag = diag_fn(None, batch, loss.detach(), grads, updates,
                               state.params, state.target_params, out[2],
                               q_zero=q_zero)
        else:
            diag = torch.zeros(DIAG_SIZE, dtype=torch.float32,
                               device=loss.device)
        return state, loss.detach(), priorities, diag

    return train_step


class SuperStep:
    """``k`` train steps on ``k`` batches gathered on the device from the
    replay ring — the port of ``make_super_step_fn``, the retrace guard's
    ``learner.super_step``.  One small H2D (the (k, B, 6) index bundle and
    its weights) and one small D2H (losses and priorities, in the learner)
    serve k optimizer steps, and batch bytes never cross PCIe.  The inner
    step is exactly :func:`make_train_step`'s: the step counter and the
    target sync advance per inner step, so a super-step equals k plain
    steps.

    Callable as ``super_step(state, arrays, ints (k,B,6), is_weights (k,B))
    -> (state, losses (k,), priorities (k,B))``, plus ``diags (k,
    DIAG_SIZE)`` — each inner step's diagnostic vector, zeros off cadence
    — under ``learnhealth``.  On a card each inner step (its gather and
    its train step) is a replay of a CUDA graph (learner/graphs.py) that
    reads the ring at its fixed address, with the step's index row and
    weights copied in: issued under the buffer lock, the gathers stay
    ordered before any later ring write.  ``train_step`` replaces the
    plain step (the meshed learner passes ``sharding.mesh_step``, built
    with the same ``learnhealth``): each inner step's graph then holds
    the meshed step with its collectives, and the learner calls the two
    halves apart — :meth:`gather` enqueues the k gathers under the buffer
    lock, :meth:`run` replays the k steps on the rows of the group's
    broadcast.  ``guard`` replaces the retrace guard."""

    def __init__(self, cfg: Config, net: R2D2Network, k: int,
                 train_step=None, learnhealth: bool = False, guard=None):
        from r2d2_tpu_torch.learner.graphs import StepGraphs

        self.cfg, self.k = cfg, k
        self.lh = learnhealth and cfg.learnhealth_interval > 0
        self._step = train_step or make_train_step(cfg, net,
                                                   learnhealth=self.lh)
        self.graphs = StepGraphs("learner.super_step", guard=guard)

    def _armed(self, state: TrainState) -> bool:
        return self.lh and (state.step + 1) % self.cfg.learnhealth_interval \
            == 0

    def _gather_step(self, state, arrays, scratch, row):
        batch = gather_batch(self.cfg, arrays, row["ints"], row["w"])
        return self._step(state, batch)[1:]

    def _batch_step(self, state, fixed, scratch, batch):
        return self._step(state, batch)[1:]

    def _stack(self, state: TrainState, outs: list):
        return (state,) + tuple(torch.stack(col) for col in zip(*outs))

    def gather(self, arrays, ints: torch.Tensor,
               is_weights: torch.Tensor) -> List[Batch]:
        return [gather_batch(self.cfg, arrays, ints[j], is_weights[j])
                for j in range(self.k)]

    def run(self, state: TrainState, batches: List[Batch]):
        return self._stack(state, [
            self.graphs.run(self._batch_step, state, inputs=batch,
                            armed=self._armed(state)) for batch in batches])

    def __call__(self, state: TrainState, arrays, ints: torch.Tensor,
                 is_weights: torch.Tensor):
        return self._stack(state, [
            self.graphs.run(self._gather_step, state, arrays,
                            inputs=dict(ints=ints[j], w=is_weights[j]),
                            armed=self._armed(state))
            for j in range(self.k)])


def make_super_step_fn(cfg: Config, net: R2D2Network, k: int,
                       learnhealth: bool = False, guard=None) -> SuperStep:
    """The host-sampled super-step (see :class:`SuperStep`), by the JAX
    package's name."""
    return SuperStep(cfg, net, k, learnhealth=learnhealth, guard=guard)


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


def make_in_graph_per_super_step_fn(cfg: Config, net: R2D2Network, k: int,
                                    train_step=None, cross=None,
                                    learnhealth: bool = False, guard=None):
    """``k`` steps with device-side PER: sample → gather → step → priority
    scatter, k times, with no host round trip.  Step j+1 samples from the
    priorities step j scattered.  The retrace guard's (``guard``'s)
    ``learner.in_graph_per_super_step``.

    Signature: ``super_step(state, arrays, prios (NB*K,) f32, seq_meta
    (NB,K,3) i32, first_burn (NB,) i32, generator=None, uniforms=None) ->
    (state, prios, losses (k,))``.  ``prios`` is updated in place
    (``prios[idx] = new_p ** prio_exponent``; at a duplicated index the
    last write wins, :func:`scatter_last` — JAX's ``.at[idx].set`` leaves
    it unspecified).  The
    uniforms are ``uniforms`` (k, B) when given — the tests feed JAX's own
    draws — else drawn from ``generator`` on ``prios``' device, before the
    k steps.  On a card each inner step is a replay of a CUDA graph
    (learner/graphs.py) that reads the ring, the leaves and the metadata
    at their fixed addresses, with its row of uniforms copied in.  The
    caller holds the buffer lock for the whole call, so no actor commit
    lands between a step's draw and its scatter.  ``train_step`` replaces
    the plain step (the meshed learner's ``sharding.mesh_step``, which
    returns plain priorities).

    ``cross`` (a :class:`~r2d2_tpu_torch.parallel.cross_rank.CrossRank`)
    is the meshed hook: the ring, ``prios``, ``seq_meta`` and
    ``first_burn`` are then this rank's slab, the draw runs over every
    rank's leaves (``seq_meta`` and ``first`` gathered once per call,
    outside the graphs, into buffers that keep their addresses; the
    leaves once per inner step), each rank trains its rows of the global
    batch, exchanged from their owners, and the feedback goes back to the
    slabs that own the leaves.  On a card an inner step's graph holds its
    draw, row exchange, train step and feedback with their collectives,
    and on a dp group's leader the broadcast of its rows to the group.
    On a peer of a dp group that spans ranks ``cross`` is a
    :class:`~r2d2_tpu_torch.parallel.cross_rank.GroupPeer`, the ring
    arguments are None and no uniforms are drawn: each inner step's rows
    come from the group's leader, received inside the peer's graph.
    ``record`` (a list), when given, collects each inner step's global
    sampled indices.

    ``learnhealth`` (with ``cfg.learnhealth_interval > 0``) appends each
    inner step's diagnostic vector: ``-> (state, prios, losses, diags (k,
    DIAG_SIZE))``; a ``train_step`` given with it must return the vector
    too."""
    from r2d2_tpu_torch.learner.graphs import StepGraphs

    lh = learnhealth and cfg.learnhealth_interval > 0
    step = train_step or make_train_step(cfg, net, learnhealth=lh)
    B = cfg.batch_size
    graphs = StepGraphs("learner.in_graph_per_super_step", guard=guard)

    def inner(state, fixed, scratch, row):
        arrays, seq_meta, first_burn, meta = fixed
        prios, u = scratch[0], row.get("u")
        if cross is None:
            idx, w, ints = _in_graph_sample(cfg, u, prios, seq_meta,
                                            first_burn)
            batch = gather_batch(cfg, arrays, ints, w)
        else:
            d, batch = cross.sample_batch(u, prios, meta, arrays)
            idx = d.idx
        out = step(state, batch)
        # feedback: the exponent the host tree applies (sum_tree.py)
        if cross is None:
            scatter_last(prios, idx, out[2] ** cfg.prio_exponent)
        else:
            cross.scatter_feedback(prios, idx, out[2] ** cfg.prio_exponent)
        return (out[1], idx) + ((out[3],) if lh else ())

    def super_step(state: TrainState, arrays, prios: torch.Tensor,
                   seq_meta: torch.Tensor, first_burn: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   uniforms: Optional[torch.Tensor] = None,
                   record: Optional[list] = None):
        if uniforms is None and prios is not None:
            uniforms = torch.rand((k, B), generator=generator,
                                  device=prios.device)
        meta = None if cross is None else cross.global_meta(seq_meta,
                                                            first_burn)
        fixed = (arrays, seq_meta, first_burn, meta)
        losses, diags = [], []
        for j in range(k):
            armed = lh and (state.step + 1) % cfg.learnhealth_interval == 0
            out = graphs.run(inner, state, fixed, (prios,), {} if uniforms
                             is None else dict(u=uniforms[j]), armed)
            losses.append(out[0])
            if lh:
                diags.append(out[2])
            if record is not None:
                record.append(out[1])
        if lh:
            return state, prios, torch.stack(losses), torch.stack(diags)
        return state, prios, torch.stack(losses)

    super_step.graphs = graphs
    return super_step
