"""Anakin: the fused on-device training loop (``actor_transport="anakin"``).

Port of ``r2d2_tpu/learner/anakin.py``, on one device or on the learner
mesh (``AnakinPlane(table=...)``).  When the environment is itself tensor
ops (``envs/anakin.py``), the actor/replay/learner split collapses: env step →
act → block cut → replay write → train step all run on the device, and
the host only issues the work and reads a few scalars back:

- the env is a batched device env (``cfg.anakin_env`` →
  :func:`~r2d2_tpu_torch.envs.anakin.make_anakin_env`);
- the actor is the device twin of ``VectorActor``'s hot loop — per-lane
  ladder epsilons, LSTM carry, deferred block-boundary cuts with bootstrap
  Q, episode lifecycle — over a device twin of ``VectorLocalBuffer``,
  acting through the scan recurrence (``_loss_net``), as JAX's does, so
  the anakin path launches no ``lstm_infer`` kernel;
- block cutting reproduces ``replay.block.assemble_block``'s math
  (windows, stored-hidden selection, n-step targets, actor-side initial
  priorities) as masked static-shape tensor ops, and writes finished
  blocks straight into the :class:`~r2d2_tpu_torch.replay.device_ring.
  DeviceRing` arrays and its ``in_graph_per`` leaves and metadata;
- training is the unchanged ``make_train_step`` fed by the unchanged
  in-graph PER sampler (``_in_graph_sample`` + ``gather_batch``).

JAX compiles a dispatch — ``k × (E env/actor steps + 1 train step)``,
E = ``cfg.anakin_env_steps_per_update`` — into one program.  Here Python
issues the same work op by op on one stream, with no host
synchronisation inside a dispatch: no ``.item()``, no tensor truth value,
no ``nonzero`` or boolean-mask indexing.  On a card the meshless plane
replays that work as one CUDA graph per entry and eval branch
(learner/graphs.py: the carry, the ring and the PER state written in
place, at fixed addresses).  What leaves the device per dispatch is one
small float vector (k losses, the :data:`STATS_FIELDS` deltas, then the
:data:`EVAL_FIELDS` pair when the eval lane is on), in one non-blocking
copy into pinned memory, ticked as ``anakin.result_fetch`` on
``HOST_TRANSFERS``; nothing goes up (the dispatch index enters the
kernels as an argument, or a graph as a 0-d tensor filled on the device,
from which the PER uniforms and the eval episodes' root derive there).

Where JAX needs constructs eager torch has not:

- JAX can skip a step's block emit behind ``lax.cond(any(cut))``; here
  that test would be a device→host sync per env step, so every step
  emits, as JAX's ``cut_cond=False`` path does (JAX pins it bit-exact
  against the cond path).
- JAX scatters non-cut lanes to a dropped out-of-bounds slot.  Here every
  lane writes a distinct slot — cut lanes ``(ptr + rank among cut lanes)
  % NB``, the others ``(ptr + n_cut + rank among the rest) % NB``, distinct
  because ``num_blocks >= num_actors`` — and a non-cut lane writes back
  the bytes its slot held.  The ring keeps its shape and layout.
- JAX donates the ring and the carry; here the ring, the PER leaves and
  metadata and the local buffers are written in place, on one stream from
  one thread, so the device runs the writes in issue order.

On the learner mesh (``AnakinPlane(table=..., state_template=...)``;
JAX's ``table=`` entry points, whose GSPMD program moves the data
implicitly) the port issues the moves itself, through
``parallel/cross_rank.py``, the same at every world size:

- each rank steps its share of the lanes, ``[r·N/dp, (r+1)·N/dp)``,
  whose carry rows, streams and ladder epsilons are the global lanes', so
  a dp = 2 trajectory is dp = 1's bit for bit; its ring is its slab of
  ``num_blocks / dp`` slots;
- an emit all-gathers the cut vector and the new learning totals, so
  every rank computes the meshless slots for all N lanes (and keeps
  ``ptr``, ``fill``, ``block_learning_total`` and the deltas replicated),
  then one all_to_all moves the cut lanes' packed blocks to the ranks
  that own their slots;
- each inner step's draw is global over every slab (``CrossRank.
  sample_batch``), each rank trains its rows with the meshed step and
  writes back the leaves it owns; the lanes' episode and reward deltas
  are summed over the ranks once a dispatch, so every rank's result
  vector is the global one and still one fetch a dispatch;
- when the lanes do not divide over dp, or outnumber one slab's blocks,
  the lane axis is replicated instead, as JAX's falls back to
  replication: every rank steps every lane with its global stream and
  epsilon, computes the meshless slots with no collective, and writes the
  cut blocks whose slots its slab holds (:func:`_make_owned_emit`); the
  trajectory is the same;
- the actor steps read plain local views of the replicated params
  (:func:`acting_params`); the eval lane runs whole on every rank;
- when a dp group spans ranks (fsdp or tp across ranks), every rank of
  the group steps the group's lanes from their global streams and holds
  a replica of the group's slab, as JAX replicates the ring over tp: each
  (fsdp, tp) position runs the draw, the routing and the feedback over
  its own dp axis of the mesh, identically, and nothing is broadcast.
  The params the lanes act on are gathered whole (a collective) at the
  start of a dispatch and again after each train step, where a dp-only
  mesh reads them in place;
- the snapshot is layout-free: ``write_state`` gathers every split entry
  and rank 0 writes the global arrays; ``read_state`` keeps this rank's
  rows, so a dp = 2 snapshot resumes at dp = 1 and the other way round.

Numerics against the host block cutter and JAX (tests/test_torch_
anakin.py): integer fields, observation bytes, gamma tails (host f32
power tables) and stored hiddens bit-exact; n-step returns and priorities
to f32 round-off (the host sums in float64; the n-step sum keeps JAX's
static order).  Unlike the host ring writer, slots keep whatever bytes
the lane's stream buffer held past the used window instead of zeros: the
sampling clamp invariant already keeps those positions loss-masked.
"""
from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.func import functional_call

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.envs.anakin import (
    advance,
    derive,
    lane_keys,
    make_anakin_env,
    mix32,
    randint,
    stream_bits,
    uniform,
)
from r2d2_tpu_torch.learner.learner import _Result
from r2d2_tpu_torch.learner.step import (
    TrainState,
    _in_graph_sample,
    _loss_net,
    make_train_step,
    scatter_last,
)
from r2d2_tpu_torch.models.network import R2D2Network
from r2d2_tpu_torch.replay.device_ring import gather_batch
from r2d2_tpu_torch.utils.math import epsilon_ladder
from r2d2_tpu_torch.utils.resilience import Deadline
from r2d2_tpu_torch.telemetry.learnhealth import DIAG_SIZE, diag_enabled
from r2d2_tpu_torch.utils.trace import (
    HOST_TRANSFERS,
    RETRACES,
    TRANSFER_GUARD,
    Tracer,
)

log = logging.getLogger(__name__)

# host-facing stats appended to the losses in the per-dispatch result
# vector, in this order (all float32; the deltas are per-dispatch)
STATS_FIELDS = ("env_steps", "fill", "episodes", "reward_sum", "blocks")

# the greedy eval lane's fields, appended after STATS_FIELDS when
# cfg.anakin_eval_interval > 0 (zeros on off-cadence dispatches)
EVAL_FIELDS = ("eval_episodes", "eval_return_sum")

# the most bytes a rank contributes to one all_gather of a meshed
# snapshot (AnakinPlane._gather_host)
_SNAPSHOT_CHUNK = 256 << 20

# stream salts: the plane's env/exploration root, the eval lane's root,
# the PER sampler's uniforms (JAX's fold_in constants where it has them)
_PLANE_SALT, _EVAL_SALT, _SAMPLE_SALT = 0x414B, 0x45564C, 0x504552


def _act(net: R2D2Network, params, obs, last_action, last_reward, hidden):
    with torch.no_grad():
        return functional_call(net, params,
                               (obs, last_action, last_reward, hidden))


def _gamma_tables(cfg: Config):
    """Host-precomputed float32 discount constants, bit-identical to
    ``utils.math.n_step_gamma_tail``'s values: ``tail[e]`` is numpy's
    float32 ``gamma ** e`` (the tail entries), ``interior`` is the python
    ``gamma ** n`` cast to f32 (the interior fill), ``kernel[i]`` is the
    f32-rounded f64 ``gamma ** i`` for the n-step return sum."""
    n, g = cfg.forward_steps, cfg.gamma
    tail = g ** np.arange(0, n + 1, dtype=np.float32)
    interior = np.float32(g ** n)
    kernel = (g ** np.arange(0, n, dtype=np.float64)).astype(np.float32)
    return tail, interior, kernel


def sample_uniforms(seed: int, dispatch_idx, k: int, B: int,
                    device) -> torch.Tensor:
    """(k, B) float32 PER uniforms for one dispatch: a counter-based
    stream of (seed, dispatch index), so a resumed run draws what an
    uninterrupted one would (JAX: ``split(fold_in(PRNGKey(seed),
    dispatch), k)``; the same scheme, not the same bits).  The index is
    a python int, or a 0-d int64 tensor on ``device`` (a graph's input):
    the same bits, derived on the device."""
    root = derive(seed, _SAMPLE_SALT, dispatch_idx)
    pos = torch.arange(k * B, dtype=torch.int64, device=device)
    return uniform(mix32(mix32(pos + 0x9E3779B9) ^ root)).reshape(k, B)


def _make_assemble(cfg: Config, action_dim: int, done: bool, device,
                   n_lanes: Optional[int] = None):
    """Block assembly for every lane at once: the tensor twin of
    ``replay.block.assemble_block`` over the lanes' stream/window buffers,
    every per-sequence quantity computed at the static maximum K and
    masked past ``num_sequences``.

    ``done`` is static: the two call sites are terminal (episode-end cuts)
    or bootstrapped (boundary cuts), like the host actor's two ``finish``
    calls.  ``n_lanes`` (default ``cfg.num_actors``) is the lanes this
    process steps: a rank's share on the mesh."""
    N, A = n_lanes or cfg.num_actors, action_dim
    BL, L, n = cfg.block_length, cfg.learning_steps, cfg.forward_steps
    K, cap = cfg.seqs_per_block, cfg.max_block_steps
    burn_max = cfg.burn_in_steps
    seq_start_mode = cfg.stored_hidden_mode == "seq_start"
    tail, interior, kernel = _gamma_tables(cfg)
    tail_t = torch.from_numpy(tail).to(device)
    interior = float(interior)
    kernel = [float(x) for x in kernel]
    t = torch.arange(BL, dtype=torch.int32, device=device)[None, :]
    q_rows = torch.arange(BL + 1, dtype=torch.int32, device=device)
    seq = torch.arange(K, dtype=torch.int32, device=device)[None, :]
    lidx = torch.arange(L, dtype=torch.int32, device=device)
    lanes = torch.arange(N, device=device)[:, None]
    r_pad = torch.zeros((N, n - 1), dtype=torch.float32, device=device)

    def assemble(bufs: Dict[str, torch.Tensor], prefix, size, last_q):
        s, c = size[:, None], prefix[:, None]                  # (N, 1)
        # the bootstrap Q (zeros for a terminal cut) lands in row ``size``
        # of each lane's window
        boot = 0.0 if done else last_q[:, None, :]
        qv = torch.where((q_rows[None, :] == s)[:, :, None], boot,
                         bufs["qval"])

        tmask = t < s                                          # (N, BL)
        r = torch.where(tmask, bufs["reward"], 0.0)

        # n-step returns: sum_{i<n} gamma^i * r[t+i], JAX's static order
        r_ext = torch.cat([r, r_pad], dim=1) if n > 1 else r
        nstep = torch.zeros_like(r)
        for i in range(n):
            nstep = nstep + kernel[i] * r_ext[:, i:i + BL]

        # bootstrap discount tail (utils.math n_step_gamma_tail, exact:
        # table lookups of the host's own f32 values)
        steps_left = s - t                       # >= 1 wherever tmask
        if done:
            gtail = torch.where(steps_left > n, interior, 0.0)
        else:
            e = torch.clamp(steps_left, 0, n).long()
            gtail = torch.where(steps_left > n, interior, tail_t[e])
        gtail = torch.where(tmask, gtail, 0.0)

        # per-sequence windows (worker.py:471-474 invariants)
        num_seq = (s + L - 1) // L
        valid = seq < num_seq                                  # (N, K)
        zero = torch.zeros_like(seq)
        burn = torch.where(valid, torch.clamp(seq * L + c, max=burn_max),
                           zero)
        learn = torch.where(valid, torch.clamp(s - seq * L, max=L), zero)
        fwd = torch.where(valid, torch.clamp(
            s + 1 - torch.cumsum(learn, dim=1, dtype=torch.int32), max=n),
            zero)

        # stored recurrent state at each sequence's burn-in start (or the
        # reference's seq-start indexing under the compat switch)
        hidx = (seq * L).expand(N, K) if seq_start_mode \
            else c + seq * L - burn
        hidx = torch.clamp(hidx, 0, cap - 1).long()
        hiddens = torch.where(valid[:, :, None, None, None],
                              bufs["hidden"][lanes, hidx], 0.0)

        # actor-side initial priorities (block.py: plain max-Q n-step TD,
        # replicating the reference's asymmetry vs the learner)
        qmax = qv.max(dim=2).values                            # (N, BL+1)
        mf = torch.clamp(s, max=n)
        maxq_t = torch.gather(qmax, 1, torch.minimum(t + mf, s).long())
        q_taken = torch.gather(qv[:, :BL], 2,
                               bufs["action"].long()[:, :, None])[:, :, 0]
        td = torch.abs(nstep + gtail * maxq_t - q_taken)
        td = torch.where(tmask, td, 0.0).reshape(N, K, L)
        lmask = lidx[None, None, :] < learn[:, :, None]
        td = torch.where(lmask, td, 0.0)
        seg_max = td.max(dim=2).values
        seg_mean = td.sum(dim=2) / torch.clamp(learn, min=1)
        prios = torch.where(valid, 0.9 * seg_max + 0.1 * seg_mean, 0.0)

        return dict(
            slot=dict(obs=bufs["obs"], last_action=bufs["last_action"],
                      last_reward=bufs["last_reward"],
                      action=bufs["action"], n_step_reward=nstep,
                      n_step_gamma=gtail, hidden=hiddens),
            priorities=prios,
            meta=torch.stack([burn, learn, fwd], dim=2),
            first_burn=burn[:, 0],
            learning_total=learn.sum(dim=1, dtype=torch.int32),
        )

    return assemble


def _make_emit(cfg: Config, action_dim: int, done: bool, device,
               n_lanes: Optional[int] = None, cross: Any = None,
               replicated: bool = False):
    """Batched cut-and-write: assemble every lane's candidate block, then
    write the ``cut`` lanes' blocks into ring slots ``ptr..`` (cut lanes
    take consecutive slots in lane order, the order the host actor's
    per-lane sink calls would land) and every other lane's slot back with
    the bytes it held (module docstring).  Updates the ring arrays, the
    PER leaves, ``seq_meta``, ``first`` and ``block_learning_total`` in
    place; returns the carry with ``ptr``, ``fill`` and the deltas
    advanced.

    ``cross`` (a :class:`~r2d2_tpu_torch.parallel.cross_rank.CrossRank`)
    is the mesh's routing: this rank assembles its ``n_lanes`` lanes'
    blocks, and the slots are global FIFO slots of which this rank's ring
    holds its slab — see :func:`_make_routed_emit`; with ``replicated``
    every rank steps every lane and nothing is routed — see
    :func:`_make_owned_emit`."""
    if cross is not None and replicated:
        return _make_owned_emit(cfg, action_dim, done, device, cross)
    if cross is not None:
        return _make_routed_emit(cfg, action_dim, done, device, n_lanes,
                                 cross)
    NB, K, N = cfg.num_blocks, cfg.seqs_per_block, cfg.num_actors
    alpha = cfg.prio_exponent
    assemble = _make_assemble(cfg, action_dim, done, device)
    kk = torch.arange(K, device=device)[None, :]

    def emit(ast, arrays, prios, seq_meta, first, cut, last_q):
        blocks = assemble(_lane_bufs(ast), ast["prefix"], ast["size"],
                          last_q)

        slot, n_cut = _slots(cut, ast["ptr"], NB)
        for key, dst in arrays.items():
            _put(dst, slot, cut, blocks["slot"][key])
        leaf = (slot[:, None] * K + kk).reshape(-1)
        _put(prios, leaf, cut[:, None].expand(N, K).reshape(-1),
             (blocks["priorities"] ** alpha).reshape(-1))
        _put(seq_meta, slot, cut, blocks["meta"])
        _put(first, slot, cut, blocks["first_burn"])
        return _account(ast, slot, cut, n_cut, blocks["learning_total"], NB)

    return emit


def _slots(cut: torch.Tensor, ptr: torch.Tensor, NB: int):
    """Every lane's ring slot for one emit, and the cut count: cut lanes
    ``(ptr + rank among cut lanes) % NB``, the others ``(ptr + n_cut +
    rank among the rest) % NB`` — N distinct slots."""
    cut_i = cut.int()
    rest_i = 1 - cut_i
    n_cut = cut_i.sum(dtype=torch.int32)
    rank_cut = torch.cumsum(cut_i, 0, dtype=torch.int32) - cut_i
    rank_rest = torch.cumsum(rest_i, 0, dtype=torch.int32) - rest_i
    slot = torch.where(cut, (ptr + rank_cut) % NB,
                       (ptr + n_cut + rank_rest) % NB).long()
    return slot, n_cut


def _put(dst: torch.Tensor, slot: torch.Tensor, cut: torch.Tensor,
         new: torch.Tensor) -> torch.Tensor:
    """``dst[slot] = where(cut, new, dst[slot])`` for distinct ``slot``
    entries; returns the old rows."""
    old = dst.index_select(0, slot)
    m = cut.reshape((-1,) + (1,) * (new.dim() - 1))
    dst.index_copy_(0, slot, torch.where(m, new.to(dst.dtype), old))
    return old


def _lane_bufs(ast: dict) -> Dict[str, torch.Tensor]:
    return dict(obs=ast["buf_obs"], last_action=ast["buf_last_action"],
                last_reward=ast["buf_last_reward"],
                hidden=ast["buf_hidden"], action=ast["buf_action"],
                reward=ast["buf_reward"], qval=ast["buf_qval"])


def _account(ast: dict, slot, cut, n_cut, new_tot, NB: int) -> dict:
    """The emit's ring accounting, as ``ReplayBuffer.add``: the cut
    lanes' learning totals into ``block_learning_total`` at their slots
    (subtracting the overwritten ones from the fill), the pointer and the
    per-dispatch deltas advanced."""
    old_tot = _put(ast["block_learning_total"], slot, cut, new_tot)
    new_tot = torch.where(cut, new_tot, 0)
    old_tot = torch.where(cut, old_tot, 0)
    return {**ast,
            "ptr": (ast["ptr"] + n_cut) % NB,
            "fill": ast["fill"] + (new_tot - old_tot).sum(
                dtype=torch.int32),
            "env_steps_d": ast["env_steps_d"]
            + new_tot.sum(dtype=torch.int32),
            "blocks_d": ast["blocks_d"] + n_cut}


def _make_routed_emit(cfg: Config, action_dim: int, done: bool, device,
                      n_lanes: int, cross: Any):
    """The emit on the mesh.  This rank assembles its lanes' candidate
    blocks; one all_gather gives every rank every lane's cut flag and new
    learning total, so every rank computes the meshless emit's slots for
    all N lanes; one all_to_all moves the cut lanes' packed blocks to the
    ranks whose slabs hold their slots.  Each rank writes the rows, PER
    leaves, ``seq_meta`` and ``first`` of the slots it owns; the N slots
    are the window ``[ptr, ptr + N)`` of the ring, so with ``N <= NB_r``
    they fall on N distinct rows of every slab (``slot % NB_r``), and a
    row this rank does not own writes back the bytes it held.  ``ptr``,
    ``fill``, ``block_learning_total`` and the deltas stay replicated:
    every rank computes them alike from the gathered vectors."""
    NB, K, N = cfg.num_blocks, cfg.seqs_per_block, cfg.num_actors
    nb = cross.nb
    alpha = cfg.prio_exponent
    assemble = _make_assemble(cfg, action_dim, done, device, n_lanes)
    kk = torch.arange(K, device=device)[None, :]
    layout = None

    def emit(ast, arrays, prios, seq_meta, first, cut, last_q):
        nonlocal layout
        blocks = assemble(_lane_bufs(ast), ast["prefix"], ast["size"],
                          last_q)
        cut_g, tot_g = cross.gather_cuts(cut, blocks["learning_total"])
        slot, n_cut = _slots(cut_g, ast["ptr"], NB)

        fields = dict(blocks["slot"])
        fields.update(
            prios=blocks["priorities"] ** alpha, meta=blocks["meta"],
            first=blocks["first_burn"])
        dtypes = dict({k: v.dtype for k, v in arrays.items()},
                      prios=prios.dtype, meta=seq_meta.dtype,
                      first=first.dtype)
        if layout is None:
            layout = _pack_layout({k: (tuple(v.shape[1:]), dtypes[k])
                                   for k, v in fields.items()})
        new = _unpack(cross.route_blocks(
            _pack({k: v.to(dtypes[k]) for k, v in fields.items()}, layout),
            slot, cut_g), layout)

        local = slot % nb
        write = cut_g & (slot // nb == cross.rank)
        for key, dst in arrays.items():
            _put(dst, local, write, new[key])
        leaf = (local[:, None] * K + kk).reshape(-1)
        _put(prios, leaf, write[:, None].expand(N, K).reshape(-1),
             new["prios"].reshape(-1))
        _put(seq_meta, local, write, new["meta"])
        _put(first, local, write, new["first"])
        return _account(ast, slot, cut_g, n_cut, tot_g, NB)

    return emit


def _make_owned_emit(cfg: Config, action_dim: int, done: bool, device,
                     cross: Any):
    """The emit on the mesh with replicated lanes (the plane's fallback
    when the lanes do not divide over dp, or outnumber one slab's blocks):
    every rank has stepped every lane, so every rank assembles every
    lane's block and computes the meshless slots, with no collective, and
    writes the cut blocks whose slots its slab holds.  With N above a
    slab's ``nb`` blocks, several lanes' slots can fall on one slab row
    (``slot % nb``), and an ``index_copy_`` with repeated rows keeps any
    one of their writes; so every lane bound for a row writes the same
    bytes: those of the cut lane that owns the row (at most one, the N
    global slots being distinct), else the row's own.  ``ptr``, ``fill``
    and ``block_learning_total`` advance as the meshless emit's."""
    NB, K, N = cfg.num_blocks, cfg.seqs_per_block, cfg.num_actors
    nb = cross.nb
    alpha = cfg.prio_exponent
    assemble = _make_assemble(cfg, action_dim, done, device)
    kk = torch.arange(K, device=device)[None, :]
    lane_ids = torch.arange(N, device=device)
    no_owner = torch.full((nb,), -1, dtype=torch.long, device=device)

    def emit(ast, arrays, prios, seq_meta, first, cut, last_q):
        blocks = assemble(_lane_bufs(ast), ast["prefix"], ast["size"],
                          last_q)
        slot, n_cut = _slots(cut, ast["ptr"], NB)
        local = slot % nb
        write = cut & (slot // nb == cross.rank)
        # each slab row's writing lane (-1: none), then every lane's
        owner = no_owner.scatter_reduce(
            0, local, torch.where(write, lane_ids, -1), reduce="amax")[local]
        hit = owner >= 0
        src = owner.clamp(min=0)
        for key, dst in arrays.items():
            _put(dst, local, hit, blocks["slot"][key][src])
        leaf = (local[:, None] * K + kk).reshape(-1)
        _put(prios, leaf, hit[:, None].expand(N, K).reshape(-1),
             (blocks["priorities"][src] ** alpha).reshape(-1))
        _put(seq_meta, local, hit, blocks["meta"][src])
        _put(first, local, hit, blocks["first_burn"][src])
        return _account(ast, slot, cut, n_cut, blocks["learning_total"], NB)

    return emit


def _pack_layout(spec: Dict[str, tuple]) -> List[tuple]:
    """``(name, shape, dtype, byte offset, bytes)`` per field of one
    lane's block, packed back to back in a row of bytes."""
    out, off = [], 0
    for name, (shape, dtype) in spec.items():
        n = int(np.prod(shape, dtype=np.int64)) * torch.empty(
            0, dtype=dtype).element_size()
        out.append((name, shape, dtype, off, n))
        off += n
    return out


def _pack(fields: Dict[str, torch.Tensor], layout) -> torch.Tensor:
    """(lanes, row bytes) uint8: each lane's fields back to back."""
    n = next(iter(fields.values())).shape[0]

    def raw(t: torch.Tensor, nbytes: int) -> torch.Tensor:
        # default strides (a size-1 dim may carry any stride, and a view
        # as bytes needs a unit last stride)
        t = t.reshape(n, -1).clone(memory_format=torch.contiguous_format)
        return t.view(torch.uint8).reshape(n, nbytes)

    return torch.cat([raw(fields[name], nbytes)
                      for name, _, _, _, nbytes in layout], dim=1)


def _unpack(rows: torch.Tensor, layout) -> Dict[str, torch.Tensor]:
    """The fields of :func:`_pack`'s rows, typed and shaped."""
    n = rows.shape[0]
    return {name: rows[:, off:off + nbytes].contiguous().view(dtype)
            .reshape(n, *shape)
            for name, shape, dtype, off, nbytes in layout}


def _retain_prefix(cfg: Config, ast: dict, cut: torch.Tensor,
                   j: torch.Tensor, rows: torch.Tensor) -> dict:
    """Post-boundary-cut retention: keep the trailing ``burn_in + 1``
    stream entries in place as the next block's warm prefix
    (VectorLocalBuffer.finish), as a per-lane index-shift gather applied
    only to cut lanes.  ``j`` is ``arange(max_block_steps)``, ``rows``
    ``arange(N)[:, None]``."""
    N = ast["size"].shape[0]
    entries = ast["prefix"] + ast["size"] + 1
    keep = torch.clamp(entries, max=cfg.burn_in_steps + 1)
    lo = entries - keep
    src = torch.where(j[None, :] < keep[:, None], j[None, :] + lo[:, None],
                      j[None, :]).long()                          # (N, cap)

    def shift(name):
        arr = ast[name]
        return torch.where(cut.reshape((N, 1) + (1,) * (arr.dim() - 2)),
                           arr[rows, src], arr)

    return {**ast,
            "buf_obs": shift("buf_obs"),
            "buf_last_action": shift("buf_last_action"),
            "buf_last_reward": shift("buf_last_reward"),
            "buf_hidden": shift("buf_hidden"),
            "prefix": torch.where(cut, keep - 1, ast["prefix"]),
            "size": torch.where(cut, 0, ast["size"])}


def _make_actor_step(cfg: Config, net: R2D2Network, env: Any,
                     action_dim: int, lanes: Optional[tuple] = None,
                     cross: Any = None, replicated: bool = False):
    """One env/actor step for the whole fleet — the twin of one
    ``VectorActor.run`` iteration, same sub-step order (boundary cuts with
    this step's bootstrap Q first, then act/step/record, then episode-end
    cuts and lane resets).  Returns ``actor_step(params, ast, arrays,
    prios, seq_meta, first, draws=None) -> (ast', trace)``; the ring, PER
    state and ``block_learning_total`` are written in place.

    ``draws`` (the parity tests' hook) replaces the step's random values:
    ``u`` (N,) f32 and ``rand_a`` (N,) for exploration, ``reset`` for
    ``env.reset_lanes``.

    ``lanes`` = ``(lo, hi)`` are the global lanes this process steps
    (default: all); each keeps its global ladder epsilon, and its carry
    rows (streams included) are the global lane's, so a rank's lanes act
    as they would in a world of one.  ``cross`` routes the cut blocks to
    the ranks that own their slots (:func:`_make_routed_emit`), or, with
    ``replicated`` (every rank steps every lane), each rank writes the cut
    blocks its slab owns (:func:`_make_owned_emit`)."""
    lo, hi = lanes or (0, cfg.num_actors)
    N, A, BL = hi - lo, action_dim, cfg.block_length
    device = env.device
    eps = torch.tensor([epsilon_ladder(i, cfg.num_actors, cfg.base_eps,
                                       cfg.eps_alpha)
                        for i in range(lo, hi)], dtype=torch.float32,
                       device=device)
    act_net = _loss_net(net)   # the scan recurrence, as JAX's actor
    emit_boundary = _make_emit(cfg, A, False, device, N, cross, replicated)
    emit_done = _make_emit(cfg, A, True, device, N, cross, replicated)
    env_keys = tuple(env.STATE_KEYS)
    lanes = torch.arange(N, device=device)
    rows = lanes[:, None]
    actions_a = torch.arange(A, device=device)
    j = torch.arange(cfg.max_block_steps, dtype=torch.int32, device=device)
    noop = (actions_a == 0)[None, :].expand(N, A)
    zero_q = torch.zeros((N, A), dtype=torch.float32, device=device)

    def actor_step(params, ast, arrays, prios, seq_meta, first,
                   draws: Optional[dict] = None):
        q, new_hidden = _act(act_net, params, ast["obs"], ast["last_action"],
                             ast["last_reward"], ast["hidden"])

        # 1) deferred block-boundary cuts: this step's Q at the new state
        #    is the bootstrap (worker.py:550-554 semantics, no 2nd forward)
        pend = ast["finish_pending"]
        ast = emit_boundary(ast, arrays, prios, seq_meta, first, pend, q)
        ast = _retain_prefix(cfg, ast, pend, j, rows)

        # 2) ladder-epsilon exploration
        key = ast["act_key"]
        if draws is None:
            u = uniform(stream_bits(key, 0))
            rand_a = randint(stream_bits(key, 1), A)
        else:
            u, rand_a = draws["u"], draws["rand_a"].int()
        actions = torch.where(u < eps, rand_a, q.argmax(dim=1).int())

        # 3) env step (no auto-reset: the post-step obs is recorded first)
        env_state = {k: ast["env_" + k] for k in env_keys}
        env_state, reward, truncated = env.step(env_state, actions)
        obs_step = env.observe(env_state)

        # 4) batched local-buffer add (VectorLocalBuffer.add_batch), in
        #    place on the buffers the retention above made
        one_hot = actions[:, None] == actions_a
        p = (ast["prefix"] + ast["size"] + 1).long()
        s = ast["size"].long()
        ast["buf_obs"][lanes, p] = obs_step
        ast["buf_last_action"][lanes, p] = one_hot
        ast["buf_last_reward"][lanes, p] = reward
        ast["buf_hidden"][lanes, p] = new_hidden
        ast["buf_action"][lanes, s] = actions.to(torch.uint8)
        ast["buf_reward"][lanes, s] = reward
        ast["buf_qval"][lanes, s] = q
        ast = {**ast,
               "obs": obs_step,
               "last_action": one_hot.float(),
               "last_reward": reward,
               "hidden": new_hidden,
               "size": ast["size"] + 1,
               "sum_reward": ast["sum_reward"] + reward,
               "episode_steps": ast["episode_steps"] + 1,
               "act_key": advance(key),
               **{f"env_{k}": env_state[k] for k in env_keys}}

        # 5) episode-end cuts (terminal: zero bootstrap)
        ast = emit_done(ast, arrays, prios, seq_meta, first, truncated,
                        zero_q)

        # 6) episode accounting, env reset, lane reset (VectorActor
        #    ._reset_lane: fresh obs, zero agent state, vbuf.reset_lane)
        tr = truncated
        ast = {**ast,
               "episodes_d": ast["episodes_d"] + tr.sum(dtype=torch.int32),
               "reward_d": ast["reward_d"]
               + torch.where(tr, ast["sum_reward"], 0.0).sum()}
        env_state = env.reset_lanes(
            env_state, tr, None if draws is None else draws.get("reset"))
        obs_reset = env.observe(env_state)
        tr_obs = tr.reshape((N,) + (1,) * (obs_step.dim() - 1))
        tr_h = tr[:, None, None, None]
        obs_next = torch.where(tr_obs, obs_reset, obs_step)
        ast["buf_obs"][:, 0] = torch.where(tr_obs, obs_reset,
                                           ast["buf_obs"][:, 0])
        ast["buf_last_action"][:, 0] = torch.where(
            tr[:, None], noop, ast["buf_last_action"][:, 0])
        ast["buf_last_reward"][:, 0] = torch.where(
            tr, 0.0, ast["buf_last_reward"][:, 0])
        ast["buf_hidden"][:, 0] = torch.where(tr_h, 0.0,
                                              ast["buf_hidden"][:, 0])
        ast = {**ast,
               "obs": obs_next,
               "last_action": torch.where(tr[:, None], 0.0,
                                          ast["last_action"]),
               "last_reward": torch.where(tr, 0.0, ast["last_reward"]),
               "hidden": torch.where(tr_h, 0.0, ast["hidden"]),
               "episode_steps": torch.where(tr, 0, ast["episode_steps"]),
               "sum_reward": torch.where(tr, 0.0, ast["sum_reward"]),
               "prefix": torch.where(tr, 0, ast["prefix"]),
               "size": torch.where(tr, 0, ast["size"]),
               **{f"env_{k}": env_state[k] for k in env_keys}}

        # 7) deferred boundary cut next step (worker.py block-cut rule)
        ast["finish_pending"] = ((ast["size"] == BL) & ~tr
                                 & (ast["episode_steps"]
                                    < cfg.max_episode_steps))

        trace = dict(pending=pend, q=q, hidden=new_hidden, actions=actions,
                     reward=reward, truncated=tr, obs_step=obs_step,
                     obs_next=obs_next)
        return ast, trace

    return actor_step


def _zero_deltas(ast: dict) -> dict:
    """Per-dispatch counters start at zero, so the returned values ARE the
    dispatch's deltas — the host accumulates them in Python ints (no
    device counter can wrap)."""
    dev = ast["fill"].device
    return {**ast,
            "env_steps_d": torch.zeros((), dtype=torch.int32, device=dev),
            "episodes_d": torch.zeros((), dtype=torch.int32, device=dev),
            "reward_d": torch.zeros((), dtype=torch.float32, device=dev),
            "blocks_d": torch.zeros((), dtype=torch.int32, device=dev)}


def _stats_vec(ast: dict) -> torch.Tensor:
    """(5,) float32, ordered as :data:`STATS_FIELDS`."""
    return torch.stack([ast["env_steps_d"].float(), ast["fill"].float(),
                        ast["episodes_d"].float(), ast["reward_d"],
                        ast["blocks_d"].float()])


def _sum_lane_deltas(ast: dict, cross: Any, replicated: bool = False
                     ) -> dict:
    """On the mesh the lanes' deltas (episodes, reward) count this rank's
    lanes: the carry with them summed over the ranks (one all_reduce), so
    every rank's deltas are the global ones, as the ring's (env steps,
    fill, blocks) already are.  Meshless, or with replicated lanes (every
    rank's deltas are already every lane's): ``ast`` as it is."""
    if cross is None or replicated:
        return ast
    both = cross.reduce_sum(torch.stack([ast["episodes_d"].float(),
                                         ast["reward_d"]]))
    return {**ast, "episodes_d": both[0].to(ast["episodes_d"].dtype),
            "reward_d": both[1]}


def make_anakin_state(cfg: Config, action_dim: int, env: Any, root: int,
                      draws: Optional[dict] = None) -> dict:
    """The fused loop's full device-resident carry, on ``env.device``: the
    env state (``env.STATE_KEYS``), the batched agent state, the
    VectorLocalBuffer twin, ring pointer/accounting, and the exploration
    streams (``act_key`` (N, 2) int64, one stream per lane).  ``root``
    (a python int) seeds the env and exploration streams; ``draws`` goes
    to the env's initial reset."""
    N, A, BL = cfg.num_actors, action_dim, cfg.block_length
    cap, dev = cfg.max_block_steps, env.device
    layers, H = cfg.lstm_layers, cfg.hidden_dim

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    env_state = env.init_state(derive(root, 0), draws)
    obs0 = env.observe(env_state)
    buf_obs = zeros(N, cap, *cfg.stored_obs_shape, dtype=torch.uint8)
    buf_obs[:, 0] = obs0
    buf_la = zeros(N, cap, A, dtype=torch.bool)
    buf_la[:, 0, 0] = True                    # noop one-hot at stream start
    ast = dict(
        **{f"env_{k}": env_state[k] for k in env.STATE_KEYS},
        obs=obs0,
        last_action=zeros(N, A),
        last_reward=zeros(N),
        hidden=zeros(N, 2, layers, H),
        buf_obs=buf_obs,
        buf_last_action=buf_la,
        buf_last_reward=zeros(N, cap),
        buf_hidden=zeros(N, cap, 2, layers, H),
        buf_action=zeros(N, BL, dtype=torch.uint8),
        buf_reward=zeros(N, BL),
        buf_qval=zeros(N, BL + 1, A),
        prefix=zeros(N, dtype=torch.int32),
        size=zeros(N, dtype=torch.int32),
        sum_reward=zeros(N),
        episode_steps=zeros(N, dtype=torch.int32),
        finish_pending=zeros(N, dtype=torch.bool),
        act_key=lane_keys(derive(root, 1), N, dev),
        ptr=zeros(dtype=torch.int32),
        block_learning_total=zeros(cfg.num_blocks, dtype=torch.int32),
        fill=zeros(dtype=torch.int32),
    )
    return _zero_deltas(ast)


def _make_eval_lane(cfg: Config, net: R2D2Network, env: Any,
                    action_dim: int):
    """The greedy eval lane: on every ``cfg.anakin_eval_interval``-th
    dispatch, ONE truncation-length episode per lane with epsilon = 0 from
    a fresh env state (its stream derived from the dispatch index, so eval
    episodes are reproducible and never touch the training streams);
    returns ``(2,)`` f32 ``[episodes, return_sum]`` for the dispatch's
    result vector — zeros off cadence.  The cadence test is a host-side
    ``if`` on the python dispatch index (JAX: ``lax.cond``); the episodes'
    root derives from ``index`` (default the same index; a 0-d int64
    tensor in a CUDA graph, so that a replay draws its own dispatch's
    episodes)."""
    N, A = cfg.num_actors, action_dim
    layers, H = cfg.lstm_layers, cfg.hidden_dim
    act_net = _loss_net(net)
    interval, steps = cfg.anakin_eval_interval, cfg.anakin_episode_len
    dev = env.device
    actions_a = torch.arange(A, device=dev)

    def eval_rollout(params, index) -> torch.Tensor:
        est = env.init_state(derive(cfg.seed, _EVAL_SALT, index))
        obs = env.observe(est)
        la = torch.zeros((N, A), dtype=torch.float32, device=dev)
        lr = torch.zeros(N, dtype=torch.float32, device=dev)
        hidden = torch.zeros((N, 2, layers, H), dtype=torch.float32,
                             device=dev)
        ret = torch.zeros(N, dtype=torch.float32, device=dev)
        done = torch.zeros(N, dtype=torch.bool, device=dev)
        for _ in range(steps):
            q, hidden = _act(act_net, params, obs, la, lr, hidden)
            a = q.argmax(dim=1).int()
            est, reward, trunc = env.step(est, a)
            # the truncating step's reward still counts (it ends the
            # episode); anything after a lane's done flag does not
            ret = ret + torch.where(done, 0.0, reward)
            done = done | trunc
            la = (a[:, None] == actions_a).float()
            lr = reward
            obs = env.observe(est)
        return torch.stack([done.sum().float(), ret.sum()])

    def eval_lane(params, dispatch_idx: int, index=None) -> torch.Tensor:
        if dispatch_idx % interval == 0:
            return eval_rollout(params,
                                dispatch_idx if index is None else index)
        return torch.zeros(2, dtype=torch.float32, device=dev)

    return eval_lane


def make_anakin_super_step(cfg: Config, net: R2D2Network, env: Any,
                           action_dim: int, lanes: Optional[tuple] = None,
                           cross: Any = None, train_step=None,
                           replicated: bool = False):
    """The fused dispatch: ``k × (E env/actor steps + 1 train step)``.
    Signature::

        super_step(train_state, ast, arrays, prios, seq_meta, first,
                   dispatch_idx: int, uniforms=None, draws=None,
                   index=None)
          -> (train_state', ast', arrays, prios, seq_meta, first, flat)

    The ring arrays, ``prios``, ``seq_meta`` and ``first`` are updated in
    place and returned; the train state's tensors too.  ``flat`` is the
    k losses, the :data:`STATS_FIELDS` deltas, then the
    :data:`EVAL_FIELDS` pair when ``cfg.anakin_eval_interval > 0``, then
    the k inner steps' learnhealth diag rows (k × DIAG_SIZE) when
    ``cfg.learnhealth_interval > 0`` — the dispatch's only device→host
    payload.  The PER uniforms are
    :func:`sample_uniforms` of (``cfg.seed``, ``dispatch_idx``) unless
    ``uniforms`` (k, B) is given; ``draws`` (a list of k·E per-step
    dicts, see :func:`_make_actor_step`) replaces the actor's draws.
    ``index`` (a 0-d int64 tensor holding ``dispatch_idx``: a CUDA
    graph's input, learner/graphs.py) stands in for ``dispatch_idx`` in
    every derivation, the uniforms and the eval episodes' root, so that
    the python int only picks the eval lane's cadence.  The
    priority feedback is :func:`~r2d2_tpu_torch.learner.step.
    scatter_last` of ``new_p ** prio_exponent``, as in the in-graph PER
    super-step.

    On the mesh (``cross``, a :class:`~r2d2_tpu_torch.parallel.cross_rank.
    CrossRank`; ``lanes``, this rank's ``(lo, hi)``; ``train_step``, the
    meshed step): the actor steps run this rank's lanes on plain local
    views of the (replicated) params, their blocks routed to the slabs
    that own their slots; each inner step's draw is global over every
    rank's leaves and metadata, each rank trains its rows of the batch
    and writes back the leaves it owns; and the lane counters (episodes,
    reward) are summed over the ranks, so every rank's stats are the
    global ones.  With ``replicated`` every rank steps every lane
    (``lanes`` is all of them) and writes the cut blocks its slab owns:
    no block moves, and the lane counters are already global.  The eval
    lane runs alike on every rank.

    The plane counts its traces as ``learner.anakin_super_step``
    (utils/trace.py): on the mesh by input signature, meshless by CUDA
    graph (learner/graphs.py:graphed_super_step)."""
    k, E, B = cfg.superstep_k, cfg.anakin_env_steps_per_update, \
        cfg.batch_size
    lh = diag_enabled(cfg)
    step = train_step or make_train_step(cfg, net, learnhealth=lh)
    actor_step = _make_actor_step(cfg, net, env, action_dim, lanes, cross,
                                  replicated)
    eval_lane = (_make_eval_lane(cfg, net, env, action_dim)
                 if cfg.anakin_eval_interval > 0 else None)

    def super_step(train_state: TrainState, ast, arrays, prios, seq_meta,
                   first, dispatch_idx: int,
                   uniforms: Optional[torch.Tensor] = None,
                   draws: Optional[List[dict]] = None,
                   index: Optional[torch.Tensor] = None):
        at = dispatch_idx if index is None else index
        ast = _zero_deltas(ast)
        if uniforms is None:
            uniforms = sample_uniforms(cfg.seed, at, k, B, prios.device)
        params = acting_params(train_state.params)
        # whole copies of split params do not follow the step's in-place
        # update: take them again after each step
        regather = params_split(train_state.params)
        losses, diags = [], []
        for i in range(k):
            for e in range(E):
                ast, _ = actor_step(params, ast, arrays, prios,
                                    seq_meta, first,
                                    None if draws is None
                                    else draws[i * E + e])
            if cross is None:
                idx, w, ints = _in_graph_sample(cfg, uniforms[i], prios,
                                                seq_meta, first)
                batch = gather_batch(cfg, arrays, ints, w)
            else:
                d, batch = cross.sample_batch(
                    uniforms[i], prios, cross.global_meta(seq_meta, first),
                    arrays)
                idx = d.idx
            out = step(train_state, batch)
            train_state, loss, new_p = out[:3]
            if regather:
                params = acting_params(train_state.params)
            if lh:
                diags.append(out[3])
            if cross is None:
                scatter_last(prios, idx, new_p ** cfg.prio_exponent)
            else:
                cross.scatter_feedback(prios, idx,
                                       new_p ** cfg.prio_exponent)
            losses.append(loss)
        ast = _sum_lane_deltas(ast, cross, replicated)
        parts = [torch.stack(losses), _stats_vec(ast)]
        if eval_lane is not None:
            parts.append(eval_lane(params, dispatch_idx, at))
        if lh:
            parts.append(torch.stack(diags).reshape(-1))
        return (train_state, ast, arrays, prios, seq_meta, first,
                torch.cat(parts))

    return super_step


def acting_params(params: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """The params the actor steps read: the tensors themselves, or on the
    mesh each replicated DTensor's local tensor — the full parameter, with
    no copy and no collective, updated in place by the train step as the
    meshless params are (a placement over an axis of size 1 holds the
    whole tensor).  A parameter split over several ranks (fsdp or tp
    across ranks) is gathered whole: a collective every rank makes at the
    same point, and a copy that the step does not update
    (:func:`params_split`)."""
    from torch.distributed.tensor import DTensor

    out = {}
    for k, v in params.items():
        if isinstance(v, DTensor):
            local = v.to_local()
            v = local if local.shape == v.shape else v.full_tensor()
        out[k] = v
    return out


def params_split(params: Dict[str, torch.Tensor]) -> bool:
    """Whether any parameter is split over several ranks, so that
    :func:`acting_params` gathers a copy of it."""
    from torch.distributed.tensor import DTensor

    return any(isinstance(v, DTensor) and v.to_local().shape != v.shape
               for v in params.values())


def make_anakin_rollout(cfg: Config, net: R2D2Network, env: Any,
                        action_dim: int, steps: int,
                        lanes: Optional[tuple] = None, cross: Any = None,
                        replicated: bool = False):
    """The warm-up dispatch: ``steps`` env/actor steps with ring/PER
    writes but NO train step — dispatched until the fill counter reaches
    ``learning_starts``.  ``rollout(params, ast, arrays, prios, seq_meta,
    first) -> (ast', arrays, prios, seq_meta, first, stats (5,))``.
    ``lanes``, ``cross`` and ``replicated`` as in
    :func:`make_anakin_super_step`; the plane counts its traces as
    ``learner.anakin_rollout``."""
    actor_step = _make_actor_step(cfg, net, env, action_dim, lanes, cross,
                                  replicated)

    def rollout(params, ast, arrays, prios, seq_meta, first):
        ast = _zero_deltas(ast)
        params = acting_params(params)
        for _ in range(steps):
            ast, _ = actor_step(params, ast, arrays, prios, seq_meta, first)
        ast = _sum_lane_deltas(ast, cross, replicated)
        return ast, arrays, prios, seq_meta, first, _stats_vec(ast)

    return rollout


def make_debug_rollout(cfg: Config, net: R2D2Network, env: Any,
                       action_dim: int, steps: int):
    """Parity-test harness: like :func:`make_anakin_rollout` but keeps the
    per-step trace (q, hidden, actions, rewards, cut masks, observations),
    stacked over the steps, so tests can replay the exact trajectory into
    the host LocalBuffer oracle, and takes ``draws`` (a list of ``steps``
    per-step dicts).  ``rollout(params, ast, arrays, prios, seq_meta,
    first, draws=None) -> ((ast', arrays, prios, seq_meta, first),
    trace)``."""
    actor_step = _make_actor_step(cfg, net, env, action_dim)

    def rollout(params, ast, arrays, prios, seq_meta, first, draws=None):
        traces = []
        for i in range(steps):
            ast, tr = actor_step(params, ast, arrays, prios, seq_meta, first,
                                 None if draws is None else draws[i])
            traces.append(tr)
        trace = {key: torch.stack([tr[key] for tr in traces])
                 for key in traces[0]}
        return (ast, arrays, prios, seq_meta, first), trace

    return rollout


# --------------------------------------------------------------------------
# the host side: dispatch, harvest, snapshots
# --------------------------------------------------------------------------

def _np_dtype(t: torch.Tensor) -> np.dtype:
    return torch.empty(0, dtype=t.dtype).numpy().dtype


class AnakinPlane:
    """Owns the fused loop's device state and its dispatch/harvest cycle.

    The host's job: issue the dispatches, read back the small result
    vector, and keep Python-int mirrors of the counters.  Every
    device→host crossing ticks ``HOST_TRANSFERS`` (``anakin.result_fetch``
    once per dispatch and per rollout; ``anakin.snapshot_fetch`` per
    full-state snapshot), so the "one fetch per dispatch" claim is an
    assertable invariant.

    The ring lives in the :class:`DeviceRing` passed in: the fused loop
    writes its arrays and PER state in place, and the plane stores the
    handles back after every dispatch (``put_prios``/``put_per_meta``),
    so the ring object stays the single owner.  Everything runs on one
    stream from one thread; a snapshot runs only with no dispatch in
    flight (``run_anakin_loop`` drains first)."""

    def __init__(self, cfg: Config, net: R2D2Network, action_dim: int,
                 ring: Any, start_env_steps: int = 0, table: Any = None,
                 state_template: Optional[TrainState] = None,
                 replicate_lanes: bool = False):
        if not getattr(cfg, "in_graph_per", False):
            raise ValueError("the anakin plane requires in_graph_per=True "
                             "(train._train_anakin flips it on)")
        if cfg.num_blocks < cfg.num_actors:
            raise ValueError(
                f"anakin needs num_blocks ({cfg.num_blocks}) >= num_actors "
                f"({cfg.num_actors}): every lane may cut a block in the "
                "same step, and every lane writes a distinct slot")
        if cfg.anakin_episode_len > cfg.max_episode_steps:
            raise ValueError(
                f"anakin_episode_len ({cfg.anakin_episode_len}) must be "
                f"<= max_episode_steps ({cfg.max_episode_steps}): the "
                "fused loop relies on truncation firing before the "
                "episode-step cap (the cap path needs a second forward "
                "the fused loop does not run)")
        self.cfg = cfg
        self.ring = ring
        self.action_dim = action_dim
        self._eval = cfg.anakin_eval_interval > 0
        # learnhealth: the flat result vector carries the per-inner-step
        # diag rows, absorbed by the attached monitor
        self._lh = diag_enabled(cfg)
        self.monitor = None
        self.env = make_anakin_env(cfg, action_dim, device=ring.device)
        # the env/exploration root: two salts, a derivation distinct from
        # the PER sampler's and the eval lane's (JAX: a double fold_in)
        state = make_anakin_state(
            cfg, action_dim, self.env, derive(cfg.seed, _PLANE_SALT, 1))
        self.table, self.cross, lanes, train_step = table, None, None, None
        self.replicated_lanes = False
        if table is not None:
            lanes, train_step = self._mesh_setup(net, state, state_template,
                                                 replicate_lanes)
            state = {k: self._my_rows(v).clone() if self._split(k) else v
                     for k, v in state.items()}
        self.state = state
        self.roll_steps = cfg.superstep_k * cfg.anakin_env_steps_per_update
        super_step = make_anakin_super_step(
            cfg, net, self.env, action_dim, lanes, self.cross, train_step,
            self.replicated_lanes)
        rollout = make_anakin_rollout(cfg, net, self.env, action_dim,
                                      self.roll_steps, lanes, self.cross,
                                      self.replicated_lanes)
        if self.cross is None:
            # both entries replay CUDA graphs on a card (learner/graphs.py)
            from r2d2_tpu_torch.learner.graphs import (
                graphed_rollout,
                graphed_super_step,
            )

            self.super_step = graphed_super_step(cfg, super_step)
            self.rollout = graphed_rollout(rollout)
        else:
            # eager, retrace-guarded by input signature (ROADMAP.md A's
            # third host-bound cut)
            self.super_step = RETRACES.wrap("learner.anakin_super_step",
                                            super_step)
            self.rollout = RETRACES.wrap("learner.anakin_rollout", rollout)
        self._frames_per_dispatch = self.roll_steps * cfg.num_actors

        # host-int counter mirrors (absolute; deltas arrive per dispatch).
        # The lock covers them: the dispatch thread folds deltas in while
        # the log thread's stats() reads and resets the interval
        # accumulators (ReplayBuffer.stats' contract)
        self._stats_lock = threading.Lock()
        self.env_steps = int(start_env_steps)
        self.fill = 0
        self.frames = 0
        self.super_steps = 0
        self.blocks = 0
        self.episodes_total = 0
        self.reward_total = 0.0
        self.training_steps = 0
        self.dispatch_no = 0
        # the greedy eval lane: totals accumulate across resumes,
        # last_eval_return is the latest eval dispatch's mean return
        self.eval_episodes_total = 0
        self.eval_return_total = 0.0
        self.last_eval_return = float("nan")
        self._interval_episodes = 0
        self._interval_reward = 0.0
        self._interval_loss = 0.0
        self._interval_eval_episodes = 0

    # --------------------------------------------------------------- mesh
    def _mesh_setup(self, net, state, state_template, replicate_lanes):
        """The meshed plane (``table``): this rank steps its share of the
        lanes, its ring is its slab of ``num_blocks / dp`` blocks, and
        the draw, block routing and train step are the mesh's.  When the
        lanes do not divide over dp, or outnumber one slab's blocks (or
        ``replicate_lanes`` asks for it), every rank steps every lane
        instead, the JAX package's replicated lane axis: the same
        trajectory, nothing routed.  Returns ``(lanes, train_step)``."""
        from r2d2_tpu_torch.parallel.cross_rank import CrossRank
        from r2d2_tpu_torch.parallel.sharding import mesh_train_step

        cfg, mesh = self.cfg, self.table.mesh
        if state_template is None:
            raise ValueError("a meshed AnakinPlane needs state_template "
                             "(the learner's TrainState) for its step")
        # over this rank's dp axis of the mesh: with a dp group that spans
        # ranks, every (fsdp, tp) position holds replicas of the slabs
        self.cross = CrossRank(cfg, mesh, self.ring.cfg.num_blocks)
        dp, nb = self.cross.dp, self.cross.nb
        N = cfg.num_actors
        # a split lane axis needs N/dp lanes a rank, and the N-slot window
        # of one routed emit on N distinct rows of every slab
        self.replicated_lanes = bool(replicate_lanes or N % dp or N > nb)
        self._shardings = self.table.anakin_state_shardings(state)
        train_step = mesh_train_step(cfg, net, self.table,
                                     state_template=state_template)
        if self.replicated_lanes:
            return (0, N), train_step
        n = N // dp
        r = self.cross.rank
        return (r * n, (r + 1) * n), train_step

    def _split(self, key: str) -> bool:
        """Whether carry leaf ``key`` is split over the ranks by its
        leading (lane) axis (never with replicated lanes)."""
        return not self.replicated_lanes and any(
            getattr(p, "dim", None) == 0 for p in self._shardings[key])

    def _my_rows(self, v):
        """This rank's rows of a global entry split over the ranks (a
        tensor or an array)."""
        n = v.shape[0] // self.cross.dp
        return v[self.cross.rank * n:(self.cross.rank + 1) * n]

    # ----------------------------------------------------------- dispatch
    def _handles(self):
        meta = self.ring.per_meta()
        return (self.ring.snapshot(), self.ring.take_prios(),
                meta["seq_meta"], meta["first"])

    def _store(self, arrays, prios, seq_meta, first) -> None:
        self.ring.arrays = arrays
        self.ring.put_prios(prios)
        self.ring.put_per_meta(seq_meta, first)

    def rollout_step(self, params) -> None:
        """One warm-up dispatch (env/actor/ring-write only), harvested at
        once — the fill counter gates the switch to training."""
        with TRANSFER_GUARD.disallow("anakin.rollout"):
            ast, arrays, prios, seq_meta, first, stats = self.rollout(
                params, self.state, *self._handles())
            self.state = ast
            self._store(arrays, prios, seq_meta, first)
            with self._stats_lock:
                self.frames += self._frames_per_dispatch
            result = _Result(stats)
            with HOST_TRANSFERS.allowed("anakin.result_fetch"):
                stats_np = result.fetch()
        self._absorb(stats_np)

    def dispatch(self, train_state: TrainState):
        """One fused super-step dispatch.  Returns ``(train_state',
        result)``, the result's device→host copy already started — harvest
        it later (pipelined) with :meth:`harvest`."""
        idx = self.dispatch_no & 0xFFFFFFFF
        self.dispatch_no += 1
        with TRANSFER_GUARD.disallow("anakin.dispatch"):
            train_state, ast, arrays, prios, seq_meta, first, flat = (
                self.super_step(train_state, self.state, *self._handles(),
                                idx))
            self.state = ast
            self._store(arrays, prios, seq_meta, first)
            with self._stats_lock:
                self.frames += self._frames_per_dispatch
                self.super_steps += 1
            # the result's copy starts here, from the card into pinned
            # memory: it waits on nothing
            result = _Result(flat)
        return train_state, result

    def harvest(self, result: _Result) -> np.ndarray:
        """Fetch one dispatch's result vector — the loop's only recurring
        device→host crossing — and fold its deltas into the host
        counters.  Returns the k inner-step losses."""
        with TRANSFER_GUARD.disallow("anakin.harvest"), \
                HOST_TRANSFERS.allowed("anakin.result_fetch"):
            v = result.fetch()
        k = self.cfg.superstep_k
        losses = v[:k]
        stats = v[k:k + len(STATS_FIELDS)]
        off = k + len(STATS_FIELDS)
        if self._eval:
            ep, rsum = float(v[off]), float(v[off + 1])
            off += len(EVAL_FIELDS)
            if ep > 0:
                with self._stats_lock:
                    self.eval_episodes_total += int(ep)
                    self.eval_return_total += rsum
                    self.last_eval_return = rsum / ep
                    self._interval_eval_episodes += int(ep)
        if self.monitor is not None:
            # the monitor owns non-finite handling (a clean fabric stop
            # and the nonfinite alert) and absorbs the diag rows the
            # dispatch appended to the same flat vector
            self.monitor.note_losses(losses)
            if self._lh:
                self.monitor.absorb_diags(v[off:].reshape(k, DIAG_SIZE))
        else:
            assert np.isfinite(losses).all(), (
                f"non-finite loss in anakin super-step: {losses}")
        self._absorb(stats)
        with self._stats_lock:
            self.training_steps += k
            self._interval_loss += float(losses.sum())
        return losses

    def _absorb(self, s: np.ndarray) -> None:
        d = dict(zip(STATS_FIELDS, s.tolist()))
        with self._stats_lock:
            self.env_steps += int(d["env_steps"])
            self.fill = int(d["fill"])
            self.blocks += int(d["blocks"])
            self.episodes_total += int(d["episodes"])
            self.reward_total += float(d["reward_sum"])
            self._interval_episodes += int(d["episodes"])
            self._interval_reward += float(d["reward_sum"])

    @property
    def ready(self) -> bool:
        return self.fill >= self.cfg.learning_starts

    def stats(self) -> Dict[str, float]:
        """ReplayBuffer.stats()-shaped snapshot for the log loop (the
        interval accumulators reset on read, like the buffer's)."""
        with self._stats_lock:
            out = dict(size=self.fill, env_steps=self.env_steps,
                       training_steps=self.training_steps,
                       num_episodes=self._interval_episodes,
                       episode_reward=self._interval_reward,
                       sum_loss=self._interval_loss,
                       frames=self.frames, super_steps=self.super_steps,
                       blocks=self.blocks,
                       episodes_total=self.episodes_total,
                       eval_episodes=self.eval_episodes_total,
                       interval_eval_episodes=self._interval_eval_episodes,
                       eval_return=self.last_eval_return)
            self._interval_episodes = 0
            self._interval_reward = 0.0
            self._interval_loss = 0.0
            self._interval_eval_episodes = 0
        return out

    # ----------------------------------------------------------- snapshot
    _COUNTER_FIELDS = ("env_steps", "fill", "frames", "super_steps",
                       "blocks", "episodes_total", "reward_total",
                       "training_steps", "dispatch_no",
                       "eval_episodes_total", "eval_return_total")

    def _payload_tensors(self) -> Dict[str, torch.Tensor]:
        arrays, prios, seq_meta, first = self._handles()
        out = {f"state_{k}": v for k, v in self.state.items()}
        out.update({f"ring_{k}": v for k, v in arrays.items()})
        out.update(per_prios=prios, per_seq_meta=seq_meta, per_first=first)
        return out

    def _split_payload(self, key: str) -> bool:
        """Whether payload entry ``key`` is split over the ranks (a lane
        leaf of the carry, or a slab of the ring and its PER state)."""
        if self.cross is None:
            return False
        if key.startswith("state_"):
            return self._split(key[len("state_"):])
        return True

    def _gather_host(self, v: torch.Tensor) -> np.ndarray:
        """Every rank's part of a split entry, in rank order, on the host:
        all_gathers of at most ``_SNAPSHOT_CHUNK`` bytes a rank, so a
        whole ring is never held twice on the device."""
        dp, n = self.cross.dp, v.shape[0]
        out = np.empty((dp * n, *v.shape[1:]), dtype=_np_dtype(v))
        row = max(1, v[0].numel() * v.element_size()) if n else 1
        step = max(1, _SNAPSHOT_CHUNK // row)
        for c in range(0, n, step):
            m = min(step, n - c)
            got = self.cross.all_gather(v[c:c + m]).cpu().numpy()
            for d in range(dp):
                out[d * n + c:d * n + c + m] = got[d * m:(d + 1) * m]
        return out

    def _payload(self) -> Dict[str, np.ndarray]:
        """Host copies of the ENTIRE on-device loop state — the anakin
        carry (env state and streams, agent obs/LSTM carry, local
        buffers), the ring arrays and the PER leaves and metadata — under
        the JAX package's names.  Call only with no dispatch in flight.
        On the mesh the split entries are gathered from every rank (a
        collective), so the payload is the global state at any mesh
        shape."""
        with HOST_TRANSFERS.allowed("anakin.snapshot_fetch"):
            return {k: (self._gather_host(v) if self._split_payload(k)
                        else v.cpu().numpy())
                    for k, v in self._payload_tensors().items()}

    def write_state(self, path: str) -> Dict[str, Any]:
        """Serialise the full loop state into ``path`` (the
        ``Checkpointer.save_replay`` writer contract).  Returns the
        JSON-able meta :meth:`read_state` validates against.  On the mesh
        every rank calls it (the gathers are collectives) and rank 0
        alone writes the layout-free global state (its replicas at other
        fsdp or tp positions hold the same)."""
        import torch.distributed as dist

        flat = self._payload()
        if self.cross is None or dist.get_rank() == 0:
            with open(path, "wb") as f:  # savez must not append .npz
                np.savez(f, **flat)
        return dict(
            kind="anakin",
            layout=[[k, list(v.shape), v.dtype.name]
                    for k, v in sorted(flat.items())],
            counters={k: getattr(self, k) for k in self._COUNTER_FIELDS},
        )

    def read_state(self, path: str, meta: Dict[str, Any]) -> None:
        """Restore the state :meth:`write_state` captured.  Raises
        ``ValueError`` on a geometry or layout mismatch — another config,
        or a snapshot the JAX package wrote (its stream keys are uint32,
        these int64) — and the caller warns and resumes cold.  The carry,
        the ring arrays and the PER state are overwritten in place (never
        reallocated), so the entries' CUDA graphs, which read them where
        they are, replay the restored state."""
        if meta.get("kind") != "anakin":
            raise ValueError("snapshot is not an anakin loop snapshot")
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        dp = 1 if self.cross is None else self.cross.dp
        want = [[k, list(v.shape), v.dtype.name]
                for k, v in sorted(flat.items())]
        have = [[k, ([v.shape[0] * dp, *v.shape[1:]]
                     if self._split_payload(k) else list(v.shape)),
                 _np_dtype(v).name]
                for k, v in sorted(self._payload_tensors().items())]
        if want != have:
            raise ValueError(
                "anakin snapshot layout mismatch — written under a "
                "different config geometry (or by another package); "
                "resuming cold")
        # the global arrays, re-placed under this plane's mesh: each rank
        # keeps its lanes and its slab
        flat = {k: (np.ascontiguousarray(self._my_rows(v))
                    if self._split_payload(k) else v)
                for k, v in flat.items()}
        with torch.no_grad():
            for k, dst in self._payload_tensors().items():
                dst.copy_(torch.from_numpy(flat[k]))
        c = meta.get("counters", {})
        for k in self._COUNTER_FIELDS:
            if k in c:
                setattr(self, k, type(getattr(self, k))(c[k]))


def run_anakin_loop(learner: Any, plane: AnakinPlane,
                    stop: Optional[Any] = None, tracer: Optional[Any] = None,
                    max_steps: Optional[int] = None,
                    snapshot_fn: Optional[Any] = None,
                    chaos: Optional[Any] = None) -> Dict[str, Any]:
    """The anakin drivetrain: warm-up rollouts until the ring fill passes
    ``learning_starts``, then pipelined fused super-steps (up to
    ``cfg.superstep_pipeline`` in flight beyond the one harvested) with
    the device drivetrains' checkpoint cadence (updates advance by k per
    dispatch).  ``snapshot_fn(step)``, when given, is called at
    ``cfg.replay_snapshot_interval``-second crossings ON this thread,
    after draining the pipeline (a snapshot needs no dispatch in flight).
    Returns summary metrics incl. the full per-update loss curve.

    ``cfg.dispatch_deadline`` (> 0) bounds each harvest — the loop's one
    blocking device wait — by fetching on a helper thread with a bounded
    join, so a device wait that never returns cannot hang the loop.  Two
    wedge grades, both ending in a clean abort
    (``metrics["dispatch_wedged"]``):

    - *slow* (the fetch completed but blew the budget; it gets one extra
      budget of grace): drain the pipeline, write a full resumable
      snapshot via ``snapshot_fn``, abort;
    - *hard* (the fetch did not return within twice the budget; the chaos
      ``wedge_dispatch`` site drills this by stalling the fetch thread):
      abandon the fetch thread, skip the drain (it would block on the
      same device), attempt the snapshot on a BOUNDED helper thread, and
      abort; if even that times out, the last periodic snapshot remains
      the resume point."""
    cfg = learner.cfg
    tracer = tracer or Tracer()
    k = cfg.superstep_k
    t0 = time.time()
    updates = learner.num_updates
    target = cfg.training_steps if max_steps is None else updates + max_steps
    losses_all: list = []
    pending: deque = deque()
    last_snap = time.time()
    wedged = False
    hard_wedged = False
    abandoned = threading.Event()   # set when a hard wedge walks away

    def harvest_one() -> None:
        nonlocal wedged, hard_wedged
        result = pending.popleft()

        def fetch():
            # the chaos stall lives INSIDE the fetch, so the drill runs
            # the real hard-wedge path: a device wait that does not come
            # back within the budget
            if chaos is not None:
                stall = chaos.dispatch_wedge_seconds()
                if stall > 0:
                    log.warning("chaos: wedging the anakin dispatch "
                                "harvest for %.1fs", stall)
                    time.sleep(stall)
            if abandoned.is_set():
                # the loop declared a hard wedge and may be mid-snapshot:
                # a late harvest would fold this dispatch's counters into
                # state the snapshot thread is reading
                return None
            return plane.harvest(result)

        if cfg.dispatch_deadline <= 0:           # unbounded: fetch inline
            losses_all.extend(fetch().tolist())
            return
        budget = Deadline(cfg.dispatch_deadline)
        box: list = []

        def run():
            try:
                box.append(("ok", fetch()))
            except BaseException as e:           # re-raised on the loop
                box.append(("err", e))

        # a bounded-join fetch, abandoned on a hard wedge by design: a
        # supervised restart would block on the same dead device again
        t = threading.Thread(target=run, name="anakin-harvest", daemon=True)  # graftlint: disable=thread-discipline -- bounded-join fetch; abandoned on a hard wedge BY DESIGN, a Supervisor restart would re-block on the dead device
        t.start()
        t.join(budget.remaining())
        if t.is_alive():
            # over budget: one extra budget of grace, so that a slow but
            # completing fetch lands in the slow grade below
            t.join(cfg.dispatch_deadline)
        if t.is_alive():
            log.error(
                "anakin dispatch harvest exceeded its %.1fs budget and "
                "has not returned after as much grace — treating the "
                "device as hard-wedged: abandoning the fetch, "
                "best-effort snapshot, aborting cleanly (resume with "
                "--resume)", cfg.dispatch_deadline)
            abandoned.set()
            wedged = hard_wedged = True
            return
        tag, val = box[0]
        if tag == "err":
            raise val
        losses_all.extend(val.tolist())
        if budget.expired:
            log.error(
                "anakin dispatch harvest took %.1fs (budget %.1fs) — "
                "treating the device as wedged: draining, snapshotting "
                "and aborting cleanly (resume with --resume)",
                budget.elapsed(), cfg.dispatch_deadline)
            wedged = True

    # cfg.transfer_guard: arm the process guard once the warm-up ends, so
    # every window of dispatch, harvest and rollout enforces its declared
    # crossings — an undeclared sync raises TransferGuardTripped instead
    # of stalling the stream.  Armed AFTER the warm-up: the library
    # handles the first dispatches create belong to bring-up
    guard = contextlib.ExitStack()
    guard_armed = False
    try:
        while updates < target and not wedged:
            if stop is not None and stop():
                break
            if not plane.ready:
                with tracer.span("anakin.rollout_dispatch"):
                    plane.rollout_step(learner.state.params)
                continue
            if cfg.transfer_guard and not guard_armed:
                guard.enter_context(TRANSFER_GUARD.arm())
                guard_armed = True
            with tracer.span("learner.step_dispatch"):
                learner.state, result = plane.dispatch(learner.state)
            pending.append(result)
            while len(pending) > cfg.superstep_pipeline and not wedged:
                with tracer.span("learner.result_sync"):
                    harvest_one()

            prev, updates = updates, updates + k
            if (learner.checkpointer is not None
                    and updates // cfg.save_interval
                    > prev // cfg.save_interval):
                learner.env_steps = plane.env_steps
                with tracer.span("learner.checkpoint_save"):
                    learner._save(updates, t0)
            if (snapshot_fn is not None
                    and cfg.replay_snapshot_interval > 0
                    and time.time() - last_snap
                    > cfg.replay_snapshot_interval):
                while pending and not hard_wedged:
                    harvest_one()   # snapshots need no dispatch in flight
                if not hard_wedged:
                    snapshot_fn(updates)
                    last_snap = time.time()
        while pending and not hard_wedged:
            harvest_one()
    finally:
        guard.close()
    if wedged and snapshot_fn is not None:
        # the clean abort's resumable artifact.  On a HARD wedge the
        # snapshot reads device handles and can block on the same dead
        # device: bound the attempt (if it times out, the last periodic
        # snapshot stays the resume point)
        if not hard_wedged:
            snapshot_fn(updates)
        else:
            _bounded(lambda: snapshot_fn(updates), "anakin-wedge-snap",
                     max(10.0, 10.0 * cfg.dispatch_deadline),
                     "hard-wedge snapshot")

    learner.env_steps = plane.env_steps
    if hard_wedged:
        # the epilogue's final checkpoint save reads params from the same
        # wedged device: bounded like the snapshot above
        box: dict = {}

        def fin():
            box["metrics"] = learner._finish_device_run(losses_all[-100:],
                                                        t0)

        _bounded(fin, "anakin-wedge-fin",
                 max(10.0, 10.0 * cfg.dispatch_deadline),
                 "hard-wedge final save")
        metrics = box.get("metrics") or dict(
            num_updates=learner.num_updates,
            env_steps=learner.env_steps,
            minutes=learner.start_minutes + (time.time() - t0) / 60.0,
            mean_loss=(float(np.mean(losses_all[-100:]))
                       if losses_all else float("nan")))
    else:
        metrics = learner._finish_device_run(losses_all[-100:], t0)
    metrics["losses"] = losses_all
    metrics["dispatch_wedged"] = wedged
    metrics["env_steps"] = plane.env_steps
    metrics["anakin_frames"] = plane.frames
    metrics["anakin_super_steps"] = plane.super_steps
    metrics["episodes"] = plane.episodes_total
    metrics["mean_episode_return"] = (
        plane.reward_total / plane.episodes_total
        if plane.episodes_total else float("nan"))
    metrics["eval_episodes"] = plane.eval_episodes_total
    metrics["mean_eval_return"] = (
        plane.eval_return_total / plane.eval_episodes_total
        if plane.eval_episodes_total else float("nan"))
    return metrics


def _bounded(fn, name: str, seconds: float, what: str) -> None:
    """Run ``fn`` on a daemon thread and wait at most ``seconds`` — one
    best-effort step of a hard-wedge abort, with nothing to supervise
    after it."""
    done = threading.Event()

    def run():
        try:
            fn()
            done.set()
        except Exception:
            log.exception("%s failed", what)

    t = threading.Thread(target=run, name=name, daemon=True)  # graftlint: disable=thread-discipline -- one best-effort bounded-join step at abort (the snapshot or the epilogue save); nothing to supervise after it
    t.start()
    t.join(seconds)
    if not done.is_set():
        log.error("%s did not complete in time — aborting without it", what)
