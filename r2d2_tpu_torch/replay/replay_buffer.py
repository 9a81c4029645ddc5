"""Prioritised sequence replay buffer (host-side data plane).

Port of the host ring of ``r2d2_tpu/replay/replay_buffer.py``, numpy
throughout: the same seeds give the same samples, weights and priority
updates as the JAX package, bit for bit.

Capability-parity with the reference's ``ReplayBuffer`` (worker.py:38-261):
a ring of blocks with one PER leaf per learning sequence, stratified
prioritised sampling, IS weights, stale-index masking when leaves are
overwritten between sampling and the learner's priority feedback, and
size/env-step/episode-return accounting.  Blocks live in preallocated
contiguous ring arrays, so a batch is a handful of vectorised fancy-index
gathers into fixed-shape ``(B, T, ...)`` arrays.

The replay snapshot (``write_state``/``read_state``) keeps the reference's
byte layout — ``slot_layout`` over the same spec, the same layout
fingerprint and meta — so a snapshot written by either package restores
in the other.

With a :class:`~r2d2_tpu_torch.replay.device_ring.DeviceRing` the bulk
data lives on the device: ``add`` stages each block outside the lock and
commits it under it, ``sample_meta`` yields index bundles for the device
gather, and under ``cfg.in_graph_per`` the PER leaves live on the device
too.  Under the learner mesh each rank's buffer is one dp group's slab of
the global ring and draws its rows with their raw inclusion densities
(``sample_meta(raw_densities=True)``), which the learner normalises by the
minimum over every rank; a buffer of several slot groups in one process
(JAX's single-process dp ring) has no counterpart, since a rank holds one
device.
:meth:`ReplayBuffer.serve_sample` is the sharded replay plane's shard-side
draw (parallel/replay_shards.py, parallel/replay_net.py).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import numpy as np

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.replay.block import Block, slot_layout, slot_views
from r2d2_tpu_torch.replay.sum_tree import SumTree
from r2d2_tpu_torch.telemetry.tracing import EVENTS

# at most this many lineage flow points per sampled batch / feedback call
_FLOW_CAP = 8


def _emit_flows(name: str, trace_ids: np.ndarray, fph: str) -> None:
    """Flow points for the distinct nonzero capture-window trace ids in
    ``trace_ids`` (capped) — no-op unless a capture is armed."""
    if not EVENTS.armed:
        return
    seen = 0
    for tid in np.unique(trace_ids):
        if tid == 0:
            continue
        EVENTS.instant(name, flow=int(tid), fph=fph)
        seen += 1
        if seen >= _FLOW_CAP:
            break


def _data_spec(cfg: Config, action_dim: int):
    """(name, shape, dtype) of the bulk experience arrays."""
    NB, K, MS = cfg.num_blocks, cfg.seqs_per_block, cfg.max_block_steps
    BL, layers, H = cfg.block_length, cfg.lstm_layers, cfg.hidden_dim
    return (
        ("obs", (NB, MS, *cfg.stored_obs_shape), np.uint8),
        ("last_action", (NB, MS, action_dim), bool),
        ("last_reward", (NB, MS), np.float32),
        ("action", (NB, BL), np.uint8),
        ("n_step_reward", (NB, BL), np.float32),
        ("n_step_gamma", (NB, BL), np.float32),
        ("hidden", (NB, K, 2, layers, H), np.float32),
    )


def _count_spec(cfg: Config):
    """(name, shape, dtype) of the per-sequence/per-block accounting arrays
    (they drive index computation and sampling)."""
    NB, K = cfg.num_blocks, cfg.seqs_per_block
    return (
        ("burn_in_steps", (NB, K), np.uint8),
        ("learning_steps", (NB, K), np.uint8),
        ("forward_steps", (NB, K), np.uint8),
        ("first_burn_in", (NB,), np.int64),
        ("block_learning_total", (NB,), np.int64),
    )


def _ring_spec(cfg: Config, action_dim: int):
    """(name, shape, dtype) of every preallocated ring array — the single
    source of truth for both the allocation loop and the RAM guard."""
    return _data_spec(cfg, action_dim) + _count_spec(cfg)


def _spec_bytes(spec) -> int:
    return sum(int(np.prod(shape)) * np.dtype(dtype).itemsize
               for _, shape, dtype in spec)


def data_bytes(cfg: Config, action_dim: int) -> int:
    """Bytes of the bulk experience arrays alone."""
    return _spec_bytes(_data_spec(cfg, action_dim))


def _layout_fingerprint(spec) -> list:
    """JSON-able (name, shape, dtype) list identifying a snapshot layout."""
    return [[name, list(shape), np.dtype(dtype).name]
            for name, shape, dtype in spec]


def _available_host_bytes() -> Optional[int]:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:  # non-Linux host: skip the guard
        pass
    return None


class ReplayBuffer:
    """Synchronous core.  Thread-safe via one lock."""

    def __init__(self, cfg: Config, action_dim: int,
                 rng: Optional[np.random.Generator] = None,
                 device_ring: Optional[Any] = None):
        """``device_ring`` (replay/device_ring.DeviceRing): when given, the
        bulk experience arrays live on the device — ``add`` streams each
        block there once, ``sample_meta`` yields index bundles for the
        device gather, and the big host data arrays are not allocated
        (``sample_batch`` then raises)."""
        self.cfg = cfg
        self.action_dim = action_dim
        self.device_ring = device_ring
        if cfg.in_graph_per and device_ring is None:
            # fail here with the remedy, not in an actor thread at the
            # first block commit: device PER cannot run on host replay
            raise ValueError(
                "in_graph_per requires a device ring, but none was built "
                "— the ring did not fit the device budget (see the warning "
                "above); shrink buffer_capacity or set in_graph_per=False")
        # slot groups of a dp-sharded ring map the logical FIFO walk onto
        # physical slots round-robin (_phys_block); with one group every
        # mapping is the identity
        self.G = device_ring.num_groups if device_ring is not None else 1
        if self.G != 1:
            raise ValueError(
                "r2d2_tpu_torch: a device ring of several slot groups in one "
                "process has no counterpart in the port: each rank of the "
                "learner mesh holds one dp group's slab of the ring "
                "(train(cfg, use_mesh=True), parallel/distributed.py)")
        self._blocks_per_group = cfg.num_blocks // self.G
        spec = (_count_spec(cfg) if device_ring is not None
                else _ring_spec(cfg, action_dim))
        # fail fast with an actionable message instead of letting the
        # allocator OOM partway through the allocation loop (or later, as
        # the lazily-committed pages fill); 10% headroom for the rest
        need = _spec_bytes(spec)
        avail = _available_host_bytes()
        if avail is not None and need > 0.9 * avail:
            raise MemoryError(
                f"replay ring needs {need / 1e9:.1f} GB but only "
                f"{avail / 1e9:.1f} GB of host memory is available "
                "(guard requires 10% headroom) — reduce buffer_capacity / "
                "block_length / obs size (flagship defaults need ~16 GB)")
        for name, shape, dtype in spec:
            setattr(self, name, np.zeros(shape, dtype))

        self.tree = SumTree(cfg.num_sequences, cfg.prio_exponent,
                            cfg.importance_sampling_exponent, rng=rng)
        # data-health sidecar: the resident block's member id per slot and
        # the sampled-row counts per member (not part of the snapshot)
        self._slot_member = np.zeros(cfg.num_blocks, np.int32)
        self.samples_per_member: Dict[int, int] = {}
        # block-lineage sidecar per slot: the resident block's cut/add
        # wall-clock stamps (the sampled rows' ages) and its capture id
        self._slot_cut_ts = np.zeros(cfg.num_blocks)
        self._slot_add_ts = np.zeros(cfg.num_blocks)
        self._slot_trace = np.zeros(cfg.num_blocks, np.int64)

        self.lock = threading.Lock()
        self.block_ptr = 0
        self.size = 0  # total learning steps stored (reference "size")
        self.env_steps = 0
        self.num_episodes = 0
        self.episode_reward = 0.0
        self.training_steps = 0
        self.sum_loss = 0.0
        self.corrupt_blocks = 0  # wire-format CRC mismatches, never reset
        self.blocks_per_member: Dict[int, int] = {}

    def __len__(self) -> int:
        return self.size

    def _phys_block(self, n):
        """Logical ring position → physical slot (round-robin over the G
        group slabs; the identity for G == 1)."""
        return (n % self.G) * self._blocks_per_group + n // self.G

    def _log_block(self, p):
        """Physical slot → logical ring position (the inverse of
        :meth:`_phys_block`)."""
        return ((p % self._blocks_per_group) * self.G
                + p // self._blocks_per_group)

    @property
    def ready(self) -> bool:
        # with one slot group the in-graph PER gate is this one too: the
        # sampler draws from the whole leaf vector
        return self.size >= self.cfg.learning_starts

    # ------------------------------------------------------------------ add
    def add(self, block: Block, priorities: np.ndarray,
            episode_reward: Optional[float]) -> None:
        """Overwrite the ring slot at ``block_ptr`` (worker.py:141-161)."""
        cfg = self.cfg
        K = cfg.seqs_per_block
        # stage the device copy OUTSIDE the lock: the zero-pad and the H2D
        # copies are the slow part of a device-ring write, and the
        # learner's sample+dispatch serialises on this lock; only the
        # commit needs the ordering the lock gives
        staged = (self.device_ring.stage(block)
                  if self.device_ring is not None else None)
        if cfg.in_graph_per:
            # device-PER leaves: td**alpha; ``priorities`` arrives K long,
            # zero past the block's real sequences, and 0**alpha keeps the
            # padding unsampleable; the metadata is per real sequence
            k_seq = block.num_sequences
            prios_alpha = (np.asarray(priorities, np.float64)
                           ** cfg.prio_exponent).astype(np.float32)
            meta = np.zeros((K, 3), np.int32)
            meta[:k_seq, 0] = block.burn_in_steps
            meta[:k_seq, 1] = block.learning_steps
            meta[:k_seq, 2] = block.forward_steps
        with self.lock:
            ptr = self.block_ptr
            # every array and PER leaf is keyed by the PHYSICAL slot; the
            # logical ptr only orders the FIFO walk
            slot = self._phys_block(ptr)
            if cfg.in_graph_per:
                # the priorities live on the device; the host tree stays
                # empty
                self.device_ring.commit_per(slot, prios_alpha, meta,
                                            int(block.burn_in_steps[0]))
            else:
                self.tree.update(np.arange(slot * K, (slot + 1) * K,
                                           dtype=np.int64), priorities)
            self.size -= int(self.block_learning_total[slot])

            k = block.num_sequences
            if staged is not None:
                # the commit is enqueued under the lock the learner
                # samples and gathers under (device_ring's contract)
                self.device_ring.commit(staged, slot)
            else:
                n_obs = block.obs.shape[0]
                n_steps = block.action.shape[0]
                self.obs[slot, :n_obs] = block.obs
                self.last_action[slot, :n_obs] = block.last_action
                self.last_reward[slot, :n_obs] = block.last_reward
                self.action[slot, :n_steps] = block.action
                self.n_step_reward[slot, :n_steps] = block.n_step_reward
                self.n_step_gamma[slot, :n_steps] = block.n_step_gamma
                self.hidden[slot, :k] = block.hidden
            self.burn_in_steps[slot] = 0
            self.learning_steps[slot] = 0
            self.forward_steps[slot] = 0
            self.burn_in_steps[slot, :k] = block.burn_in_steps
            self.learning_steps[slot, :k] = block.learning_steps
            self.forward_steps[slot, :k] = block.forward_steps
            self.first_burn_in[slot] = int(block.burn_in_steps[0])

            total = int(block.learning_steps.sum())
            self.block_learning_total[slot] = total
            self.size += total
            self.env_steps += total

            self.block_ptr = (ptr + 1) % cfg.num_blocks
            self._slot_cut_ts[slot] = block.cut_ts
            self._slot_add_ts[slot] = time.time()
            self._slot_trace[slot] = block.trace_id
            m = int(block.member_id)
            self._slot_member[slot] = m
            self.blocks_per_member[m] = self.blocks_per_member.get(m, 0) + 1
            if episode_reward is not None:
                self.episode_reward += episode_reward
                self.num_episodes += 1
        if block.trace_id:
            _emit_flows("replay.add_block", np.array([block.trace_id]), "t")

    # --------------------------------------------------------------- sample
    def sample_batch(self, batch_size: Optional[int] = None
                     ) -> Dict[str, np.ndarray]:
        """Assemble one fixed-shape training batch.

        Returns a dict of arrays (B = batch, T = seq_len, L = learning_steps):
        obs (B,T,*obs) u8 · last_action (B,T,A) f32 · last_reward (B,T) f32 ·
        hidden (B,2,layers,H) · action (B,L) i32 · n_step_reward/gamma (B,L) ·
        burn_in/learning/forward (B,) i32 · is_weights (B,) f32, plus host-only
        bookkeeping: idxes, block_ptr snapshot, env_steps, ages
        (worker.py:219-238).
        """
        if self.device_ring is not None:
            raise RuntimeError(
                "sample_batch needs host data arrays; this buffer runs "
                "device_replay — use sample_meta and the device gather")
        B = batch_size or self.cfg.batch_size
        with self.lock:
            if self.size == 0:
                raise RuntimeError(
                    "sample_batch on an empty buffer; wait for add() (use "
                    "`ready` to gate on learning_starts)")
            idxes, is_weights = self.tree.sample(B)
            self._note_sampled(idxes)
            batch = dict(
                self._gather_rows(idxes),
                is_weights=is_weights.astype(np.float32),
                idxes=idxes,
                block_ptr=self.block_ptr,
                env_steps=self.env_steps,
                ages=self._row_ages(idxes),
            )
        if EVENTS.armed:
            _emit_flows("replay.sample",
                        self._slot_trace[idxes // self.cfg.seqs_per_block],
                        "t")
        return batch

    def _note_sampled(self, idxes: np.ndarray) -> None:
        """Count sampled rows per resident member (caller holds the
        lock) — the per-member sample fractions of the data-health
        surface."""
        members = self._slot_member[idxes // self.cfg.seqs_per_block]
        for m, c in zip(*np.unique(members, return_counts=True)):
            m = int(m)
            self.samples_per_member[m] = (
                self.samples_per_member.get(m, 0) + int(c))

    def _row_ages(self, idxes: np.ndarray) -> np.ndarray:
        """(n, 2) float32 per-row block ages at gather time — seconds since
        the block was cut and since it landed in this ring; -1 for a slot
        with no stamp.  Caller holds the lock."""
        slots = idxes // self.cfg.seqs_per_block
        now = time.time()
        cut, add = self._slot_cut_ts[slots], self._slot_add_ts[slots]
        ages = np.empty((idxes.shape[0], 2), np.float32)
        ages[:, 0] = np.where(cut > 0, np.maximum(0.0, now - cut), -1.0)
        ages[:, 1] = np.where(add > 0, np.maximum(0.0, now - add), -1.0)
        return ages

    def _gather_rows(self, idxes: np.ndarray,
                     out: Optional[Dict[str, np.ndarray]] = None
                     ) -> Dict[str, np.ndarray]:
        """The vectorised fancy-index gather of the per-row batch fields
        for leaf ``idxes`` — shared by :meth:`sample_batch` and
        :meth:`serve_sample`.  Caller holds the lock.

        ``out``: destination views (a sharded plane's response slab, each
        already sliced to ``len(idxes)`` rows) — the dominant ``obs``
        gather then runs as one ``np.take(..., out=)`` pass straight into
        the slab instead of through a batch-sized intermediate.

        INVARIANT (load-bearing): the clamp below pads short sequences
        with whatever bytes previously occupied the ring slot.  This is
        safe because every index the learner gathers is
        < burn_in + learning + forward (learner/step.py:_window_indices
        clamps to that bound), i.e. strictly before the stale region,
        and loss/priorities are masked to the learning window.  The
        stale tail does flow through the LSTM scan, but only *after*
        the last gathered timestep, so it cannot affect any used
        output.  Tested in tests/test_torch_replay.py.
        """
        cfg = self.cfg
        K, L, T = cfg.seqs_per_block, cfg.learning_steps, cfg.seq_len
        block_idx = idxes // K
        seq_idx = idxes % K

        burn_in = self.burn_in_steps[block_idx, seq_idx].astype(np.int64)
        learning = self.learning_steps[block_idx, seq_idx].astype(np.int64)
        forward = self.forward_steps[block_idx, seq_idx].astype(np.int64)

        # obs-coordinate window start: first burn-in prefix + k full
        # learning windows (worker.py:186), reaching back over this
        # sequence's own burn-in
        start = self.first_burn_in[block_idx] + seq_idx * L
        t0 = start - burn_in
        time_idx = np.minimum(t0[:, None] + np.arange(T),
                              cfg.max_block_steps - 1)
        bcol = block_idx[:, None]
        widx = np.minimum(seq_idx[:, None] * L + np.arange(L),
                          cfg.block_length - 1)
        if out is None:
            return dict(
                obs=self.obs[bcol, time_idx],
                last_action=self.last_action[bcol, time_idx].astype(
                    np.float32),
                last_reward=self.last_reward[bcol, time_idx],
                hidden=self.hidden[block_idx, seq_idx],
                action=self.action[bcol, widx].astype(np.int32),
                n_step_reward=self.n_step_reward[bcol, widx],
                n_step_gamma=self.n_step_gamma[bcol, widx],
                burn_in=burn_in.astype(np.int32),
                learning=learning.astype(np.int32),
                forward=forward.astype(np.int32),
            )
        n = idxes.shape[0]
        # obs dominates the batch bytes: one flat-index take straight
        # into the destination (same [block, time] pairs as the fancy
        # gather above — bit-identical rows, one fewer full pass)
        flat_t = (block_idx[:, None] * cfg.max_block_steps
                  + time_idx).ravel()
        np.take(self.obs.reshape(cfg.num_blocks * cfg.max_block_steps, -1),
                flat_t, axis=0, out=out["obs"].reshape(n * T, -1))
        # the rest is small relative to obs: plain gathers/casts into out
        out["last_action"][...] = self.last_action[bcol, time_idx]
        out["last_reward"][...] = self.last_reward[bcol, time_idx]
        out["hidden"][...] = self.hidden[block_idx, seq_idx]
        out["action"][...] = self.action[bcol, widx]
        out["n_step_reward"][...] = self.n_step_reward[bcol, widx]
        out["n_step_gamma"][...] = self.n_step_gamma[bcol, widx]
        out["burn_in"][...] = burn_in
        out["learning"][...] = learning
        out["forward"][...] = forward
        return out

    def serve_sample(self, n: int,
                     out: Optional[Dict[str, np.ndarray]] = None):
        """One shard-side sample service call (the sharded replay plane's
        owner processes, parallel/replay_shards.py): a stratified draw of
        ``n`` rows over THIS buffer's own tree plus the gathered row
        fields.  Returns ``(rows, idxes, raw_prios, block_ptr,
        env_steps)`` — priorities travel RAW (no zero-clamp, no IS
        normalisation) because the trainer-side coordinator normalises by
        the min across ALL shards' rows at once, preserving the K=1
        min-of-the-whole-batch scheme; ``block_ptr`` is this buffer's
        local FIFO pointer, which the shard's own
        :meth:`update_priorities` stale-mask needs at feedback time.
        ``out``: response-slab destination views (already sliced to
        ``n`` rows) the gather writes straight into.  The trailing
        ``ages`` element is the :meth:`_row_ages` lineage decomposition
        the trainer-side coordinator feeds into the ``pipeline.*``
        histograms (the shard process has no registry of its own)."""
        with self.lock:
            if self.size == 0 or self.tree.total <= 0:
                # the coordinator's mass vector can be one publish stale —
                # answer empty instead of raising so the trainer
                # redistributes the rows over the shards that have mass
                return None
            idxes, prios = self.tree.sample(n, raw=True)
            self._note_sampled(idxes)
            rows = self._gather_rows(idxes, out=out)
            ages = self._row_ages(idxes)
        if EVENTS.armed:
            _emit_flows("replay.sample",
                        self._slot_trace[idxes // self.cfg.seqs_per_block],
                        "t")
        return rows, idxes, prios, self.block_ptr, self.env_steps, ages

    # ---------------------------------------------------------- sample (meta)
    def sample_meta(self, k: int, batch_size: Optional[int] = None,
                    dispatch=None, raw_densities: bool = False
                    ) -> Dict[str, Any]:
        """Sample ``k`` index bundles for the device gather
        (replay/device_ring.gather_batch) — the index arithmetic of
        :meth:`sample_batch` without touching any data array.

        The k bundles are drawn without priority feedback between them,
        like the prefetch depth of the queued host path (the reference
        stages up to 8+4 batches ahead of the learner, worker.py:300-316).

        ``dispatch``, when given, is called as ``dispatch(ints, weights)``
        while the buffer lock is still held, and its result returned under
        ``meta["dispatched"]``: this enqueues the gathers before any later
        ring write (the device_ring concurrency contract).

        ``raw_densities=True`` returns the rows' inclusion densities q
        (prio / this buffer's mass) in the ``is_weights`` slots instead of
        normalised weights: each rank of the learner mesh draws from its
        own slab, and the learner normalises by the minimum over every
        rank's rows (``learner.global_is_weights``), keeping the
        min-of-the-whole-batch scheme across ranks.

        Returns ints (k,B,6) i32 · is_weights (k,B) f32 · idxes (k,B) i64 ·
        block_ptr · env_steps.
        """
        cfg = self.cfg
        B = batch_size or cfg.batch_size
        K, L = cfg.seqs_per_block, cfg.learning_steps
        ints = np.empty((k, B, 6), np.int32)
        weights = np.empty((k, B), np.float32)
        idxes = np.empty((k, B), np.int64)
        with self.lock:
            if self.size == 0:
                raise RuntimeError(
                    "sample_meta on an empty buffer; wait for add() (use "
                    "`ready` to gate on learning_starts)")
            for j in range(k):
                if raw_densities:
                    idx, w = self._grouped_densities(B)
                else:
                    idx, w = self.tree.sample(B)
                block_idx = idx // K
                seq_idx = idx % K
                burn_in = self.burn_in_steps[block_idx, seq_idx].astype(
                    np.int64)
                start = self.first_burn_in[block_idx] + seq_idx * L
                ints[j, :, 0] = block_idx
                ints[j, :, 1] = start - burn_in          # t0, always >= 0
                ints[j, :, 2] = seq_idx
                ints[j, :, 3] = burn_in
                ints[j, :, 4] = self.learning_steps[block_idx, seq_idx]
                ints[j, :, 5] = self.forward_steps[block_idx, seq_idx]
                weights[j] = w
                idxes[j] = idx
                self._note_sampled(idx)
            meta = dict(ints=ints, is_weights=weights, idxes=idxes,
                        block_ptr=self.block_ptr, env_steps=self.env_steps)
            if dispatch is not None:
                meta["dispatched"] = dispatch(ints, weights)
        return meta

    def _grouped_densities(self, B: int):
        """One B-row draw (B/G rows from each group's slab; G is 1 in the
        port) with the rows' raw inclusion densities prio / group mass
        (caller holds the lock).  A zero density (a descent landing on a
        zero leaf through float error) is clamped to the smallest positive
        one, as ``SumTree.sample`` guards its weights."""
        K = self.cfg.seqs_per_block
        span = self._blocks_per_group * K
        per = B // self.G
        idx_parts, q_parts = [], []
        for g in range(self.G):
            part, prios, mass = self.tree.sample_range(per, g * span,
                                                       (g + 1) * span)
            idx_parts.append(part)
            q_parts.append(prios / mass)
        idx = np.concatenate(idx_parts)
        q = np.concatenate(q_parts)
        pos = q[q > 0]
        return idx, np.maximum(q, pos.min() if pos.size else 1.0)

    # ------------------------------------------------------- priority update
    def update_priorities(self, idxes: np.ndarray, priorities: np.ndarray,
                          old_ptr: int, loss: float) -> None:
        """Write back learner priorities, discarding indices whose ring slots
        were overwritten since the batch was sampled: the interval
        [old_ptr, new_ptr) of the ring walk, with wraparound
        (worker.py:242-261).  Leaf indices are physical; they map back to
        the logical walk through :meth:`_log_block` (the identity for
        G == 1)."""
        K = self.cfg.seqs_per_block
        with self.lock:
            new_ptr = self.block_ptr
            n = self._log_block(idxes // K)
            if new_ptr > old_ptr:
                mask = (n < old_ptr) | (n >= new_ptr)
            elif new_ptr < old_ptr:
                mask = (n < old_ptr) & (n >= new_ptr)
            else:
                mask = np.ones_like(idxes, dtype=bool)
            self.tree.update(idxes[mask], priorities[mask])
            self.training_steps += 1
            self.sum_loss += float(loss)
            traces = (self._slot_trace[idxes[mask] // K]
                      if EVENTS.armed and mask.any() else None)
        if traces is not None:
            _emit_flows("replay.priority_feedback", traces, "f")

    def note_corrupt_block(self) -> None:
        """A wire-format integrity check failed and the block was dropped:
        count it so the log plane surfaces a garbling transport."""
        with self.lock:
            self.corrupt_blocks += 1

    def note_updates(self, n: int, loss_sum: float) -> None:
        """Learner-side update accounting for updates whose priority
        feedback never crosses the host (``cfg.in_graph_per``: the
        super-step scatters it on the device), so ``stats()`` stays
        live."""
        with self.lock:
            self.training_steps += n
            self.sum_loss += float(loss_sum)

    # ------------------------------------------------------------- snapshot
    # scalar state that rides the replay snapshot's JSON meta (arrays ride
    # the binary payload); order is the wire order of the restore loop
    STATE_COUNTERS = ("block_ptr", "size", "env_steps", "num_episodes",
                      "episode_reward", "training_steps", "sum_loss",
                      "corrupt_blocks")

    def state_spec(self):
        """(name, shape, dtype) of the on-disk replay-snapshot payload: the
        ring arrays (the block.py slot layout reused at whole-ring scale)
        plus the PER leaf vector."""
        return _ring_spec(self.cfg, self.action_dim) + (
            ("tree_leaves", (self.tree.capacity,), np.float64),)

    def write_state(self, path: str) -> Dict[str, Any]:
        """Serialise the full replay state into ``path`` — one flat binary
        laid out by :func:`~r2d2_tpu_torch.replay.block.slot_layout` over
        :meth:`state_spec`.  Returns the JSON-able meta (counters, the
        sampling RNG, the layout fingerprint) that :meth:`read_state`
        validates against.  The lock covers only the copy into the page
        cache; the flush to disk runs with it released.

        Host-ring buffers only: a device ring's bulk arrays (and under
        ``in_graph_per`` its priorities) live on the device, and those runs
        save learner state alone."""
        if self.device_ring is not None:
            raise RuntimeError(
                "replay snapshot requires the host ring; device_replay "
                "runs persist learner state only")
        spec = self.state_spec()
        nbytes, offsets = slot_layout(spec)
        mm = np.memmap(path, np.uint8, "w+", shape=(nbytes,))
        views = slot_views(mm, spec, offsets, nbytes, 0)
        with self.lock:
            for name, _, _ in spec:
                views[name][:] = (self.tree.leaf_values()
                                  if name == "tree_leaves"
                                  else getattr(self, name))
            meta = dict(
                layout=_layout_fingerprint(spec),
                nbytes=nbytes,
                counters={k: getattr(self, k) for k in self.STATE_COUNTERS},
                rng_state=self.tree.rng.bit_generator.state,
                tree_total=self.tree.total,
            )
        del views
        mm.flush()
        del mm
        return meta

    def read_state(self, path: str, meta: Dict[str, Any]) -> None:
        """Restore the state :meth:`write_state` captured.  Raises
        ``ValueError`` when the snapshot was written under a different
        buffer geometry (the caller warns and resumes cold instead of
        ingesting a misaligned ring)."""
        spec = self.state_spec()
        nbytes, offsets = slot_layout(spec)
        want = _layout_fingerprint(spec)
        if meta.get("layout") != want:
            raise ValueError(
                "replay snapshot layout mismatch — written under a "
                "different buffer geometry/config; resuming with a cold "
                f"buffer (snapshot {meta.get('layout')} vs config {want})")
        mm = np.memmap(path, np.uint8, "r", shape=(nbytes,))
        views = slot_views(mm, spec, offsets, nbytes, 0)
        with self.lock:
            for name, _, _ in spec:
                if name == "tree_leaves":
                    self.tree.load_leaves(views[name])
                else:
                    getattr(self, name)[:] = views[name]
            c = meta["counters"]
            self.block_ptr = int(c["block_ptr"])
            self.size = int(c["size"])
            self.env_steps = int(c["env_steps"])
            self.num_episodes = int(c["num_episodes"])
            self.episode_reward = float(c["episode_reward"])
            self.training_steps = int(c["training_steps"])
            self.sum_loss = float(c["sum_loss"])
            self.corrupt_blocks = int(c.get("corrupt_blocks", 0))
            if meta.get("rng_state") is not None:
                self.tree.rng.bit_generator.state = meta["rng_state"]
        del views
        del mm

    # ---------------------------------------------------------- data health
    def data_health(self) -> Dict[str, Any]:
        """Learning-health view of the replay plane: the PER
        distribution's effective sample size and fixed-bucket priority
        histogram over the sum-tree leaves, the cumulative replay ratio
        (samples consumed per transition inserted), and per-member
        sampled-row counts.

        Under ``in_graph_per`` the priority leaves live on the device (the
        host tree stays empty): ``priorities`` is then None, since reading
        the leaves every log interval would cost a D2H copy and a
        synchronisation beside the learner's dispatches."""
        from r2d2_tpu_torch.telemetry.learnhealth import (
            priority_health,
            replay_ratio,
        )

        in_graph = self.cfg.in_graph_per and self.device_ring is not None
        with self.lock:
            leaves = None if in_graph else self.tree.leaf_values()
            training_steps = self.training_steps
            env_steps = self.env_steps
            samples = dict(self.samples_per_member)
        return dict(
            replay_ratio=replay_ratio(self.cfg, training_steps, env_steps),
            samples_per_member=samples,
            priorities=None if leaves is None else priority_health(leaves),
        )

    # ---------------------------------------------------------------- stats
    def stats(self) -> Dict[str, float]:
        """Counters for the log plane; the episode return, episode count
        and loss sum are read and reset."""
        with self.lock:
            s = dict(
                size=self.size, env_steps=self.env_steps,
                training_steps=self.training_steps,
                num_episodes=self.num_episodes,
                episode_reward=self.episode_reward,
                sum_loss=self.sum_loss,
                corrupt_blocks=self.corrupt_blocks,
                # the in-process buffer has no owner processes to lose;
                # the key keeps one schema with the sharded plane's
                shard_respawns=0,
                blocks_per_member=dict(self.blocks_per_member),
            )
            self.episode_reward = 0.0
            self.num_episodes = 0
            self.sum_loss = 0.0
        return s
