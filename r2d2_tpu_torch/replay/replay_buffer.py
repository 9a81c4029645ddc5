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

Not ported yet (ROADMAP.md A, items 4-5): the device ring and its
``sample_meta``, the sharded plane's ``serve_sample``, and the replay
snapshot (``write_state``/``read_state``).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import numpy as np

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.replay.block import Block
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
                 rng: Optional[np.random.Generator] = None):
        self.cfg = cfg
        self.action_dim = action_dim
        spec = _ring_spec(cfg, action_dim)
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

    @property
    def ready(self) -> bool:
        return self.size >= self.cfg.learning_starts

    # ------------------------------------------------------------------ add
    def add(self, block: Block, priorities: np.ndarray,
            episode_reward: Optional[float]) -> None:
        """Overwrite the ring slot at ``block_ptr`` (worker.py:141-161)."""
        cfg = self.cfg
        K = cfg.seqs_per_block
        with self.lock:
            slot = self.block_ptr
            self.tree.update(np.arange(slot * K, (slot + 1) * K,
                                       dtype=np.int64), priorities)
            self.size -= int(self.block_learning_total[slot])

            k = block.num_sequences
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

            self.block_ptr = (slot + 1) % cfg.num_blocks
            self._slot_cut_ts[slot] = block.cut_ts
            self._slot_add_ts[slot] = time.time()
            self._slot_trace[slot] = block.trace_id
            m = int(block.member_id)
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
        B = batch_size or self.cfg.batch_size
        with self.lock:
            if self.size == 0:
                raise RuntimeError(
                    "sample_batch on an empty buffer; wait for add() (use "
                    "`ready` to gate on learning_starts)")
            idxes, is_weights = self.tree.sample(B)
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

    def _gather_rows(self, idxes: np.ndarray) -> Dict[str, np.ndarray]:
        """The vectorised fancy-index gather of the per-row batch fields
        for leaf ``idxes``.  Caller holds the lock.

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
        return dict(
            obs=self.obs[bcol, time_idx],
            last_action=self.last_action[bcol, time_idx].astype(np.float32),
            last_reward=self.last_reward[bcol, time_idx],
            hidden=self.hidden[block_idx, seq_idx],
            action=self.action[bcol, widx].astype(np.int32),
            n_step_reward=self.n_step_reward[bcol, widx],
            n_step_gamma=self.n_step_gamma[bcol, widx],
            burn_in=burn_in.astype(np.int32),
            learning=learning.astype(np.int32),
            forward=forward.astype(np.int32),
        )

    # ------------------------------------------------------- priority update
    def update_priorities(self, idxes: np.ndarray, priorities: np.ndarray,
                          old_ptr: int, loss: float) -> None:
        """Write back learner priorities, discarding indices whose ring slots
        were overwritten since the batch was sampled: the interval
        [old_ptr, new_ptr) of the ring walk, with wraparound
        (worker.py:242-261)."""
        K = self.cfg.seqs_per_block
        with self.lock:
            new_ptr = self.block_ptr
            n = idxes // K
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

    def note_updates(self, n: int, loss_sum: float) -> None:
        """Learner-side update accounting for updates whose priority
        feedback never crosses the host, so ``stats()`` stays live."""
        with self.lock:
            self.training_steps += n
            self.sum_loss += float(loss_sum)

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
