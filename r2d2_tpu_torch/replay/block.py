"""Block wire format: the actor → replay unit of experience.

Port of ``r2d2_tpu/replay/block.py`` (numpy throughout, so a block the port
cuts is the block the JAX package cuts, bit for bit), with the sharded
replay plane's sample-slab layout (``batch_slot_spec``).

Capability-parity with the reference's ``Block`` dataclass (worker.py:23-36)
and ``LocalBuffer`` (worker.py:395-497): an episode is cut into blocks of up
to ``block_length`` env steps; each block carries the observation stream
*including a burn-in prefix carried over from the previous block*, per-step
n-step returns and bootstrap discounts (terminality encoded as a zero
discount tail instead of done flags), stored recurrent states at sequence
starts, per-sequence window sizes, and actor-computed initial priorities.

Intentional divergence from the reference: stored hidden states are recorded
at each sequence's **burn-in start** (the R2D2 paper's scheme).  The
reference samples them at ``i * learning_steps`` into the buffer
(worker.py:461), which for blocks whose carried burn-in prefix is shorter
than ``burn_in_steps`` (i.e. the first block of every episode) feeds a state
recorded *after* the burn-in window it is unrolled over.  The reference's
indexing is available as a compat switch
(``Config.stored_hidden_mode="seq_start"``) so the divergence can be A/B'd;
the two schemes coincide whenever the carried prefix is full.
"""
from __future__ import annotations

import dataclasses
import math
import time
import zlib
from typing import List, Optional, Tuple

import numpy as np

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.utils.math import (
    mixed_td_errors,
    n_step_gamma_tail,
    n_step_return,
)


@dataclasses.dataclass
class Block:
    """One actor-produced chunk of experience.

    Array shapes (S = env steps in the block, P = burn-in prefix length,
    K = number of sequences, A = action dim, layers/H = LSTM geometry):

    - ``obs``:          (P + S + 1, *obs_shape) uint8 — includes next-obs tail
    - ``last_action``:  (P + S + 1, A) bool (one-hot)
    - ``last_reward``:  (P + S + 1,) float32
    - ``action``:       (S,) uint8
    - ``n_step_reward``:(S,) float32
    - ``n_step_gamma``: (S,) float32 — 0 tail encodes terminal
    - ``hidden``:       (K, 2, layers, H) float32 — state at burn-in start
    - ``burn_in_steps``/``learning_steps``/``forward_steps``: (K,) uint8
    """
    obs: np.ndarray
    last_action: np.ndarray
    last_reward: np.ndarray
    action: np.ndarray
    n_step_reward: np.ndarray
    n_step_gamma: np.ndarray
    hidden: np.ndarray
    num_sequences: int
    burn_in_steps: np.ndarray
    learning_steps: np.ndarray
    forward_steps: np.ndarray
    # block lineage (telemetry/tracing.py, docs/OBSERVABILITY.md):
    # ``cut_ts`` is the wall-clock time the block was cut (always
    # stamped — one time.time() per block, which feeds the
    # pipeline.block_age_at_train_s decomposition); ``trace_id`` is the
    # nonzero flow id of an armed capture window (0 in steady state —
    # the capture flag that keeps disarmed overhead at zero);
    # ``member_id`` is the population member that produced the block
    # (league/population.py — stamped by the fleet-side producer, 0 for
    # non-population runs), so per-member experience flow is countable
    # at every hop (replay stats, population.* telemetry)
    cut_ts: float = 0.0
    trace_id: int = 0
    member_id: int = 0


def assemble_block(cfg: Config, *, obs: np.ndarray, last_action: np.ndarray,
                   last_reward: np.ndarray, hidden_stream: np.ndarray,
                   actions: np.ndarray, rewards: np.ndarray,
                   qvals: np.ndarray, prefix: int, size: int, done: bool
                   ) -> Tuple[Block, np.ndarray]:
    """The block math shared by :class:`LocalBuffer` (list-backed) and
    :class:`VectorLocalBuffer` (preallocated-array-backed): per-sequence
    window sizes (worker.py:471-474), stored-hidden selection, n-step
    targets, and the actor-side initial priorities (worker.py:477-483 —
    plain max-Q n-step TD, no value rescale / double-Q, replicating the
    reference's asymmetry vs the learner).

    ``obs``/``last_action``/``last_reward``/``hidden_stream`` are the full
    (prefix + size + 1)-entry streams; ``qvals`` is (size+1, A) with the
    bootstrap value (zeros when ``done``) in the last row.  The arrays are
    stored in the Block as-is — callers reusing backing storage must pass
    copies.
    """
    L, n = cfg.learning_steps, cfg.forward_steps
    c = prefix
    num_sequences = math.ceil(size / L)

    gamma_tail = n_step_gamma_tail(size, n, cfg.gamma, done)
    nstep_r = n_step_return(np.asarray(rewards, np.float32), n, cfg.gamma)

    # per-sequence window sizes (worker.py:471-474 invariants)
    seq_ids = np.arange(num_sequences)
    burn_in = np.minimum(seq_ids * L + c, cfg.burn_in_steps).astype(np.uint8)
    learning = np.minimum(L, size - seq_ids * L).astype(np.uint8)
    forward = np.minimum(n, size + 1 - np.cumsum(learning)).astype(np.uint8)
    assert forward[-1] == 1 and burn_in[0] == min(c, cfg.burn_in_steps)

    # recurrent state at each sequence's burn-in start (paper-correct; see
    # module docstring for the divergence from worker.py:461), or the
    # reference's own indexing under stored_hidden_mode="seq_start"
    if cfg.stored_hidden_mode == "seq_start":
        hidden_idx = seq_ids * L
    else:
        hidden_idx = c + seq_ids * L - burn_in.astype(np.int64)
    hiddens = np.asarray(hidden_stream[hidden_idx], np.float32)

    max_forward = min(size, n)
    max_q = qvals[max_forward:size + 1].max(axis=1)
    max_q = np.pad(max_q, (0, max_forward - 1), mode="edge")
    taken_q = qvals[np.arange(size), actions]
    td = np.abs(nstep_r + gamma_tail * max_q - taken_q).astype(np.float32)
    priorities = np.zeros(cfg.seqs_per_block, np.float32)
    priorities[:num_sequences] = mixed_td_errors(td, learning)

    block = Block(
        obs=obs, last_action=last_action, last_reward=last_reward,
        action=actions, n_step_reward=nstep_r, n_step_gamma=gamma_tail,
        hidden=hiddens, num_sequences=num_sequences,
        burn_in_steps=burn_in, learning_steps=learning,
        forward_steps=forward,
        cut_ts=time.time(),   # block-lineage birth stamp (Block docstring)
    )
    return block, priorities


# --------------------------------------------------------------------------
# block <-> shared-memory slot (the process-fleet transport's wire format)
# --------------------------------------------------------------------------

def block_slot_spec(cfg: Config, action_dim: int):
    """(name, max shape, dtype) of ONE preallocated block slot — the wire
    format of the shared-memory block channel (parallel/actor_procs.py).

    DERIVED from the replay ring's own layout (replay_buffer._data_spec /
    _count_spec with the slot axis dropped) plus the actor-computed
    initial priorities, so the wire format cannot drift from the ring a
    future field/dtype change lands in: a fleet subprocess serialises a
    Block with a handful of vectorised array copies and the trainer's
    ingest reconstructs zero-copy views — bulk experience never goes
    through pickle."""
    # lazy import: replay_buffer imports this module (Block)
    from r2d2_tpu_torch.replay.replay_buffer import _count_spec, _data_spec

    per_block = tuple((name, shape[1:], dtype)
                      for name, shape, dtype in _data_spec(cfg, action_dim))
    # of the accounting arrays, only the per-sequence windows travel;
    # first_burn_in / block_learning_total are derived at add() time
    windows = tuple((name, shape[1:], dtype)
                    for name, shape, dtype in _count_spec(cfg)
                    if name in ("burn_in_steps", "learning_steps",
                                "forward_steps"))
    return per_block + windows + (
        ("priorities", (cfg.seqs_per_block,), np.float32),
        # block lineage (telemetry/tracing.py): the cut wall-clock stamp
        # (always written — feeds the pipeline.* latency histograms), the
        # capture-window flow id (0 when no capture is armed), and the
        # population member id (league/population.py; 0 outside a
        # population run).  Deliberately OUTSIDE the slot CRC: telemetry,
        # not experience — a garbled stamp must never cost a valid block
        ("cut_ts", (1,), np.float64),
        ("trace_id", (1,), np.int64),
        ("member_id", (1,), np.int64),
        # integrity word: CRC32 over the slot's used payload bytes + the
        # shape header, written LAST by the producer.  A torn write (a
        # producer SIGKILLed mid-slot) or garbled slab shows up as a
        # mismatch at ingest, where the trainer drops the block instead of
        # feeding torn experience to the learner (actor_procs.ingest_once).
        ("crc32", (1,), np.uint32),)


def batch_slot_spec(cfg: Config, action_dim: int, batch_size: int):
    """(name, shape, dtype) of ONE preassembled sample-batch RPC slot —
    the wire format of the sharded replay plane's stratified sample RPC
    (parallel/replay_shards.py): request words in, a preassembled batch
    back, over one preallocated shared-memory slab per shard.

    The row fields mirror — by name, shape and dtype — the batch
    ``ReplayBuffer.sample_batch`` assembles, so the trainer-side
    concatenation of K shard responses is byte-compatible with the
    in-process K=1 batch and the learner never special-cases the
    transport.  ``prios`` travel RAW (``td**alpha`` leaf values, f64)
    instead of IS weights: normalisation by the minimum sampled priority
    happens across ALL shards' rows at once (the K=1 scheme), and
    ``idxes`` are shard-LOCAL leaf indices the trainer offsets into the
    global leaf space.  Rows are sized for the full ``batch_size`` —
    under skewed priority mass one shard can legitimately serve the
    whole batch.

    Request region (trainer-written): ``req_n`` rows wanted, ``req_seq``
    (a retry supersedes older tokens), ``req_crc`` written last.
    Response region (shard-written): the rows above plus ``rsp_n`` rows
    actually served (< req_n only when the shard drained empty under a
    stale mass vector), the shard's local FIFO ``rsp_block_ptr`` (the
    priority-feedback stale mask), ``rsp_env_steps``, ``rsp_seq`` and
    ``rsp_crc`` — written LAST, the block channel's torn-write
    discipline."""
    B, T, L = batch_size, cfg.seq_len, cfg.learning_steps
    return (
        ("obs", (B, T, *cfg.stored_obs_shape), np.uint8),
        ("last_action", (B, T, action_dim), np.float32),
        ("last_reward", (B, T), np.float32),
        ("hidden", (B, 2, cfg.lstm_layers, cfg.hidden_dim), np.float32),
        ("action", (B, L), np.int32),
        ("n_step_reward", (B, L), np.float32),
        ("n_step_gamma", (B, L), np.float32),
        ("burn_in", (B,), np.int32),
        ("learning", (B,), np.int32),
        ("forward", (B,), np.int32),
        ("prios", (B,), np.float64),
        ("idxes", (B,), np.int64),
        # block-lineage ages per served row (seconds since cut / since
        # ring add, measured shard-side at gather time — the shard owns
        # the stamps; telemetry/tracing.py).  Outside BATCH_ROW_FIELDS,
        # hence outside the response CRC: telemetry, not experience
        ("ages", (B, 2), np.float32),
        ("req_n", (1,), np.int64),
        ("req_seq", (1,), np.int64),
        ("req_crc", (1,), np.uint32),
        ("rsp_n", (1,), np.int64),
        ("rsp_block_ptr", (1,), np.int64),
        ("rsp_env_steps", (1,), np.int64),
        ("rsp_seq", (1,), np.int64),
        ("rsp_crc", (1,), np.uint32),
    )


# the response-payload fields a sample-RPC CRC covers, in slot order —
# shared by the shard-side writer and the trainer-side verifier
# (parallel/replay_shards.py) so the two can never drift
BATCH_ROW_FIELDS = ("obs", "last_action", "last_reward", "hidden",
                    "action", "n_step_reward", "n_step_gamma", "burn_in",
                    "learning", "forward", "prios", "idxes")


# The ONE CRC convention every channel shares: int64 header words first,
# then the payload arrays in their declared order, masked to 32 bits.
# The transport modules (here, serving/wire.py, replay/netwire.py and
# parallel/replay_shards.py) import it rather than restate it.
CRC_MASK = 0xFFFFFFFF


def payload_crc32(header, arrays) -> int:
    """CRC32 over ``header`` (a sequence of ints, hashed as int64 words —
    covering the shape/token metadata so a header/payload mismatch is
    caught too) followed by ``arrays`` (numpy views, hashed in order).

    Arrays hash through the buffer protocol, NOT ``.tobytes()``: the
    byte stream (and therefore the CRC) is identical, but tobytes
    copies the whole payload first — at the sharded replay plane's
    batch-response scale (tens of MB per RPC) that copy cost as much
    as the hash itself.  Non-contiguous views still pay one compaction
    copy (``ascontiguousarray``).

    An empty array adds no bytes and is skipped: a memoryview of a
    zero-row array cannot be cast, and the reference raises there, which
    kills a replay shard that answers an empty sample (ROADMAP.md C 9).
    The CRC of every input the reference accepts is unchanged."""
    c = zlib.crc32(np.asarray(list(header), np.int64).tobytes())
    for a in arrays:
        if a.size:
            c = zlib.crc32(memoryview(np.ascontiguousarray(a)).cast("B"), c)
    return c & CRC_MASK


# (field, used-length selector) pairs of the payload a slot CRC covers —
# shared by the producer (write_block) and the verifying consumer so the
# two can never drift
_CRC_FIELDS = (("obs", "n_obs"), ("last_action", "n_obs"),
               ("last_reward", "n_obs"), ("action", "n_steps"),
               ("n_step_reward", "n_steps"), ("n_step_gamma", "n_steps"),
               ("hidden", "k"), ("burn_in_steps", "k"),
               ("learning_steps", "k"), ("forward_steps", "k"))


def slot_crc(views: dict, k: int, n_obs: int, n_steps: int) -> int:
    """CRC32 of a block slot's used payload bytes (plus the shape header,
    so a header/payload mismatch is also caught)."""
    used = dict(k=k, n_obs=n_obs, n_steps=n_steps)
    return payload_crc32(
        (k, n_obs, n_steps),
        [views[name][:used[sel]] for name, sel in _CRC_FIELDS]
        + [views["priorities"]])


def slot_layout(spec) -> Tuple[int, dict]:
    """(slot_nbytes, {name: byte offset}) for a :func:`block_slot_spec`,
    every array 8-byte aligned so the shm views are properly aligned for
    their dtypes."""
    offsets, off = {}, 0
    for name, shape, dtype in spec:
        off = (off + 7) & ~7
        offsets[name] = off
        off += int(np.prod(shape)) * np.dtype(dtype).itemsize
    return (off + 7) & ~7, offsets


def slot_views(buf, spec, offsets: dict, slot_nbytes: int, slot: int) -> dict:
    """Numpy views of slot ``slot`` inside a shared-memory buffer — the
    same call serves the producer (writes) and the consumer (zero-copy
    reads)."""
    base = slot * slot_nbytes
    return {name: np.ndarray(shape, dtype=dtype, buffer=buf,
                             offset=base + offsets[name])
            for name, shape, dtype in spec}


def write_block(views: dict, block: Block, priorities: np.ndarray
                ) -> Tuple[int, int, int]:
    """Serialise ``block`` into a slot's views.  Returns the shape header
    ``(num_sequences, n_obs, n_steps)`` — the only thing that crosses the
    metadata queue (a tuple of ints; the arrays travel through shm)."""
    k = block.num_sequences
    n_obs = block.obs.shape[0]
    n_steps = block.action.shape[0]
    views["obs"][:n_obs] = block.obs
    views["last_action"][:n_obs] = block.last_action
    views["last_reward"][:n_obs] = block.last_reward
    views["action"][:n_steps] = block.action
    views["n_step_reward"][:n_steps] = block.n_step_reward
    views["n_step_gamma"][:n_steps] = block.n_step_gamma
    views["hidden"][:k] = block.hidden
    views["burn_in_steps"][:k] = block.burn_in_steps
    views["learning_steps"][:k] = block.learning_steps
    views["forward_steps"][:k] = block.forward_steps
    views["priorities"][:] = priorities
    # lineage stamps travel outside the CRC (block_slot_spec) — always
    # written so a recycled slot can never leak its previous block's id
    views["cut_ts"][0] = block.cut_ts
    views["trace_id"][0] = block.trace_id
    views["member_id"][0] = block.member_id
    # CRC last: a slot is only valid once its integrity word matches
    views["crc32"][0] = slot_crc(views, k, n_obs, n_steps)
    return k, n_obs, n_steps


def read_block(views: dict, k: int, n_obs: int, n_steps: int
               ) -> Tuple[Block, np.ndarray]:
    """Reconstruct ``(block, priorities)`` from a slot's views — zero
    copy: the Block fields alias the shm slab, valid until the slot is
    released back to the free list (ReplayBuffer.add copies them into the
    ring / stages them to the device before that happens)."""
    block = Block(
        obs=views["obs"][:n_obs],
        last_action=views["last_action"][:n_obs],
        last_reward=views["last_reward"][:n_obs],
        action=views["action"][:n_steps],
        n_step_reward=views["n_step_reward"][:n_steps],
        n_step_gamma=views["n_step_gamma"][:n_steps],
        hidden=views["hidden"][:k],
        num_sequences=k,
        burn_in_steps=views["burn_in_steps"][:k],
        learning_steps=views["learning_steps"][:k],
        forward_steps=views["forward_steps"][:k],
        cut_ts=float(views["cut_ts"][0]),
        trace_id=int(views["trace_id"][0]),
        member_id=int(views["member_id"][0]),
    )
    return block, views["priorities"]


class LocalBuffer:
    """Actor-side accumulator that cuts episodes into Blocks.

    Mirrors the reference's LocalBuffer lifecycle (worker.py:413-497):
    ``reset`` at episode start, ``add`` once per env step, ``finish`` at
    episode end / block boundary / episode-step cap.  ``finish`` retains the
    trailing ``burn_in_steps + 1`` entries so the next block of the same
    episode starts with a warm burn-in prefix.
    """

    def __init__(self, cfg: Config, action_dim: int):
        self.cfg = cfg
        self.action_dim = action_dim
        self.hidden_shape = (2, cfg.lstm_layers, cfg.hidden_dim)
        self.curr_burn_in_steps = 0
        self.size = 0

    def __len__(self) -> int:
        return self.size

    def reset(self, init_obs: np.ndarray) -> None:
        noop_one_hot = np.zeros(self.action_dim, dtype=bool)
        noop_one_hot[0] = True
        self.obs_buffer: List[np.ndarray] = [np.asarray(init_obs, dtype=np.uint8)]
        self.last_action_buffer: List[np.ndarray] = [noop_one_hot]
        self.last_reward_buffer: List[float] = [0.0]
        self.hidden_buffer: List[np.ndarray] = [np.zeros(self.hidden_shape, np.float32)]
        self.action_buffer: List[int] = []
        self.reward_buffer: List[float] = []
        self.qval_buffer: List[np.ndarray] = []
        self.curr_burn_in_steps = 0
        self.size = 0
        self.sum_reward = 0.0
        self.done = False

    def add(self, action: int, reward: float, next_obs: np.ndarray,
            q_value: np.ndarray, hidden: np.ndarray) -> None:
        """Record one env step.  ``hidden`` is the recurrent state *after*
        consuming the obs that produced ``q_value`` (so buffers stay aligned:
        entry i is the state with which obs i is consumed)."""
        one_hot = np.zeros(self.action_dim, dtype=bool)
        one_hot[action] = True
        self.action_buffer.append(action)
        self.reward_buffer.append(reward)
        self.obs_buffer.append(np.asarray(next_obs, dtype=np.uint8))
        self.last_action_buffer.append(one_hot)
        self.last_reward_buffer.append(reward)
        self.hidden_buffer.append(np.asarray(hidden, np.float32).reshape(self.hidden_shape))
        self.qval_buffer.append(np.asarray(q_value, np.float32).reshape(self.action_dim))
        self.sum_reward += reward
        self.size += 1

    def finish(self, last_qval: Optional[np.ndarray] = None
               ) -> Tuple[Block, np.ndarray, Optional[float]]:
        """Close the current chunk into a Block.

        ``last_qval=None`` means the episode terminated (bootstrap discount
        tail is zeroed); otherwise it is the Q-value at the final obs, used to
        bootstrap a truncated chunk (worker.py:443-453).

        Returns ``(block, per-leaf priorities, episode_reward or None)``.
        """
        cfg = self.cfg
        assert 0 < self.size <= cfg.block_length
        size = self.size
        c = self.curr_burn_in_steps
        self.done = last_qval is None

        qvals = list(self.qval_buffer)
        if self.done:
            qvals.append(np.zeros(self.action_dim, np.float32))
        else:
            qvals.append(np.asarray(last_qval, np.float32).reshape(self.action_dim))
        qvals = np.stack(qvals)                       # (size+1, A)

        block, priorities = assemble_block(
            cfg,
            obs=np.stack(self.obs_buffer),
            last_action=np.stack(self.last_action_buffer),
            last_reward=np.asarray(self.last_reward_buffer, np.float32),
            hidden_stream=np.stack(self.hidden_buffer),
            actions=np.asarray(self.action_buffer, np.uint8),
            rewards=np.asarray(self.reward_buffer, np.float32),
            qvals=qvals, prefix=c, size=size, done=self.done)
        episode_reward = self.sum_reward if self.done else None

        # carry the burn-in prefix into the next block (worker.py:486-493)
        keep = cfg.burn_in_steps + 1
        self.obs_buffer = self.obs_buffer[-keep:]
        self.last_action_buffer = self.last_action_buffer[-keep:]
        self.last_reward_buffer = self.last_reward_buffer[-keep:]
        self.hidden_buffer = self.hidden_buffer[-keep:]
        self.action_buffer.clear()
        self.reward_buffer.clear()
        self.qval_buffer.clear()
        self.curr_burn_in_steps = len(self.obs_buffer) - 1
        self.size = 0

        return block, priorities, episode_reward


class VectorLocalBuffer:
    """Batched LocalBuffer: one preallocated array set shared by N lanes.

    The per-env-step host cost of N :class:`LocalBuffer`\\ s (5 list appends
    + 2 small array builds per lane per step — the reference's per-actor
    hot loop, worker.py:426-435) becomes a handful of vectorized
    fancy-indexed writes per *batched* step, one numpy op per field for
    ALL lanes at once.  Blocks and priorities are bit-identical to the
    list-backed implementation (shared :func:`assemble_block`; oracle test
    in tests/test_local_buffer.py).

    Lifecycle per lane mirrors LocalBuffer: ``reset_lane`` at episode
    start, one ``add_batch`` row per env step, ``finish(i)`` at episode
    end / block boundary / step cap (the trailing ``burn_in_steps + 1``
    stream entries are retained in place as the next block's warm
    prefix).
    """

    def __init__(self, cfg: Config, action_dim: int, num_lanes: int):
        self.cfg = cfg
        self.action_dim = action_dim
        N, B = num_lanes, cfg.block_length
        cap = cfg.burn_in_steps + B + 1  # obs-stream entries per block max
        self.cap = cap
        self.obs = np.zeros((N, cap, *cfg.stored_obs_shape), np.uint8)
        self.last_action = np.zeros((N, cap, action_dim), bool)
        self.last_reward = np.zeros((N, cap), np.float32)
        self.hidden = np.zeros(
            (N, cap, 2, cfg.lstm_layers, cfg.hidden_dim), np.float32)
        self.action = np.zeros((N, B), np.uint8)
        self.reward = np.zeros((N, B), np.float32)
        self.qval = np.zeros((N, B + 1, action_dim), np.float32)
        self.prefix = np.zeros(N, np.int64)      # carried burn-in length c
        self.size = np.zeros(N, np.int64)        # env steps in current block
        self.sum_reward = np.zeros(N, np.float64)

    def sizes(self) -> np.ndarray:
        """Per-lane current block sizes (read-only view)."""
        return self.size

    # every array attribute, i.e. the buffer's whole mutable state — the
    # actor snapshot payload (VectorActor.snapshot)
    _STATE_FIELDS = ("obs", "last_action", "last_reward", "hidden",
                     "action", "reward", "qval", "prefix", "size",
                     "sum_reward")

    def snapshot(self) -> dict:
        """Copy of the full buffer state (all lanes) for the resumable
        actor snapshot — in-progress blocks and carried burn-in prefixes
        survive a preemption with it."""
        return {k: getattr(self, k).copy() for k in self._STATE_FIELDS}

    def load_snapshot(self, snap: dict) -> None:
        """Restore state captured by :meth:`snapshot` (same geometry)."""
        for k in self._STATE_FIELDS:
            dst = getattr(self, k)
            if dst.shape != snap[k].shape:
                raise ValueError(
                    f"local-buffer snapshot field {k!r} has shape "
                    f"{snap[k].shape}, expected {dst.shape}")
            dst[:] = snap[k]

    def reset_lane(self, i: int, init_obs: np.ndarray) -> None:
        self.obs[i, 0] = np.asarray(init_obs, np.uint8)
        self.last_action[i, 0] = False
        self.last_action[i, 0, 0] = True  # noop one-hot
        self.last_reward[i, 0] = 0.0
        self.hidden[i, 0] = 0.0
        self.prefix[i] = 0
        self.size[i] = 0
        self.sum_reward[i] = 0.0

    def add_batch(self, idx: np.ndarray, actions: np.ndarray,
                  rewards: np.ndarray, next_obs: np.ndarray,
                  q: np.ndarray, hidden: np.ndarray) -> None:
        """Record one env step for every lane in ``idx``.

        ``next_obs``/``q``/``hidden`` are the full (N, ...) batched arrays
        (rows outside ``idx`` ignored); ``hidden`` rows are the state
        *after* consuming the obs that produced ``q`` (same alignment as
        LocalBuffer.add).
        """
        p = self.prefix[idx] + self.size[idx] + 1  # append position
        self.obs[idx, p] = next_obs[idx]
        self.last_action[idx, p] = False
        self.last_action[idx, p, actions[idx]] = True
        self.last_reward[idx, p] = rewards[idx]
        self.hidden[idx, p] = hidden[idx]
        s = self.size[idx]
        self.action[idx, s] = actions[idx]
        self.reward[idx, s] = rewards[idx]
        self.qval[idx, s] = q[idx]
        self.sum_reward[idx] += rewards[idx]
        self.size[idx] += 1

    def finish(self, i: int, last_qval: Optional[np.ndarray] = None
               ) -> Tuple[Block, np.ndarray, Optional[float]]:
        """Close lane ``i``'s current chunk into a Block (LocalBuffer.finish
        semantics: ``last_qval=None`` = terminated; returns
        ``(block, priorities, episode_reward or None)``)."""
        cfg = self.cfg
        size, c = int(self.size[i]), int(self.prefix[i])
        assert 0 < size <= cfg.block_length
        done = last_qval is None
        entries = c + size + 1

        qvals = self.qval[i, :size + 1].copy()
        qvals[size] = (np.zeros(self.action_dim, np.float32) if done
                       else np.asarray(last_qval, np.float32
                                       ).reshape(self.action_dim))

        block, priorities = assemble_block(
            cfg,
            # copies: the Block must not alias storage the next block reuses
            obs=self.obs[i, :entries].copy(),
            last_action=self.last_action[i, :entries].copy(),
            last_reward=self.last_reward[i, :entries].copy(),
            hidden_stream=self.hidden[i, :entries],  # fancy-indexed → copies
            actions=self.action[i, :size].copy(),
            rewards=self.reward[i, :size],
            qvals=qvals, prefix=c, size=size, done=done)
        episode_reward = float(self.sum_reward[i]) if done else None

        # retain the trailing burn_in+1 stream entries as the next block's
        # warm prefix (worker.py:486-493), in place
        keep = min(cfg.burn_in_steps + 1, entries)
        lo = entries - keep
        for arr in (self.obs, self.last_action, self.last_reward,
                    self.hidden):
            arr[i, :keep] = arr[i, lo:entries].copy()  # overlap-safe
        self.prefix[i] = keep - 1
        self.size[i] = 0

        return block, priorities, episode_reward
