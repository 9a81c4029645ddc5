"""Sharded replay plane: prioritized sampling across K owner processes.

Port of ``r2d2_tpu/parallel/replay_shards.py``.  The slots, the CRCs, the
RNG streams and the order they are drawn in are the reference's, so the
same blocks and seeds give the same batches and masses, bit for bit.  The
shard children are spawned, never forked (the trainer holds a CUDA
context), and hide every card from themselves before they build anything.

One replay process caps what the fleets can feed the learner: every block
ingest, priority update and batch gather contends on one core and one
lock.  ``cfg.replay_shards = K`` splits the ring across K spawn-started
**owner processes**, each running the standard
:class:`~r2d2_tpu_torch.replay.replay_buffer.ReplayBuffer` core over its
``num_blocks / K`` slot slice plus its own
:class:`~r2d2_tpu_torch.replay.sum_tree.SumTree`.  ``K = 1`` (the
default) keeps the in-process path — ``train._build`` only constructs
this plane for ``K > 1``.

Data planes (all over the ``replay/block.py`` slot/CRC shm wire format —
bulk arrays never pickle):

- **Ingest routing**: the trainer's block sink routes block ``n`` to
  shard ``n % K`` (round-robin — the same logical↔physical scheme the
  dp-sharded device ring uses), serialised into a free slot of the
  shard's preallocated ingest channel via
  :func:`~r2d2_tpu_torch.replay.block.write_block` (CRC last); the shard
  verifies :func:`~r2d2_tpu_torch.replay.block.slot_crc` and ``add``\\ s into
  its local ring.  After any number of adds the union of live blocks is
  exactly the K=1 ring's FIFO window.
- **Stratified sample RPCs with preassembled batches**: the trainer-side
  coordinator keeps a cross-shard **total-mass vector** fresh (each
  shard publishes ``(seq, values, crc)`` through a stats slab — the
  telemetry plane's convention) and allocates the B batch strata across
  shards by a global stratified draw over that vector
  (:func:`allocate_strata`): shard k receives the strata whose mass
  targets fall in its cumulative-mass interval, so content-for-content
  the marginal inclusion probability of every sequence is the K=1
  ``B·p/M`` exactly.  Each shard answers with a **preassembled batch**
  — its own stratified draw + fancy-index gather
  (``ReplayBuffer.serve_sample``) written straight into a preallocated
  response slab (:func:`~r2d2_tpu_torch.replay.block.batch_slot_spec`, CRC
  last) — so the learner thread only copies K slab views into one host
  buffer (pinned on a CUDA learner: the batch then crosses to the card
  in one copy, ``learner.packed_batch``).  Raw
  priorities travel with the rows; the coordinator applies the K=1
  zero-clamp + min-of-the-whole-batch IS normalisation globally.
- **Priority feedback fan-out**: the learner's ``update_priorities``
  call routes each row back to its owning shard (global leaf index //
  leaves-per-shard) with the shard's sample-time FIFO pointer; the
  shard's own ``ReplayBuffer.update_priorities`` applies the reference's
  stale-index masking locally.  Feedback across a shard respawn is
  dropped (generation-tagged): a restored ring may have lost the slots
  the indices named.

Failure story (composes with the chaos suite):

- a sample RPC is deadline-bounded (``cfg.replay_sample_timeout``); a
  timeout marks the shard suspect and its rows are **redistributed**
  over the healthy shards' mass (counted — the learner never stalls on
  a dead or SIGSTOPped shard);
- a garbled response (CRC mismatch — the ``garble_sample_response``
  chaos site flips slab bytes at receipt) is retried with a fresh seq;
- a dead shard is respawned by the supervised ``replay_watch`` loop and
  its slots **restored from the latest replay snapshot** (the plane
  reads it back through the run's Checkpointer); with no usable
  snapshot the shard comes up cold and its slots re-ingest fresh
  (degraded, counted in ``shard_respawns``);
- full-state recovery takes **per-shard snapshots**: ``write_state``
  runs a drain-then-save handshake (each shard first consumes every
  routed block and feedback message it has been sent, then writes its
  own ``ReplayBuffer.write_state`` payload next to the snapshot index),
  and ``--resume`` restores every shard mass-exact.

Everything publishes under the ``replay.shard.*`` telemetry namespace.
The reference's cross-process trace slab is ROADMAP.md A item 10: the
lineage hooks stay behind the disarmed ``EVENTS`` stand-in.
"""
from __future__ import annotations

import logging
import multiprocessing as mp
import os
import threading
import time
from multiprocessing import shared_memory
from queue import Empty
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.replay.block import (
    BATCH_ROW_FIELDS,
    Block,
    batch_slot_spec,
    block_slot_spec,
    payload_crc32,
    read_block,
    slot_crc,
    slot_layout,
    slot_views,
    write_block,
)
from r2d2_tpu_torch.telemetry.learnhealth import PRIO_EDGES, replay_ratio
from r2d2_tpu_torch.telemetry.registry import MetricsRegistry
from r2d2_tpu_torch.telemetry.slab import CounterMerger, StatsSlab, StatsSlabWriter
from r2d2_tpu_torch.telemetry.tracing import EVENTS
from r2d2_tpu_torch.utils.resilience import Deadline
from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS

log = logging.getLogger(__name__)

# (name, kind) schema of the shard stats slab — the coordinator's
# cross-shard mass vector rides here (telemetry/slab.py conventions:
# seq + CRC, torn publishes keep the previous good reading).  Counters
# are SESSION-LOCAL (an incarnation starts them at zero even after a
# snapshot restore) so the CounterMerger's respawn fold stays exact.
# The trailing gauges are the per-shard replay data-health view
# (telemetry/learnhealth.py): PER effective sample size + the
# fixed-bucket priority histogram, refreshed at most once a second by
# the owner (the leaf walk is not per-publish work).
SHARD_STAT_FIELDS: Tuple[Tuple[str, str], ...] = (
    ("tree_mass", "gauge"),
    ("size", "gauge"),
    ("blocks", "counter"),
    ("corrupt_blocks", "counter"),
    ("samples", "counter"),
    ("prio_updates", "counter"),
    ("incarnation", "gauge"),
    ("ess", "gauge"),
    ("ess_frac", "gauge"),
    ("positive_leaves", "gauge"),
) + tuple((f"prio_hist_{i}", "gauge")
          for i in range(len(PRIO_EDGES) + 1))

_SAVE_DRAIN_BUDGET = 15.0   # seconds a shard waits to consume every
                            # routed block/feedback before snapshotting
_INGEST_SEND_BUDGET = 2.0   # seconds the router waits for a free slot
                            # before dropping the block (dead shard —
                            # crash-lost experience, counted)


def allocate_strata(masses: np.ndarray, batch: int,
                    rng: np.random.Generator) -> np.ndarray:
    """Per-shard row counts of one global stratified draw over the
    cross-shard mass vector.

    The K=1 sampler splits total mass M into ``batch`` equal strata with
    one uniform target each; here each target is routed to the shard
    whose cumulative-mass interval contains it.  ``E[counts[k]] =
    batch · masses[k] / M`` exactly, and combined with each shard's own
    within-shard stratified draw the marginal inclusion probability of
    every leaf is the K=1 ``batch · p / M`` — content-for-content
    distribution equivalence (the oracle test in
    tests/test_replay_shards.py and tests/test_torch_replay_shards.py).
    """
    masses = np.asarray(masses, np.float64)
    total = masses.sum()
    if total <= 0:
        raise ValueError("cannot allocate strata over zero total mass")
    targets = (np.arange(batch) + rng.uniform(0.0, 1.0, batch)) \
        * (total / batch)
    cum = np.cumsum(masses)
    shard = np.minimum(np.searchsorted(cum, targets, side="right"),
                       len(masses) - 1)
    return np.bincount(shard, minlength=len(masses))


def sample_request_crc(views: dict, seq: int) -> int:
    """CRC32 of a sample request — header-only (the request payload IS
    the two header words), via the one shared convention."""
    return payload_crc32((seq, int(views["req_n"][0])), [])


def sample_response_crc(views: dict, seq: int) -> int:
    """CRC32 over a sample response's used rows plus its scalar header,
    written LAST by the shard; the trainer verifies before concatenating
    the slab views into the learner batch."""
    n = int(views["rsp_n"][0])
    return payload_crc32(
        (seq, n, int(views["rsp_block_ptr"][0]),
         int(views["rsp_env_steps"][0])),
        [views[f][:n] for f in BATCH_ROW_FIELDS])


# the response fields that stay host bookkeeping (never cross to the card)
_HOST_ROW_FIELDS = ("prios", "idxes", "ages")


def alloc_batch(spec, B: int, pin: bool) -> Dict[str, Any]:
    """Preallocated output rows for one assembled batch, shared by both
    transports: each verified response copies its rows straight into its
    span (ONE copy; a response slab or frame is reused or dropped by the
    next RPC, so the batch must own its bytes).  The learner's device
    fields and the IS weights share one host buffer
    (:func:`~r2d2_tpu_torch.learner.learner.packed_batch`, pinned when
    ``pin``: the batch crosses to the card in one copy); ``prios``,
    ``idxes`` and ``ages`` are plain arrays beside it."""
    from r2d2_tpu_torch.learner.learner import packed_batch

    shapes = {name: (shape, dtype) for name, shape, dtype in spec}
    dev = tuple((name, (B, *shapes[name][0][1:]), shapes[name][1])
                for name in BATCH_ROW_FIELDS
                if name not in _HOST_ROW_FIELDS)
    out = packed_batch(dev + (("is_weights", (B,), np.float32),), pin)
    for name in _HOST_ROW_FIELDS:
        out[name] = np.empty((B, *shapes[name][0][1:]), shapes[name][1])
    return out


def finish_batch(cfg: Config, out: Dict[str, Any], parts, lps: int,
                 ptrs: Dict[int, Tuple[int, int]],
                 env_steps: int) -> Dict[str, Any]:
    """The trainer-side tail of one assembled batch, shared by both
    transports: offset local leaf indices into the global space (shard k
    owns ``[k·lps, (k+1)·lps)``), then the K=1 IS-weight math across ALL
    shards' rows at once — clamp zero leaves to the min positive sampled
    priority, min-normalise (``SumTree.sample``'s scheme) — written into
    the packed buffer."""
    from r2d2_tpu_torch.learner.learner import PACKED_KEY

    idxes = out["idxes"]
    for p in parts:
        idxes[p["off"]:p["off"] + p["n"]] += p["shard"] * lps
    prios = out["prios"]
    pos = prios[prios > 0]
    min_p = pos.min() if pos.size else 1.0
    prios = np.maximum(prios, min_p)
    w = (prios / min_p) ** (-cfg.importance_sampling_exponent)
    out["is_weights"][...] = w
    batch = {name: out[name] for name in BATCH_ROW_FIELDS
             if name not in ("prios", "idxes")}
    # lineage decomposition (shard-side stamps; the sample loop observes
    # them into pipeline.*)
    batch["ages"] = out["ages"]
    return dict(batch, is_weights=out["is_weights"], idxes=idxes,
                block_ptr=ptrs, env_steps=env_steps,
                **{PACKED_KEY: out[PACKED_KEY]})


class _ShardChannels:
    """Trainer-side ends of ONE shard's transports: the block ingest
    channel (the fleet block channel's slot scheme with the producer and
    consumer roles swapped — the TRAINER writes, the shard reads) and
    the single-slot sample-RPC slab, plus the small control queues.
    Shard-private and retired wholesale on respawn, exactly like the
    fleet channels: a SIGKILLed process can die holding a queue's pipe
    lock, and corruption must not outlive the process that caused it."""

    INGEST_SLOTS = 4

    def __init__(self, cfg: Config, action_dim: int, ctx):
        self.block_spec = block_slot_spec(cfg, action_dim)
        self.block_nbytes, self.block_offsets = slot_layout(self.block_spec)
        self.ingest_shm = shared_memory.SharedMemory(
            create=True, size=self.INGEST_SLOTS * self.block_nbytes)
        self.free = ctx.Queue()
        self.ready = ctx.Queue()
        for i in range(self.INGEST_SLOTS):
            self.free.put(i)

        self.sample_spec = batch_slot_spec(cfg, action_dim, cfg.batch_size)
        self.sample_nbytes, self.sample_offsets = slot_layout(
            self.sample_spec)
        self.sample_shm = shared_memory.SharedMemory(
            create=True, size=self.sample_nbytes)
        self.sample_views = slot_views(
            self.sample_shm.buf, self.sample_spec, self.sample_offsets,
            self.sample_nbytes, 0)
        self.req_q = ctx.Queue()
        self.rsp_q = ctx.Queue()
        self.fb_q = ctx.Queue()     # priority feedback (tiny arrays)
        self.ctrl_q = ctx.Queue()   # save requests out
        self.snap_q = ctx.Queue()   # shard snapshot metas back

    def worker_info(self) -> dict:
        """The picklable handle a shard child needs to attach."""
        return dict(ingest=(self.ingest_shm.name, self.free, self.ready),
                    sample=(self.sample_shm.name, self.req_q, self.rsp_q),
                    fb=self.fb_q, ctrl=self.ctrl_q, snap=self.snap_q)

    def send_block(self, block: Block, priorities: np.ndarray,
                   episode_reward: Optional[float],
                   stop: Callable[[], bool]) -> bool:
        """Serialise one routed block into a free ingest slot (CRC
        written last) and post its shape header.  Bounded: returns False
        when no slot frees up within the send budget — the shard is dead
        or wedged, and the caller drops the block like any crash-lost
        experience instead of wedging the actor sink."""
        deadline = Deadline(_INGEST_SEND_BUDGET)
        while True:
            if stop():
                return False
            try:
                slot = self.free.get(timeout=deadline.poll_timeout(0.05))
                break
            except Empty:
                if deadline.expired:
                    return False
                continue
        views = slot_views(self.ingest_shm.buf, self.block_spec,
                           self.block_offsets, self.block_nbytes, slot)
        k, n_obs, n_steps = write_block(views, block, priorities)
        self.ready.put((slot, k, n_obs, n_steps, episode_reward))
        return True

    def close(self) -> None:
        self.sample_views = None
        for shm in (self.ingest_shm, self.sample_shm):
            try:
                shm.close()
            except BufferError:
                pass  # a late reader holds views; unlink still frees it
            try:
                shm.unlink()
            except FileNotFoundError:
                pass


def _shard_worker_main(cfg: Config, action_dim: int, shard_id: int,
                       incarnation: int, info: dict, stop_event,
                       stats_info, restore) -> None:
    """Entry point of one replay shard owner process.

    ``cfg`` is the already-sliced shard config (``buffer_capacity / K``);
    the worker is a single-threaded event loop over a plain
    :class:`ReplayBuffer`: drain ingest slots → serve one sample RPC →
    apply priority feedback → answer control requests → publish the
    stats-slab vector (mass, size, session counters).  ``restore`` is
    ``(ring_path, meta)`` from the latest replay snapshot (full-state
    ``--resume`` or a watchdog respawn); a failed restore comes up cold
    with a warning — its slots re-ingest fresh (degraded mode).

    The child hides every CUDA card from itself before it builds anything:
    the replay plane is host code, and a stray CUDA call must raise rather
    than open a second context on the trainer's card.
    """
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    buffer = ReplayBufferForShard(cfg, action_dim, shard_id, incarnation)
    restored = False
    if restore is not None:
        path, meta = restore
        try:
            buffer.read_state(path, meta)
            restored = True
        except (ValueError, OSError) as e:
            log.warning("replay shard%d: snapshot not restored (%s) — "
                        "starting cold, its slots re-ingest fresh",
                        shard_id, e)

    ingest_name, free_q, ready_q = info["ingest"]
    ingest_shm = shared_memory.SharedMemory(name=ingest_name)
    block_spec = block_slot_spec(cfg, action_dim)
    block_nbytes, block_offsets = slot_layout(block_spec)

    sample_name, req_q, rsp_q = info["sample"]
    sample_shm = shared_memory.SharedMemory(name=sample_name)
    sample_spec = batch_slot_spec(cfg, action_dim, cfg.batch_size)
    sample_nbytes, sample_offsets = slot_layout(sample_spec)
    sviews = slot_views(sample_shm.buf, sample_spec, sample_offsets,
                        sample_nbytes, 0)
    fb_q, ctrl_q, snap_q = info["fb"], info["ctrl"], info["snap"]

    writer = StatsSlabWriter(stats_info, SHARD_STAT_FIELDS)
    # session-local counters (start at zero every incarnation, even after
    # a restore — the trainer's CounterMerger folds across respawns)
    counters = dict(blocks=0, corrupt=0, samples=0, prio_updates=0)
    # per-shard data-health gauges (learnhealth plane): the ESS/histogram
    # leaf walk is refreshed at most once a second, NOT per publish —
    # publish fires per event-loop progress tick
    health = {"t": float("-inf"), "vals": {}}

    def data_health_vals() -> dict:
        now = time.monotonic()
        if now - health["t"] > 1.0:
            pr = buffer.data_health()["priorities"]
            vals = dict(ess=pr["ess"], ess_frac=pr["ess_frac"],
                        positive_leaves=pr["positive_leaves"])
            for i, c in enumerate(pr["hist"]):
                vals[f"prio_hist_{i}"] = c
            health["vals"] = vals
            health["t"] = now
        return health["vals"]

    def publish() -> None:
        writer.publish(dict(
            tree_mass=buffer.tree.total, size=buffer.size,
            blocks=counters["blocks"],
            corrupt_blocks=counters["corrupt"],
            samples=counters["samples"],
            prio_updates=counters["prio_updates"],
            incarnation=incarnation, **data_health_vals()))

    def ingest_once() -> bool:
        try:
            slot, k, n_obs, n_steps, ep = ready_q.get_nowait()
        except Empty:
            return False
        views = slot_views(ingest_shm.buf, block_spec, block_offsets,
                           block_nbytes, slot)
        if int(views["crc32"][0]) != slot_crc(views, k, n_obs, n_steps):
            # garbled in transit (chaos, torn producer): drop + count —
            # the slot still recycles, the content is crash-lost
            counters["corrupt"] += 1
            log.warning("replay shard%d: block slot %d failed CRC32 — "
                        "dropped", shard_id, slot)
            free_q.put(slot)
            return True
        block, prios = read_block(views, k, n_obs, n_steps)
        # the buffer copies the views into its ring before returning, so
        # releasing the slot after add() is safe (the fleet-ingest rule)
        buffer.add(block, prios, ep)
        free_q.put(slot)
        counters["blocks"] += 1
        return True

    def feedback_once() -> bool:
        try:
            idxes, prios, old_ptr, loss = fb_q.get_nowait()
        except Empty:
            return False
        buffer.update_priorities(np.asarray(idxes, np.int64),
                                 np.asarray(prios, np.float64),
                                 int(old_ptr), float(loss))
        counters["prio_updates"] += 1
        return True

    def serve_once() -> bool:
        try:
            seq = req_q.get_nowait()
        except Empty:
            return False
        if int(sviews["req_seq"][0]) != seq:
            return True   # superseded by a retry: answer the newest only
        if int(sviews["req_crc"][0]) != sample_request_crc(sviews, seq):
            # torn/garbled request: drop — the trainer's bounded retry
            # resends clean (serving would stamp a valid response CRC
            # over rows drawn for a garbage row count)
            counters["corrupt"] += 1
            return True
        n = min(int(sviews["req_n"][0]), cfg.batch_size)
        # the gather writes the row fields straight into the response
        # slab (one pass — ReplayBuffer._gather_rows' out= path)
        out = {name: sviews[name][:n] for name in BATCH_ROW_FIELDS
               if name not in ("prios", "idxes")}
        got = buffer.serve_sample(n, out=out)
        if got is None:
            ptr, env_steps, served = (buffer.block_ptr, buffer.env_steps,
                                      0)
        else:
            _, idxes, prios, ptr, env_steps, ages = got
            served = idxes.shape[0]
            sviews["prios"][:served] = prios
            sviews["idxes"][:served] = idxes
            sviews["ages"][:served] = ages
        sviews["rsp_n"][0] = served
        sviews["rsp_block_ptr"][0] = ptr
        sviews["rsp_env_steps"][0] = env_steps
        sviews["rsp_seq"][0] = seq
        # CRC last: the response is only valid once the word matches
        sviews["rsp_crc"][0] = sample_response_crc(sviews, seq)
        rsp_q.put(seq)
        counters["samples"] += 1
        return True

    def ctrl_once() -> bool:
        try:
            req = ctrl_q.get_nowait()
        except Empty:
            return False
        if req[0] == "save":
            _, path, blocks_expected, fb_expected = req
            # drain-then-save: the snapshot must include every block and
            # feedback message the trainer routed BEFORE the save request
            # (cross-queue delivery is unordered) — consume until the
            # session counters reach the trainer's routed counts, bounded
            deadline = Deadline(_SAVE_DRAIN_BUDGET)
            while ((counters["blocks"] + counters["corrupt"]
                    < blocks_expected
                    or counters["prio_updates"] < fb_expected)
                   and not deadline.expired and not stop_event.is_set()):
                if not (ingest_once() or feedback_once()):
                    time.sleep(0.005)
            try:
                meta = buffer.write_state(path)
                meta["restored"] = restored
                snap_q.put((shard_id, meta))
            except Exception as e:   # surface, don't die mid-shutdown
                snap_q.put((shard_id, dict(error=str(e))))
            publish()
        return True

    publish()   # announce (possibly restored) mass/size before any work:
                # the coordinator's ready gate and strata allocation read
                # the vector ahead of the first ingest
    last_pub = time.monotonic()
    try:
        while not stop_event.is_set():
            progress = False
            for _ in range(8):
                if not ingest_once():
                    break
                progress = True
            progress = serve_once() or progress
            for _ in range(8):
                if not feedback_once():
                    break
                progress = True
            progress = ctrl_once() or progress
            now = time.monotonic()
            if progress or now - last_pub > 0.05:
                publish()
                last_pub = now
            if not progress:
                time.sleep(0.002)
        # a final save request may arrive with the stop event already set
        # (drain-then-save shutdown): answer it before exiting
        ctrl_once()
        publish()
    finally:
        writer.close()
        for shm in (ingest_shm, sample_shm):
            try:
                shm.close()
            except Exception:
                pass


def ReplayBufferForShard(cfg: Config, action_dim: int, shard_id: int,
                         incarnation: int):
    """One shard's ReplayBuffer core: the standard host buffer over the
    shard slice, with a sampling RNG keyed by (seed, shard, incarnation)
    so a respawned shard never replays its dead predecessor's draw
    stream."""
    from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer

    rng = np.random.default_rng([cfg.seed, 0x5A1D, shard_id, incarnation])
    return ReplayBuffer(cfg, action_dim, rng=rng)


class ShardedReplayPlane:
    """The trainer-side coordinator of the K replay shard processes.

    A drop-in for the :class:`ReplayBuffer` role in ``train()``'s
    fabric: ``add`` routes, ``ready``/``sample_batch`` run the
    mass-vector allocation + scatter/gather sample RPC,
    ``update_priorities`` fans feedback out, ``stats``/``__len__`` merge
    the shard vectors, and ``write_state``/``read_state`` are the
    per-shard snapshot fan-out ``checkpoint.save_replay`` drives.
    ``sample_batch`` is single-caller by design (the fabric's one sample
    thread) — the per-shard RPC slab holds one request in flight.

    Lifecycle mirrors :class:`ProcessFleetPlane`: construct in
    ``train._build`` (no processes yet), ``start()`` spawns the shards,
    the ``replay_watch`` loop from :meth:`make_loops` respawns dead
    shards (restored from the latest replay snapshot when the run's
    Checkpointer is attached), and ``shutdown()`` — called AFTER the
    final snapshot — stops and reaps everything.
    """

    def __init__(self, cfg: Config, action_dim: int,
                 rng: Optional[np.random.Generator] = None,
                 max_restarts: int = 3):
        if cfg.replay_shards < 1:
            raise ValueError("replay_shards must be >= 1")
        if cfg.num_blocks % cfg.replay_shards:
            raise ValueError(
                f"num_blocks ({cfg.num_blocks}) must divide evenly over "
                f"{cfg.replay_shards} replay shards")
        self.cfg = cfg
        self.action_dim = action_dim
        self.K = cfg.replay_shards
        self.max_restarts = max_restarts
        self.ctx = mp.get_context("spawn")
        # each shard runs the UNCHANGED ReplayBuffer core over its slice
        self.shard_cfg = cfg.replace(
            buffer_capacity=cfg.buffer_capacity // self.K, replay_shards=1)
        self.leaves_per_shard = self.shard_cfg.num_sequences
        self.rng = rng if rng is not None else np.random.default_rng(
            cfg.seed)

        self.stop_event = self.ctx.Event()
        # trainer-side mirror of the stop flag (actor_procs'
        # ProcessFleetPlane rule): a shard SIGKILLed while holding the
        # shared event's lock (kill_replay_shard chaos) would wedge any
        # trainer-side is_set() forever — trainer logic reads this bool,
        # shutdown() writes the event via bounded_event_set only
        self._stopping = False
        # serialises respawns: the watch loop and a snapshot writer that
        # found a dead shard must not both spawn a replacement
        self._watch_lock = threading.Lock()
        self.stats_slab = StatsSlab(self.K, SHARD_STAT_FIELDS)
        self.stats_merger = CounterMerger(self.K, SHARD_STAT_FIELDS)
        self._stats_lock = threading.Lock()
        self.channels: List[Optional[_ShardChannels]] = [None] * self.K
        self._graveyard: List[_ShardChannels] = []
        self.procs: List[Optional[mp.Process]] = [None] * self.K
        self.restarts = [0] * self.K
        self.failed = False
        self._closed = False
        # feedback across a respawn is dropped: a restored (or cold)
        # ring may no longer hold the slots the sampled indices named
        self._generation = [0] * self.K
        # per-shard routed/feedback counts of the CURRENT incarnation —
        # the drain-then-save handshake's expectations (reset at spawn)
        self._routed = [0] * self.K
        self._fb_sent = [0] * self.K
        self._seq = [0] * self.K

        # the run's shared registry (train() swaps it in via
        # set_registry); standalone planes keep this private instance
        self.registry = MetricsRegistry()
        # the run's Checkpointer (train() attaches it when full-state
        # snapshots are armed): the respawn path restores a dead shard's
        # slots from the latest committed replay snapshot through it
        self.checkpointer = None
        # the run's ChaosInjector (train() attaches): the
        # garble_sample_response site fires at response receipt
        self.chaos = None
        # pinned host batches (train() sets it for a CUDA learner): the
        # assembled batch then crosses to the card in one copy
        self.pin_batches = False

        # plane-side accounting (the ReplayBuffer.stats contract): the
        # coordinator sees every add and every feedback call, so these
        # need no cross-process merging — and they restore from the
        # snapshot meta, surviving --resume
        self._lock = threading.Lock()
        self.env_steps = 0
        self.training_steps = 0
        self.sum_loss = 0.0
        self.num_episodes = 0
        self.episode_reward = 0.0
        self.corrupt_blocks = 0     # fleet-ingest CRC drops (note_corrupt)
        self.blocks_routed = 0
        self.dropped_blocks = 0     # send-budget drops (dead shard)
        self.shard_respawns = 0
        self.sample_timeouts = 0
        self.sample_retries = 0
        self.garbled_responses = 0
        self.redraws = 0            # rows redistributed off a suspect shard
        self.stale_feedback = 0     # feedback rows dropped across respawns
        self._route_ptr = 0         # global logical FIFO position
        self._armed_restore: Optional[Tuple[str, Dict[str, Any]]] = None
        self._last_sizes = np.zeros(self.K)

    # ----------------------------------------------------------- lifecycle
    def set_registry(self, registry: MetricsRegistry) -> None:
        self.registry = registry

    def _spawn(self, s: int, restore=None) -> None:
        """(Re)provision shard ``s``: fresh channels (the predecessor's
        are retired wholesale — SIGKILL can corrupt a queue's pipe lock),
        reset routed/feedback expectations, then the process spawn."""
        old = self.channels[s]
        if old is not None:
            try:
                old.ingest_shm.unlink()
                old.sample_shm.unlink()
            except FileNotFoundError:
                pass
            self._graveyard.append(old)
        self.channels[s] = _ShardChannels(self.shard_cfg, self.action_dim,
                                          self.ctx)
        self._routed[s] = 0
        self._fb_sent[s] = 0
        self._seq[s] = 0
        p = self.ctx.Process(
            target=_shard_worker_main, name=f"replay_shard{s}",
            args=(self.shard_cfg, self.action_dim, s, self.restarts[s],
                  self.channels[s].worker_info(), self.stop_event,
                  self.stats_slab.writer_info(s), restore),
            daemon=True)
        p.start()
        self.procs[s] = p

    def _restore_for(self, s: int):
        """(ring_path, shard meta) of shard ``s`` in the latest committed
        replay snapshot, or None.  Used at first spawn (armed by
        :meth:`read_state` — full-state ``--resume``) and by the watchdog
        respawn path (via the attached Checkpointer)."""
        if self._armed_restore is not None:
            path, meta = self._armed_restore
            return (f"{path}.shard{s}", meta["shard_metas"][s])
        if self.checkpointer is None:
            return None
        try:
            rep = self.checkpointer.restore_replay()
        except Exception:
            return None
        if rep is None:
            return None
        meta, ring_path, _ = rep
        if (meta.get("kind") != "sharded"
                or int(meta.get("shards", 0)) != self.K):
            return None
        return (f"{ring_path}.shard{s}", meta["shard_metas"][s])

    def start(self, wait_ready: float = 30.0) -> None:
        for s in range(self.K):
            self._spawn(s, restore=self._restore_for(s))
        self._armed_restore = None   # one-shot: respawns go through the
        # Checkpointer's latest snapshot instead (fresher than boot-time)
        # bounded wait for every shard's FIRST stats publish (each worker
        # publishes before its event loop): actors start producing the
        # moment the fabric is up, and without this the spawn warm-up
        # (the child's import) would eat the first blocks' send budgets
        deadline = Deadline(wait_ready)
        while not deadline.expired and not self._stopping:
            if all(self.stats_slab.read(s) is not None
                   for s in range(self.K)):
                return
            time.sleep(0.05)

    def _stop_requested(self) -> bool:
        """The trainer-side stop predicate bounded sends poll — the
        plain-bool mirror, never the child-shared event (module
        docstring / ProcessFleetPlane._stopping rule)."""
        return self._stopping

    def watch_once(self) -> int:
        """Respawn any dead shard process (skipped while shutting down).
        Raises — after marking the plane failed — once a shard exhausts
        its restart budget, so the supervised watchdog escalates to a
        fabric stop instead of a silently thinning replay plane."""
        restarted = 0
        if self._stopping:   # the trainer-local mirror, never the
            return 0         # possibly-corrupted shared event
        with self._watch_lock:
            for s, p in enumerate(self.procs):
                if p is None or p.is_alive():
                    continue
                if self.restarts[s] >= self.max_restarts:
                    self.failed = True
                    raise RuntimeError(
                        f"replay shard{s} died (exitcode {p.exitcode}) "
                        f"with its restart budget ({self.max_restarts}) "
                        "exhausted")
                self.restarts[s] += 1
                self._generation[s] += 1
                with self._lock:
                    self.shard_respawns += 1
                restarted += 1
                restore = self._restore_for(s)
                self.registry.inc("replay.shard.respawns", shard=str(s))
                log.warning(
                    "replay shard%d died — respawning (%s)", s,
                    "restoring its slots from the latest snapshot"
                    if restore is not None else
                    "no usable snapshot: cold, slots re-ingest fresh")
                self._spawn(s, restore=restore)
        return restarted

    def make_loops(self, stop: Callable[[], bool]):
        """The plane's supervised fabric loop for ``train()``."""

        def replay_watch():
            while not stop():
                self.watch_once()
                time.sleep(0.25)

        return [("replay_watch", replay_watch)]

    def shutdown(self, timeout: float = 10.0) -> None:
        """Stop and reap the shards, unlink the shared memory.  Called
        AFTER the final snapshot (the save fan-out needs live shards);
        idempotent."""
        if self._closed:
            return
        from r2d2_tpu_torch.utils.resilience import bounded_event_set

        self._closed = True
        self._stopping = True
        # bounded: a SIGKILLed shard may have corrupted the event's lock
        # — an abandoned set degrades to the terminate/join reap below
        bounded_event_set(self.stop_event, name="replay-stop")
        for p in self.procs:
            if p is None:
                continue
            p.join(timeout)
            if p.is_alive():
                p.terminate()
                p.join(2.0)
        self.poll_shard_stats()   # final vectors before the slab unlinks
        for ch in list(self.channels) + self._graveyard:
            if ch is not None:
                ch.close()
        self.stats_slab.close()

    # -------------------------------------------------------------- ingest
    def add(self, block: Block, priorities: np.ndarray,
            episode_reward: Optional[float]) -> None:
        """Route one block to its owning shard (round-robin over the
        logical FIFO — the K=1 ring walk split across owners) and
        serialise it into the shard's ingest channel.  The BlockSink
        signature, so actor threads and the fleet-ingest loop plug in
        unchanged."""
        with self._lock:
            s = self._route_ptr % self.K
            self._route_ptr = (self._route_ptr + 1) % self.cfg.num_blocks
            ch, p = self.channels[s], self.procs[s]
        if ch is None or p is None or not p.is_alive():
            # dead shard: drop NOW (crash-lost experience) — waiting
            # out the send budget against a retired channel would
            # stall every producer for the whole respawn window
            with self._lock:
                self.dropped_blocks += 1
            self.registry.inc("replay.shard.dropped_blocks",
                              shard=str(s))
            return
        t0 = time.perf_counter()
        # the send — the bounded free-slot wait AND the multi-MB
        # write_block memcpy — runs OUTSIDE the coordinator lock:
        # holding it here would stall priority feedback and the stats
        # scrape behind a slow/stalled shard's backpressure, and would
        # serialise every producer's serialisation work on one lock
        # (per-shard arrival order may interleave across producers,
        # which sampling is invariant to — leaf placement is
        # priority-independent either way; a concurrent watchdog
        # retirement of `ch` just makes the bounded send fail → drop)
        ok = ch.send_block(block, priorities, episode_reward,
                           stop=self._stop_requested)
        with self._lock:
            if not ok:
                # dead/wedged shard: crash-lost experience, bounded wait
                self.dropped_blocks += 1
                self.registry.inc("replay.shard.dropped_blocks",
                                  shard=str(s))
                return
            if ch is self.channels[s]:
                # counted toward the drain-then-save expectations only
                # while this channel is current: a block posted to a
                # since-retired channel will never be consumed by the
                # replacement (its ready queue died with the process)
                self._routed[s] += 1
            HOST_TRANSFERS.count("replay.route_block")
            self.blocks_routed += 1
            self.env_steps += int(block.learning_steps.sum())
            if episode_reward is not None:
                self.episode_reward += float(episode_reward)
                self.num_episodes += 1
        if block.trace_id and EVENTS.armed:
            # lineage hop: trainer-side routing into the owning shard's
            # ingest channel (slice covers the bounded send)
            EVENTS.complete("replay.route", t0, time.perf_counter() - t0,
                            flow=block.trace_id, fph="t", arg=s)

    def note_corrupt_block(self) -> None:
        """A fleet-channel CRC failure upstream of routing (the
        ProcessFleetPlane's ``on_corrupt`` hook)."""
        with self._lock:
            self.corrupt_blocks += 1

    # ------------------------------------------------------- mass vector
    def poll_shard_stats(self) -> Dict[str, Any]:
        """Scrape every shard's stats-slab vector into the merger and
        return the coordinator view: the per-shard ``masses`` the strata
        allocation draws over, sizes, and the merged session counters."""
        with self._stats_lock:
            for s in range(self.K):
                got = self.stats_slab.read(s)
                if got is not None:
                    self.stats_merger.update(s, *got)
            per = self.stats_merger.per_slot()
            masses = np.array([row.get("tree_mass", 0.0) for row in per])
            sizes = np.array([row.get("size", 0.0) for row in per])
            self._last_sizes = sizes
            return dict(masses=masses, sizes=sizes,
                        mass_total=float(masses.sum()),
                        size_total=int(sizes.sum()),
                        totals=self.stats_merger.totals(),
                        per_shard=per)

    @property
    def ready(self) -> bool:
        st = self.poll_shard_stats()
        return (st["size_total"] >= self.cfg.learning_starts
                and st["mass_total"] > 0)

    def __len__(self) -> int:
        return int(self._last_sizes.sum())

    # -------------------------------------------------------------- sample
    def _post_request(self, s: int, n: int) -> int:
        ch = self.channels[s]
        v = ch.sample_views
        self._seq[s] += 1
        seq = self._seq[s]
        v["req_n"][0] = n
        v["req_seq"][0] = seq
        # CRC last: the request is only valid once the word matches
        v["req_crc"][0] = sample_request_crc(v, seq)
        ch.req_q.put(seq)
        return seq

    def _await_response(self, s: int, seq: int,
                        stop: Optional[Callable[[], bool]]) -> str:
        """Wait (bounded by ``cfg.replay_sample_timeout``) for shard
        ``s``'s reply to ``seq`` and verify its CRC.  Returns "ok" /
        "timeout" / "garbled" — never raises into the sample loop."""
        ch = self.channels[s]
        deadline = Deadline(self.cfg.replay_sample_timeout)
        while True:
            if stop is not None and stop():
                return "timeout"
            try:
                got = ch.rsp_q.get(timeout=deadline.poll_timeout(0.05))
            except Empty:
                if deadline.expired:
                    return "timeout"
                continue
            if got != seq:
                continue   # a stale token from a superseded attempt
            v = ch.sample_views
            chaos = self.chaos
            if chaos is not None and chaos.garble_sample_response():
                # chaos site: flip response bytes AFTER the shard wrote
                # its CRC — receipt-side verification must catch it and
                # the bounded retry must re-request
                v["prios"][0] = float(v["prios"][0]) + 1.0
            if (int(v["rsp_seq"][0]) != seq
                    or int(v["rsp_crc"][0]) != sample_response_crc(v, seq)):
                return "garbled"
            return "ok"

    def _take_rows(self, s: int, out: Dict[str, np.ndarray],
                   off: int) -> Dict[str, Any]:
        """Copy the used rows out of shard ``s``'s response slab into
        ``out`` at row offset ``off``; returns the part's metadata."""
        v = self.channels[s].sample_views
        n = int(v["rsp_n"][0])
        for name in BATCH_ROW_FIELDS + ("ages",):
            out[name][off:off + n] = v[name][:n]
        return dict(n=n, shard=s, off=off,
                    block_ptr=int(v["rsp_block_ptr"][0]),
                    env_steps=int(v["rsp_env_steps"][0]),
                    gen=self._generation[s])

    def sample_batch(self, batch_size: Optional[int] = None,
                     stop: Optional[Callable[[], bool]] = None
                     ) -> Optional[Dict[str, np.ndarray]]:
        """Assemble one batch via parallel per-shard sample RPCs.

        1. refresh the cross-shard mass vector (stats slab);
        2. allocate the B strata over it (:func:`allocate_strata`);
        3. post every shard's request, then collect the preassembled
           responses — a garbled response retries the shard, a timeout
           (or an empty shard under a stale vector) redistributes its
           rows over the remaining mass;
        4. concatenate the K slab views, offset local leaf indices into
           the global space, and apply the K=1 zero-clamp +
           min-of-the-whole-batch IS normalisation.

        Returns None when no shard could serve (all suspect/empty) —
        the sample loop retries; the learner never wedges on a dead
        shard.
        """
        cfg = self.cfg
        B = batch_size or cfg.batch_size
        st = self.poll_shard_stats()
        masses = st["masses"].copy()
        if masses.sum() <= 0:
            raise RuntimeError(
                "sample_batch on an empty sharded replay plane; wait for "
                "add() (use `ready` to gate on learning_starts)")
        counts = allocate_strata(masses, B, self.rng)
        out = alloc_batch(self.channels[0].sample_spec, B, self.pin_batches)
        parts: List[Dict[str, Any]] = []
        have = 0
        for round_no in range(4):   # bounded redistribution rounds
            pending = {s: int(n) for s, n in enumerate(counts) if n > 0}
            if not pending:
                break
            issued = {s: self._post_request(s, n)
                      for s, n in pending.items()
                      if self.channels[s] is not None}
            counts = np.zeros(self.K, np.int64)
            for s, seq in issued.items():
                verdict = self._await_response(s, seq, stop)
                if verdict == "ok":
                    part = self._take_rows(s, out, have)
                    short = pending[s] - part["n"]
                    if part["n"] > 0:
                        parts.append(part)
                        have += part["n"]
                    if short > 0:
                        # stale mass vector: the shard drained empty —
                        # move the shortfall to shards that have mass
                        masses[s] = 0.0
                        with self._lock:
                            self.redraws += short
                        self.registry.inc("replay.shard.redraws", short,
                                          shard=str(s))
                elif verdict == "garbled":
                    with self._lock:
                        self.garbled_responses += 1
                        self.sample_retries += 1
                    self.registry.inc("replay.shard.garbled_responses",
                                      shard=str(s))
                    counts[s] = pending[s]   # same shard, fresh seq
                else:   # timeout: suspect — redistribute off this shard
                    with self._lock:
                        self.sample_timeouts += 1
                        self.redraws += pending[s]
                    self.registry.inc("replay.shard.sample_timeouts",
                                      shard=str(s))
                    masses[s] = 0.0
            shortfall = B - have - int(counts.sum())
            if shortfall > 0:
                if masses.sum() <= 0:
                    break   # nowhere left to draw from
                counts = counts + allocate_strata(masses, shortfall,
                                                  self.rng)
        if have < B:
            # a partial batch would break the learner's compiled shapes;
            # drop what we gathered and let the sample loop retry — the
            # watchdog respawns whatever starved this draw
            return None
        # per-shard FIFO pointers (+ generation) for the feedback fan-out:
        # first part per shard wins (the conservative/earlier pointer)
        ptrs: Dict[int, Tuple[int, int]] = {}
        for p in parts:
            ptrs.setdefault(p["shard"], (p["block_ptr"], p["gen"]))
        HOST_TRANSFERS.count("replay.sample_rpc")
        with self._lock:
            env_steps = self.env_steps
        return finish_batch(cfg, out, parts, self.leaves_per_shard, ptrs,
                            env_steps)

    # ------------------------------------------------------------ feedback
    def update_priorities(self, idxes: np.ndarray, priorities: np.ndarray,
                          old_ptr: Any, loss: float) -> None:
        """Fan the learner's priority feedback back to the owning shards
        (global leaf index // leaves-per-shard), each with its own
        sample-time FIFO pointer for the local stale mask.  Rows whose
        shard respawned since the sample are dropped (generation tag) —
        the restored ring may no longer hold those slots."""
        idxes = np.asarray(idxes, np.int64)
        priorities = np.asarray(priorities, np.float64)
        with self._lock:
            self.training_steps += 1
            self.sum_loss += float(loss)
        shards = idxes // self.leaves_per_shard
        for s in np.unique(shards):
            s = int(s)
            entry = old_ptr.get(s) if isinstance(old_ptr, dict) else None
            m = shards == s
            if entry is None:
                continue   # a shard that served no rows cannot own any
            ptr, gen = entry
            ch = self.channels[s]
            if ch is None or gen != self._generation[s]:
                with self._lock:
                    self.stale_feedback += int(m.sum())
                self.registry.inc("replay.shard.stale_feedback",
                                  int(m.sum()), shard=str(s))
                continue
            ch.fb_q.put((idxes[m] % self.leaves_per_shard, priorities[m],
                         int(ptr), float(loss)))
            self._fb_sent[s] += 1

    # ------------------------------------------------------------ snapshot
    # plane-side counters that ride the snapshot meta (the shards' ring
    # counters ride each shard's own payload)
    STATE_COUNTERS = ("env_steps", "training_steps", "sum_loss",
                      "num_episodes", "episode_reward", "corrupt_blocks",
                      "blocks_routed", "dropped_blocks", "shard_respawns",
                      "_route_ptr")

    def write_state(self, path: str) -> Dict[str, Any]:
        """Per-shard snapshot fan-out (``checkpoint.save_replay``'s
        writer): every shard runs its drain-then-save handshake and
        writes its own ``ReplayBuffer.write_state`` payload to
        ``path + ".shardN"``; ``path`` itself holds a tiny index.
        Returns the sharded meta ``read_state`` validates."""
        import json

        # a shard that died right before this snapshot (e.g. a chaos
        # kill at drain time, with the watch loop already joined) is
        # respawned HERE — restored from the previous committed snapshot
        # — so the save fans out over a complete plane instead of
        # failing; an exhausted restart budget still raises
        if any(p is None or not p.is_alive() for p in self.procs):
            self.watch_once()
        with self._lock:
            expectations = [(self._routed[s], self._fb_sent[s])
                            for s in range(self.K)]
            counters = {k: getattr(self, k) for k in self.STATE_COUNTERS}
        live = []
        for s in range(self.K):
            ch, p = self.channels[s], self.procs[s]
            if ch is None or p is None or not p.is_alive():
                raise RuntimeError(
                    f"replay shard{s} is not alive — snapshot would be "
                    "partial; the watchdog respawns it first")
            blocks_expected, fb_expected = expectations[s]
            ch.ctrl_q.put(("save", f"{path}.shard{s}", blocks_expected,
                           fb_expected))
            live.append(s)
        metas: List[Optional[Dict[str, Any]]] = [None] * self.K
        deadline = Deadline(_SAVE_DRAIN_BUDGET + 30.0)
        for s in live:
            ch, p = self.channels[s], self.procs[s]
            while metas[s] is None:
                try:
                    sid, meta = ch.snap_q.get(
                        timeout=deadline.poll_timeout(0.2))
                except Empty:
                    if p is not None and not p.is_alive():
                        # died mid-save (chaos kill during its drain
                        # window): fail THIS snapshot promptly — the
                        # watchdog respawns the shard and the next
                        # cadence/final save retries over a whole plane
                        raise RuntimeError(
                            f"replay shard{s} died during the snapshot "
                            "fan-out; retry after its respawn")
                    if deadline.expired:
                        raise RuntimeError(
                            f"replay shard{s}: no snapshot within budget")
                    continue
                if sid == s:
                    metas[s] = meta
            if "error" in (metas[s] or {}):
                raise RuntimeError(
                    f"replay shard{s} snapshot failed: "
                    f"{metas[s]['error']}")
        with open(path, "w") as f:
            json.dump(dict(kind="sharded", shards=self.K), f)
        return dict(kind="sharded", shards=self.K, shard_metas=metas,
                    plane_counters=counters,
                    rng_state=self.rng.bit_generator.state)

    def read_state(self, path: str, meta: Dict[str, Any]) -> None:
        """Validate a sharded snapshot and arm the per-shard restores for
        :meth:`start` (the processes do not exist yet at ``_build``
        time).  Raises ``ValueError`` on a geometry mismatch so the
        caller warns and resumes cold — the ReplayBuffer contract."""
        from r2d2_tpu_torch.replay.replay_buffer import (
            _layout_fingerprint,
            _ring_spec,
        )

        if meta.get("kind") != "sharded":
            raise ValueError(
                "replay snapshot is not a sharded-plane snapshot "
                f"(kind={meta.get('kind')!r}) — written by a different "
                "replay topology; resuming with a cold plane")
        if int(meta.get("shards", 0)) != self.K:
            raise ValueError(
                f"replay snapshot has {meta.get('shards')} shards but "
                f"this run uses replay_shards={self.K}; resuming cold")
        want = _layout_fingerprint(
            _ring_spec(self.shard_cfg, self.action_dim)
            + (("tree_leaves", (self.leaves_per_shard,), np.float64),))
        for s, smeta in enumerate(meta.get("shard_metas") or []):
            if (smeta or {}).get("layout") != want:
                raise ValueError(
                    f"replay snapshot shard{s} layout mismatch — written "
                    "under a different buffer geometry; resuming cold")
        with self._lock:
            for k, v in (meta.get("plane_counters") or {}).items():
                if k in self.STATE_COUNTERS:
                    setattr(self, k, type(getattr(self, k))(v))
            if meta.get("rng_state") is not None:
                self.rng.bit_generator.state = meta["rng_state"]
        self._armed_restore = (path, meta)

    # ---------------------------------------------------------- data health
    def data_health(self) -> Dict[str, Any]:
        """Learning-health view of the sharded plane: one data-health
        row PER SHARD (ESS + priority histogram, published by each owner
        through the stats slab) plus the plane-level replay-ratio gauge.
        Per-member sample fractions live shard-side (the preassembled
        response rows carry no member word) — ``samples_per_member`` is
        empty here; ``blocks_per_member`` via the population plane
        remains the member-flow proof."""
        st = self.poll_shard_stats()
        with self._lock:
            training_steps = self.training_steps
            env_steps = self.env_steps
        shards = []
        for s, row in enumerate(st["per_shard"]):
            shards.append(dict(
                shard=s,
                ess=float(row.get("ess", 0.0)),
                ess_frac=float(row.get("ess_frac", 0.0)),
                positive_leaves=int(row.get("positive_leaves", 0)),
                mass=float(row.get("tree_mass", 0.0)),
                hist=[int(row.get(f"prio_hist_{i}", 0))
                      for i in range(len(PRIO_EDGES) + 1)],
            ))
        return dict(
            replay_ratio=replay_ratio(self.cfg, training_steps, env_steps),
            samples_per_member={},
            edges=list(PRIO_EDGES),
            shards=shards,
        )

    # --------------------------------------------------------------- stats
    def stats(self) -> Dict[str, float]:
        """The ReplayBuffer.stats contract (interval fields reset on
        read) plus the shard-health drive-bys the telemetry registry
        absorbs."""
        st = self.poll_shard_stats()
        with self._lock:
            s = dict(
                size=st["size_total"], env_steps=self.env_steps,
                training_steps=self.training_steps,
                num_episodes=self.num_episodes,
                episode_reward=self.episode_reward,
                sum_loss=self.sum_loss,
                corrupt_blocks=(self.corrupt_blocks
                                + int(st["totals"].get(
                                    "corrupt_blocks", 0))),
                shard_respawns=self.shard_respawns,
            )
            self.episode_reward = 0.0
            self.num_episodes = 0
            self.sum_loss = 0.0
        return s

    def health(self) -> Dict[str, Any]:
        """The plane's shard-health verdict for ``/healthz``, the log
        entry (``replay.shard.*`` absorption) and ``r2d2_top``."""
        st = self.poll_shard_stats()
        alive = sum(1 for p in self.procs
                    if p is not None and p.is_alive())
        with self._lock:
            out = dict(
                shards=self.K, alive=alive, failed=self.failed,
                respawns=list(self.restarts),
                masses=[round(float(m), 6) for m in st["masses"]],
                sizes=[int(x) for x in st["sizes"]],
                per_shard_corrupt=[
                    int(row.get("corrupt_blocks", 0))
                    for row in st["per_shard"]],
                blocks_routed=self.blocks_routed,
                dropped_blocks=self.dropped_blocks,
                corrupt_blocks=(self.corrupt_blocks
                                + int(st["totals"].get(
                                    "corrupt_blocks", 0))),
                sample_timeouts=self.sample_timeouts,
                sample_retries=self.sample_retries,
                garbled_responses=self.garbled_responses,
                redraws=self.redraws,
                stale_feedback=self.stale_feedback,
                degraded=alive < self.K,
            )
        for s in range(self.K):
            self.registry.set_gauge("replay.shard.mass",
                                    float(st["masses"][s]), shard=str(s))
            self.registry.set_gauge("replay.shard.size",
                                    float(st["sizes"][s]), shard=str(s))
        return out
