"""Process-fleet actor plane: experience generation in subprocesses.

Port of ``r2d2_tpu/parallel/actor_procs.py``.  The threaded fabric runs
every actor fleet in the trainer's interpreter, where the fleets, the
learner's issue and the fabric threads share one GIL.  This plane moves
each fleet into a process of its own:

- **N subprocess fleets** (``cfg.actor_fleets``), spawn-started (the
  trainer holds a CUDA context, which a fork would copy), each running the
  lockstep :class:`~r2d2_tpu_torch.actor.VectorActor` over its contiguous
  shard of the env lanes with the global ladder epsilons.  A child never
  touches the card: it hides every CUDA device from itself before it
  builds anything, acts on the CPU, and sizes torch's thread pool to its
  share of the host's cores.
- **Shared-memory block channel**: finished blocks return over
  preallocated ``multiprocessing.shared_memory`` slots laid out by
  :func:`~r2d2_tpu_torch.replay.block.block_slot_spec` — the reference's
  byte layout, so a JAX fleet and a torch trainer read each other's
  blocks.  Only a tuple-of-ints shape header crosses the metadata queue.
  Slot recycling over a free-list queue is the backpressure.  One channel
  per fleet: a SIGKILLed process can die holding a queue's pipe lock, so
  channels are fleet-private and retired wholesale on respawn.
- **Versioned weight pump**: the trainer flattens each ParamStore publish
  into one host buffer (narrowed to bfloat16 on the wire under
  ``cfg.param_pump_dtype``, round-to-nearest-even, shipped as ``uint16``),
  pickles it once for every fleet, and each fleet republishes it into its
  process-local ParamStore.
- **Supervision**: a watchdog respawns a dead fleet on its lane shard,
  bounded by a restart budget, after which the run stops.
- **Population** (``members``, ``league/population.py``): fleet f acts
  for member f — its child runs under the member's config (env, epsilon
  ladder, discount) and stamps the member's id into every block — while
  the channels stay laid out under the base config (asserted
  byte-identical); :meth:`ProcessFleetPlane.population_health` is the
  per-member view of the fleet counters.

Inference placement is ``cfg.actor_inference``: ``"local"`` acts in every
child through its CPU twin of the network (float32, the scan recurrence —
the reference's fleets pin the CPU backend the same way); ``"serve"`` runs
no network in the children: every env step is an RPC over a per-fleet act
slab to the trainer's
:class:`~r2d2_tpu_torch.parallel.inference_service.InferenceService`,
which acts once per cross-fleet batch on the learner's device.

The env factory must be picklable (a module-level function or a
``functools.partial`` of one): spawn re-imports it in the child.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import multiprocessing as mp
import os
import pickle
import sys
import threading
import time
from multiprocessing import shared_memory
from queue import Empty, Full
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.replay.block import (
    Block,
    block_slot_spec,
    read_block,
    slot_crc,
    slot_layout,
    slot_views,
    write_block,
)
from r2d2_tpu_torch.telemetry.registry import MetricsRegistry
from r2d2_tpu_torch.telemetry.slab import (
    FLEET_STAT_FIELDS,
    CounterMerger,
    StatsSlab,
    StatsSlabWriter,
)
from r2d2_tpu_torch.utils.resilience import CLOSED, bounded_event_set
from r2d2_tpu_torch.telemetry.tracing import EVENTS
from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS

log = logging.getLogger(__name__)

# sink(block, priorities, episode_reward_or_None) — the trainer-side
# consumer of the channel (ReplayBuffer.add in train()).
BlockSink = Callable[[Block, np.ndarray, Optional[float]], None]


class FleetStopped(Exception):
    """Raised inside a fleet's sink when the plane is shutting down —
    unwinds the actor loop instead of blocking on a free slot forever."""


class CorruptBlockError(Exception):
    """A ready slot failed its CRC32 integrity check (torn producer write
    or garbled slab).  The slot has already been released back to the free
    list; the caller drops the block and counts it."""

    def __init__(self, slot: int, src: int):
        super().__init__(f"block slot {slot} from fleet {src} failed CRC32")
        self.slot = slot
        self.src = src


class ShmBlockChannel:
    """Trainer-side end of ONE fleet's block transport.

    Owns one shared-memory segment of ``num_slots`` max-shape block slots
    plus two small index queues: ``free`` (slot numbers the producer may
    fill) and ``ready`` (slot + shape header + episode reward).  ``recv``
    hands back zero-copy Block views into the slab; the caller must
    :meth:`release` the slot after consuming them (ReplayBuffer.add copies
    or stages the bytes before returning, so release-after-add is safe).
    """

    def __init__(self, cfg: Config, action_dim: int, num_slots: int, ctx):
        self.spec = block_slot_spec(cfg, action_dim)
        self.slot_nbytes, self.offsets = slot_layout(self.spec)
        self.num_slots = num_slots
        self.shm = shared_memory.SharedMemory(
            create=True, size=num_slots * self.slot_nbytes)
        self.free = ctx.Queue()
        self.ready = ctx.Queue()
        for i in range(num_slots):
            self.free.put(i)

    def producer_info(self) -> Tuple[str, Any, Any]:
        """The picklable handle a fleet child needs to attach
        (:class:`ShmBlockProducer`): segment name + the two queues."""
        return (self.shm.name, self.free, self.ready)

    def _views(self, slot: int) -> dict:
        return slot_views(self.shm.buf, self.spec, self.offsets,
                          self.slot_nbytes, slot)

    def recv(self, timeout: float = 0.1
             ) -> Optional[Tuple[Block, np.ndarray, Optional[float], int,
                                 int]]:
        """One finished block, or None when nothing is ready (timeout
        <= 0: non-blocking).  Returns ``(block, priorities,
        episode_reward, slot, src)``; block and priorities are views into
        the slab, valid until ``release(slot)``."""
        try:
            if timeout <= 0:
                slot, src, k, n_obs, n_steps, ep = self.ready.get_nowait()
            else:
                slot, src, k, n_obs, n_steps, ep = self.ready.get(
                    timeout=timeout)
        except Empty:
            return None
        views = self._views(slot)
        # the producer writes the CRC32 word LAST: a torn write or a
        # garbled slab never reaches the replay ring
        if int(views["crc32"][0]) != slot_crc(views, k, n_obs, n_steps):
            self.release(slot)
            raise CorruptBlockError(slot, src)
        block, prios = read_block(views, k, n_obs, n_steps)
        return block, prios, ep, slot, src

    def release(self, slot: int) -> None:
        self.free.put(slot)

    def close(self) -> None:
        try:
            self.shm.close()
        except BufferError:
            # the ingest thread still holds slot views; the mapping dies
            # with the process — unlinking below still frees the name
            pass
        try:
            self.shm.unlink()
        except FileNotFoundError:
            pass


class ShmBlockProducer:
    """Fleet-side end of the block transport (lives in the subprocess).

    ``send`` has the :data:`BlockSink` signature, so it plugs straight into
    a VectorActor.  Waiting for a free slot is the backpressure; the wait
    polls ``stop_event`` so shutdown never hangs a fleet mid-block."""

    def __init__(self, cfg: Config, action_dim: int,
                 info: Tuple[str, Any, Any], stop_event, src: int = 0,
                 member_id: int = 0):
        name, self.free, self.ready = info
        self.src = src
        self.member_id = member_id   # population member tag (league/)
        # Attaching registers the segment with the resource tracker again.
        # Spawned children share the trainer's tracker, whose registry is a
        # set: the second registration is a no-op, the child's exit (or
        # SIGKILL) unlinks nothing, and the trainer's one unlink at channel
        # close balances it (tests/test_torch_actor_procs.py pins this).
        self.shm = shared_memory.SharedMemory(name=name)
        self.spec = block_slot_spec(cfg, action_dim)
        self.slot_nbytes, self.offsets = slot_layout(self.spec)
        self.stop_event = stop_event
        # fleet-side telemetry counters, published through the stats slab
        self.blocks_sent = 0
        self.episodes = 0
        self.episode_reward_sum = 0.0

    def send(self, block: Block, priorities: np.ndarray,
             episode_reward: Optional[float]) -> None:
        if episode_reward is not None:
            self.episodes += 1
            self.episode_reward_sum += float(episode_reward)
        # capture-window poll and ring flush at block granularity (blocks
        # are the lineage unit), BEFORE the free-slot wait: a producer
        # parked on backpressure through a capture's close has still
        # published its cut event.  flush() is a no-op when nothing new
        # was recorded
        EVENTS.poll()
        EVENTS.flush()
        t0 = time.perf_counter()
        while True:
            if self.stop_event.is_set():
                raise FleetStopped
            try:
                slot = self.free.get(timeout=0.2)
                break
            except Empty:
                continue
        views = slot_views(self.shm.buf, self.spec, self.offsets,
                           self.slot_nbytes, slot)
        # the member tag rides the wire, so every hop downstream (ingest,
        # replay stats) counts per-member flow without a side table
        block.member_id = self.member_id
        k, n_obs, n_steps = write_block(views, block, priorities)
        self.ready.put((slot, self.src, k, n_obs, n_steps, episode_reward))
        self.blocks_sent += 1
        if block.trace_id and EVENTS.armed:
            # lineage hop: the free-slot wait (channel backpressure) and
            # the serialising copy
            EVENTS.complete("fleet.block_send", t0,
                            time.perf_counter() - t0,
                            flow=block.trace_id, fph="t")

    def close(self) -> None:
        try:
            self.shm.close()
        except BufferError:
            pass


@dataclasses.dataclass
class _FleetSpec:
    """Picklable per-fleet parameters shipped to the spawn child."""
    fleet_id: int
    lo: int                 # global lane range [lo, hi)
    hi: int
    epsilons: Tuple[float, ...]   # the GLOBAL ladder slice for these lanes
    env_workers: int
    incarnation: int = 0    # bumped per watchdog respawn: the replacement
                            # must not replay its predecessor's env seeds
                            # and exploration stream
    num_threads: int = 0    # torch intra-op threads in the child (0:
                            # leave torch's default)
    member_id: int = 0      # the population member this fleet acts for
                            # (fleet f <-> member f), stamped into every
                            # block's member_id word


# ---------------------------------------------------------------- weights

def fleet_act_config(cfg: Config) -> Config:
    """The config a network acting on the CPU is built from: float32 (bf16
    is emulated on the CPU and the params are float32 anyway) and the scan
    recurrence where the card would run the fused kernel — the reference's
    CPU act twin (``r2d2_tpu/actor.py:make_act_fn``).  Every variant
    declares the same parameters, so published snapshots apply."""
    twin = dict(act_device="cpu", compute_dtype="float32")
    if cfg.lstm_impl == "pallas":
        twin["lstm_impl"] = "scan"
    return cfg.replace(**twin)


def fleet_act_net(cfg: Config, action_dim: int):
    """The fleet's CPU act twin (:func:`fleet_act_config`) as a module."""
    from r2d2_tpu_torch.models.network import create_network

    return create_network(fleet_act_config(cfg), action_dim, device="cpu")


def narrow_bf16(flat: torch.Tensor) -> np.ndarray:
    """float32 → bfloat16 bits as ``uint16`` numpy, round to nearest even
    (torch's conversion; the bits equal ``ml_dtypes.bfloat16``'s)."""
    return flat.to(torch.bfloat16).view(torch.int16).cpu().numpy().view(
        np.uint16)


def pack_params(params: Dict[str, torch.Tensor], dtype: str) -> dict:
    """One host buffer of every parameter, in ``dtype`` ("float32" or
    "bfloat16"), flattened on the parameters' device and fetched in one
    device→host copy."""
    bad = [k for k, v in params.items() if v.dtype != torch.float32]
    if bad:
        raise ValueError(f"the pump ships float32 params; {bad} are not")
    flat = torch.cat([v.detach().reshape(-1) for v in params.values()])
    data = (narrow_bf16(flat) if dtype == "bfloat16"
            else flat.cpu().numpy())
    return dict(names=list(params), shapes=[tuple(v.shape)
                                            for v in params.values()],
                dtype=dtype, data=data)


def unpack_params(host: dict) -> Dict[str, torch.Tensor]:
    """:func:`pack_params`'s buffer back to a dict of float32 CPU tensors
    (views of one widened buffer)."""
    data = host["data"]
    if host["dtype"] == "bfloat16":
        flat = torch.from_numpy(data.view(np.int16)).view(
            torch.bfloat16).float()
    else:
        flat = torch.from_numpy(data)
    sizes = [int(np.prod(s)) for s in host["shapes"]]
    return {name: part.view(shape) for name, part, shape in
            zip(host["names"], torch.split(flat, sizes), host["shapes"])}


def _decode_pump(payload: bytes):
    """Worker-side decode of one pumped weight snapshot (bytes the trainer
    pickled, :meth:`ProcessFleetPlane._encode_pump`)."""
    version, host = pickle.loads(payload)
    return version, unpack_params(host)


class _TimedAct:
    """A host act function that keeps ``(wall-clock end, seconds)`` of its
    recent calls (a local-mode fleet's acts, reported when probed)."""

    def __init__(self, fn):
        self.fn = fn
        self.times: collections.deque = collections.deque(maxlen=8192)

    def __call__(self, *args):
        t0 = time.perf_counter()
        out = self.fn(*args)
        self.times.append((time.time(), time.perf_counter() - t0))
        return out


def _child_report(spec: _FleetSpec, pumped: dict, act_times,
                  started: Tuple[float, float]) -> dict:
    """What a fleet child says about itself when probed: its pid, whether
    it opened a CUDA context or loaded JAX, its thread pool, the CPU and
    wall seconds since ``started`` (its entry point's ``(process_time,
    wall clock)``), and its recent acts as ``(wall-clock end, seconds)``
    rows — the act-RPC round trip in serve mode, the CPU act in local
    mode."""
    return dict(
        cpu_seconds=time.process_time() - started[0],
        alive_seconds=time.time() - started[1],
        fleet_id=spec.fleet_id, pid=os.getpid(),
        cuda_initialized=bool(torch.cuda.is_initialized()),
        jax_loaded=any(m == "jax" or m.startswith("jax.")
                       for m in sys.modules),
        r2d2_tpu_loaded=any(m == "r2d2_tpu" or m.startswith("r2d2_tpu.")
                            for m in sys.modules),
        num_threads=torch.get_num_threads(), cpu_count=os.cpu_count(),
        param_version=pumped["version"],
        act_times=np.asarray(act_times, np.float64).reshape(-1, 2))


def _fleet_worker_main(cfg: Config, action_dim: int, env_factory,
                       spec: _FleetSpec, producer_info, weights_q,
                       stop_event, ctrl_q=None, snap_q=None,
                       restore_snap=None, act_info=None,
                       stats_info=None, trace_info=None) -> None:
    """Entry point of one fleet subprocess.

    Hides the CUDA devices from this process and acts on the CPU (the
    child must never open a context on the trainer's card), waits for the
    first weight publication, then runs the lockstep VectorActor with the
    shm producer as its sink until ``stop_event``.

    ``ctrl_q``/``snap_q`` are the control channel: a ``"snapshot"``
    request is answered, between run bursts and once more during
    shutdown, with ``("snapshot", fleet_id, VectorActor.snapshot())``; a
    ``"probe"`` request with ``("probe", fleet_id, report)``
    (:func:`_child_report`).  ``restore_snap`` resumes a snapshot at spawn.

    ``act_info`` non-None selects serve mode: acting is an RPC through a
    :class:`~r2d2_tpu_torch.parallel.inference_service.RemoteActClient`;
    the pump still feeds the local ParamStore (non-blocking drain) as the
    weights the client's fallback acts on when its circuit opens.

    ``stats_info`` attaches the stats slab: after every run burst the
    fleet publishes its counters, CRC last, no pickling.  ``trace_info``
    attaches the process-wide event recorder to this fleet's slot of the
    trace slab (telemetry/tracing.py), polled and flushed at the burst
    and block cadence.
    """
    started = (time.process_time(), time.time())
    # before anything can create a CUDA context: none of the trainer's
    # cards is visible here, so a stray CUDA call raises instead of
    # opening a second context on the card
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    if spec.num_threads > 0:
        torch.set_num_threads(spec.num_threads)

    from r2d2_tpu_torch.actor import VectorActor, make_host_act_fn
    from r2d2_tpu_torch.utils.store import ParamStore

    store = ParamStore()
    # the TRAINER's version of the last decoded pump (the local store's own
    # counter drifts when the pump skips versions), published in the stats
    # so the staleness watchdog compares like with like
    pumped = {"version": 0}

    def weight_drain():
        while not stop_event.is_set():
            try:
                payload = weights_q.get(timeout=0.2)
            except Empty:
                continue
            version, params = _decode_pump(payload)
            store.publish(params)
            pumped["version"] = version

    client = None
    if act_info is not None:
        from r2d2_tpu_torch.parallel.inference_service import (
            RemoteActClient,
        )

        def local_act_factory():
            # built lazily, only if the circuit ever opens: the exact
            # local-mode twin, so degraded-mode blocks are bit-identical to
            # a local-mode fleet's
            return make_host_act_fn(fleet_act_net(cfg, action_dim))

        client = RemoteActClient(cfg, action_dim, spec.hi - spec.lo,
                                 act_info, stop_event, src=spec.fleet_id,
                                 param_store=store,
                                 local_act_factory=local_act_factory)
        act_fn = client
        if weights_q is not None:
            # a dead drain costs staleness of the FALLBACK weights only
            threading.Thread(target=weight_drain, daemon=True,
                             name=f"fleet{spec.fleet_id}-weights").start()
    else:
        deadline = time.time() + 120.0
        first = None
        while first is None and not stop_event.is_set():
            if time.time() > deadline:
                raise RuntimeError(
                    f"fleet{spec.fleet_id}: no initial weights within 120 s")
            try:
                first = weights_q.get(timeout=0.2)
            except Empty:
                continue
        if first is None:  # stopped before the first publication
            return
        version0, params0 = _decode_pump(first)
        store.publish(params0)
        pumped["version"] = version0
        # a dead drain leaves acting on the last version (bounded
        # staleness); the watchdog's restart budget covers anything worse
        threading.Thread(target=weight_drain, daemon=True,
                         name=f"fleet{spec.fleet_id}-weights").start()
        act_fn = _TimedAct(make_host_act_fn(fleet_act_net(cfg, action_dim)))

    producer = ShmBlockProducer(cfg, action_dim, producer_info, stop_event,
                                src=spec.fleet_id, member_id=spec.member_id)
    stats_writer = (StatsSlabWriter(stats_info)
                    if stats_info is not None else None)
    if trace_info is not None:
        EVENTS.attach(trace_info)
    num_lanes = spec.hi - spec.lo

    def publish_stats() -> None:
        if trace_info is not None:
            # capture-window poll and ring flush ride the burst cadence
            EVENTS.poll()
            EVENTS.flush()
        if stats_writer is None:
            return
        # lockstep fleet: one actor iteration steps every lane
        stats = dict(
            env_steps=actor.actor_steps * num_lanes,
            blocks_produced=producer.blocks_sent,
            episodes=producer.episodes,
            episode_reward_sum=producer.episode_reward_sum,
            param_version=pumped["version"],
            incarnation=spec.incarnation,
        )
        if client is not None:
            stats.update(client.stats)
        stats_writer.publish(stats)

    # incarnation shifts the env seeds and the exploration stream, so a
    # respawned fleet explores fresh trajectories
    envs = [env_factory(cfg, cfg.seed + i + 1_000_003 * spec.incarnation)
            for i in range(spec.lo, spec.hi)]
    actor = VectorActor(fleet_act_config(cfg), envs, list(spec.epsilons),
                        act_fn, store, sink=producer.send,
                        env_workers=spec.env_workers,
                        rng=np.random.default_rng(
                            cfg.seed + 7919 + 104729 * spec.fleet_id
                            + 15_485_863 * spec.incarnation))
    if restore_snap is not None:
        try:
            actor.restore(restore_snap)
        except (ValueError, KeyError) as e:  # geometry changed: resume cold
            log.warning("fleet%d: actor snapshot not restored (%s) — "
                        "resuming cold", spec.fleet_id, e)

    def answer_ctrl(timeout: float) -> None:
        """Answer one pending control request; the actor is quiescent
        between run bursts, so a snapshot is consistent."""
        try:
            req = (ctrl_q.get(timeout=timeout) if timeout > 0
                   else ctrl_q.get_nowait())
        except Empty:
            return
        if req == "snapshot":
            snap_q.put(("snapshot", spec.fleet_id, actor.snapshot()))
        elif req == "probe":
            snap_q.put(("probe", spec.fleet_id, _child_report(
                spec, pumped, client.rtts if client is not None
                else act_fn.times, started)))

    try:
        while not stop_event.is_set():
            actor.run(max_steps=256, stop=stop_event.is_set)
            publish_stats()
            if ctrl_q is not None:
                answer_ctrl(0.0)
    except FleetStopped:
        pass
    finally:
        try:
            publish_stats()   # final totals; a torn write fails its CRC
        except Exception as e:
            log.warning("fleet%d: final stats publish failed: %s",
                        spec.fleet_id, e)
        if ctrl_q is not None:
            # shutdown handshake: the trainer always sends one final
            # request ("snapshot" for a drain-then-save exit, "bye"
            # otherwise); the timeout bounds an orphaned worker
            try:
                answer_ctrl(3.0)
            except Exception as e:
                log.warning("fleet%d: shutdown handshake failed: %s",
                            spec.fleet_id, e)
        actor.close()
        for e in envs:
            close = getattr(e, "close", None)
            if callable(close):
                close()
        if client is not None:
            client.close()
        if stats_writer is not None:
            stats_writer.close()
        if trace_info is not None:
            EVENTS.flush()
            EVENTS.detach()
        producer.close()


def shm_bytes(cfg: Config, action_dim: int) -> int:
    """Bytes of ``/dev/shm`` a plane for ``cfg`` maps at once: every
    fleet's block slots and (serve mode) act slab, and the stats slab."""
    from r2d2_tpu_torch.actor import fleet_shards

    shards, _ = fleet_shards(cfg)
    block = slot_layout(block_slot_spec(cfg, action_dim))[0]
    total = len(shards) * ProcessFleetPlane.SLOTS_PER_FLEET * block
    if cfg.actor_inference == "serve":
        from r2d2_tpu_torch.parallel.inference_service import act_slot_spec

        total += sum(slot_layout(act_slot_spec(cfg, action_dim, hi - lo))[0]
                     for lo, hi in shards)
    stats = slot_layout((("seq", (1,), np.int64),
                         ("values", (len(FLEET_STAT_FIELDS),), np.float64),
                         ("crc32", (1,), np.uint32)))[0]
    return total + len(shards) * stats


class ProcessFleetPlane:
    """The trainer-side orchestrator of the subprocess actor fleets.

    Construct in ``train._build`` (no processes yet); ``start(param_store)``
    spawns the fleets, and the loops from :meth:`make_loops` run under the
    fabric Supervisor:

    - ``fleet_ingest``: drains the block channels into the replay buffer;
    - ``inference_serve`` (serve mode): the act server's loop
      (:meth:`InferenceService.serve_once`);
    - ``param_pump``: forwards new ParamStore versions to every fleet (at
      most ~5 snapshots/s, one pickle per version shared by the F queue
      puts) — under serve mode the fleets' degraded-mode param feed;
    - ``fleet_watch``: respawns dead fleet processes on their lane shard,
      up to ``max_restarts`` per fleet; an exhausted budget raises, which
      the Supervisor escalates to a fabric stop.  A serve-mode respawn
      also retires the fleet's act channel and zeroes its shard of the
      server-resident hidden state.

    ``shutdown()`` stops the fleets (event + join, terminate as a last
    resort) and unlinks the shared memory.

    ``device`` is where the serve-mode service acts (default: resolved
    from ``cfg.act_device``, the current CUDA device for ``"auto"``).

    ``members`` (``league/population.py``, one per fleet): fleet f's
    child runs under ``members[f].cfg`` — its envs, actor and block math —
    and tags its blocks with the member's id; the channels, the act slabs
    and the service stay laid out under ``cfg``.  The epsilons are the
    caller's (``population_epsilons``: each member's own ladder over its
    fleet's lanes).
    """

    SLOTS_PER_FLEET = 4   # in-flight blocks per fleet channel

    def __init__(self, cfg: Config, action_dim: int, env_factory,
                 epsilons: Sequence[float], max_restarts: int = 3,
                 device=None, members: Optional[Sequence[Any]] = None):
        from r2d2_tpu_torch.actor import fleet_shards

        self.cfg = cfg
        self.action_dim = action_dim
        self.env_factory = env_factory
        self.max_restarts = max_restarts
        self.ctx = mp.get_context("spawn")
        self.members = list(members) if members else []
        if self.members:
            from r2d2_tpu_torch.league.population import (
                assert_wire_compatible,
            )

            if len(self.members) != cfg.actor_fleets:
                raise ValueError(
                    f"{len(self.members)} population members for "
                    f"{cfg.actor_fleets} fleets — one fleet per member")
            assert_wire_compatible(cfg, self.members, action_dim)
        self.fleet_cfgs = ([m.cfg for m in self.members] if self.members
                           else [cfg] * cfg.actor_fleets)
        shards, fleet_workers = fleet_shards(cfg)
        threads = max(1, (os.cpu_count() or 1) // len(shards))
        self.specs = [
            _FleetSpec(f, lo, hi, tuple(float(e) for e in epsilons[lo:hi]),
                       fleet_workers, num_threads=threads,
                       member_id=(self.members[f].member_id
                                  if self.members else 0))
            for f, (lo, hi) in enumerate(shards)
        ]
        F = len(self.specs)
        # shared metric namespace: train() swaps in the run's registry via
        # set_registry before start(); standalone planes keep this one
        self.registry = MetricsRegistry()
        self._declare_metrics(self.registry)
        self.service = None
        if cfg.actor_inference == "serve":
            from r2d2_tpu_torch.parallel.inference_service import (
                InferenceService,
            )

            self.service = InferenceService(cfg, action_dim, self.specs,
                                            self.ctx,
                                            registry=self.registry,
                                            device=device)
        # one slot per fleet, merged monotone across respawns; plain shm,
        # no queues — a SIGKILLed writer cannot corrupt it
        self.stats_slab = StatsSlab(F, FLEET_STAT_FIELDS)
        # the cross-process trace slab (telemetry/tracing.py): train()
        # hands it over before start(); fleet f writes slot
        # trace_slot_base + f, a respawn re-attaching under its new
        # incarnation
        self.trace_slab = None
        self.trace_slot_base = 0
        self.stats_merger = CounterMerger(F, FLEET_STAT_FIELDS)
        # the log loop and the exporter's health handler both scrape; an
        # unlocked concurrent fold would double-count a respawn's base
        self._stats_lock = threading.Lock()
        self.channels: List[Optional[ShmBlockChannel]] = [None] * F
        self._graveyard: List[ShmBlockChannel] = []
        self.stop_event = self.ctx.Event()
        # trainer-side mirror of the stop flag: a SIGKILLed child can die
        # holding the shared event's lock, after which a trainer-side
        # is_set()/set() could block forever — trainer logic reads this
        # bool, and shutdown() writes the event through bounded_event_set
        self._stopping = False
        self.weight_queues: List[Any] = [None] * F
        self.ctrl_queues: List[Any] = [None] * F   # requests out
        self.snap_queues: List[Any] = [None] * F   # replies back
        # replies read by a caller waiting for another kind, per fleet
        self._replies: List[Dict[str, Any]] = [{} for _ in range(F)]
        self.procs: List[Optional[Any]] = [None] * F
        self.restarts = [0] * F
        self.failed = False
        self.param_store = None
        self._pumped_version = 0
        # chaos fault sites of the plane's loops (freeze_service /
        # stall_pump); train() installs the run's injector here and on the
        # service (drop/garble response)
        self.chaos = None
        # param-staleness watchdog: per fleet, when it was FIRST seen
        # behind the store's newest version (pinned until its own version
        # advances, so a dead pump's staleness keeps growing)
        self.stale_params_budget = 30.0   # seconds before health degrades
        self._behind_since: List[Optional[float]] = [None] * F
        self._fleet_version_seen = [0.0] * F
        self._rr = 0              # ingest round-robin cursor
        self.blocks_ingested = 0
        self.frames_ingested = 0
        self.blocks_corrupt = 0   # CRC-failed blocks dropped at ingest
        self.on_corrupt: Optional[Callable[[], None]] = None
        self.blocks_per_fleet = [0] * F
        # one-shot per-fleet actor snapshots applied at the FIRST spawn
        # (full-state resume); watchdog respawns start fresh
        self._restore_snaps: List[Optional[dict]] = [None] * F

    @property
    def num_fleets(self) -> int:
        return len(self.specs)

    def set_registry(self, registry: MetricsRegistry) -> None:
        """Adopt the run's metric registry (train() calls this before
        :meth:`start` so plane counters land where the exporter scrapes)."""
        self.registry = registry
        self._declare_metrics(registry)
        if self.service is not None:
            self.service.registry = registry

    def _declare_metrics(self, registry: MetricsRegistry) -> None:
        # block-size buckets as fractions of a full block (runts come from
        # episode ends and step caps)
        bl = self.cfg.block_length
        registry.declare_histogram(
            "ingest.block_frames",
            [bl // 8, bl // 4, bl // 2, (3 * bl) // 4, bl])

    # ------------------------------------------------------------ weights
    def _snapshot_params(self):
        """The latest published params as one host buffer
        (:func:`pack_params`, narrowed to bf16 on the wire under
        ``cfg.param_pump_dtype``) and its version, or ``(None, 0)``."""
        version, params = self.param_store.get()
        if params is None:
            return None, 0
        host = pack_params(params, self.cfg.param_pump_dtype)
        HOST_TRANSFERS.count("pump.param_snapshot")
        return host, version

    @staticmethod
    def _encode_pump(version: int, host) -> bytes:
        """Pickle one pump payload ONCE; every fleet queue put then ships
        the same bytes (re-pickling pre-pickled bytes is a memcpy)."""
        return pickle.dumps((version, host),
                            protocol=pickle.HIGHEST_PROTOCOL)

    def _prime(self, f: int, payload: bytes) -> None:
        """Best-effort put of an encoded weight snapshot to fleet ``f``'s
        queue, displacing a stale one if the queue is full."""
        q = self.weight_queues[f]
        try:
            q.put_nowait(payload)
        except Full:
            try:
                q.get_nowait()
            except Empty:
                pass
            try:
                q.put_nowait(payload)
            except Full:
                pass

    def pump_params_once(self) -> bool:
        """Forward the current ParamStore version to every fleet if it is
        newer than the last pumped one.  Returns True if it pumped."""
        version, _ = self.param_store.get()
        if version == self._pumped_version:
            return False
        host, version = self._snapshot_params()
        if host is None:
            return False
        blob = self._encode_pump(version, host)
        for f in range(self.num_fleets):
            self._prime(f, blob)
        self._pumped_version = version
        return True

    # ------------------------------------------------------------- fleets
    def _spawn(self, f: int, payload=None) -> None:
        """(Re)provision fleet ``f``: a FRESH channel, control and weight
        queues, weight priming, then the process spawn.  A retired channel
        is unlinked now and kept mapped until shutdown (the ingest thread
        may still hold views); its in-flight blocks are dropped.

        ``payload`` is a pre-encoded weight snapshot (start() shares one
        pickle across all fleets); None re-snapshots (a watchdog respawn).
        Serve mode also provisions the act channel and zeroes (respawn) or
        restores (resume) the fleet's shard of the server hidden."""
        old = self.channels[f]
        if old is not None:
            try:
                old.shm.unlink()  # name freed now; mapping lives on
            except FileNotFoundError:
                pass
            self._graveyard.append(old)
        self.channels[f] = ShmBlockChannel(self.cfg, self.action_dim,
                                           self.SLOTS_PER_FLEET, self.ctx)
        self.ctrl_queues[f] = self.ctx.Queue()
        self.snap_queues[f] = self.ctx.Queue()
        self._replies[f] = {}
        self.weight_queues[f] = self.ctx.Queue(maxsize=2)
        if payload is None:
            host, version = self._snapshot_params()
            if host is not None:
                payload = self._encode_pump(version, host)
        if payload is not None:
            self._prime(f, payload)
        act_info = None
        if self.service is not None:
            act_info = self.service.make_channel(f).producer_info()
        spec = dataclasses.replace(self.specs[f],
                                   incarnation=self.restarts[f])
        restore_snap, self._restore_snaps[f] = self._restore_snaps[f], None
        if self.service is not None:
            restored = False
            if restore_snap is not None:
                try:
                    self.service.load_shard_hidden(
                        f, np.asarray(restore_snap["agent"]["hidden"],
                                      np.float32))
                    restored = True
                except (KeyError, ValueError) as e:
                    log.warning("fleet%d: server hidden not restored (%s)",
                                f, e)
            if not restored:
                # respawn or cold spawn: no stale recurrent state survives
                self.service.reset_shard(f)
        trace_info = None
        if self.trace_slab is not None:
            trace_info = self.trace_slab.writer_info(
                self.trace_slot_base + f, incarnation=self.restarts[f],
                name=f"fleet{f}")
        p = self.ctx.Process(
            target=_fleet_worker_main, name=f"fleet{f}",
            # the member's config under a population: the child's envs,
            # actor and block math run member-shaped, while the channel
            # above stays laid out under the base (asserted at
            # construction)
            args=(self.fleet_cfgs[f], self.action_dim, self.env_factory,
                  spec,
                  self.channels[f].producer_info(), self.weight_queues[f],
                  self.stop_event, self.ctrl_queues[f], self.snap_queues[f],
                  restore_snap, act_info, self.stats_slab.writer_info(f),
                  trace_info),
            daemon=True)
        p.start()
        self.procs[f] = p

    def set_restore_snapshots(self, snaps: Optional[Sequence[Optional[dict]]]
                              ) -> None:
        """Arm per-fleet actor snapshots to apply at each fleet's first
        spawn.  A fleet-count mismatch resumes cold with a warning."""
        if not snaps:
            return
        if len(snaps) != self.num_fleets:
            log.warning(
                "actor snapshots cover %d fleets but the plane has %d — "
                "resuming actors cold", len(snaps), self.num_fleets)
            return
        self._restore_snaps = list(snaps)

    def start(self, param_store) -> None:
        """Spawn every fleet.  ``param_store`` must already hold the
        initial publication (Learner.__init__ publishes v1).  Serve mode
        first starts the service, whose warm act at the full batch builds
        the kernel and raises if it fails — before any fleet waits on it."""
        self.param_store = param_store
        if self.service is not None:
            self.service.start(param_store)
        # ONE device→host transfer and one pickle shared by every fleet
        payload = None
        host, version = self._snapshot_params()
        self._pumped_version = version
        if host is not None:
            payload = self._encode_pump(version, host)
        for f in range(self.num_fleets):
            self._spawn(f, payload=payload)

    def watch_once(self) -> int:
        """Respawn any dead fleet process (skipped while shutting down).
        Returns the number of restarts; raises RuntimeError — after
        marking the plane failed — once a fleet exhausts its budget."""
        restarted = 0
        if self._stopping:
            return 0
        for f, p in enumerate(self.procs):
            if p is None or p.is_alive():
                continue
            if self.restarts[f] >= self.max_restarts:
                self.failed = True
                raise RuntimeError(
                    f"fleet{f} died (exitcode {p.exitcode}) with its "
                    f"restart budget ({self.max_restarts}) exhausted")
            self.restarts[f] += 1
            restarted += 1
            self.registry.inc("fleet.respawns", fleet=str(f))
            self._spawn(f)
        return restarted

    def probe_fleets(self, timeout: float = 60.0) -> List[Optional[dict]]:
        """Ask every live fleet for its report (:func:`_child_report`:
        pid, CUDA context, JAX loaded, threads); None for a fleet that
        did not answer within ``timeout`` (they answer between bursts)."""
        out: List[Optional[dict]] = [None] * self.num_fleets
        for f, p in enumerate(self.procs):
            if p is not None and p.is_alive():
                self.ctrl_queues[f].put("probe")
        deadline = time.time() + timeout
        for f in range(self.num_fleets):
            out[f] = self._reply(f, "probe", deadline)
        return out

    def _reply(self, f: int, kind: str, deadline: float):
        """The next ``kind`` reply from fleet ``f``, or None at the
        deadline or once the fleet has exited without one (a child flushes
        its queue before it exits).  A reply of another kind read here is
        kept for its own caller (a probe and the shutdown snapshot may
        wait at once)."""
        p, q = self.procs[f], self.snap_queues[f]
        while time.time() < deadline:
            with self._stats_lock:
                kept = self._replies[f].pop(kind, None)
            if kept is not None:
                return kept
            gone = p is None or not p.is_alive()
            try:
                tag, fid, body = q.get(
                    timeout=max(0.05, min(0.5, deadline - time.time())))
            except Empty:
                if gone:
                    return None
                continue
            if fid != self.specs[f].fleet_id:
                continue
            if tag == kind:
                return body
            with self._stats_lock:
                self._replies[f][tag] = body
        return None

    def poll_fleet_stats(self) -> dict:
        """Scrape the stats slab into the merger and return the merged
        view: ``totals`` (monotone through respawns), ``per_fleet`` rows
        and the merger's incarnation count per fleet."""
        with self._stats_lock:
            for f in range(self.num_fleets):
                got = self.stats_slab.read(f)
                if got is not None:
                    self.stats_merger.update(f, *got)
            return dict(totals=self.stats_merger.totals(),
                        per_fleet=self.stats_merger.per_slot(),
                        incarnations=self.stats_merger.incarnations())

    # --------------------------------------------------------- resilience
    def _store_version(self) -> int:
        if self.param_store is None:
            return 0
        version, _ = self.param_store.get()
        return version

    def resilience_health(self, stats: Optional[dict] = None) -> dict:
        """The plane's degraded-mode verdict: per-fleet param staleness,
        the serve fleets' circuit states and the merged ``resilience.*``
        counters.  ``degraded`` when any circuit is not closed or any fleet
        is stale past ``stale_params_budget``."""
        stats = stats if stats is not None else self.poll_fleet_stats()
        now = time.time()
        stale, circuits = [], []
        # the staleness clocks are read-modify-write state shared by every
        # health caller (exporter, log loop)
        with self._stats_lock:
            version = self._store_version()
            for f, row in enumerate(stats["per_fleet"]):
                # clamp monotone: an older stats snapshot must not roll
                # the seen version back and fake a pump delivery
                fv = max(row.get("param_version", 0.0),
                         self._fleet_version_seen[f])
                if version == 0 or fv >= version:
                    self._behind_since[f] = None
                elif fv <= 0:
                    # no version reported yet (spawn, first build):
                    # staleness is unmeasurable, don't arm the clock
                    self._behind_since[f] = None
                elif (self._behind_since[f] is None
                      or fv > self._fleet_version_seen[f]):
                    self._behind_since[f] = now
                self._fleet_version_seen[f] = fv
                since = self._behind_since[f]
                stale.append(0.0 if since is None
                             else max(0.0, now - since))
                circuits.append(int(row.get("circuit_state", 0.0)))
        totals = stats["totals"]
        max_stale = max(stale, default=0.0)
        circuits_open = sum(1 for c in circuits if c != CLOSED)
        out = dict(
            circuit_states=circuits,
            circuits_open=circuits_open,
            retries=totals.get("act_retries", 0.0),
            circuit_opens=totals.get("circuit_opens", 0.0),
            local_acts=totals.get("local_acts", 0.0),
            stale_params_s=[round(s, 3) for s in stale],
            max_stale_params_s=round(max_stale, 3),
            degraded=bool(circuits_open
                          or max_stale > self.stale_params_budget),
        )
        for f, s in enumerate(stale):
            self.registry.set_gauge("fleet.stale_params_s", s,
                                    fleet=str(f))
        return out

    # ------------------------------------------------------------- ingest
    def ingest_once(self, sink: BlockSink, timeout: float = 0.1
                    ) -> Optional[Tuple[int, int]]:
        """Deliver at most one block channel→``sink``, polling every
        fleet's channel round-robin (non-blocking; sleeps ``timeout`` when
        all are empty).  Returns ``(src, frames)`` or None."""
        F = self.num_fleets
        for j in range(F):
            f = (self._rr + j) % F
            # the channel and its owning process together: a respawn may
            # retire the channel between these reads
            ch = self.channels[f]
            p = self.procs[f]
            if ch is None:
                continue
            t0 = time.perf_counter()
            try:
                got = ch.recv(timeout=0)
            except CorruptBlockError as e:
                self.blocks_corrupt += 1
                if self.on_corrupt is not None:
                    self.on_corrupt()
                log.warning("dropped corrupt block: %s", e)
                continue
            except (OSError, EOFError, ValueError, pickle.UnpicklingError):
                if (ch is not self.channels[f]
                        or p is None or not p.is_alive()):
                    # the dying producer corrupted its queue mid-write;
                    # the watchdog retires this channel with it
                    continue
                raise
            if got is None:
                continue
            block, prios, episode_reward, slot, src = got
            try:
                sink(block, prios, episode_reward)
            finally:
                ch.release(slot)
            self._rr = (f + 1) % F
            frames = block.action.shape[0]
            if block.cut_ts > 0:
                self.registry.observe(
                    "pipeline.hop.cut_to_ingest_s",
                    max(0.0, time.time() - block.cut_ts))
            if block.trace_id and EVENTS.armed:
                EVENTS.complete("ingest.block", t0,
                                time.perf_counter() - t0,
                                flow=block.trace_id, fph="t", arg=src)
            # one shm→ring crossing per block
            HOST_TRANSFERS.count("ingest.block")
            self.blocks_ingested += 1
            self.frames_ingested += frames
            self.registry.observe("ingest.block_frames", frames)
            if 0 <= src < len(self.blocks_per_fleet):
                self.blocks_per_fleet[src] += 1
            return (src, frames)
        if timeout > 0:
            time.sleep(timeout)
        return None

    def make_loops(self, stop: Callable[[], bool], sink: BlockSink):
        """The plane's supervised fabric loops for ``train()``: block
        ingest, the act server (serve mode), the weight pump and the
        process watchdog, with the ``freeze_service`` / ``stall_pump``
        chaos sites in their loop bodies."""

        def fleet_ingest():
            while not stop():
                self.ingest_once(sink)

        def param_pump():
            while not stop():
                chaos = self.chaos
                if chaos is not None:
                    stall = chaos.pump_stall_seconds()
                    if stall > 0:
                        log.warning("chaos: stalling the param pump for "
                                    "%.1fs", stall)
                        time.sleep(stall)
                self.pump_params_once()
                time.sleep(0.2)

        def inference_serve():
            while not stop():
                served = self.service.serve_once()
                chaos = self.chaos
                # one chaos opportunity per SERVED batch: the freeze drill
                # only means something under real traffic
                if chaos is not None and served > 0:
                    freeze = chaos.service_freeze_seconds()
                    if freeze > 0:
                        log.warning("chaos: freezing the inference "
                                    "service for %.1fs", freeze)
                        time.sleep(freeze)

        def fleet_watch():
            while not stop():
                self.watch_once()
                time.sleep(0.25)

        loops = [("fleet_ingest", fleet_ingest)]
        if self.service is not None:
            loops.append(("inference_serve", inference_serve))
        loops.append(("param_pump", param_pump))
        loops.append(("fleet_watch", fleet_watch))
        return loops

    def population_health(self, stats: Optional[dict] = None
                          ) -> Optional[dict]:
        """The per-member view of the slab-merged fleet counters (fleet f
        <-> member f): env steps, blocks produced and ingested, episodes,
        reward sum — the ``population.*`` telemetry rows.  None outside a
        population run."""
        if not self.members:
            return None
        stats = stats if stats is not None else self.poll_fleet_stats()
        rows = []
        for f, m in enumerate(self.members):
            row = (stats["per_fleet"][f]
                   if f < len(stats["per_fleet"]) else {})
            rows.append(dict(
                member=m.member_id, name=m.name, preset=m.preset,
                game=m.cfg.game_name,
                lanes=self.specs[f].hi - self.specs[f].lo,
                env_steps=int(row.get("env_steps", 0)),
                blocks=int(row.get("blocks_produced", 0)),
                blocks_ingested=int(self.blocks_per_fleet[f]),
                episodes=int(row.get("episodes", 0)),
                episode_reward_sum=float(
                    row.get("episode_reward_sum", 0.0)),
                param_version=int(row.get("param_version", 0)),
            ))
        return dict(members=rows)

    def health(self) -> dict:
        stats = self.poll_fleet_stats()
        out = dict(
            fleets=self.num_fleets,
            alive=sum(1 for p in self.procs
                      if p is not None and p.is_alive()),
            restarts=list(self.restarts),
            failed=self.failed,
            blocks_ingested=self.blocks_ingested,
            frames_ingested=self.frames_ingested,
            blocks_corrupt=self.blocks_corrupt,
            blocks_per_fleet=list(self.blocks_per_fleet),
            stats=stats,
            resilience=self.resilience_health(stats),
        )
        pop = self.population_health(stats)
        if pop is not None:
            out["population"] = pop
        if self.service is not None:
            out["service"] = self.service.health()
        return out

    # ----------------------------------------------------------- shutdown
    def shutdown(self, timeout: float = 10.0, snapshot: bool = False
                 ) -> Optional[List[Optional[dict]]]:
        """Stop the fleets (event + final control message + join,
        terminate as a last resort) and unlink the shared memory.

        ``snapshot=True`` — the drain-then-save exit — asks every live
        fleet for its resumable actor snapshot on the way down and returns
        the per-fleet list (None for fleets that died or timed out);
        otherwise returns None."""
        self._stopping = True
        bounded_event_set(self.stop_event, name="fleet-stop")
        live = [f for f, p in enumerate(self.procs)
                if p is not None and p.is_alive()]
        for f in live:
            try:
                self.ctrl_queues[f].put_nowait(
                    "snapshot" if snapshot else "bye")
            except (OSError, ValueError):
                pass
        snaps: Optional[List[Optional[dict]]] = None
        if snapshot:
            snaps = [None] * self.num_fleets
            deadline = time.time() + timeout
            for f in live:
                snaps[f] = self._reply(f, "snapshot", deadline)
                if snaps[f] is None:
                    log.warning("fleet%d: no shutdown snapshot within "
                                "budget — it will resume cold", f)
        for p in self.procs:
            if p is None:
                continue
            p.join(timeout)
            if p.is_alive():
                p.terminate()
                p.join(2.0)
        for ch in list(self.channels) + self._graveyard:
            if ch is not None:
                ch.close()
        # final slab scrape BEFORE unlinking: the workers' shutdown publish
        # carries their last counters into the merged view
        self.poll_fleet_stats()
        self.stats_slab.close()
        if self.service is not None:
            self.service.close()
        return snaps
