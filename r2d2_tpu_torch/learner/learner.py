"""Learner host loop: the drivetrain around the train step.

Port of ``r2d2_tpu/learner/learner.py`` (``Learner.__init__``,
``_publish``, ``_stage``, ``run``, the device-ring drivetrains
``run_device``, ``_run_device_in_graph_per`` and ``_run_device_multihost``
with their ``_superstep_loop`` and ``_collective_gate``, ``_save``, the
learning-health ``monitor`` hook and the ``poison_params`` chaos drill).

With a ``mesh`` (``train(cfg, use_mesh=True)``) the state is DTensors in
the sharding table's layout (parallel/sharding.py) and the learner is one
rank of the meshed learner: the leader of its dp group
(``distributed.dp_group``) samples the group's rows of the global batch
from its own buffer, broadcasts them to the group's other ranks
(``group_broadcast``, issued over a group of one too) and feeds back the
group's priorities; a peer (a rank of the group that is not its leader)
has no buffer and trains on the rows it receives.  Every rank publishes
full plain clones and agrees every stop and "not ready" with all the
others through one collective gate per update or dispatch — the JAX
package's multi-host learner, which is the port's only meshed path (one
device per rank), even at world size 1.

Capability-parity with the reference learner's ``run`` (worker.py:300-381):
staged batch prefetch, periodic weight publication, periodic
checkpointing.  Target-net sync happens inside the step, so the host loop
only drives data and cadences.

- The prefetch thread (``cfg.prefetch_batches > 0``) runs under the
  port's :class:`~r2d2_tpu_torch.utils.supervisor.Supervisor` and stages
  batches onto the device ahead of compute (pinned host copies, copied
  without blocking).
- Results are harvested behind up to ``cfg.superstep_pipeline`` in-flight
  steps (or super-steps): each dispatch's losses and priorities leave the
  device in ONE non-blocking copy into pinned host memory, and an event
  marks when it has landed, so the harvest usually finds the bytes already
  on the host.
- Weight publication is a versioned snapshot (ParamStore): a detached
  clone, because the step updates the parameters in place.
- On a card the steps replay as CUDA graphs (learner/graphs.py): the
  train step, and each inner step of both super-steps, meshless and on
  the mesh, where a graph holds the step's collectives.  The state is
  placed once, here, and never rebound: a graph reads it at its address
  (a DTensor's at its local shard's).
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from r2d2_tpu_torch.checkpoint import Checkpointer, arch_meta
from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.learner.graphs import make_learner_step
from r2d2_tpu_torch.learner.step import (
    TrainState,
    make_in_graph_per_super_step_fn,
    make_super_step_fn,
    place_counters,
)
from r2d2_tpu_torch.models.network import R2D2Network
from r2d2_tpu_torch.replay.device_ring import to_device
from r2d2_tpu_torch.utils.store import ParamStore
from r2d2_tpu_torch.telemetry.learnhealth import DIAG_SIZE, diag_enabled
from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS, TRANSFER_GUARD, Tracer

# the batch fields the step reads; the rest of a sampled batch (idxes,
# block_ptr, env_steps, ages) is host bookkeeping
DEVICE_BATCH_KEYS = (
    "obs", "last_action", "last_reward", "hidden", "action",
    "n_step_reward", "n_step_gamma", "burn_in", "learning", "forward",
    "is_weights",
)

# the key of a packed batch's one host buffer (:func:`packed_batch`)
PACKED_KEY = "_packed"


def packed_batch(spec, pin: bool) -> Dict[str, Any]:
    """Numpy views, one per ``(name, shape, dtype)`` of ``spec``, into ONE
    host buffer (pinned when ``pin``), plus that buffer under
    :data:`PACKED_KEY`.  A batch assembled into these views reaches the
    device in one copy (:meth:`Learner._stage`) instead of one pinned
    staging copy and one transfer per field — the sharded replay planes
    assemble their batches so."""
    from r2d2_tpu_torch.replay.block import slot_layout, slot_views

    nbytes, offsets = slot_layout(spec)
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
    views = slot_views(host.numpy(), spec, offsets, nbytes, 0)
    views[PACKED_KEY] = (host, tuple(
        (name, offsets[name], tuple(shape), np.dtype(dtype))
        for name, shape, dtype in spec))
    return views


def _unpack(buf: torch.Tensor, layout) -> Dict[str, torch.Tensor]:
    """Typed views of a packed batch's device copy (8-byte aligned fields,
    ``slot_layout``)."""
    out = {}
    for name, off, shape, dtype in layout:
        n = int(np.prod(shape)) * dtype.itemsize
        tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
        out[name] = buf[off:off + n].view(tdtype).view(shape)
    return out


# batch_source() -> host batch dict (blocking); returns None to stop early.
BatchSource = Callable[[], Optional[Dict[str, np.ndarray]]]
# priority_sink(idxes, priorities, old_ptr, loss)
PrioritySink = Callable[[np.ndarray, np.ndarray, int, float], None]


def global_is_weights(q: np.ndarray, beta: float,
                      gmin: Optional[np.ndarray] = None) -> np.ndarray:
    """IS weights of a meshed draw: this rank's raw densities ``q`` (k, B
    rows, ``sample_meta(raw_densities=True)``) normalised by each step's
    minimum density over EVERY rank's rows, ``(q / min)^-beta`` — the JAX
    package's multi-host arithmetic (float64, one cast to float32).
    ``gmin`` is agreed over the ranks (one ``sync_min_array``) unless
    given."""
    if gmin is None:
        from r2d2_tpu_torch.parallel.distributed import sync_min_array

        gmin = sync_min_array(q.min(axis=1), tag="min_density")
    return ((q / gmin[:, None]) ** (-beta)).astype(np.float32)


def place_state(state: TrainState, device: torch.device) -> TrainState:
    """``state`` with every tensor on ``device`` (no copy where it is
    already there), its device counters included."""
    def on(d):
        return {k: v.to(device) for k, v in d.items()}

    state.params = on(state.params)
    state.target_params = on(state.target_params)
    state.opt_state.mu = on(state.opt_state.mu)
    state.opt_state.nu = on(state.opt_state.nu)
    return place_counters(state, device)


class _Result:
    """One dispatch's results (a step's loss and priorities, a super-step's
    losses and priorities) on their way to the host, flattened into one
    float32 vector: on a CUDA device a non-blocking copy into pinned
    memory and the event that marks its end; on the CPU the tensor
    itself."""

    def __init__(self, *tensors: torch.Tensor):
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        self._event = None
        if flat.device.type == "cuda":
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
            flat = host
        self._flat = flat

    def fetch(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._flat.numpy()


class Learner:
    def __init__(self, cfg: Config, net: R2D2Network, state: TrainState,
                 param_store: Optional[ParamStore] = None,
                 checkpointer: Optional[Checkpointer] = None,
                 start_env_steps: int = 0, start_minutes: float = 0.0,
                 mesh: Any = None, table: Any = None, span: Any = None):
        """The learner runs on ``net``'s device; ``state`` is moved there.
        With a ``mesh`` (a ``DeviceMesh`` of the learner's ranks) the state
        is placed through ``table`` (default: the table over ``mesh`` and
        ``cfg``), every update runs the meshed step, and ``span`` is this
        rank's dp group (default: ``distributed.dp_group(mesh)``, made
        here, a collective)."""
        self.cfg = cfg
        self.net = net
        self.device = next(net.parameters()).device
        self.param_store = param_store
        self.checkpointer = checkpointer
        self.env_steps = start_env_steps
        self.start_minutes = start_minutes
        self._saved_steps: set = set()  # steps THIS run saved (see _save)
        # learnhealth plane (telemetry/learnhealth.py): the trainer
        # attaches a LearnHealthMonitor that absorbs each harvested loss
        # and, with cfg.learnhealth_interval > 0, each step's diagnostic
        # vector, folded into the same single result fetch
        self.monitor: Optional[Any] = None
        self._lh = diag_enabled(cfg)
        self.tracer = Tracer()
        # the collective gate's outcomes ("go", "wait", "break") under a
        # mesh: one gate per update or dispatch
        self.gate_counts: collections.Counter = collections.Counter()
        self.mesh, self.table = mesh, table
        # this rank's dp group under a mesh; a peer holds no data plane
        self.span = span
        if mesh is not None and span is None:
            from r2d2_tpu_torch.parallel.distributed import dp_group

            self.span = dp_group(mesh)
        state = place_state(state, self.device)
        if mesh is None:
            self._step_fn = make_learner_step(cfg, net, learnhealth=self._lh)
        else:
            from r2d2_tpu_torch.parallel.sharding import (
                ShardingTable,
                mesh_train_step,
            )

            if self.table is None:
                self.table = ShardingTable(mesh, cfg)
            self._step_fn = mesh_train_step(cfg, net, self.table,
                                            state_template=state)
            self._batch_shardings = self.table.batch_shardings()
            state = self.table.place_state(state)
        self.state = state
        if self.param_store is not None:
            self._publish()

    def _publish(self) -> None:
        # a clone: the step updates the parameters in place, so a snapshot
        # that aliased them would change under the actors mid-act.  Under
        # a mesh the full tensors are gathered here, on the learner thread
        # (a collective), and the actors get plain local clones: an actor
        # thread never touches a DTensor nor issues a collective
        from r2d2_tpu_torch.parallel.sharding import full

        self.param_store.publish({k: full(v).detach().clone()
                                  for k, v in self.state.params.items()})

    @property
    def num_updates(self) -> int:
        return self.state.step

    @property
    def is_peer(self) -> bool:
        """A rank of a dp group that is not its leader: it trains on the
        rows its leader broadcasts and runs no data plane."""
        return self.span is not None and not self.span.is_leader

    def _share(self, tensors, tag: str):
        """The leader's tensors on every rank of its dp group
        (``group_broadcast``; a peer passes None)."""
        from r2d2_tpu_torch.parallel.distributed import group_broadcast

        return group_broadcast(self.span, None if self.is_peer else tensors,
                               tag=tag)

    def full_params(self) -> Dict[str, torch.Tensor]:
        """The online params as full plain tensors (under a mesh gathered
        from their shards: a collective, on the learner thread)."""
        from r2d2_tpu_torch.parallel.sharding import full

        return {k: full(v) for k, v in self.state.params.items()}

    def _note_results(self, losses_np: np.ndarray,
                      diags_np: Optional[np.ndarray] = None,
                      strict: bool = True) -> None:
        """Route harvested losses (and the learnhealth diag rows) to the
        attached monitor.  Without a monitor, ``strict`` fails fast on a
        non-finite loss; with one, the monitor trips the fabric's clean
        stop and fires the ``nonfinite`` alert instead of crashing the
        learner thread."""
        m = self.monitor
        if m is not None:
            m.note_losses(losses_np)
            if diags_np is not None and diags_np.size:
                m.absorb_diags(diags_np)
            return
        if strict:
            assert np.isfinite(losses_np).all(), (
                f"non-finite loss: {losses_np}")

    def poison_params(self) -> None:
        """Chaos drill hook (``poison_params`` site, utils/chaos.py):
        overwrite the first param tensor with NaN so the next step's loss
        and grads go non-finite — the learnhealth NaN-sentry drill.  Runs
        on the learner thread, between steps."""
        name = next(iter(self.state.params))
        with torch.no_grad():
            self.state.params[name].mul_(float("nan"))

    def _stage(self, batch: Dict[str, np.ndarray]
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        """Split host bookkeeping from device fields and start the H2D
        copies (from pinned memory without blocking, on a CUDA device):
        one copy of the whole buffer for a :func:`packed_batch`, else one
        per field.  Each copy ticks ``learner.batch_h2d``.  Under a mesh
        the batch holds the dp group's rows, which :meth:`run` broadcasts
        to the group and wraps as its shard of the global dp-sharded
        batch, on the learner thread."""
        host = {k: batch[k] for k in batch
                if k not in DEVICE_BATCH_KEYS and k != PACKED_KEY}
        cuda = self.device.type == "cuda"
        packed = batch.get(PACKED_KEY)
        # the copies start from pinned memory and wait on nothing: an
        # armed guard catches any copy that would
        with TRANSFER_GUARD.disallow("learner.stage"):
            if packed is not None:
                buf, layout = packed
                HOST_TRANSFERS.count("learner.batch_h2d")
                dev = _unpack(buf.to(self.device, non_blocking=cuda),
                              layout)
                dev = {k: dev[k] for k in DEVICE_BATCH_KEYS}
            else:
                dev = {}
                for k in DEVICE_BATCH_KEYS:
                    t = torch.from_numpy(np.ascontiguousarray(batch[k]))
                    if cuda:
                        t = t.pin_memory()
                    HOST_TRANSFERS.count("learner.batch_h2d")
                    dev[k] = t.to(self.device, non_blocking=cuda)
        return dev, host

    def _group_batch(self, dev: Optional[Dict[str, torch.Tensor]]
                     ) -> Dict[str, Any]:
        """The dp group's staged rows (the leader's ``dev``; None on a
        peer) on every rank of the group, as this rank's shard of the
        global dp-sharded batch."""
        from r2d2_tpu_torch.parallel.distributed import host_local_batch

        got = self._share(None if dev is None else
                          [dev[k] for k in DEVICE_BATCH_KEYS], "batch")
        return host_local_batch(self.mesh, dict(zip(DEVICE_BATCH_KEYS, got)),
                                self._batch_shardings)

    def run(self, batch_source: BatchSource,
            priority_sink: Optional[PrioritySink] = None,
            max_steps: Optional[int] = None,
            stop: Optional[Callable[[], bool]] = None,
            tracer: Optional[Tracer] = None) -> Dict[str, float]:
        """Drive training until ``cfg.training_steps`` (or ``max_steps``
        more updates, or ``stop()``).  Returns summary metrics.

        Results (loss + priorities) are harvested behind up to
        ``cfg.superstep_pipeline`` in-flight steps; priority feedback lags
        ≤ pipeline steps (0 = fully synchronous, the train_sync setting).
        ``tracer`` (default: the learner's own) records per-stage spans:
        batch wait, step dispatch, the device→host result sync, publish
        and checkpoint save.

        Under a mesh a peer passes no ``batch_source``: it takes each
        update's rows from its leader."""
        cfg = self.cfg
        tracer = tracer or self.tracer
        t0 = time.time()
        target = cfg.training_steps if max_steps is None else (
            self.num_updates + max_steps)
        peer = self.is_peer
        if peer:
            priority_sink = None

        # prefetch_batches == 0 → fully synchronous staging (deterministic;
        # used by train_sync and tests).  Otherwise a Supervisor-managed
        # thread keeps up to ``prefetch_batches`` staged batches ahead of
        # compute; a transient staging crash restarts the loop, and only
        # an exhausted restart budget ends the stream.
        pf_sup = None
        done = threading.Event()
        if peer:
            def next_item():
                return None, {}
        elif cfg.prefetch_batches > 0:
            from r2d2_tpu_torch.utils.supervisor import Supervisor

            staged: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch_batches)

            def prefetch():
                while not done.is_set():
                    batch = batch_source()
                    item = None if batch is None else self._stage(batch)
                    # bounded put that re-checks done: when the learner
                    # stops consuming with the queue full, the thread must
                    # exit rather than park in put() forever.  A None item
                    # is the end-of-stream sentinel — delivered through the
                    # queue, so a supervised restart can never fabricate one
                    while not done.is_set():
                        try:
                            staged.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if batch is None:
                        return

            pf_sup = Supervisor(max_restarts=2, backoff=0.1)
            pf_thread = pf_sup.start("learner_prefetch", prefetch)

            def next_item():
                # a producer that exhausted its restart budget with the
                # queue empty can never enqueue its sentinel — only then
                # give up
                while True:
                    try:
                        return staged.get(timeout=0.5)
                    except queue.Empty:
                        if pf_sup.any_failed or (not pf_thread.alive
                                                 and done.is_set()):
                            return None
        else:
            def next_item():
                batch = batch_source()
                return None if batch is None else self._stage(batch)

        # bounded to exactly the reported window
        losses: deque = deque(maxlen=100)

        def harvest(pending_item) -> None:
            host, result = pending_item
            with tracer.span("learner.result_sync"), \
                    TRANSFER_GUARD.disallow("learner.harvest"), \
                    HOST_TRANSFERS.allowed("learner.result_fetch"):
                flat = result.fetch()
            # one flat vector: the loss, the priorities, then (learnhealth)
            # the step's diag vector
            loss, diag = float(flat[0]), None
            if self._lh:
                priorities, diag = flat[1:-DIAG_SIZE], flat[-DIAG_SIZE:]
            else:
                priorities = flat[1:]
            self._note_results(np.asarray([loss]),
                               None if diag is None else diag[None],
                               strict=False)
            losses.append(loss)
            self.env_steps = int(host.get("env_steps", self.env_steps))
            if priority_sink is not None:
                priority_sink(host["idxes"], priorities, host["block_ptr"],
                              loss)

        updates = self.num_updates
        pending: deque = deque()
        try:
            while updates < target:
                stopping = stop is not None and stop()
                item = None
                if not stopping:
                    with tracer.span("learner.batch_wait"):
                        item = next_item()
                if self.mesh is not None:
                    # the step is a collective: every rank takes it or
                    # none does
                    stopping = self._agree(stopping or item is None,
                                           True) == "break"
                if stopping or item is None:
                    break
                dev_batch, host = item
                if self.mesh is not None:
                    dev_batch = self._group_batch(dev_batch)
                with tracer.span("learner.step_dispatch"), \
                        TRANSFER_GUARD.disallow("learner.dispatch"):
                    out = self._step_fn(self.state, dev_batch)
                    self.state = out[0]
                    # the diag rides the step's one result copy
                    result = _Result(*out[1:])
                pending.append((host, result))
                while len(pending) > cfg.superstep_pipeline:
                    harvest(pending.popleft())

                updates += 1
                if (self.param_store is not None
                        and updates % cfg.weight_publish_interval == 0):
                    with tracer.span("learner.publish"):
                        self._publish()
                if (self.checkpointer is not None
                        and updates % cfg.save_interval == 0):
                    with tracer.span("learner.checkpoint_save"):
                        self._save(updates, t0)
            while pending:
                harvest(pending.popleft())
        finally:
            done.set()
            if pf_sup is not None:
                # stop supervision and reap the prefetch thread; it exits
                # at its next done poll
                pf_sup.join_all(timeout=2.0)

        if self.checkpointer is not None:
            self._save(self.num_updates, t0)
        self._sum_env_steps()
        return dict(
            num_updates=self.num_updates,
            env_steps=self.env_steps,
            minutes=self.start_minutes + (time.time() - t0) / 60.0,
            mean_loss=float(np.mean(losses)) if losses else float("nan"),
        )

    def _sum_env_steps(self) -> None:
        """Under a mesh the run's env steps are every leader's (a peer
        runs no actors)."""
        if self.mesh is not None:
            from r2d2_tpu_torch.parallel.distributed import sync_counter

            self.env_steps = sync_counter(
                0 if self.is_peer else self.env_steps, "sum",
                tag="env_steps")

    def _agree(self, stopping: bool, ready: bool) -> str:
        """The collective gate's decision: "break" when any rank stops,
        else "wait" when any rank is not ready, else "go" — one
        ``sync_min_array`` of both flags ("stop" travels inverted)."""
        from r2d2_tpu_torch.parallel.distributed import sync_min_array

        flags = sync_min_array([0.0 if stopping else 1.0,
                                1.0 if ready else 0.0], tag="gate")
        out = ("break" if flags[0] == 0.0
               else "wait" if flags[1] == 0.0 else "go")
        self.gate_counts[out] += 1
        return out

    def _collective_gate(self, buffer, stop):
        """The meshed device drivetrains' gate(): every super-step is a
        collective, so whether to make it is decided by all ranks
        together (:meth:`_agree`).  A peer (no buffer) is always ready."""
        def gate() -> str:
            return self._agree(stop is not None and stop(),
                               buffer is None or buffer.ready)
        return gate

    # ------------------------------------------------ device-ring drivetrain
    def run_device(self, buffer: Any, ring: Any,
                   priority_sink: Optional[PrioritySink] = None,
                   max_steps: Optional[int] = None,
                   stop: Optional[Callable[[], bool]] = None,
                   tracer: Optional[Tracer] = None) -> Dict[str, float]:
        """Drive training from the device-resident replay ring
        (replay/device_ring.py): ``superstep_k`` optimizer steps per
        dispatch, batches gathered on the device, one small H2D (the index
        bundle and its weights) and one small D2H (stacked losses and
        priorities) per dispatch.  Replaces :meth:`run`'s host staging
        when ``cfg.device_replay``: batch bytes never cross PCIe.

        The update counter advances by k per dispatch, so the loop may
        overshoot ``training_steps`` by up to k-1 updates.  Under
        ``cfg.in_graph_per`` it hands over to
        :meth:`_run_device_in_graph_per`.

        The k gathers are enqueued under the buffer lock, as
        ``sample_meta``'s ``dispatch`` callback, so they read the ring
        before any later write lands (device_ring's contract).  Meshless,
        the whole super-step is issued there: on a card k graph replays
        (learner/graphs.py), each gathering its batch and stepping on it.
        Under a mesh the k steps are issued after the lock is released and
        the group's broadcast, since they read only the gathered
        batches."""
        cfg = self.cfg
        tracer = tracer or self.tracer
        k = cfg.superstep_k
        t0 = time.time()
        target = cfg.training_steps if max_steps is None else (
            self.num_updates + max_steps)
        if self.is_peer:
            # a peer of a dp group: no buffer, ring or feedback of its own
            buffer = ring = priority_sink = None
        if cfg.in_graph_per:
            return self._run_device_in_graph_per(buffer, ring, k, target,
                                                 t0, stop, tracer)
        if self.mesh is not None:
            return self._run_device_multihost(buffer, ring, priority_sink,
                                              k, target, t0, stop, tracer)
        return self._run_host_sampled(buffer, ring, priority_sink, k,
                                      target, t0, tracer,
                                      self._ready_gate(buffer, stop))

    def _run_device_multihost(self, buffer, ring, priority_sink, k: int,
                              target: int, t0: float, stop, tracer
                              ) -> Dict[str, float]:
        """Device-resident replay over the mesh's ranks (JAX's multi-host
        data plane, here also the world-size-1 path).  Each rank's buffer
        and ring are one dp group's slab of the global ring; its writes
        and draws are its own.  Per super-step every rank:

        1. agrees that all ranks are ready and none stops (the collective
           gate, :meth:`_agree`);
        2. draws its ``host_batch_size`` rows per step from its own slab
           with their raw inclusion densities
           (``sample_meta(raw_densities=True)``), agrees the k global
           minimum densities (one ``sync_min_array``) so the IS weights
           keep the reference's min-of-the-whole-batch normalisation, and
           gathers its rows from its own slab;
        3. runs the meshed super-step on the global batch its rows are a
           dp shard of;
        4. feeds its rows of the priorities back to its own buffer —
           feedback never crosses ranks.

        Batch bytes never leave the dp group; only the gradient
        reductions, the two small agreements and the group's broadcast
        cross ranks.  Step 2's draw and gathers run under the buffer lock
        (the device_ring contract).  Steps 2 and 4 are the leader's: it
        broadcasts the k gathered batches to its dp group in one
        ``group_broadcast`` a super-step, and a peer (``buffer`` and
        ``ring`` None) trains on them."""
        return self._run_host_sampled(buffer, ring, priority_sink, k,
                                      target, t0, tracer,
                                      self._collective_gate(buffer, stop),
                                      multihost=True)

    def _run_host_sampled(self, buffer, ring, priority_sink, k: int,
                          target: int, t0: float, tracer, gate,
                          multihost: bool = False) -> Dict[str, float]:
        """The host-sampled super-step loop of :meth:`run_device` and
        :meth:`_run_device_multihost` (``multihost``: this rank's rows,
        raw densities normalised by the global minimum, the meshed
        super-step)."""
        cfg = self.cfg
        if multihost:
            from r2d2_tpu_torch.parallel.distributed import host_batch_size
            from r2d2_tpu_torch.parallel.sharding import mesh_super_step

            B = host_batch_size(cfg, self.mesh)
            super_step = mesh_super_step(cfg, self.net, self.table, k,
                                         state_template=self.state)
        else:
            B = cfg.batch_size
            super_step = make_super_step_fn(cfg, self.net, k,
                                            learnhealth=self._lh)
        beta = cfg.importance_sampling_exponent
        losses_hist: deque = deque(maxlen=100)   # bounded, see run()
        peer = multihost and self.is_peer

        def share(batches):
            # the k gathered batches, one (k, B, ...) tensor a field, on
            # every rank of the dp group
            got = self._share(None if batches is None else [
                torch.stack([b[f] for b in batches])
                for f in DEVICE_BATCH_KEYS], "super_batch")
            return [{f: t[j] for f, t in zip(DEVICE_BATCH_KEYS, got)}
                    for j in range(k)]

        def dispatch(ints, weights):
            with tracer.span("learner.gather_dispatch"):
                if multihost:
                    weights = global_is_weights(weights, beta)
                # the dispatch's one declared H2D: the index rows and
                # their weights (a few KB)
                with HOST_TRANSFERS.allowed("learner.dispatch_put"):
                    HOST_TRANSFERS.count("learner.dispatch_put_bytes",
                                         ints.nbytes + weights.nbytes)
                    d_ints = to_device(ints, self.device)
                    d_w = to_device(weights, self.device)
                if multihost:
                    return super_step.gather(ring.snapshot(), d_ints, d_w)
                with tracer.span("learner.step_dispatch"):
                    return super_step(self.state, ring.snapshot(), d_ints,
                                      d_w)

        def sample():
            with TRANSFER_GUARD.disallow("learner.dispatch"):
                if peer:
                    # the leaders' agreement on the k minimum densities
                    # spans every rank: a peer adds nothing to the min
                    from r2d2_tpu_torch.parallel.distributed import (
                        sync_min_array,
                    )

                    sync_min_array(np.full(k, np.inf), tag="min_density")
                    meta = dict(env_steps=self.env_steps)
                    out = share(None)
                else:
                    with tracer.span("learner.sample_meta"):
                        meta = buffer.sample_meta(k, batch_size=B,
                                                  dispatch=dispatch,
                                                  raw_densities=multihost)
                    # meshless: the super-step's results; else the batches
                    out = meta.pop("dispatched")
                    if multihost:
                        out = share(out)
                if multihost:
                    with tracer.span("learner.step_dispatch"):
                        out = super_step.run(self.state, out)
            # the diag rows ride with the losses (prepare)
            meta["dispatched"] = ((out[0], (out[1], out[3]), out[2])
                                  if self._lh else out)
            return meta

        def prepare(item):
            # start the result's D2H now, so a harvest
            # ``superstep_pipeline`` dispatches later finds it landed: ONE
            # flat vector of the losses, priorities and (learnhealth) the
            # (k, DIAG_SIZE) diag rows
            meta, losses, priorities = item
            if self._lh:
                losses, diags = losses
                return meta, _Result(losses, priorities, diags)
            return meta, _Result(losses, priorities)

        def harvest(item) -> None:
            meta, result = item
            with tracer.span("learner.result_sync"), \
                    TRANSFER_GUARD.disallow("learner.harvest"), \
                    HOST_TRANSFERS.allowed("learner.result_fetch"):
                flat = result.fetch()
            diags = (flat[k + k * B:].reshape(k, DIAG_SIZE) if self._lh
                     else None)
            self._feed_back(meta, flat[:k], flat[k:k + k * B].reshape(k, B),
                            priority_sink, losses_hist, diags)

        self._superstep_loop(k, target, t0, gate, sample, harvest,
                             prepare=prepare, tracer=tracer)
        return self._finish_device_run(losses_hist, t0)

    def _ready_gate(self, buffer, stop):
        """The device drivetrains' gate(): stop-aware, waits for
        ``learning_starts``."""
        def gate() -> str:
            if stop is not None and stop():
                return "break"
            return "go" if buffer.ready else "wait"
        return gate

    def _finish_device_run(self, losses_hist, t0: float) -> Dict[str, float]:
        """The device drivetrains' epilogue: the final save and the
        summary."""
        if self.checkpointer is not None:
            self._save(self.num_updates, t0)
        self._sum_env_steps()
        return dict(
            num_updates=self.num_updates,
            env_steps=self.env_steps,
            minutes=self.start_minutes + (time.time() - t0) / 60.0,
            mean_loss=(float(np.mean(losses_hist))
                       if losses_hist else float("nan")),
        )

    def _run_device_in_graph_per(self, buffer, ring, k: int, target: int,
                                 t0: float, stop, tracer
                                 ) -> Dict[str, float]:
        """Device-PER drivetrain (``cfg.in_graph_per``): sampling, IS
        weights and priority feedback all run inside the super-step
        (learner/step.py:make_in_graph_per_super_step_fn), so a dispatch
        puts nothing on the device and fetches one small D2H (the losses,
        for logging); the k inner steps sample from the priorities the
        previous inner step wrote.

        The uniforms come from a ``torch.Generator`` on the learner's
        device seeded with ``cfg.seed`` at the start of each run — JAX's
        per-run ``fold_in(PRNGKey(seed), dispatch_idx)`` stream in
        semantics, not in bits.

        The buffer lock is held while the whole super-step is issued (the
        ``learner.dispatch_lock`` span): step j+1 samples from priorities
        step j scattered, so an actor's ``commit_per`` enqueued between
        them could be overwritten by a stale scatter.  JAX issues the
        super-step as one asynchronous dispatch, in microseconds; on a
        card the port replays one CUDA graph an inner step
        (learner/graphs.py), and the hold is those k replays; the first
        dispatch also captures them.  Under a mesh an inner step's graph
        holds its collectives too, and only the metadata gather of each
        dispatch runs outside the graphs.

        Under a mesh, at every world size, the ring is this rank's slab
        and the draw is global (parallel/cross_rank.py): every rank draws
        the same strata over every slab's leaves, trains its rows of the
        batch, exchanged from the slabs that hold them, and writes back
        the new priorities of the leaves it owns.  Every rank seeds the
        generator alike and passes the collective gate before each
        dispatch, so the uniforms stay in lockstep (JAX's note: its
        dispatch counters advance together for the same reason); each
        rank holds its own buffer lock over its issue.

        When a dp group spans ranks only its leader holds the slab: the
        draw runs over the leaders (their dp axis of the mesh), and each
        inner step the leader broadcasts its rows and their leaf indices
        to its group (``group_broadcast``, issued over a group of one
        too); a peer (``buffer`` and ``ring`` None) trains on them and
        feeds nothing back."""
        cfg = self.cfg
        cross = None
        peer = self.is_peer
        if peer:
            from r2d2_tpu_torch.parallel.cross_rank import GroupPeer

            cross = GroupPeer(self.span)
        elif self.mesh is not None:
            from r2d2_tpu_torch.parallel.cross_rank import CrossRank

            cross = CrossRank(cfg, self.mesh, ring.cfg.num_blocks,
                              span=self.span)
        train_step = None
        if self.mesh is not None:
            from r2d2_tpu_torch.parallel.sharding import mesh_step

            train_step = mesh_step(cfg, self.net, self.table, self.state)
        super_step = make_in_graph_per_super_step_fn(
            cfg, self.net, k, train_step=train_step, cross=cross,
            learnhealth=self._lh)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(cfg.seed)
        losses_hist: deque = deque(maxlen=100)

        def sample():
            with tracer.span("learner.step_dispatch"), \
                    TRANSFER_GUARD.disallow("learner.dispatch"):
                if peer:
                    out = super_step(self.state, None, None, None, None)
                    return dict(dispatched=(out[0], out[2:], None),
                                env_steps=self.env_steps)
                with buffer.lock:
                    with tracer.span("learner.dispatch_lock"):
                        meta = ring.per_meta()
                        out = super_step(
                            self.state, ring.snapshot(), ring.take_prios(),
                            meta["seq_meta"], meta["first"],
                            generator=generator)
                        ring.put_prios(out[1])
                        env_steps = buffer.env_steps
            # the losses (and the diag rows) ride the pipeline; priorities
            # never leave the device
            return dict(dispatched=(out[0], out[2:], None),
                        env_steps=env_steps)

        def prepare(item):
            meta, losses, _ = item
            return meta, _Result(*losses)

        def harvest(item) -> None:
            meta, result = item
            with tracer.span("learner.result_sync"), \
                    TRANSFER_GUARD.disallow("learner.harvest"), \
                    HOST_TRANSFERS.allowed("learner.result_fetch"):
                flat = result.fetch()
            losses_np = flat[:k]
            self._note_results(losses_np, flat[k:].reshape(k, DIAG_SIZE)
                               if self._lh else None)
            self.env_steps = int(meta["env_steps"])
            if buffer is not None:
                buffer.note_updates(losses_np.shape[0], losses_np.sum())
            losses_hist.extend(losses_np.tolist())

        gate = (self._ready_gate(buffer, stop) if self.mesh is None
                else self._collective_gate(buffer, stop))
        self._superstep_loop(k, target, t0, gate, sample, harvest,
                             prepare=prepare, tracer=tracer)
        return self._finish_device_run(losses_hist, t0)

    def _superstep_loop(self, k: int, target: int, t0: float,
                        gate: Callable[[], str],
                        sample: Callable[[], Dict[str, Any]],
                        harvest: Callable[[Any], None],
                        prepare: Callable[[Any], Any],
                        tracer: Tracer) -> None:
        """The pipelined super-step loop of both device drivetrains: keep
        up to ``cfg.superstep_pipeline`` dispatches in flight beyond the
        one being harvested.  ``prepare`` runs at enqueue time and starts
        the result's D2H copy, so a harvest ``superstep_pipeline``
        dispatches later finds the bytes on the host.  Priority feedback
        lags ≤ (pipeline+1)·k updates.  Cadences fire on interval
        crossings (updates advance by k per dispatch).

        ``gate()`` → "break" | "wait" | "go" decides each iteration;
        ``sample()`` returns a meta dict whose ``dispatched`` holds the
        in-flight (state, losses, priorities)."""
        cfg = self.cfg
        updates = self.num_updates
        pending: deque = deque()
        while updates < target:
            g = gate()
            if g == "break":
                break
            if g == "wait":
                time.sleep(0.02)
                continue
            meta = sample()
            self.state, losses, priorities = meta["dispatched"]
            pending.append(prepare((meta, losses, priorities)))
            while len(pending) > cfg.superstep_pipeline:
                harvest(pending.popleft())

            prev, updates = updates, updates + k
            if (self.param_store is not None
                    and updates // cfg.weight_publish_interval
                    > prev // cfg.weight_publish_interval):
                with tracer.span("learner.publish"):
                    self._publish()
            if (self.checkpointer is not None
                    and updates // cfg.save_interval
                    > prev // cfg.save_interval):
                with tracer.span("learner.checkpoint_save"):
                    self._save(updates, t0)
        while pending:
            harvest(pending.popleft())

    def _feed_back(self, meta, losses_np: np.ndarray, prios_np: np.ndarray,
                   priority_sink: Optional[PrioritySink],
                   losses_hist: deque,
                   diags_np: Optional[np.ndarray] = None) -> None:
        """Route one harvested super-step's results to the host side: one
        priority feedback per inner step."""
        self._note_results(losses_np, diags_np)
        self.env_steps = int(meta["env_steps"])
        if priority_sink is not None:
            for j in range(losses_np.shape[0]):
                priority_sink(meta["idxes"][j], prios_np[j],
                              meta["block_ptr"], float(losses_np[j]))
        losses_hist.extend(losses_np.tolist())

    def _save(self, updates: int, t0: float) -> None:
        if updates in self._saved_steps:
            # THIS RUN already saved this step completely (the epilogue
            # save lands on the same step as the last cadence save
            # whenever training_steps % save_interval == 0); re-saving
            # would rewrite a payload under a sidecar that marks it
            # complete
            return
        minutes = self.start_minutes + (time.time() - t0) / 60.0
        state = self.state
        if self.mesh is not None:
            # every rank gathers the full state (a collective); rank 0
            # writes it in the meshless byte layout, so a checkpoint
            # crosses between meshed and meshless runs
            import torch.distributed as dist

            from r2d2_tpu_torch.parallel.sharding import gather_state

            state = gather_state(state)
            if dist.get_rank() != 0:
                self._saved_steps.add(updates)
                return
        self.checkpointer.save(updates, state,
                               meta=dict(env_steps=self.env_steps,
                                         minutes=minutes,
                                         game=self.cfg.game_name,
                                         **arch_meta(self.cfg)))
        self._saved_steps.add(updates)
