"""Learner host loop: the drivetrain around the train step.

Port of ``r2d2_tpu/learner/learner.py`` for one process (``Learner.
__init__``, ``_publish``, ``_stage``, ``run``, the device-ring drivetrains
``run_device`` and ``_run_device_in_graph_per`` with their
``_superstep_loop``, ``_save``, the learning-health ``monitor`` hook and
the ``poison_params`` chaos drill; the multi-host branches wait for
ROADMAP.md A item 7).
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
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from r2d2_tpu_torch.checkpoint import Checkpointer, arch_meta
from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.learner.step import (
    TrainState,
    make_in_graph_per_super_step_fn,
    make_super_step_fn,
    make_train_step,
)
from r2d2_tpu_torch.models.network import R2D2Network
from r2d2_tpu_torch.replay.device_ring import to_device
from r2d2_tpu_torch.utils.store import ParamStore
from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS, Tracer

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


def place_state(state: TrainState, device: torch.device) -> TrainState:
    """``state`` with every tensor on ``device`` (no copy where it is
    already there)."""
    def on(d):
        return {k: v.to(device) for k, v in d.items()}

    state.params = on(state.params)
    state.target_params = on(state.target_params)
    state.opt_state.mu = on(state.opt_state.mu)
    state.opt_state.nu = on(state.opt_state.nu)
    return state


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
                 start_env_steps: int = 0, start_minutes: float = 0.0):
        """The learner runs on ``net``'s device; ``state`` is moved there."""
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
        self.monitor: Optional[Any] = None
        self.tracer = Tracer()
        self._step_fn = make_train_step(cfg, net)
        self.state = place_state(state, self.device)
        if self.param_store is not None:
            self._publish()

    def _publish(self) -> None:
        # a clone: the step updates the parameters in place, so a snapshot
        # that aliased them would change under the actors mid-act
        self.param_store.publish({k: v.detach().clone()
                                  for k, v in self.state.params.items()})

    @property
    def num_updates(self) -> int:
        return self.state.step

    def _note_results(self, losses_np: np.ndarray,
                      strict: bool = True) -> None:
        """Route harvested losses to the attached monitor.  Without a
        monitor, ``strict`` fails fast on a non-finite loss; with one, the
        monitor trips the fabric's clean stop and fires the ``nonfinite``
        alert instead of crashing the learner thread."""
        m = self.monitor
        if m is not None:
            m.note_losses(losses_np)
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
        per field.  Each copy ticks ``learner.batch_h2d``."""
        host = {k: batch[k] for k in batch
                if k not in DEVICE_BATCH_KEYS and k != PACKED_KEY}
        cuda = self.device.type == "cuda"
        packed = batch.get(PACKED_KEY)
        if packed is not None:
            buf, layout = packed
            HOST_TRANSFERS.count("learner.batch_h2d")
            dev = _unpack(buf.to(self.device, non_blocking=cuda), layout)
            return {k: dev[k] for k in DEVICE_BATCH_KEYS}, host
        dev = {}
        for k in DEVICE_BATCH_KEYS:
            t = torch.from_numpy(np.ascontiguousarray(batch[k]))
            if cuda:
                t = t.pin_memory()
            HOST_TRANSFERS.count("learner.batch_h2d")
            dev[k] = t.to(self.device, non_blocking=cuda)
        return dev, host

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
        and checkpoint save."""
        cfg = self.cfg
        tracer = tracer or self.tracer
        t0 = time.time()
        target = cfg.training_steps if max_steps is None else (
            self.num_updates + max_steps)

        # prefetch_batches == 0 → fully synchronous staging (deterministic;
        # used by train_sync and tests).  Otherwise a Supervisor-managed
        # thread keeps up to ``prefetch_batches`` staged batches ahead of
        # compute; a transient staging crash restarts the loop, and only
        # an exhausted restart budget ends the stream.
        pf_sup = None
        done = threading.Event()
        if cfg.prefetch_batches > 0:
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
                    HOST_TRANSFERS.allowed("learner.result_fetch"):
                flat = result.fetch()
            loss, priorities = float(flat[0]), flat[1:]
            self._note_results(np.asarray([loss]), strict=False)
            losses.append(loss)
            self.env_steps = int(host.get("env_steps", self.env_steps))
            if priority_sink is not None:
                priority_sink(host["idxes"], priorities, host["block_ptr"],
                              loss)

        updates = self.num_updates
        pending: deque = deque()
        try:
            while updates < target:
                if stop is not None and stop():
                    break
                with tracer.span("learner.batch_wait"):
                    item = next_item()
                if item is None:
                    break
                dev_batch, host = item
                with tracer.span("learner.step_dispatch"):
                    self.state, loss, priorities = self._step_fn(self.state,
                                                                 dev_batch)
                    result = _Result(loss, priorities)
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
        return dict(
            num_updates=self.num_updates,
            env_steps=self.env_steps,
            minutes=self.start_minutes + (time.time() - t0) / 60.0,
            mean_loss=float(np.mean(losses)) if losses else float("nan"),
        )

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
        before any later write lands (device_ring's contract); the k steps
        are issued after the lock is released, since they read only the
        gathered batches."""
        cfg = self.cfg
        tracer = tracer or self.tracer
        k = cfg.superstep_k
        t0 = time.time()
        target = cfg.training_steps if max_steps is None else (
            self.num_updates + max_steps)
        if cfg.in_graph_per:
            return self._run_device_in_graph_per(buffer, ring, k, target,
                                                 t0, stop, tracer)
        super_step = make_super_step_fn(cfg, self.net, k)
        B = cfg.batch_size
        losses_hist: deque = deque(maxlen=100)   # bounded, see run()

        def dispatch(ints, weights):
            with tracer.span("learner.gather_dispatch"):
                # the dispatch's one declared H2D: the index rows and
                # their weights (a few KB)
                with HOST_TRANSFERS.allowed("learner.dispatch_put"):
                    HOST_TRANSFERS.count("learner.dispatch_put_bytes",
                                         ints.nbytes + weights.nbytes)
                    d_ints = to_device(ints, self.device)
                    d_w = to_device(weights, self.device)
                return super_step.gather(ring.snapshot(), d_ints, d_w)

        def sample():
            with tracer.span("learner.sample_meta"):
                meta = buffer.sample_meta(k, dispatch=dispatch)
            with tracer.span("learner.step_dispatch"):
                meta["dispatched"] = super_step.run(self.state,
                                                    meta.pop("dispatched"))
            return meta

        def prepare(item):
            # start the result's D2H now, so a harvest
            # ``superstep_pipeline`` dispatches later finds it landed
            meta, losses, priorities = item
            return meta, _Result(losses, priorities)

        def harvest(item) -> None:
            meta, result = item
            with tracer.span("learner.result_sync"), \
                    HOST_TRANSFERS.allowed("learner.result_fetch"):
                flat = result.fetch()
            self._feed_back(meta, flat[:k], flat[k:].reshape(k, B),
                            priority_sink, losses_hist)

        self._superstep_loop(k, target, t0, self._ready_gate(buffer, stop),
                             sample, harvest, prepare=prepare, tracer=tracer)
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
        super-step as one asynchronous dispatch, in microseconds; here
        the host issues each inner step's kernels, and the hold is that
        long (capturing the super-step in a CUDA graph would shrink it)."""
        cfg = self.cfg
        super_step = make_in_graph_per_super_step_fn(cfg, self.net, k)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(cfg.seed)
        losses_hist: deque = deque(maxlen=100)

        def sample():
            with tracer.span("learner.step_dispatch"):
                with buffer.lock:
                    with tracer.span("learner.dispatch_lock"):
                        meta = ring.per_meta()
                        state, prios, losses = super_step(
                            self.state, ring.snapshot(), ring.take_prios(),
                            meta["seq_meta"], meta["first"],
                            generator=generator)
                        ring.put_prios(prios)
                        env_steps = buffer.env_steps
            # the losses ride the pipeline; priorities never leave the
            # device
            return dict(dispatched=(state, losses, None),
                        env_steps=env_steps)

        def prepare(item):
            meta, losses, _ = item
            return meta, _Result(losses)

        def harvest(item) -> None:
            meta, result = item
            with tracer.span("learner.result_sync"), \
                    HOST_TRANSFERS.allowed("learner.result_fetch"):
                losses_np = result.fetch()
            self._note_results(losses_np)
            self.env_steps = int(meta["env_steps"])
            buffer.note_updates(losses_np.shape[0], losses_np.sum())
            losses_hist.extend(losses_np.tolist())

        self._superstep_loop(k, target, t0, self._ready_gate(buffer, stop),
                             sample, harvest, prepare=prepare, tracer=tracer)
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
                   losses_hist: deque) -> None:
        """Route one harvested super-step's results to the host side: one
        priority feedback per inner step."""
        self._note_results(losses_np)
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
        self.checkpointer.save(updates, self.state,
                               meta=dict(env_steps=self.env_steps,
                                         minutes=minutes,
                                         game=self.cfg.game_name,
                                         **arch_meta(self.cfg)))
        self._saved_steps.add(updates)
