"""Learner host loop: the drivetrain around the train step.

Port of ``r2d2_tpu/learner/learner.py`` (``Learner.__init__``, ``_publish``,
``_stage``, ``run`` and ``_save``; the device-ring drivetrain, the
multi-host branches and the chaos hook wait for later slices).
Capability-parity with the reference learner's ``run`` (worker.py:300-381):
staged batch prefetch, periodic weight publication, periodic
checkpointing.  Target-net sync happens inside the step, so the host loop
only drives data and cadences.

- The prefetch thread (``cfg.prefetch_batches > 0``) runs under the
  port's :class:`~r2d2_tpu_torch.utils.supervisor.Supervisor` and stages
  batches onto the device ahead of compute (pinned host copies, copied
  without blocking).
- Results are harvested behind up to ``cfg.superstep_pipeline`` in-flight
  steps: each step's loss and priorities leave the device in ONE
  non-blocking copy into pinned host memory, and an event marks when it
  has landed, so the harvest usually finds the bytes already on the host.
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
from r2d2_tpu_torch.learner.step import TrainState, make_train_step
from r2d2_tpu_torch.models.network import R2D2Network
from r2d2_tpu_torch.utils.store import ParamStore
from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS, Tracer

# the batch fields the step reads; the rest of a sampled batch (idxes,
# block_ptr, env_steps, ages) is host bookkeeping
DEVICE_BATCH_KEYS = (
    "obs", "last_action", "last_reward", "hidden", "action",
    "n_step_reward", "n_step_gamma", "burn_in", "learning", "forward",
    "is_weights",
)

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
    """One step's loss and priorities on their way to the host: on a CUDA
    device a non-blocking copy into pinned memory and the event that marks
    its end; on the CPU the tensor itself."""

    def __init__(self, loss: torch.Tensor, priorities: torch.Tensor):
        flat = torch.cat([loss.reshape(1).float(), priorities.float()])
        self._event = None
        if flat.device.type == "cuda":
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
            flat = host
        self._flat = flat

    def fetch(self) -> Tuple[float, np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        flat = self._flat.numpy()
        return float(flat[0]), flat[1:]


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

    def _stage(self, batch: Dict[str, np.ndarray]
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        """Split host bookkeeping from device fields and start the H2D
        copies (from pinned memory without blocking, on a CUDA device)."""
        host = {k: batch[k] for k in batch if k not in DEVICE_BATCH_KEYS}
        cuda = self.device.type == "cuda"
        dev = {}
        for k in DEVICE_BATCH_KEYS:
            t = torch.from_numpy(np.ascontiguousarray(batch[k]))
            if cuda:
                t = t.pin_memory()
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
                loss, priorities = result.fetch()
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
