"""Centralized batched inference for the process actor plane.

Port of ``r2d2_tpu/parallel/inference_service.py``, whole.  With
``cfg.actor_inference="serve"`` the fleet subprocesses run no network:
each env step ships its lanes' inputs to one server that batches across
every fleet and acts once per batch on the learner's device.

- **Act slab**: each fleet owns one shared-memory request/response slot
  (:func:`act_slot_spec`, laid out by ``replay.block.slot_layout`` — the
  reference's byte layout, request and response CRCs included, so a JAX
  fleet can act through a torch service and the other way round).  The
  fleet writes ``(obs, last_action, last_reward, reset_mask)``, posts a
  ``(seq, mode)`` token on its request queue and waits on the response
  queue; the reply carries ``(q, new_hidden)`` in the same slab.  CRC32
  integrity words, written last, cover each direction.
- **Server-resident recurrent state**: one ``(num_actors, 2, layers, H)``
  hidden array, indexed by global lane, zeroed by each request's reset
  mask and shard-wide when the watchdog respawns a fleet.  The response
  carries the post-step hidden so the fleet records R2D2's stored state
  into its blocks; the server's copy is authoritative.
- **Zero-staleness weights**: the service reads the trainer's ParamStore
  each batch.  The weight pump still runs as the fleets' degraded-mode
  param feed.
- **Peek requests**: the episode-step-cap bootstrap asks for q without
  advancing state (``MODE_PEEK``).

**Degraded-mode failover** (utils/resilience.py): every attempt is bounded
by ``cfg.act_response_timeout`` and verified by the response CRC; a
timeout or a garbled response retries (jittered backoff, each retry a
*resync* request that ships the fleet's hidden carry, so a half-served
predecessor never double-advances server state), and exhausted retries
open the fleet's circuit breaker.  While it is open the fleet acts through
its own CPU twin on its last pumped weights; each cooldown one half-open
probe (a resync commit) tries to re-attach.  The fleet's counters publish
through the stats slab as ``resilience.*``, and an open circuit degrades
``/healthz``: the failover is visible, never silent.

On the device: each batch makes ONE host→device copy of the assembled lane
slabs (staged in one pinned buffer: hidden, last action, last reward,
observations) and ONE device→host copy of q and the new hidden, counted
under ``HOST_TRANSFERS`` ``serve.act_put`` and ``serve.act_fetch``.  The
act runs the service's own ``R2D2Network`` (``functional_call`` swaps a
module's params while it runs, so the learner's module is never shared);
on a CUDA device it resolves ``lstm_impl="auto"`` to the fused
``lstm_infer`` kernel, one launch per LSTM layer per batch, and replays
one CUDA graph of the act (actor.py:GraphedAct), captured by
:meth:`InferenceService.start`'s warm-up act and reused by every batch and
peek; each new ParamStore version is copied into the act's own param
tensors on the serve thread before the batch that first reads it.  Every port
path issues on the default stream, so a batch queues behind an in-flight
super-step.  The act runs in a ``TRANSFER_GUARD`` window (``serve.act``)
whose two declared crossings are those copies, and a capture window marks
each served batch with a ``serve.batch`` instant carrying its lane count.
"""
from __future__ import annotations

import collections
import contextlib
import logging
import threading
import time
from multiprocessing import shared_memory
from queue import Empty
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.parallel.actor_procs import FleetStopped, fleet_act_net
from r2d2_tpu_torch.replay.block import payload_crc32, slot_layout, slot_views
from r2d2_tpu_torch.utils.resilience import (
    CLOSED,
    OPEN,
    CircuitBreaker,
    Deadline,
    RetryPolicy,
)
from r2d2_tpu_torch.telemetry.tracing import EVENTS
from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS, TRANSFER_GUARD

log = logging.getLogger(__name__)

# request payload fields, in CRC order (shared by producer + verifier)
_REQ_FIELDS = ("obs", "last_action", "last_reward", "reset_mask")

# act-request modes on the token queue (``(seq, mode)``)
MODE_PEEK = 0     # q only; no reset application, no hidden scatter
MODE_COMMIT = 1   # normal act: advance server-resident hidden
MODE_RESYNC = 2   # commit, but FIRST load the shard's hidden from the
                  # slab's sync_hidden region (retries + re-attach probes)


class ActTimeout(Exception):
    """One act RPC attempt exceeded ``cfg.act_response_timeout``."""


class ActGarbled(Exception):
    """A response arrived but failed its CRC32 integrity check."""


def act_slot_spec(cfg: Config, action_dim: int, num_lanes: int):
    """(name, shape, dtype) of ONE fleet's act request/response slot.

    Request region (fleet-written): the batched inputs minus hidden
    (server-resident), the reset mask, the resync hidden rows, the
    ``req_seq`` word and the request CRC.  Response region
    (server-written): q per lane, the post-step hidden rows and the
    response CRC (written last)."""
    n = num_lanes
    return (
        ("obs", (n, *cfg.stored_obs_shape), np.uint8),
        ("last_action", (n, action_dim), np.float32),
        ("last_reward", (n,), np.float32),
        ("reset_mask", (n,), np.uint8),
        ("sync_hidden", (n, 2, cfg.lstm_layers, cfg.hidden_dim),
         np.float32),
        ("req_seq", (1,), np.int64),
        ("req_crc", (1,), np.uint32),
        ("q", (n, action_dim), np.float32),
        ("rsp_hidden", (n, 2, cfg.lstm_layers, cfg.hidden_dim), np.float32),
        ("rsp_crc", (1,), np.uint32),
    )


def act_request_crc(views: dict, seq: int, mode: int) -> int:
    """CRC32 over the request payload plus the token header; resync
    requests also cover the sync_hidden rows they carry."""
    fields = [views[name] for name in _REQ_FIELDS]
    if int(mode) == MODE_RESYNC:
        fields.append(views["sync_hidden"])
    return payload_crc32((seq, int(mode)), fields)


def act_response_crc(views: dict, seq: int, mode: int) -> int:
    """CRC32 over the response region (q; plus the hidden rows for
    commit-mode replies, the only ones that carry them)."""
    fields = [views["q"]]
    if int(mode) != MODE_PEEK:
        fields.append(views["rsp_hidden"])
    return payload_crc32((seq, int(mode)), fields)


def _span(tracer, name: str):
    return tracer.span(name) if tracer is not None else (  # graftlint: disable=telemetry-discipline -- nullable-tracer pass-through; every call site passes a literal
        contextlib.nullcontext())


class ActChannel:
    """Trainer-side end of ONE fleet's inference RPC transport: the act
    slab plus the two token queues.  Fleet-private and retired wholesale
    on respawn, like the block channel."""

    def __init__(self, cfg: Config, action_dim: int, num_lanes: int, ctx):
        self.num_lanes = num_lanes
        self.spec = act_slot_spec(cfg, action_dim, num_lanes)
        self.nbytes, self.offsets = slot_layout(self.spec)
        self.shm = shared_memory.SharedMemory(create=True, size=self.nbytes)
        self.req_q = ctx.Queue()
        self.rsp_q = ctx.Queue()
        self.views = slot_views(self.shm.buf, self.spec, self.offsets,
                                self.nbytes, 0)

    def producer_info(self) -> Tuple[str, Any, Any]:
        """The picklable handle the fleet child attaches with
        (:class:`RemoteActClient`)."""
        return (self.shm.name, self.req_q, self.rsp_q)

    def close(self) -> None:
        self.views = None
        try:
            self.shm.close()
        except BufferError:
            # a straggler still holds slab views; the mapping dies with
            # the process — unlinking below still frees the name
            pass
        try:
            self.shm.unlink()
        except FileNotFoundError:
            pass


class RemoteActClient:
    """Fleet-side act function: each call is one RPC over the act slab.

    Has the host act fn signature ``(params, obs, last_action,
    last_reward, hidden) → (q, new_hidden)``, so it plugs into a
    VectorActor; ``params`` is ignored and ``hidden`` is the fleet's
    authoritative carry (consumed by resyncs and the local fallback).
    The returned arrays are slab views (remote) or fresh arrays (local),
    valid until the next call.  Waits poll ``stop_event``.
    ``stats`` holds the slab-published ``resilience.*`` counters;
    ``on_state_change``, when given, is called after every circuit
    transition, so the fleet publishes its circuit state when it changes
    (the reference publishes it only at the end of a 256-step burst,
    which under load can start and end a whole degraded window:
    ROADMAP.md C 17)."""

    def __init__(self, cfg: Config, action_dim: int, num_lanes: int,
                 info: Tuple[str, Any, Any], stop_event, src: int = 0,
                 param_store=None, local_act_factory=None,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 on_state_change: Optional[Callable[[], None]] = None):
        name, self.req_q, self.rsp_q = info
        self.cfg = cfg
        self.shm = shared_memory.SharedMemory(name=name)
        self.spec = act_slot_spec(cfg, action_dim, num_lanes)
        nbytes, offsets = slot_layout(self.spec)
        self.views = slot_views(self.shm.buf, self.spec, offsets, nbytes, 0)
        self.num_lanes = num_lanes
        self.stop_event = stop_event
        self.src = src
        self._seq = 0
        self.timeout = float(cfg.act_response_timeout)
        # the degraded-mode kit: a param feed (the fleet's pumped store)
        # and a factory for the local act twin, built only if needed
        self.param_store = param_store
        self._local_act_factory = local_act_factory
        self._local_act = None
        self.retry = retry if retry is not None else RetryPolicy(
            attempts=3, base=0.05, max_delay=1.0,
            seed=cfg.seed + 7_577 * (src + 1))
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            name=f"fleet{src}.act",
            cooldown=max(0.5, min(5.0, self.timeout)),
            on_transition=self._on_transition)
        self.stats = dict(act_retries=0, circuit_opens=0, local_acts=0,
                          circuit_state=float(CLOSED))
        self._on_state_change = on_state_change
        # (wall-clock end, seconds) of the recent answered attempts: the
        # act-RPC round trip, reported when the trainer probes the fleet
        self.rtts: collections.deque = collections.deque(maxlen=8192)
        # lanes whose server-side hidden is zeroed at the next commit;
        # starts all-pending (a fresh incarnation's lanes all start anew)
        self._pending_resets = set(range(num_lanes))

    # ------------------------------------------------------------- breaker
    def _on_transition(self, bname: str, old: int, new: int) -> None:
        self.stats["circuit_state"] = float(new)
        if new == OPEN:
            self.stats["circuit_opens"] += 1
            log.warning(
                "fleet%d: act circuit OPEN (service unresponsive) — "
                "degrading to fleet-local inference on the last pumped "
                "weights; half-open probe every %.1fs", self.src,
                self.breaker.cooldown)
        elif new == CLOSED:
            log.warning("fleet%d: act circuit CLOSED — re-attached to the "
                        "inference service (hidden resynced from the "
                        "fleet's carry)", self.src)
        if self._on_state_change is not None:
            self._on_state_change()

    # --------------------------------------------------- VectorActor hooks
    def note_reset(self, lane: int) -> None:
        """Lane ``lane`` starts a fresh episode: its server hidden is
        zeroed at the next commit request."""
        self._pending_resets.add(int(lane))

    def clear_reset_notes(self) -> None:
        """VectorActor.restore: lanes resuming mid-episode must NOT zero
        the server hidden the snapshot restored."""
        self._pending_resets.clear()

    def __call__(self, params, obs, last_action, last_reward, hidden):
        return self._rpc(obs, last_action, last_reward, hidden,
                         MODE_COMMIT)

    def peek(self, params, obs, last_action, last_reward, hidden):
        """Bootstrap forward (episode-step cap): q WITHOUT advancing
        server state.  Returns ``(q, None)``."""
        return self._rpc(obs, last_action, last_reward, hidden, MODE_PEEK)

    # ---------------------------------------------------------- local path
    def _await_params(self):
        """Latest pumped params for the local twin; blocks (stop-aware)
        until the feed delivers the first snapshot (the pump primes each
        fleet's queue at spawn)."""
        if self.param_store is None:
            raise RuntimeError(
                f"fleet{self.src}: circuit open but no local fallback "
                "was provisioned (no param feed)")
        while True:
            _, params = self.param_store.get()
            if params is not None:
                return params
            if self.stop_event.is_set():
                raise FleetStopped
            time.sleep(0.05)

    def _local(self, obs, last_action, last_reward, hidden, mode: int):
        """Degraded-mode act: the fleet's CPU twin over its last pumped
        weights and its authoritative hidden carry — local mode's act, so
        blocks stay bit-exact with a local-mode fleet's."""
        if self._local_act is None:
            if self._local_act_factory is None:
                raise RuntimeError(
                    f"fleet{self.src}: circuit open but no local act "
                    "factory was provisioned")
            log.warning("fleet%d: building the local act twin for "
                        "degraded-mode inference", self.src)
            self._local_act = self._local_act_factory()
        params = self._await_params()
        q, new_hidden = self._local_act(params, obs, last_action,
                                        last_reward, hidden)
        self.stats["local_acts"] += 1
        if mode == MODE_PEEK:
            return q, None
        # the reset is already in the fleet's carry — the next resync
        # transfers it wholesale
        self._pending_resets.clear()
        return q, new_hidden

    # ---------------------------------------------------------- remote rpc
    def _write_request(self, obs, last_action, last_reward, hidden,
                       mode: int) -> None:
        v = self.views
        v["obs"][:] = obs
        v["last_action"][:] = last_action
        v["last_reward"][:] = last_reward
        mask = np.zeros(self.num_lanes, np.uint8)
        if mode != MODE_PEEK and self._pending_resets:
            mask[sorted(self._pending_resets)] = 1
        v["reset_mask"][:] = mask
        if mode == MODE_RESYNC:
            v["sync_hidden"][:] = hidden
        self._seq += 1
        v["req_seq"][0] = self._seq
        # CRC last: the slab is only valid once the integrity word matches
        v["req_crc"][0] = act_request_crc(v, self._seq, mode)
        self.req_q.put((self._seq, int(mode)))

    def _await_response(self, mode: int,
                        timeout: Optional[float] = None) -> None:
        """Wait (bounded, stop-aware) for the reply to ``self._seq`` and
        verify its CRC.  Raises ActTimeout / ActGarbled — retryable."""
        budget = self.timeout if timeout is None else timeout
        deadline = Deadline(budget)
        while True:
            if self.stop_event.is_set():
                raise FleetStopped
            try:
                seq = self.rsp_q.get(timeout=deadline.poll_timeout(0.2))
            except Empty:
                if deadline.expired:
                    raise ActTimeout(
                        f"fleet{self.src}: no inference response within "
                        f"{budget:.1f} s (seq {self._seq})")
                continue
            if seq != self._seq:
                continue   # stale token from a superseded attempt
            v = self.views
            if int(v["rsp_crc"][0]) != act_response_crc(v, seq, mode):
                raise ActGarbled(
                    f"fleet{self.src}: response {seq} failed CRC32")
            return

    def _attempt(self, obs, last_action, last_reward, hidden, mode: int,
                 timeout: Optional[float] = None):
        t0 = time.perf_counter()
        self._write_request(obs, last_action, last_reward, hidden, mode)
        self._await_response(mode, timeout=timeout)
        self.rtts.append((time.time(), time.perf_counter() - t0))
        v = self.views
        if mode == MODE_PEEK:
            return v["q"], None
        self._pending_resets.clear()
        return v["q"], v["rsp_hidden"]

    def _rpc(self, obs, last_action, last_reward, hidden, mode: int):
        state = self.breaker.state
        if state != CLOSED:
            # peeks never probe: a peek cannot resync hidden
            if (mode == MODE_PEEK or state == OPEN
                    or not self.breaker.allow_attempt()):
                return self._local(obs, last_action, last_reward, hidden,
                                   mode)
            # the half-open probe: ONE resync attempt, bounded by the
            # cooldown so a long outage never starves the local path
            try:
                out = self._attempt(obs, last_action, last_reward, hidden,
                                    MODE_RESYNC,
                                    timeout=min(self.timeout,
                                                self.breaker.cooldown))
            except (ActTimeout, ActGarbled) as e:
                log.warning("fleet%d: re-attach probe failed (%s) — "
                            "circuit re-opens", self.src, e)
                self.breaker.record_failure()
                return self._local(obs, last_action, last_reward, hidden,
                                   mode)
            self.breaker.record_success()
            return out
        # circuit closed: bounded retries, each retry in resync mode (the
        # failed attempt may have half-advanced the server state)
        eff = mode
        for attempt in range(1, self.retry.attempts + 1):
            try:
                out = self._attempt(obs, last_action, last_reward, hidden,
                                    eff)
            except (ActTimeout, ActGarbled) as e:
                if attempt >= self.retry.attempts:
                    log.warning(
                        "fleet%d: act RPC failed after %d attempts (%s)",
                        self.src, attempt, e)
                    self.breaker.record_failure()   # -> OPEN
                    return self._local(obs, last_action, last_reward,
                                       hidden, mode)
                self.stats["act_retries"] += 1
                if mode != MODE_PEEK:
                    eff = MODE_RESYNC
                time.sleep(self.retry.backoff(attempt))
                continue
            self.breaker.record_success()
            return out

    def close(self) -> None:
        self.views = None
        try:
            self.shm.close()
        except BufferError:
            pass


_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.uint8): torch.uint8}


class InferenceService:
    """The trainer-side act server for every serve-mode fleet.

    Owns the per-fleet :class:`ActChannel` s (created and retired by
    ``ProcessFleetPlane._spawn``), the server-resident hidden array and the
    act function on ``device``.  ``serve_once`` is the supervised loop
    body: drain pending tokens, give the other lockstep fleets
    ``cfg.inference_batch_window`` seconds to catch up, run ONE act at the
    full ``num_actors`` batch (lanes not pending carry stale rows whose
    outputs are discarded), scatter the replies.

    ``device`` (default: resolved from ``cfg.act_device``) is where the act
    runs; on the CPU the act is the fleets' twin (float32, scan), so serve
    mode's blocks equal local mode's there bit for bit.
    """

    def __init__(self, cfg: Config, action_dim: int, specs: Sequence[Any],
                 ctx, registry=None, device=None):
        from r2d2_tpu_torch.actor import _resolve_act_device

        self.cfg = cfg
        self.action_dim = action_dim
        self.specs = list(specs)          # per-fleet (fleet_id, lo, hi)
        self.ctx = ctx
        self.device = _resolve_act_device(cfg.act_device, device)
        if registry is None:
            from r2d2_tpu_torch.telemetry.registry import MetricsRegistry

            registry = MetricsRegistry()
        self.registry = registry
        F = len(self.specs)
        self.channels: List[Optional[ActChannel]] = [None] * F
        self._graveyard: List[ActChannel] = []
        N = cfg.num_actors
        self.hidden = np.zeros((N, 2, cfg.lstm_layers, cfg.hidden_dim),
                               np.float32)
        self._hidden_lock = threading.Lock()
        # fleet -> (seq, mode, channel): drained-but-unanswered requests,
        # kept as service state so a supervisor restart of the serve loop
        # answers them instead of wedging the blocked fleets
        self._pending: dict = {}
        self.param_store = None
        self.net = None
        self._act = None
        self._stage = None
        self._params = None
        self._param_version = 0
        self.tracer = None                # set by train(); spans optional
        self.chaos = None                 # set by train(): drop/garble sites
        self.batches = 0
        self.warmups = 0                  # acts run by start(), not served
        self.lanes_served = 0
        self.last_batch_lanes = 0
        self.peeks = 0
        self.requests_corrupt = 0
        self.shard_resets = 0
        self.partial_batches = 0          # batches serving < all attached
                                          # fleets
        self.stale_requests = 0           # tokens superseded by a retry
        self.resyncs = 0                  # MODE_RESYNC requests honoured
        self.dropped_responses = 0        # chaos drop_act_response fires
        self.garbled_responses = 0        # chaos garble_act_response fires

    # ------------------------------------------------------------ channels
    def make_channel(self, f: int) -> ActChannel:
        """Fresh act channel for fleet ``f``, retiring any predecessor
        (unlinked now, kept mapped: the serve loop may hold views)."""
        old = self.channels[f]
        if old is not None:
            try:
                old.shm.unlink()
            except FileNotFoundError:
                pass
            self._graveyard.append(old)
        self._pending.pop(f, None)   # the dead incarnation's request
        spec = self.specs[f]
        ch = ActChannel(self.cfg, self.action_dim, spec.hi - spec.lo,
                        self.ctx)
        self.channels[f] = ch
        return ch

    # -------------------------------------------------------- hidden state
    def reset_shard(self, f: int) -> None:
        """Zero fleet ``f``'s server hidden lanes (a respawned fleet must
        never act on its predecessor's recurrent state)."""
        spec = self.specs[f]
        with self._hidden_lock:
            self.hidden[spec.lo:spec.hi] = 0.0
        self.shard_resets += 1
        self.registry.inc("serve.shard_resets", fleet=str(f))

    def load_shard_hidden(self, f: int, hidden: np.ndarray) -> None:
        """Restore fleet ``f``'s hidden lanes from its actor snapshot; a
        geometry mismatch zeroes instead (the lanes resume cold)."""
        spec = self.specs[f]
        with self._hidden_lock:
            if hidden.shape != self.hidden[spec.lo:spec.hi].shape:
                log.warning(
                    "fleet%d: snapshot hidden %s does not match shard %s — "
                    "zeroing", f, hidden.shape,
                    self.hidden[spec.lo:spec.hi].shape)
                self.hidden[spec.lo:spec.hi] = 0.0
            else:
                self.hidden[spec.lo:spec.hi] = hidden

    # ---------------------------------------------------------------- act
    def _build_stage(self) -> None:
        """One host buffer for a batch's inputs — pinned when the act runs
        on a CUDA device — with numpy views the assembly writes into, so
        the batch crosses to the device in one copy."""
        cfg, N, A = self.cfg, self.cfg.num_actors, self.action_dim
        spec = (("hidden", (N, 2, cfg.lstm_layers, cfg.hidden_dim),
                 np.float32),
                ("last_action", (N, A), np.float32),
                ("last_reward", (N,), np.float32),
                ("obs", (N, *cfg.stored_obs_shape), np.uint8))
        nbytes, offsets = slot_layout(spec)
        self._stage = torch.zeros(nbytes, dtype=torch.uint8,
                                  pin_memory=self.device.type == "cuda")
        self._stage_spec = [(name, shape, offsets[name],
                             int(np.prod(shape)) * np.dtype(dt).itemsize,
                             _TORCH_DTYPES[np.dtype(dt)])
                            for name, shape, dt in spec]
        self._views = slot_views(self._stage.numpy(), spec, offsets,
                                 nbytes, 0)
        self.obs = self._views["obs"]
        self.last_action = self._views["last_action"]
        self.last_reward = self._views["last_reward"]

    def start(self, param_store) -> None:
        """Build the service's network on its device and run one act at
        the full batch on zeros: the kernel is built and launched here (on
        a card, the act's CUDA graph captured), and a failure raises
        before any fleet waits on the service."""
        self.param_store = param_store
        if self._act is None:
            from r2d2_tpu_torch.actor import make_act_fn
            from r2d2_tpu_torch.models.network import create_network

            if self.device.type == "cpu":
                self.net = fleet_act_net(self.cfg, self.action_dim)
            else:
                self.net = create_network(self.cfg, self.action_dim,
                                          device=self.device)
            self._act = make_act_fn(self.net)
            self._build_stage()
        self._refresh_params()
        if self._params is None:
            raise RuntimeError("InferenceService.start needs a published "
                               "parameter snapshot in the store")
        self._act_batch(np.zeros_like(self.hidden), "serve.warm_fetch")
        self.warmups += 1

    def _refresh_params(self) -> None:
        """Adopt the newest ParamStore publication, placed on the service's
        device once per version (no copy when the learner shares it)."""
        version, params = self.param_store.get_placed(self.device)
        if params is None or version == self._param_version:
            return
        self._params = params
        self._param_version = version

    def _act_batch(self, hidden_in: np.ndarray, fetch_name: str):
        """The full-batch act on the staged inputs: one H2D of the stage,
        the act, one D2H of ``(q, new_hidden)`` as numpy."""
        self._views["hidden"][:] = hidden_in
        with HOST_TRANSFERS.allowed("serve.act_put"):
            dev = self._stage.to(self.device, non_blocking=True)
        args = {name: dev[off:off + n].view(dt).view(shape)
                for name, shape, off, n, dt in self._stage_spec}
        q, new_hidden = self._act(self._params, args["obs"],
                                  args["last_action"], args["last_reward"],
                                  args["hidden"])
        N, A = q.shape
        # ONE device→host fetch per cross-fleet batch
        with HOST_TRANSFERS.allowed(fetch_name):
            flat = torch.cat([q, new_hidden.reshape(N, -1)], 1).cpu().numpy()
        return flat[:, :A], flat[:, A:].reshape(new_hidden.shape)

    # --------------------------------------------------------------- serve
    def _drain(self, f: int) -> bool:
        """Pull one pending request token from fleet ``f`` (non-blocking).
        The channel is captured WITH the token: a respawn may retire it
        concurrently, and the reply must go to the slab it was written to."""
        ch = self.channels[f]
        if ch is None or f in self._pending:
            return False
        try:
            seq, mode = ch.req_q.get_nowait()
        except Empty:
            return False
        except (OSError, EOFError, ValueError, TypeError):
            return False   # retired channel / corrupted pipe: respawn path
        if int(ch.views["req_seq"][0]) != seq:
            # superseded by a retry: answering would act on a
            # half-overwritten slab for a reply nobody consumes
            self.stale_requests += 1
            self.registry.inc("serve.stale_requests", fleet=str(f))
            return True
        if int(ch.views["req_crc"][0]) != act_request_crc(ch.views, seq,
                                                          mode):
            # garbled: DROP it (serving would stamp a valid response CRC
            # over a poisoned reply); the fleet's retry resends clean
            self.requests_corrupt += 1
            log.warning("fleet%d: act request %d failed CRC32 — dropped "
                        "(fleet retry resends clean)", f, seq)
            return True
        self._pending[f] = (seq, int(mode), ch)
        return True

    def serve_once(self, idle_sleep: float = 0.001) -> int:
        """One service iteration: gather pending requests, act, scatter.
        Returns the number of lanes served (0 when idle)."""
        F = len(self.specs)
        for f in range(F):
            self._drain(f)
        if not self._pending:
            if idle_sleep > 0:
                time.sleep(idle_sleep)
            return 0
        # batch window: lockstep peers post within microseconds of each
        # other; a short wait turns F singleton batches into one.  A hard
        # per-batch deadline: a dead, slow or degraded fleet never holds
        # the others hostage (counted in serve.partial_batches)
        if len(self._pending) < F and self.cfg.inference_batch_window > 0:
            window = Deadline(self.cfg.inference_batch_window)
            while len(self._pending) < F and not window.expired:
                if not any(self._drain(f) for f in range(F)):
                    time.sleep(0.0002)
        self._refresh_params()
        if self._params is None:   # no publication yet: keep requests
            time.sleep(idle_sleep)
            return 0
        tr = self.tracer
        pend = sorted(self._pending)
        with _span(tr, "serve.assemble"):
            with self._hidden_lock:
                for f in list(pend):
                    item = self._pending.get(f)
                    if item is None:
                        # retired by the watchdog since the snapshot above
                        pend.remove(f)
                        continue
                    _seq, mode, ch = item
                    spec = self.specs[f]
                    lo, hi = spec.lo, spec.hi
                    v = ch.views
                    self.obs[lo:hi] = v["obs"]
                    self.last_action[lo:hi] = v["last_action"]
                    self.last_reward[lo:hi] = v["last_reward"]
                    if mode == MODE_RESYNC:
                        # the fleet's carry is authoritative: load it over
                        # the shard BEFORE the reset mask
                        self.hidden[lo:hi] = v["sync_hidden"]
                        self.resyncs += 1
                        self.registry.inc("serve.resyncs", fleet=str(f))
                    if mode != MODE_PEEK:
                        resets = np.nonzero(v["reset_mask"])[0]
                        if resets.size:
                            self.hidden[lo + resets] = 0.0
                # consistent snapshot: a concurrent reset_shard must not
                # tear mid-act
                hidden_in = self.hidden.copy()
        if not pend:
            return 0
        attached = sum(1 for ch in self.channels if ch is not None)
        if len(pend) < attached:
            self.partial_batches += 1
            self.registry.inc("serve.partial_batches")
        with _span(tr, "serve.act"), TRANSFER_GUARD.disallow("serve.act"):
            q, new_hidden = self._act_batch(hidden_in, "serve.act_fetch")
        lanes = 0
        with _span(tr, "serve.scatter"):
            with self._hidden_lock:
                for f in pend:
                    item = self._pending.pop(f, None)
                    if item is None:   # fleet retired mid-batch
                        continue
                    seq, mode, ch = item
                    spec = self.specs[f]
                    lo, hi = spec.lo, spec.hi
                    ch.views["q"][:] = q[lo:hi]
                    if mode != MODE_PEEK:
                        ch.views["rsp_hidden"][:] = new_hidden[lo:hi]
                        # only pending lanes advance
                        self.hidden[lo:hi] = new_hidden[lo:hi]
                    else:
                        self.peeks += 1
                    # response CRC LAST
                    ch.views["rsp_crc"][0] = act_response_crc(
                        ch.views, seq, mode)
                    lanes += hi - lo
                    chaos = self.chaos
                    if chaos is not None and chaos.garble_response():
                        # flip response bytes AFTER the CRC landed — the
                        # fleet's verification must catch it
                        ch.views["q"][0, 0] = np.float32(
                            ch.views["q"][0, 0]) + 1.0
                        self.garbled_responses += 1
                        self.registry.inc("serve.garbled_responses")
                    if chaos is not None and chaos.drop_response():
                        # lose the wakeup — the fleet's retry recovers
                        self.dropped_responses += 1
                        self.registry.inc("serve.dropped_responses")
                        continue
                    try:
                        ch.rsp_q.put(seq)
                    except (OSError, ValueError):
                        pass   # fleet died mid-rpc; the watchdog respawns
        self.batches += 1
        self.lanes_served += lanes
        self.last_batch_lanes = lanes
        if tr is not None:
            tr.gauge("serve.batch_lanes", lanes)
        if EVENTS.armed:
            # capture-window marker: one instant per served cross-fleet
            # batch, with its lane count, on the trainer track
            EVENTS.instant("serve.batch", arg=lanes)
        return lanes

    # --------------------------------------------------------------- misc
    def health(self) -> dict:
        """Service stats for fleet health and train logs."""
        return dict(
            batches=self.batches,
            warmups=self.warmups,
            lanes_served=self.lanes_served,
            last_batch_lanes=self.last_batch_lanes,
            mean_batch_lanes=round(self.lanes_served / self.batches, 2)
            if self.batches else 0.0,
            peeks=self.peeks,
            requests_corrupt=self.requests_corrupt,
            shard_resets=self.shard_resets,
            param_version=self._param_version,
            partial_batches=self.partial_batches,
            stale_requests=self.stale_requests,
            resyncs=self.resyncs,
            dropped_responses=self.dropped_responses,
            garbled_responses=self.garbled_responses,
        )

    def close(self) -> None:
        for ch in list(self.channels) + self._graveyard:
            if ch is not None:
                ch.close()
