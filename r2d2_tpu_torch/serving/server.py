"""The session-serving frontier: external episodic traffic over the
Q-network.  Port of ``r2d2_tpu/serving/server.py``.

One :class:`SessionServer` composes:

- :class:`~r2d2_tpu_torch.serving.store.SessionStore` — session-keyed
  server-resident LSTM state under the ``cfg.serve_max_sessions`` LRU
  budget, idle-reaped.
- :class:`~r2d2_tpu_torch.serving.admission.AdmissionController` —
  bounded pending queue, per-request deadlines, the act circuit breaker:
  every overload answer is an immediate 429/408-style reply, never an
  unbounded wait.
- :class:`~r2d2_tpu_torch.serving.batcher.ContinuousBatcher` — drains
  whatever is pending (up to ``cfg.serve_max_batch``), bucket-pads it,
  acts on the CUDA device (the fused LSTM kernel runs once per layer per
  batch), gathers each request's hidden from the store and scatters
  results back.

Transport: length-framed CRC'd messages (``serving/wire.py``, byte-
identical to the JAX package's) over a loopback TCP socket;
per-connection reader threads decode and enqueue, the batch loop serves,
replies go back tagged ``(session_id, seq)``.  All threads run under the
:class:`~r2d2_tpu_torch.utils.supervisor.Supervisor`.

Telemetry: the ``serving.*`` namespace in a :class:`MetricsRegistry`
(session lifecycle counters, sheds, the ``serving.act_latency_s`` /
``serving.batch_size`` histograms, p50/p95/p99 latency gauges) and the
``serving.gather/act/scatter`` tracer spans.

The params are published with :meth:`SessionServer.publish_params`, or
by :func:`run_server` from the newest complete checkpoint of the port's
``Checkpointer`` (``step_N/state.pt``): the architecture is checked
against the checkpoint's meta first, follow mode republishes each new
complete step behind the greedy-parity gate, and the live sessions are
snapshotted at shutdown (``resume_sessions=True`` restores them).  An HTTP
exporter (``/metrics``, ``/healthz``, ``/statusz``) serves the registry
when ``cfg.telemetry_port`` is set.
"""
from __future__ import annotations

import logging
import socket
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.serving.admission import AdmissionController, Request
from r2d2_tpu_torch.serving.batcher import ContinuousBatcher
from r2d2_tpu_torch.serving.store import SessionStore
from r2d2_tpu_torch.serving.wire import (
    EMPTY_SPEC,
    FLAG_RESET,
    MSG_ACT,
    MSG_CLOSE,
    MSG_OPEN,
    MSG_RSP,
    STATUS_EXPIRED,
    STATUS_GONE,
    STATUS_OK,
    STATUS_SHED,
    FrameReader,
    WireClosed,
    WireGarbled,
    decode_frame,
    encode_frame,
    peek_kind,
    send_frame,
    session_request_spec,
    session_response_spec,
)
from r2d2_tpu_torch.telemetry.registry import MetricsRegistry
from r2d2_tpu_torch.utils.resilience import CLOSED, Deadline
from r2d2_tpu_torch.utils.supervisor import Supervisor
from r2d2_tpu_torch.utils.trace import Tracer

log = logging.getLogger(__name__)

# act-latency histogram bounds (seconds): finer than the registry default
# at the low end, where the p99 story lives
LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0)

# cadence for the cheap periodic work folded into the batch loop: idle
# reaping, store-counter absorption, latency percentile gauges
_HOUSEKEEPING_S = 0.25


class _Conn:
    """One client connection: socket + write lock + its frame reader."""

    __slots__ = ("cid", "sock", "wlock", "reader")

    def __init__(self, cid: int, sock: socket.socket):
        self.cid = cid
        self.sock = sock
        self.wlock = threading.Lock()
        self.reader = FrameReader(sock)


class SessionServer:
    """Continuous-batching session tier over one published param set."""

    def __init__(self, cfg: Config, action_dim: int,
                 registry: Optional[MetricsRegistry] = None,
                 host: str = "127.0.0.1", device=None):
        self.cfg = cfg
        self.action_dim = action_dim
        self.registry = registry if registry is not None else (
            MetricsRegistry())
        self.registry.declare_histogram("serving.act_latency_s",
                                        LATENCY_BUCKETS)
        self.tracer = Tracer()
        self.store = SessionStore(cfg)
        self.admission = AdmissionController(
            cfg, on_transition=self._on_breaker)
        # acts on the CUDA device unless the caller (or cfg.act_device)
        # asks for the CPU — actor._resolve_act_device
        self.batcher = ContinuousBatcher(cfg, action_dim, device=device)
        self.registry.declare_histogram(
            "serving.batch_size", [float(b) for b in self.batcher.buckets])
        self._req_spec = session_request_spec(cfg, action_dim)
        self._rsp_spec = session_response_spec(cfg, action_dim)

        port = 0 if cfg.serve_port < 0 else cfg.serve_port
        self._listener = socket.create_server((host, port))
        self._listener.settimeout(0.2)
        self.host = host
        self.port = int(self._listener.getsockname()[1])

        self.supervisor = Supervisor(
            max_restarts=3,
            on_giveup=lambda name: self.registry.inc("supervisor.gaveup",
                                                     thread=name))
        self.stop_event = threading.Event()
        self._started = False
        self._conns: Dict[int, _Conn] = {}
        self._conns_lock = threading.Lock()
        self._next_cid = 0
        # request latencies for the percentile gauges (the histogram on
        # /metrics is the durable record; this bounded tail feeds the
        # p50/p95/p99 gauges without per-sample registry storage)
        self._lat = deque(maxlen=4096)
        self._lat_lock = threading.Lock()
        self._last_housekeeping = 0.0
        self.batches = 0
        self.requests = 0
        self.requests_corrupt = 0
        self.gone = 0
        self.act_failures = 0

    # ------------------------------------------------------------- breaker
    def _on_breaker(self, name: str, old: int, new: int) -> None:
        self.registry.set_gauge("serving.circuit_state", float(new))
        if new != CLOSED:
            log.warning("serving: act circuit %s -> %s — shedding act "
                        "requests until a probe batch succeeds", old, new)

    # -------------------------------------------------------------- params
    def publish_params(self, params) -> int:
        version = self.batcher.publish(params)
        self.registry.set_gauge("serving.param_version", version)
        return version

    def warmup(self) -> None:
        self.batcher.warmup()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        """Launch the supervised fabric: the accept loop and the batch
        loop.  Reader loops join per connection."""
        if self._started:
            raise RuntimeError("server already started")
        self._started = True
        self.supervisor.start("session_accept", self._accept_loop)
        self.supervisor.start("session_batch", self._batch_loop)

    def _stop(self) -> bool:
        return self.stop_event.is_set() or self.supervisor.any_failed

    def stop(self) -> None:
        self.stop_event.set()

    def close(self) -> None:
        self.stop_event.set()
        try:
            self._listener.close()
        except OSError:
            pass
        self.supervisor.join_all(timeout=5.0)
        with self._conns_lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for st in conns:
            try:
                st.sock.close()
            except OSError:
                pass

    # --------------------------------------------------------------- accept
    def _accept_loop(self) -> None:
        while not self._stop():
            try:
                sock, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return   # listener closed: shutdown path
            sock.settimeout(0.2)
            # replies are small frames: without TCP_NODELAY, Nagle's
            # algorithm holds each one for the peer's delayed ACK (~40 ms
            # per round trip on Linux loopback; the reference server pays
            # it, see ROADMAP.md section C)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                cid = self._next_cid
                self._next_cid += 1
                st = _Conn(cid, sock)
                self._conns[cid] = st
            self.registry.inc("serving.connections")
            # readers exit (normally) when their peer disconnects; the
            # restart budget only matters for a genuinely crashed reader
            self.supervisor.start(f"session_conn_{cid}",
                                  lambda st=st: self._conn_loop(st))

    # --------------------------------------------------------------- reader
    def _conn_loop(self, st: _Conn) -> None:
        while not self._stop():
            try:
                frames = st.reader.poll()
            except WireClosed:
                break
            except WireGarbled as e:
                # a desynced LENGTH stream is unrecoverable: drop the
                # connection (its sessions reap below, slots never leak)
                log.warning("serving: conn%d stream desync (%s) — "
                            "closing", st.cid, e)
                self.requests_corrupt += 1
                self.registry.inc("serving.requests_corrupt")
                break
            for body in frames:
                self._handle_frame(st, body)
        self._drop_conn(st)

    def _drop_conn(self, st: _Conn) -> None:
        with self._conns_lock:
            self._conns.pop(st.cid, None)
        try:
            st.sock.close()
        except OSError:
            pass
        if self.stop_event.is_set():
            # server shutdown, not a client abandon: the sessions survive
            # in the store (the reference snapshots them after the loops
            # drain; reaping here would race that snapshot)
            return
        reaped = self.store.reap_owner(st.cid)
        if reaped:
            # mid-episode disconnect: the owned sessions reap NOW — an
            # abandoned client must never pin hidden-state slots until
            # the idle timeout crawls by
            self.admission.note_degrade()
            log.info("serving: conn%d disconnected — reaped %d live "
                     "session(s)", st.cid, len(reaped))

    def _handle_frame(self, st: _Conn, body: bytes) -> None:
        try:
            kind = peek_kind(body)
            spec = self._req_spec if kind == MSG_ACT else EMPTY_SPEC
            header, views = decode_frame(spec, body)
        except WireGarbled:
            # a torn/garbled frame is dropped, never served: acting on it
            # would return a well-formed reply derived from garbage.  The
            # client's bounded per-request deadline owns recovery
            self.requests_corrupt += 1
            self.registry.inc("serving.requests_corrupt")
            return
        _, sid, seq, aux = header
        if kind == MSG_OPEN:
            # the lifecycle quadruple (admitted/completed/reaped/evicted)
            # reaches the registry ONLY via housekeeping's counter_max
            # absorption of the store counts — an event-site inc here
            # would race it upward (e.g. a retried open of a live
            # session) and break the conservation identity on /metrics
            verdict, evicted = self.store.admit(sid, owner=st.cid)
            if verdict == "exists":
                self.store.adopt(sid, st.cid)
            if evicted is not None:
                self.admission.note_degrade()
            ok = verdict in ("ok", "exists")
            if not ok:
                self.registry.inc("serving.rejected")
            self._reply(st, sid, seq, STATUS_OK if ok else STATUS_SHED)
        elif kind == MSG_CLOSE:
            ok = self.store.release(sid, "completed")
            self._reply(st, sid, seq, STATUS_OK if ok else STATUS_GONE)
        elif kind == MSG_ACT:
            self.store.adopt(sid, st.cid)   # restored sessions re-bind
            if not self.store.mark_pending(sid):
                # unknown or evicted: never act on a zeroed slot — the
                # client re-opens and restarts its episode
                self.gone += 1
                self.registry.inc("serving.gone")
                self._reply(st, sid, seq, STATUS_GONE)
                return
            # zero-copy views: the frame body is per-frame immutable
            # bytes (FrameReader.poll), so the request can alias it for
            # its queued lifetime — the batch path copies exactly once,
            # into the batcher's padded scratch
            req = Request(st.cid, sid, seq, bool(aux & FLAG_RESET),
                          np.asarray(views["obs"]),
                          np.asarray(views["last_action"]),
                          float(views["last_reward"][0]))
            if not self.admission.submit(req):
                self.store.clear_pending(sid)
                self.registry.inc("serving.rejected")
                self._reply(st, sid, seq, STATUS_SHED)
        else:
            self.requests_corrupt += 1
            self.registry.inc("serving.requests_corrupt")

    # ---------------------------------------------------------------- reply
    def _reply(self, st: _Conn, sid: int, seq: int, status: int,
               q: Optional[np.ndarray] = None) -> None:
        if q is None:
            frame = encode_frame(EMPTY_SPEC, (MSG_RSP, sid, seq, status))
        else:
            frame = encode_frame(self._rsp_spec,
                                 (MSG_RSP, sid, seq, status), {"q": q})
        try:
            with st.wlock:
                send_frame(st.sock, frame)
        except OSError:
            # a dead peer OR a send timeout (a stuck client whose TCP
            # buffer filled mid-frame).  Either way the reply stream may
            # now hold a TORN frame — every later frame would desync the
            # client's reader — so the connection is unusable: close it
            # and let the reader loop observe the EOF and reap
            try:
                st.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                st.sock.close()
            except OSError:
                pass

    def _reply_to(self, req: Request, status: int,
                  q: Optional[np.ndarray] = None) -> None:
        with self._conns_lock:
            st = self._conns.get(req.conn_id)
        if st is not None:
            self._reply(st, req.sid, req.seq, status, q)

    # ---------------------------------------------------------------- serve
    def _batch_loop(self) -> None:
        while not self._stop():
            self.serve_once()

    def serve_once(self, idle_sleep: float = 0.002) -> int:
        """One continuous-batch turn: housekeeping, drain, act, scatter.
        Returns the number of requests served (0 when idle)."""
        now = time.monotonic()
        if now - self._last_housekeeping > _HOUSEKEEPING_S:
            self._last_housekeeping = now
            self._housekeeping(now)
        ready, expired = self.admission.drain(self.cfg.serve_max_batch,
                                              now=now)
        for r in expired:
            # the client's deadline passed while the request queued:
            # answering 408 now beats serving a reply nobody awaits
            self.store.clear_pending(r.sid)
            self.registry.inc("serving.expired")
            self._reply_to(r, STATUS_EXPIRED)
        if not ready:
            if idle_sleep > 0:
                time.sleep(idle_sleep)
            return 0
        # one request per session per batch: a pipelined second step must
        # observe the first's hidden, so it waits for the next turn
        # (arrival order within the session is preserved)
        batch: List[Request] = []
        seen = set()
        later: List[Request] = []
        for r in ready:
            if r.sid in seen:
                later.append(r)
            else:
                seen.add(r.sid)
                batch.append(r)
        if later:
            self.admission.requeue_front(later)

        br = self.admission.breaker
        if br.state != CLOSED and not br.allow_attempt():
            # circuit open: shed fast — queueing behind a broken act
            # path would turn into the unbounded wait this tier bans
            for r in batch:
                self.store.clear_pending(r.sid)
                self.registry.inc("serving.rejected")
                self._reply_to(r, STATUS_SHED)
            return 0

        tr = self.tracer
        with tr.span("serving.gather"):
            sids = [r.sid for r in batch]
            reset = np.fromiter((r.reset for r in batch), bool,
                                len(batch))
            kept, hidden = self.store.gather(sids, reset, now=now)
            if len(kept) < len(batch):
                kept_set = set(kept)
                for i, r in enumerate(batch):
                    if i not in kept_set:
                        # reaped between submit and dispatch (owner
                        # disconnect): nothing to act on
                        self.gone += 1
                        self.registry.inc("serving.gone")
                        self._reply_to(r, STATUS_GONE)
                batch = [batch[i] for i in kept]
            if not batch:
                return 0
            obs = np.stack([r.obs for r in batch])
            last_action = np.stack([r.last_action for r in batch])
            last_reward = np.fromiter((r.last_reward for r in batch),
                                      np.float32, len(batch))
        try:
            with tr.span("serving.act"):
                q, new_hidden = self.batcher.act(obs, last_action,
                                                 last_reward, hidden)
        except Exception as e:  # noqa: BLE001 — breaker boundary
            self.act_failures += 1
            self.registry.inc("serving.act_failures")
            br.record_failure()
            self.admission.note_degrade()
            log.error("serving: act batch failed (%s) — circuit %s, "
                      "shedding the batch", e, br.state_name)
            for r in batch:
                self.store.clear_pending(r.sid)
                self.registry.inc("serving.rejected")
                self._reply_to(r, STATUS_SHED)
            return 0
        br.record_success()
        # counted before the replies go out, so stats() taken after a
        # client has seen its reply already counts that request
        self.batches += 1
        self.requests += len(batch)
        with tr.span("serving.scatter"):
            self.store.scatter([r.sid for r in batch], new_hidden)
            done = time.monotonic()
            lats = [done - r.recv_ts for r in batch]
            for i, r in enumerate(batch):
                self.store.clear_pending(r.sid)
                self._reply_to(r, STATUS_OK, q[i])
        self.registry.observe_many("serving.act_latency_s", lats)
        self.registry.observe("serving.batch_size", len(batch))
        self.registry.inc("serving.requests", len(batch))
        self.registry.inc("serving.batches")
        with self._lat_lock:
            self._lat.extend(lats)
        return len(batch)

    # ---------------------------------------------------------- housekeeping
    def _housekeeping(self, now: float) -> None:
        reaped = self.store.reap_idle(self.cfg.serve_session_idle_s,
                                      now=now)
        if reaped:
            self.admission.note_degrade()
            log.info("serving: idle-reaped %d session(s)", len(reaped))
        c = self.store.counts()
        reg = self.registry
        reg.counter_max("serving.admitted", c["admitted"])
        reg.counter_max("serving.completed", c["completed"])
        reg.counter_max("serving.reaped", c["reaped"])
        reg.counter_max("serving.evicted", c["evicted"])
        reg.set_gauge("serving.live_sessions", c["live"])
        reg.set_gauge("serving.pending", self.admission.depth())
        with self._lat_lock:
            lats = list(self._lat)
        if lats:
            p50, p95, p99 = np.percentile(lats, [50, 95, 99])
            reg.set_gauge("serving.act_latency_p50_s", float(p50))
            reg.set_gauge("serving.act_latency_p95_s", float(p95))
            reg.set_gauge("serving.act_latency_p99_s", float(p99))

    # ---------------------------------------------------------------- state
    def healthz(self) -> Dict[str, Any]:
        """Three-state verdict through the existing /healthz contract:
        ``failing`` (503) only when the serve fabric itself is down;
        shedding / evicting / an open act circuit is ``degraded`` —
        HTTP 200, because a tier that is successfully degrading must not
        be evicted by its load balancer (docs/OBSERVABILITY.md)."""
        ok = not (self.supervisor.any_failed
                  or (self._started and self.stop_event.is_set()))
        degraded = self.admission.degraded()
        out = dict(ok=ok, degraded=degraded and ok,
                   status=("failing" if not ok
                           else "degraded" if degraded else "ok"),
                   sessions=self.store.counts(),
                   admission=self.admission.stats(),
                   threads=self.supervisor.health())
        return out

    def stats(self) -> Dict[str, Any]:
        c = self.store.counts()
        a = self.admission.stats()
        assert (c["admitted"]
                == c["completed"] + c["reaped"] + c["evicted"] + c["live"])
        return dict(
            port=self.port, batches=self.batches, requests=self.requests,
            requests_corrupt=self.requests_corrupt, gone=self.gone,
            act_failures=self.act_failures,
            mean_batch=round(self.requests / self.batches, 2)
            if self.batches else 0.0,
            param_version=self.batcher.version, **c, **a)

    # ------------------------------------------------------------- snapshot
    def save_sessions(self, ckpt) -> Optional[Dict[str, Any]]:
        """Persist the live-session store through the Checkpointer's
        atomic snapshot discipline — a restart (:meth:`restore_sessions`)
        resumes every live episode bit-exact."""
        state = self.store.state()

        def writer(path: str) -> Dict[str, Any]:
            with open(path, "wb") as f:
                np.savez(f, sids=state["sids"], steps=state["steps"],
                         hidden=state["hidden"])
            return dict(counters=state["counters"],
                        live=int(len(state["sids"])),
                        param_version=self.batcher.version)

        return ckpt.save_sessions(writer)

    def restore_sessions(self, ckpt) -> bool:
        """Load the latest session snapshot into the (empty) store.
        False when none exists — the server starts cold."""
        snap = ckpt.restore_sessions()
        if snap is None:
            return False
        meta, payload_path = snap
        with np.load(payload_path) as z:
            self.store.load_state(dict(
                sids=z["sids"], steps=z["steps"], hidden=z["hidden"],
                counters=meta["counters"]))
        log.info("serving: restored %d live session(s) from the snapshot",
                 self.store.live())
        return True

    # ------------------------------------------------------------- exporter
    def exporter_loops(self, metrics_port: int):
        """``[(name, loop)]`` for an HTTP scrape endpoint over this
        server's registry/health — the trainer's close-driven discipline
        (telemetry/exporter.py).  Empty when disabled (0); -1 binds an
        ephemeral port."""
        from r2d2_tpu_torch.telemetry.exporter import TelemetryExporter

        if metrics_port == 0:
            return []
        exporter = TelemetryExporter(
            self.registry, self.healthz,
            status_fn=lambda: dict(serving=self.stats()),
            port=max(0, metrics_port))
        self.exporter = exporter

        def serving_telemetry_loop():
            while not exporter.closed:
                try:
                    exporter.handle_once()
                except (OSError, ValueError):
                    return
        return [("serving_telemetry", serving_telemetry_loop)]


# --------------------------------------------------------------------------
# standalone entry point
# --------------------------------------------------------------------------

def follow_params_once(server: SessionServer, ckpt, cfg: Config,
                       followed: Dict[str, int]) -> bool:
    """One poll of follow-mode serving: adjudicate the newest COMPLETE
    checkpoint past ``followed["step"]`` — arch-compat-check, restore,
    re-run the bf16 greedy-parity gate, republish through the batcher.
    A failing gate or a torn/arch-drifted step is SKIPPED (serving stays
    on the last good params; deterministic verdicts are never retried).
    Returns True when a republish happened.  ``followed`` carries
    ``step`` / ``republishes`` / ``parity_failures`` across polls."""
    from r2d2_tpu_torch.checkpoint import check_arch_compat

    s = ckpt.latest_step()
    if s is None or s <= followed["step"]:
        return False
    try:
        check_arch_compat(cfg, ckpt.peek_meta(s))
        state, _ = ckpt.restore(step=s)
    except Exception as e:  # arch drift / GC'd or torn under us
        log.warning("serving: follow skipped step %d (%s)", s, e)
        followed["step"] = s
        return False
    new_params = state.params
    if not server.batcher.greedy_parity_ok(new_params):
        followed["parity_failures"] += 1
        followed["step"] = s
        server.registry.inc("serving.follow_parity_failures")
        log.error("serving: bf16 greedy-parity gate FAILED for step %d "
                  "— serving stays on the last good params (version "
                  "%d)", s, server.batcher.version)
        return False
    server.publish_params(new_params)
    followed["step"] = s
    followed["republishes"] += 1
    server.registry.inc("serving.republishes")
    server.registry.set_gauge("serving.followed_step", float(s))
    log.info("serving: republished step %d (param version %d)", s,
             server.batcher.version)
    return True


def run_server(cfg: Config, checkpoint_dir: str,
               action_dim: Optional[int] = None,
               resume_sessions: bool = False,
               max_wall_seconds: Optional[float] = None,
               verbose: bool = True,
               follow: bool = False,
               follow_poll: float = 2.0,
               stop_fn: Optional[Callable[[], bool]] = None,
               device=None) -> Dict[str, Any]:
    """Serve the newest complete checkpoint in ``checkpoint_dir`` until
    SIGTERM/SIGINT (drain, snapshot the live sessions, exit) or the wall
    budget.  Returns the final :meth:`SessionServer.stats` plus the bound
    port, the step served and the health verdict it served with.

    Acts on ``device``, by default the CUDA device (``cfg.act_device=
    "cpu"`` or ``device="cpu"`` asks for the CPU; without a card and
    without that, it raises).  ``stop_fn``, a
    predicate polled by the wait loop, asks for the same drain-then-
    snapshot exit as a signal — for callers that embed the server in a
    thread, which signals never reach (``train()``'s ``stop_fn``).

    ``follow=True`` is follow-mode serving: a supervised ``param_follow``
    loop polls the Checkpointer every ``follow_poll`` seconds and
    republishes each new COMPLETE step's params through the
    ContinuousBatcher — arch-compat-checked, and under
    ``serve_dtype="bfloat16"`` behind the greedy-parity gate
    (:meth:`ContinuousBatcher.greedy_parity_ok`; a failing step is
    skipped).  With no checkpoint on disk yet, follow mode waits (within
    the wall budget) for the first one instead of failing."""
    import signal

    from r2d2_tpu_torch.checkpoint import Checkpointer, check_arch_compat

    ckpt = Checkpointer(checkpoint_dir)
    step = ckpt.latest_step()
    if step is None and not follow:
        raise FileNotFoundError(
            f"no complete checkpoint under {checkpoint_dir} — train "
            "first, then serve (or follow a live trainer)")
    # follow-mode cold start: the wait gets its OWN bound — the serving
    # wall budget starts after warmup, as in non-follow mode
    wait = Deadline(max_wall_seconds if max_wall_seconds else 0.0)
    while step is None:
        if wait.expired:
            raise FileNotFoundError(
                f"no complete checkpoint appeared under {checkpoint_dir} "
                "within the wall budget (follow mode waits for a live "
                "trainer's first save)")
        time.sleep(0.5)
        step = ckpt.latest_step()

    meta = ckpt.peek_meta(step)
    check_arch_compat(cfg, meta)   # fail with a field list, not a shape
    state, _ = ckpt.restore(step=step)  # error deep in load_state_dict
    params = state.params
    if action_dim is None:
        from r2d2_tpu_torch.envs import create_env

        env = create_env(cfg)
        action_dim = int(env.action_space.n)
        close = getattr(env, "close", None)
        if callable(close):
            close()

    server = SessionServer(cfg, action_dim, device=device)
    stop = threading.Event()
    prev = {}
    if threading.current_thread() is threading.main_thread():
        def _on_signal(signum, frame):
            log.warning("signal %d: draining the session tier, then "
                        "snapshotting live sessions", signum)
            stop.set()
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev[sig] = signal.signal(sig, _on_signal)
            except (ValueError, OSError):
                pass
    # follow-mode state: the last step adjudicated (published OR skipped
    # by a parity failure — a deterministic gate is never retried)
    followed = dict(step=int(step), republishes=0, parity_failures=0)

    def param_follow():
        while not (stop.is_set() or server._stop()):
            time.sleep(follow_poll)
            follow_params_once(server, ckpt, cfg, followed)

    try:
        server.publish_params(params)
        server.warmup()
        if resume_sessions:
            server.restore_sessions(ckpt)
        for name, loop in server.exporter_loops(cfg.telemetry_port):
            server.supervisor.start(name, loop)
        if follow:
            server.supervisor.start("param_follow", param_follow)
        server.start()
        if verbose:
            print(f"serving step_{step} on {server.host}:{server.port} "
                  f"(device={server.batcher.device}, "
                  f"dtype={cfg.serve_dtype}, "
                  f"max_sessions={cfg.serve_max_sessions}, "
                  f"max_batch={cfg.serve_max_batch}"
                  + (", follow" if follow else "") + ")", flush=True)
        deadline = (time.monotonic() + max_wall_seconds
                    if max_wall_seconds else None)
        last_line = 0.0
        final_health = "failing"
        while not (stop.is_set() or server.supervisor.any_failed):
            # sampled pre-teardown: the summary must report the verdict
            # the tier actually served with, not the stopped state
            final_health = server.healthz()["status"]
            if deadline is not None and time.monotonic() > deadline:
                break
            if stop_fn is not None and stop_fn():
                break
            time.sleep(0.2)
            if verbose and time.monotonic() - last_line > cfg.log_interval:
                last_line = time.monotonic()
                s = server.stats()
                print(f"sessions live={s['live']} admitted={s['admitted']}"
                      f" completed={s['completed']} reaped={s['reaped']}"
                      f" evicted={s['evicted']} rejected={s['rejected']}"
                      f" batches={s['batches']} status="
                      f"{server.healthz()['status']}", flush=True)
    finally:
        # drain first (stop + join every loop), snapshot second: an
        # in-flight batch that scattered AFTER the snapshot would leave
        # the client one reply ahead of the restored hidden
        server.stop()
        exporter = getattr(server, "exporter", None)
        if exporter is not None:
            exporter.close()
        server.close()
        try:
            server.save_sessions(ckpt)
        except Exception:
            log.exception("session snapshot failed at shutdown")
        for sig, handler in prev.items():
            try:
                signal.signal(sig, handler)
            except (ValueError, OSError):
                pass
    out = dict(server.stats(), step=int(step), port=server.port,
               health=final_health)
    if follow:
        out.update(followed_step=followed["step"],
                   republishes=followed["republishes"],
                   follow_parity_failures=followed["parity_failures"])
    return out
