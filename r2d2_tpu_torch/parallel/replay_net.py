"""Cross-host replay fabric: the sharded replay plane over TCP sockets.

Port of ``r2d2_tpu/parallel/replay_net.py``.  The frames are the
reference's byte for byte (``replay/netwire.py``), so a JAX shard server
answers this coordinator and a JAX coordinator this shard server.  One
difference on the wire's timing, none in its bytes: both ends of every
link set ``TCP_NODELAY`` (:func:`_tune_socket`), which the reference
does not (ROADMAP.md C 8).

``cfg.replay_transport = "socket"`` takes the K-owner-process replay
plane (parallel/replay_shards.py) off the trainer host: every shard RPC
— block ingest, stratified sample request/response, priority feedback,
mass/stat gossip, snapshot/drain control — travels as length-framed
CRC'd messages (``replay/netwire.py``) instead of preallocated shm
slabs, so the shards can be REMOTE shard servers
(:func:`run_shard_server`; ``cfg.replay_hosts = "host:port,..."``).  With no ``replay_hosts`` the
plane spawns loopback shard servers itself — the same wire path end to
end, which is what keeps the whole fabric tier-1-testable.  The shm
plane is untouched: same-host runs keep the fast path.

Real sockets introduce a failure domain shm never had — partitions,
slow links, half-open connections, reconnecting peers — and every new
failure mode here gets detection, a metric, an automatic degraded-mode
action, and a chaos site:

- **Every RPC is Deadline-bounded** (``cfg.replay_sample_timeout`` for
  samples, ``cfg.replay_net_send_budget`` for ingest sends) with a
  per-link :class:`~r2d2_tpu_torch.utils.resilience.CircuitBreaker`
  (cooldown ``cfg.replay_net_cooldown``) and
  :class:`~r2d2_tpu_torch.utils.resilience.RetryPolicy`-paced reconnects.
- **A partitioned shard's mass leaves the gossiped view**: its gossip
  goes stale / its RPCs time out, the breaker opens, and
  :func:`~r2d2_tpu_torch.parallel.replay_shards.allocate_strata` redistributes
  its rows over the reachable mass — full batches from surviving
  shards, zero learner stalls, every redistributed row counted
  (``replay.net.redraws``).
- **A reconnecting shard re-attaches through the epoch handshake**:
  the shm plane's generation tag is the wire ``epoch`` word.  Priority
  feedback and in-flight responses from a stale epoch drop-and-count
  (``replay.net.epoch_drops`` / ``stale_feedback``) on BOTH ends —
  nothing ever scribbles on a restored ring.
- **Ingest never wedges an actor sink**: an unreachable/backpressured
  link drops the block after the bounded send budget
  (``replay.net.dropped_blocks``) — crash-lost experience, counted.
- **Torn/garbled frames** fail their CRC at the receiver and drop-and-
  count (``replay.net.garbled``); a garbled sample response retries
  with a fresh seq (bounded), a desynced stream tears the connection
  down and re-attaches.

Chaos sites (utils/chaos.py), injected in the fault wrapper around the
link: ``partition_shard_link`` (both directions blackholed for ``dur`` —
the socket stays up, exactly like a real partition), ``delay_shard_link``
(an rtt spike), ``half_open_shard`` (sends silently lost while receives
still work — the classic half-open peer), ``garble_net_frame`` (flip
received frame bytes ahead of decode).  ``kill_replay_shard`` /
``stall_shard`` compose unchanged (managed-loopback shards are real
processes).

Throughput follow-ons that only matter once the wire is real: the
coordinator **pipelines sample RPCs ahead of the learner** (the next
draw's per-shard requests are issued before the current batch returns,
so up to two requests ride each link while the learner consumes — the
double-buffered response slab, frame-shaped), and the shard **batches
priority updates** (all feedback frames drained in one event-loop pass
apply grouped per FIFO pointer — one vectorised sum-tree update per
group, counted in ``prio_batches``).

Everything publishes under ``replay.net.*`` and the plane's verdict
feeds the three-state ``/healthz`` — a partitioned or reconnecting shard
is ``degraded``, never silent.  Each managed shard process writes its
slot of the run's cross-process trace slab (telemetry/tracing.py),
polled and flushed once per event-loop tick.
"""
from __future__ import annotations

import logging
import multiprocessing as mp
import os
import socket
import threading
import time
from queue import Empty
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from r2d2_tpu_torch.config import Config, parse_replay_hosts
from r2d2_tpu_torch.parallel.replay_shards import (
    _SAVE_DRAIN_BUDGET,
    SHARD_STAT_FIELDS,
    ReplayBufferForShard,
    alloc_batch,
    allocate_strata,
    finish_batch,
)
from r2d2_tpu_torch.replay.block import (
    BATCH_ROW_FIELDS,
    Block,
    read_block,
    slot_layout,
    slot_views,
    write_block,
)
from r2d2_tpu_torch.replay.netwire import (
    NMSG_HELLO,
    NMSG_INGEST,
    NMSG_PRIO,
    NMSG_SAMPLE_REQ,
    NMSG_SAMPLE_RSP,
    NMSG_SAVE,
    NMSG_SAVE_RSP,
    NMSG_STATS,
    NMSG_WELCOME,
    get_json,
    get_str,
    ingest_shape_header,
    layout_token,
    max_net_frame_bytes,
    net_feedback_spec,
    net_hello_spec,
    net_ingest_spec,
    net_sample_response_spec,
    net_save_response_spec,
    net_save_spec,
    net_stats_spec,
    put_json,
    put_str,
)
from r2d2_tpu_torch.serving.wire import (
    FrameReader,
    WireClosed,
    WireGarbled,
    decode_frame,
    encode_frame,
    peek_kind,
    send_frame,
)
from r2d2_tpu_torch.telemetry.learnhealth import PRIO_EDGES, replay_ratio
from r2d2_tpu_torch.telemetry.registry import MetricsRegistry
from r2d2_tpu_torch.telemetry.slab import CounterMerger
from r2d2_tpu_torch.telemetry.tracing import EVENTS
from r2d2_tpu_torch.utils.resilience import (
    CLOSED,
    STATE_NAMES,
    CircuitBreaker,
    Deadline,
    RetryPolicy,
    bounded_event_set,
)

log = logging.getLogger(__name__)

# gossip schema: the shm plane's stats-slab vector plus the net-only
# counters a socket shard accumulates.  Counters are session-local per
# incarnation — the trainer-side CounterMerger folds across respawns
# exactly as it does for the shm slab (telemetry/slab.py).
NET_STAT_FIELDS: Tuple[Tuple[str, str], ...] = SHARD_STAT_FIELDS + (
    ("epoch_drops", "counter"),     # stale-epoch frames dropped shard-side
    ("net_garbled", "counter"),     # CRC-failed frames dropped shard-side
    ("net_frames", "counter"),      # frames received (the backlog proxy)
    ("prio_batches", "counter"),    # grouped feedback applications
)

_CONNECT_TIMEOUT = 1.0      # one TCP connect + handshake attempt bound
_HANDSHAKE_TIMEOUT = 3.0    # waiting for WELCOME after HELLO
_IO_TIMEOUT = 0.05          # per-syscall recv/send wait: rx stays a
                            # poll-with-timeout loop; sends compose it
                            # into a PROGRESS-based budget (below)
_SRV_SEND_BUDGET = 10.0     # server-side bound on one response send
_STATS_STALE_AFTER = 2.0    # gossip silence before a link's mass leaves
                            # the sampling view even without an RPC
                            # timeout (partition detection)
_REDIST_ROUNDS = 4          # bounded redistribution rounds per draw
_SOCK_BUF = 1 << 22         # 4 MB kernel buffers: one pong-scale block
                            # frame fits without a drain-rate stall
_DRAIN_POLLS = 256          # max reader polls per pump pass (fairness)


def _tune_socket(sock: socket.socket) -> None:
    """Buffers, the per-syscall timeout, and ``TCP_NODELAY``: sample
    requests, priority feedback and stats gossip are small frames, two
    sample requests ride each link at once, and Nagle's algorithm with
    delayed ACKs would hold such a write back for up to ~40 ms."""
    for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
        try:
            sock.setsockopt(socket.SOL_SOCKET, opt, _SOCK_BUF)
        except OSError:
            pass   # platform cap: the progress-based send still bounds
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.settimeout(_IO_TIMEOUT)


def _send_bounded(sock: socket.socket, frame: bytes,
                  deadline: Deadline) -> None:
    """Whole-frame send bounded by PROGRESS, not per-syscall luck: each
    ``send`` waits at most the IO timeout for buffer space, and the
    overall attempt fails only when no byte moves before ``deadline`` —
    a peer that drains slowly (busy CRC-ing a big frame) keeps the
    stream alive, a genuinely stalled peer raises OSError and the
    caller tears the connection down (a half-written frame desyncs the
    stream; there is no resuming it)."""
    view = memoryview(frame)
    while view:
        try:
            n = sock.send(view)
        except socket.timeout:
            n = 0
        except InterruptedError:
            n = 0
        if n:
            view = view[n:]
        elif deadline.expired:
            raise OSError(
                f"send stalled with {len(view)} bytes left past the "
                "budget")


def _flip_bytes(body: bytes) -> bytes:
    """The garble_net_frame fault: flip 8 bytes mid-frame (past the
    header so the kind stays readable — the CRC must still catch it)."""
    buf = bytearray(body)
    lo = min(len(buf) - 1, len(buf) // 2)
    for i in range(lo, min(len(buf), lo + 8)):
        buf[i] ^= 0xFF
    return bytes(buf)


# --------------------------------------------------------------------------
# shard-side: the server event loop
# --------------------------------------------------------------------------

class ShardServer:
    """One replay shard behind a listening TCP socket.

    The socket twin of ``replay_shards._shard_worker_main``: a single-
    threaded event loop over a plain ReplayBuffer — accept/handshake →
    drain ingest frames → serve sample requests → apply batched priority
    feedback → answer save control → push stats gossip.  One trainer
    connection at a time: a NEW accepted connection supersedes the old
    (the trainer reconnected; the old socket is a half-open leftover).

    ``epoch`` is the incarnation tag stamped into every outbound frame
    and checked on every inbound one (netwire module docstring).
    """

    def __init__(self, cfg: Config, action_dim: int, shard_id: int,
                 epoch: int, host: str = "127.0.0.1", port: int = 0,
                 restore=None):
        self.cfg = cfg
        self.action_dim = action_dim
        self.shard_id = shard_id
        self.epoch = int(epoch)
        self.buffer = ReplayBufferForShard(cfg, action_dim, shard_id,
                                           self.epoch)
        self.restored = False
        if restore is not None:
            path, meta = restore
            try:
                self.buffer.read_state(path, meta)
                self.restored = True
            except (ValueError, OSError) as e:
                log.warning(
                    "replay net-shard%d: snapshot not restored (%s) — "
                    "starting cold, its slots re-ingest fresh",
                    shard_id, e)

        self.token = layout_token(cfg, action_dim)
        self.max_frame = max_net_frame_bytes(cfg, action_dim)
        self.ingest_spec = net_ingest_spec(cfg, action_dim)
        self.rsp_spec = net_sample_response_spec(cfg, action_dim,
                                                 cfg.batch_size)
        self.fb_spec = net_feedback_spec(cfg.batch_size)
        self.stats_spec = net_stats_spec(len(NET_STAT_FIELDS))
        # response scratch: plain numpy arrays shaped by the response
        # spec — the gather writes rows straight into them, encode_frame
        # copies them into the outbound frame
        self._rows = {name: np.zeros(shape, dtype)
                      for name, shape, dtype in self.rsp_spec}

        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen(2)
        # non-blocking: the event loop must never park in accept() while
        # a live connection has frames to drain
        self.listener.settimeout(0.0)
        self.host, self.port = self.listener.getsockname()[:2]

        self.conn: Optional[socket.socket] = None
        self.reader: Optional[FrameReader] = None
        # session-local counters (gossiped; CounterMerger folds respawns)
        self.counters = dict(blocks=0, corrupt=0, samples=0,
                             prio_updates=0, epoch_drops=0, net_garbled=0,
                             net_frames=0, prio_batches=0)
        self._stats_seq = 0
        self._health = {"t": float("-inf"), "vals": {}}
        self._pending_prio: List[Tuple[int, float, np.ndarray,
                                       np.ndarray]] = []

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        for s in (self.conn, self.listener):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        self.conn = None

    def serve_forever(self, stop: Callable[[], bool],
                      on_tick: Optional[Callable[[], None]] = None) -> None:
        """Run the event loop until ``stop()``.  ``on_tick`` runs once
        per pass."""
        last_pub = time.monotonic()
        while not stop():
            progress = self._accept_once()
            progress = self._pump_once() or progress
            self._apply_pending_prio()
            now = time.monotonic()
            # cadence-capped (NOT per-progress like the shm slab write):
            # a gossip frame costs a real send, and flooding one per
            # event-loop pass under heavy sampling fills the socket
            # buffer and tears the link down
            if self.conn is not None and now - last_pub > 0.05:
                self._send_stats()
                last_pub = now
            if on_tick is not None:
                on_tick()
            if not progress:
                time.sleep(0.002)
        self._apply_pending_prio()
        self._send_stats()

    # ------------------------------------------------------------ transport
    def _accept_once(self) -> bool:
        try:
            conn, addr = self.listener.accept()
        except (BlockingIOError, socket.timeout, OSError):
            return False
        _tune_socket(conn)
        reader = FrameReader(conn, max_frame=self.max_frame)
        if not self._handshake(conn, reader):
            try:
                conn.close()
            except OSError:
                pass
            return True
        # a new attach supersedes the previous connection: the trainer
        # reconnected, and whatever we still hold is a half-open leftover
        if self.conn is not None:
            try:
                self.conn.close()
            except OSError:
                pass
        self.conn, self.reader = conn, reader
        log.info("replay net-shard%d: trainer attached from %s (epoch %d)",
                 self.shard_id, addr, self.epoch)
        # announce the (possibly restored) mass the moment the trainer
        # attaches — the coordinator's ready gate and strata allocation
        # read the gossip ahead of the first ingest
        self._send_stats()
        return True

    def _handshake(self, conn: socket.socket, reader: FrameReader) -> bool:
        deadline = Deadline(_HANDSHAKE_TIMEOUT)
        hello = None
        while hello is None and not deadline.expired:
            try:
                frames = reader.poll()
            except (WireClosed, WireGarbled):
                return False
            for body in frames:
                try:
                    if peek_kind(body) == NMSG_HELLO:
                        hello = decode_frame(net_hello_spec(), body)
                        break
                except WireGarbled:
                    self.counters["net_garbled"] += 1
        if hello is None:
            return False
        _, views = hello
        ok = (int(views["hello_token"][0]) == self.token
              and int(views["hello_shard"][0]) == self.shard_id)
        header = (NMSG_WELCOME, self.epoch if ok else -1, 0,
                  self.shard_id if ok else -1)
        try:
            send_frame(conn, encode_frame((), header))
        except OSError:
            return False
        if not ok:
            log.warning(
                "replay net-shard%d: rejected attach (token/shard "
                "mismatch — drifted config or mis-wired endpoint)",
                self.shard_id)
        return ok

    def _drop_conn(self, why: str) -> None:
        if self.conn is not None:
            # info, not warning: the server cannot distinguish a trainer
            # shutdown from a failure — the trainer side owns that verdict
            log.info("replay net-shard%d: connection dropped (%s)",
                     self.shard_id, why)
            try:
                self.conn.close()
            except OSError:
                pass
        self.conn, self.reader = None, None

    def _send(self, frame: bytes, budget: float = _SRV_SEND_BUDGET) -> bool:
        if self.conn is None:
            return False
        try:
            _send_bounded(self.conn, frame, Deadline(budget))
            return True
        except OSError:
            # no progress within the budget: the frame boundary is lost
            # — tear down, the trainer re-attaches
            self._drop_conn("send stalled")
            return False

    # ------------------------------------------------------------- inbound
    def _pump_once(self) -> bool:
        if self.reader is None:
            return False
        progress = False
        # drain until quiet (bounded for fairness): one poll reads at
        # most one recv chunk, and MB-scale ingest frames need many —
        # a single poll per pass cannot keep up with a producer burst.
        # `last_chunk` keeps the loop pulling through a partial frame
        # (poll returns no frames until it completes) and stops it the
        # moment the socket goes genuinely quiet.
        for _ in range(_DRAIN_POLLS):
            reader = self.reader
            if reader is None:   # torn down mid-drain (a send inside
                break            # _dispatch failed and dropped the conn)
            try:
                frames = reader.poll()
            except (WireClosed, WireGarbled) as e:
                self._drop_conn(str(e))
                return True
            if not frames and not reader.last_chunk:
                break
            for body in frames:
                progress = True
                self.counters["net_frames"] += 1
                try:
                    self._dispatch(body)
                except WireGarbled:
                    # torn/garbled frame: drop + count — for a sample
                    # request the trainer's bounded retry re-requests;
                    # for ingest the block is crash-lost like any CRC
                    # drop
                    self.counters["net_garbled"] += 1
        return progress

    def _dispatch(self, body: bytes) -> None:
        kind = peek_kind(body)
        if kind == NMSG_INGEST:
            header, views = decode_frame(self.ingest_spec, body)
            k, n_obs, n_steps = ingest_shape_header(views)
            block, prios = read_block(views, k, n_obs, n_steps)
            ep = (float(views["ing_episode_reward"][0])
                  if int(views["ing_has_reward"][0]) else None)
            # the buffer copies the frame views into its ring (the shm
            # plane's fleet-ingest rule) — body lifetime ends here
            self.buffer.add(block, prios, ep)
            self.counters["blocks"] += 1
        elif kind == NMSG_SAMPLE_REQ:
            header, _ = decode_frame((), body)
            _, epoch, seq, n = header
            if epoch != self.epoch:
                self.counters["epoch_drops"] += 1
                return
            self._serve_sample(int(seq), int(n))
        elif kind == NMSG_PRIO:
            header, views = decode_frame(self.fb_spec, body)
            _, epoch, _, n = header
            if epoch != self.epoch:
                # stale feedback across a respawn/restore: never scribble
                # on a restored ring — drop + count
                self.counters["epoch_drops"] += 1
                return
            n = min(int(n), self.cfg.batch_size)
            self._pending_prio.append(
                (int(views["fb_ptr"][0]), float(views["fb_loss"][0]),
                 views["fb_idxes"][:n].copy(),
                 views["fb_prios"][:n].copy()))
        elif kind == NMSG_SAVE:
            header, views = decode_frame(net_save_spec(), body)
            self._handle_save(int(header[2]), views)
        elif kind == NMSG_HELLO:
            # a retried handshake on the live connection: re-welcome
            self._send(encode_frame(
                (), (NMSG_WELCOME, self.epoch, 0, self.shard_id)))

    def _serve_sample(self, seq: int, n: int) -> None:
        n = min(n, self.cfg.batch_size)
        rows = self._rows
        out = {name: rows[name][:n] for name in BATCH_ROW_FIELDS
               if name not in ("prios", "idxes")}
        got = self.buffer.serve_sample(n, out=out)
        if got is None:
            ptr, env_steps, served = (self.buffer.block_ptr,
                                      self.buffer.env_steps, 0)
        else:
            _, idxes, prios, ptr, env_steps, ages = got
            served = idxes.shape[0]
            rows["prios"][:served] = prios
            rows["idxes"][:served] = idxes
            rows["ages"][:served] = ages
        rows["rsp_n"][0] = served
        rows["rsp_block_ptr"][0] = ptr
        rows["rsp_env_steps"][0] = env_steps
        if self._send(encode_frame(self.rsp_spec,
                                   (NMSG_SAMPLE_RSP, self.epoch, seq, 0),
                                   rows)):
            self.counters["samples"] += 1

    def _apply_pending_prio(self) -> None:
        """Shard-side priority-update batching: every feedback frame
        drained this pass applies grouped by its sample-time FIFO
        pointer — one vectorised sum-tree update per group instead of
        one per frame."""
        if not self._pending_prio:
            return
        pending, self._pending_prio = self._pending_prio, []
        groups: Dict[int, List[Tuple[float, np.ndarray, np.ndarray]]] = {}
        for ptr, loss, idxes, prios in pending:
            groups.setdefault(ptr, []).append((loss, idxes, prios))
        for ptr, members in groups.items():
            idxes = np.concatenate([m[1] for m in members])
            prios = np.concatenate([m[2] for m in members])
            loss = float(sum(m[0] for m in members))
            self.buffer.update_priorities(idxes, prios, int(ptr), loss)
            self.counters["prio_updates"] += len(members)
            self.counters["prio_batches"] += 1

    def _handle_save(self, seq: int, views: dict) -> None:
        path = get_str(views, "save_path", "save_path_len")
        blocks_expected = int(views["save_blocks"][0])
        fb_expected = int(views["save_fb"][0])
        # drain-then-save: consume every block and feedback frame the
        # trainer routed BEFORE the save request (in-flight on the
        # stream), bounded two ways — the overall budget, AND a
        # progress grace: frames genuinely LOST on the wire (a
        # half-open window, a torn connection) leave the expectations
        # permanently ahead of what can ever arrive, and an in-order
        # TCP stream that has gone quiet has nothing more in flight
        deadline = Deadline(_SAVE_DRAIN_BUDGET)
        last_progress = time.monotonic()
        while (self.counters["blocks"] + self.counters["net_garbled"]
               < blocks_expected
               or self.counters["prio_updates"] + len(self._pending_prio)
               < fb_expected) and not deadline.expired:
            if self._pump_once():
                last_progress = time.monotonic()
            elif time.monotonic() - last_progress > 2.0:
                break   # quiet stream: the shortfall was lost, not late
            else:
                time.sleep(0.005)
        self._apply_pending_prio()
        try:
            meta = self.buffer.write_state(path)
            meta["restored"] = self.restored
        except Exception as e:   # surface, don't die mid-shutdown
            meta = dict(error=str(e))
        rsp = {name: np.zeros(shape, dtype)
               for name, shape, dtype in net_save_response_spec()}
        put_json(rsp, "meta_json", "meta_len", meta)
        self._send(encode_frame(net_save_response_spec(),
                                (NMSG_SAVE_RSP, self.epoch, seq,
                                 0 if "error" not in meta else 1), rsp))
        self._send_stats()

    # -------------------------------------------------------------- gossip
    def _data_health_vals(self) -> dict:
        now = time.monotonic()
        if now - self._health["t"] > 1.0:
            pr = self.buffer.data_health()["priorities"]
            vals = dict(ess=pr["ess"], ess_frac=pr["ess_frac"],
                        positive_leaves=pr["positive_leaves"])
            for i, c in enumerate(pr["hist"]):
                vals[f"prio_hist_{i}"] = c
            self._health["vals"] = vals
            self._health["t"] = now
        return self._health["vals"]

    def _send_stats(self) -> None:
        if self.conn is None:
            return
        c = self.counters
        vals = dict(
            tree_mass=self.buffer.tree.total, size=self.buffer.size,
            blocks=c["blocks"], corrupt_blocks=c["corrupt"],
            samples=c["samples"], prio_updates=c["prio_updates"],
            incarnation=self.epoch, epoch_drops=c["epoch_drops"],
            net_garbled=c["net_garbled"], net_frames=c["net_frames"],
            prio_batches=c["prio_batches"], **self._data_health_vals())
        vec = np.array([float(vals.get(name, 0.0))
                        for name, _ in NET_STAT_FIELDS])
        self._stats_seq += 1
        self._send(encode_frame(self.stats_spec,
                                (NMSG_STATS, self.epoch, self._stats_seq,
                                 0), {"stats": vec}))


def _net_shard_main(cfg: Config, action_dim: int, shard_id: int,
                    epoch: int, host: str, port: int, port_q, stop_event,
                    restore, trace_info=None) -> None:
    """Entry point of one MANAGED (plane-spawned) loopback shard server;
    reports its bound port through ``port_q`` before serving.  Hides
    every CUDA card from itself first (the shm worker's rule).
    ``trace_info`` attaches the event recorder to this shard's slot of
    the trace slab."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    if trace_info is not None:
        EVENTS.attach(trace_info)
    srv = ShardServer(cfg, action_dim, shard_id, epoch, host=host,
                      port=port, restore=restore)
    port_q.put(srv.port)

    def tick() -> None:
        if trace_info is not None:
            EVENTS.poll()
            EVENTS.flush()

    try:
        srv.serve_forever(stop_event.is_set, on_tick=tick)
    finally:
        srv.close()
        if trace_info is not None:
            EVENTS.flush()
            EVENTS.detach()


def run_shard_server(cfg: Config, action_dim: int, shard_id: int = 0,
                     host: str = "127.0.0.1", port: int = 0,
                     epoch: Optional[int] = None,
                     max_wall_seconds: Optional[float] = None,
                     stop_fn: Optional[Callable[[], bool]] = None,
                     verbose: bool = True) -> Dict[str, Any]:
    """The ``replay-shard`` subcommand's body (its argument parser came
    with ROADMAP.md A item 11, in ``cli.py``): run ONE standalone shard
    server until SIGTERM/SIGINT (or ``max_wall_seconds``).

    ``cfg`` is the TRAINER-side config (full ``buffer_capacity``,
    ``replay_shards = K``); the shard slice is derived here exactly as
    the coordinator derives it, so both ends agree on geometry.  The
    epoch defaults to a boot-time stamp — every restart of a standalone
    shard is a new epoch, which is what makes stale feedback from a
    previous incarnation detectable on the wire.
    """
    shard_cfg = shard_slice_config(cfg)
    if epoch is None:
        # monotone across operator restarts of the same shard host; the
        # absolute value is meaningless — only inequality is read
        epoch = int(time.time()) & 0x7FFFFFFF
    stop = {"flag": False}

    def _sig(signum, frame):   # pragma: no cover - signal timing
        stop["flag"] = True

    import signal as _signal

    old = {}
    for s in (_signal.SIGTERM, _signal.SIGINT):
        try:
            old[s] = _signal.signal(s, _sig)
        except ValueError:     # not the main thread (embedded/test use)
            pass
    srv = ShardServer(shard_cfg, action_dim, shard_id, epoch,
                      host=host, port=port)
    deadline = (Deadline(max_wall_seconds)
                if max_wall_seconds is not None else Deadline(0.0))
    if verbose:
        print(f"replay-shard {shard_id}: serving on "
              f"{srv.host}:{srv.port} (epoch {epoch})", flush=True)
    try:
        srv.serve_forever(lambda: (stop["flag"] or deadline.expired
                                   or (stop_fn is not None and stop_fn())))
    finally:
        srv.close()
        for s, h in old.items():
            _signal.signal(s, h)
    return dict(shard=shard_id, host=srv.host, port=srv.port, epoch=epoch,
                **srv.counters)


def shard_slice_config(cfg: Config) -> Config:
    """The per-shard config both ends derive identically: the unchanged
    ReplayBuffer core over ``buffer_capacity / K`` (the shm plane's
    slicing), with the transport fields reset so the slice validates
    standalone."""
    return cfg.replace(buffer_capacity=cfg.buffer_capacity
                       // cfg.replay_shards,
                       replay_shards=1, replay_transport="shm",
                       replay_hosts="")


# --------------------------------------------------------------------------
# trainer-side: per-shard link
# --------------------------------------------------------------------------

class ShardLink:
    """One trainer↔shard connection plus its failure machinery.

    Owns the socket, an rx thread (connect → handshake → dispatch
    frames), the per-link CircuitBreaker/RetryPolicy, the last gossip
    reading, and the chaos fault windows.  All sends serialise through
    one lock; response waiters rendezvous on a condition keyed by seq.
    """

    def __init__(self, plane: "NetShardedReplayPlane", s: int,
                 host: str, port: int):
        self.plane = plane
        self.s = s
        self.host, self.port = host, port
        cfg = plane.shard_cfg
        self.token = layout_token(cfg, plane.action_dim)
        self.max_frame = max_net_frame_bytes(cfg, plane.action_dim)
        self.rsp_spec = plane.rsp_spec
        self.stats_spec = plane.stats_spec

        self.breaker = CircuitBreaker(
            name=f"replay_net{s}", failure_threshold=2,
            cooldown=plane.cfg.replay_net_cooldown,
            on_transition=plane._on_circuit_transition)
        self.retry = RetryPolicy(attempts=6, base=0.05, max_delay=1.0,
                                 seed=plane.cfg.seed + 7 * s)

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._send_lock = threading.Lock()
        self._scratch_lock = threading.Lock()
        self.sock: Optional[socket.socket] = None
        self.reader: Optional[FrameReader] = None
        self.connected = False
        self.fatal = False          # geometry rejected: never retry
        self.epoch: Optional[int] = None
        self.attaches = 0           # successful handshakes (reconnects =
                                    # attaches - 1)
        self._seq = 0
        self._expected: set = set()
        self._pending: Dict[int, Tuple[Tuple[int, ...], dict]] = {}
        self._pending_save: Dict[int, dict] = {}
        self._garbled_pending = 0   # CRC-failed frames since last wait
        self.stats: Optional[Tuple[int, np.ndarray]] = None
        self.stats_t = float("-inf")
        self.garbled = 0
        self.stale_tokens = 0
        self.epoch_drops = 0
        # chaos fault windows (monotonic deadlines; 0 = inactive)
        self._partition_until = 0.0
        self._half_open_until = 0.0
        self._delay_pending = 0.0
        self._closed = False

        # ingest scratch: one frame-payload image reused per send
        spec = plane.ingest_spec
        nbytes, offsets = slot_layout(spec)
        self._ing_spec = spec
        self._ing_buf = bytearray(nbytes)
        self._ing_views = slot_views(memoryview(self._ing_buf), spec,
                                     offsets, nbytes, 0)

        # per-link receiver owned by the link lifecycle: bounded polls,
        # stopped by the _closed flag and joined in close() (a Supervisor
        # restart loop would fight the link's own reconnect state machine)
        self._rx = threading.Thread(  # graftlint: disable=thread-discipline -- per-link receiver owned by the link lifecycle: bounded 0.05s polls, stopped by the _closed flag and joined in close(); a Supervisor restart loop would fight the link's own reconnect state machine
            target=self._rx_loop, daemon=True, name=f"replay-net-rx{s}")
        self._rx.start()

    # ----------------------------------------------------------- liveness
    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._cond.notify_all()
        self._teardown("link closed")
        self._rx.join(2.0)

    def repoint(self, host: str, port: int) -> None:
        """Managed respawn moved the shard to a new ephemeral port."""
        with self._lock:
            self.host, self.port = host, port
        self._teardown("shard respawned")

    def _teardown(self, why: str) -> None:
        with self._lock:
            sock, self.sock, self.reader = self.sock, None, None
            was = self.connected
            self.connected = False
            self._expected.clear()
            self._pending.clear()
            self._cond.notify_all()
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        if was and not self._closed:
            log.warning("replay net link%d: disconnected (%s)",
                        self.s, why)
            self.breaker.record_failure()

    # ------------------------------------------------------- chaos windows
    def partition_for(self, dur: float) -> None:
        """Blackhole both directions for ``dur`` — the socket stays up,
        exactly like a real partition (buffered frames arrive at heal)."""
        self._partition_until = time.monotonic() + dur

    def half_open_for(self, dur: float) -> None:
        """Sends silently lost for ``dur`` while receives still work —
        the classic half-open peer (crashed without FIN)."""
        self._half_open_until = time.monotonic() + dur

    def delay_for(self, dur: float) -> None:
        """One rtt spike: the rx thread sleeps ``dur`` before its next
        dispatch."""
        self._delay_pending = max(self._delay_pending, dur)

    def partitioned(self) -> bool:
        return time.monotonic() < self._partition_until

    def _half_open(self) -> bool:
        return time.monotonic() < self._half_open_until

    # ------------------------------------------------------------ rx plane
    def _rx_loop(self) -> None:
        attempt = 0
        while not self._closed:
            if self.partitioned():
                time.sleep(0.02)
                continue
            if self.fatal:
                time.sleep(0.2)
                continue
            if not self.connected:
                if self._try_connect():
                    attempt = 0
                else:
                    attempt += 1
                    time.sleep(self.retry.backoff(min(attempt,
                                                      self.retry.attempts)))
                continue
            if self._delay_pending > 0:
                d, self._delay_pending = self._delay_pending, 0.0
                time.sleep(min(d, 10.0))
            reader = self.reader
            if reader is None:
                continue
            try:
                frames = reader.poll()
            except (WireClosed, WireGarbled, OSError) as e:
                self._teardown(f"rx failed: {e}")
                continue
            for body in frames:
                self._dispatch(body)

    def _try_connect(self) -> bool:
        with self._lock:
            host, port = self.host, self.port
        if port == 0:
            return False     # managed shard not (re)spawned yet
        try:
            sock = socket.create_connection((host, port),
                                            timeout=_CONNECT_TIMEOUT)
        except OSError:
            self.breaker.record_failure()
            return False
        try:
            _tune_socket(sock)
            hello = {name: np.zeros(shape, dtype)
                     for name, shape, dtype in net_hello_spec()}
            hello["hello_token"][0] = self.token
            hello["hello_shard"][0] = self.s
            send_frame(sock, encode_frame(net_hello_spec(),
                                          (NMSG_HELLO, 0, 0, self.s),
                                          hello))
            reader = FrameReader(sock, max_frame=self.max_frame)
            deadline = Deadline(_HANDSHAKE_TIMEOUT)
            welcome = None
            while welcome is None and not deadline.expired:
                for body in reader.poll():
                    if peek_kind(body) == NMSG_WELCOME:
                        welcome, _ = decode_frame((), body)
                        break
            if welcome is None:
                raise OSError("no WELCOME within the handshake budget")
        except (OSError, WireClosed, WireGarbled):
            try:
                sock.close()
            except OSError:
                pass
            self.breaker.record_failure()
            return False
        epoch = int(welcome[1])
        if epoch < 0:
            log.error(
                "replay net link%d: shard REJECTED the attach — geometry "
                "token or shard-id mismatch (drifted config / mis-wired "
                "endpoint); not retrying", self.s)
            self.fatal = True
            try:
                sock.close()
            except OSError:
                pass
            return False
        with self._lock:
            prev_epoch = self.epoch
            self.sock, self.reader = sock, reader
            self.connected = True
            self.epoch = epoch
            self.attaches += 1
            reattach = self.attaches > 1
        self.breaker.record_success()
        self.plane._on_link_attached(self.s, epoch, prev_epoch, reattach)
        return True

    def _dispatch(self, body: bytes) -> None:
        chaos = self.plane.chaos
        if chaos is not None and chaos.garble_net_frame():
            body = _flip_bytes(body)
        try:
            kind = peek_kind(body)
            if kind == NMSG_STATS:
                header, views = decode_frame(self.stats_spec, body)
                with self._lock:
                    self.stats = (int(header[2]),
                                  np.array(views["stats"]))
                    self.stats_t = time.monotonic()
            elif kind == NMSG_SAMPLE_RSP:
                header, views = decode_frame(self.rsp_spec, body)
                seq = int(header[2])
                with self._lock:
                    if seq in self._expected:
                        self._pending[seq] = (header, views)
                        self._cond.notify_all()
                    else:
                        # superseded attempt / post-partition straggler
                        self.stale_tokens += 1
            elif kind == NMSG_SAVE_RSP:
                header, views = decode_frame(net_save_response_spec(),
                                             body)
                meta = get_json(views, "meta_json", "meta_len")
                with self._lock:
                    self._pending_save[int(header[2])] = meta
                    self._cond.notify_all()
            elif kind == NMSG_WELCOME:
                pass   # handshake already consumed its WELCOME
        except WireGarbled:
            with self._lock:
                self.garbled += 1
                self._garbled_pending += 1
                self._cond.notify_all()

    # ----------------------------------------------------------- tx plane
    def send(self, frame: bytes, budget: float = 2.0) -> bool:
        """Bounded whole-frame send.  False = unreachable (not
        connected, partitioned, or the send made NO progress within the
        budget — the link tears down: a half-written frame desyncs the
        stream).  Progress-based, so a peer slowly draining a big frame
        keeps the stream alive (``_send_bounded``)."""
        if self.partitioned():
            return False
        if self._half_open():
            return True     # the lost-write half of a half-open peer
        with self._lock:
            sock = self.sock if self.connected else None
        if sock is None:
            return False
        with self._send_lock:
            try:
                _send_bounded(sock, frame, Deadline(budget))
                return True
            except OSError:
                self._teardown("send stalled")
                return False

    def send_block(self, block: Block, priorities: np.ndarray,
                   episode_reward: Optional[float]) -> bool:
        """Serialise one routed block and send it, bounded by the ingest
        send budget (a wedged link loses the block, never the caller)."""
        with self._lock:
            epoch = self.epoch if self.connected else None
        if epoch is None:
            return False
        with self._scratch_lock:
            v = self._ing_views
            write_block(v, block, priorities)
            v["ing_k"][0] = block.num_sequences
            v["ing_n_obs"][0] = block.obs.shape[0]
            v["ing_n_steps"][0] = block.action.shape[0]
            v["ing_has_reward"][0] = 0 if episode_reward is None else 1
            v["ing_episode_reward"][0] = (0.0 if episode_reward is None
                                          else float(episode_reward))
            frame = encode_frame(self._ing_spec,
                                 (NMSG_INGEST, epoch, 0, 0), v)
        deadline = Deadline(self.plane.cfg.replay_net_send_budget)
        while True:
            if self.send(frame, budget=max(0.1, deadline.remaining(1.0))):
                return True
            if deadline.expired or self.plane._stop_requested():
                return False
            time.sleep(0.02)

    def new_seq(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def expect(self, seq: int) -> None:
        with self._lock:
            self._expected.add(seq)

    def cancel(self, seq: int) -> None:
        """Forget a request that will never be awaited (a failed send,
        or a redistribution wave issued right as the round budget ran
        out) — its late response must not pin a frame body in the
        pending map forever."""
        with self._lock:
            self._expected.discard(seq)
            self._pending.pop(seq, None)

    def await_response(self, seq: int, deadline: Deadline,
                       stop: Optional[Callable[[], bool]]
                       ) -> Tuple[str, Optional[Tuple], Optional[dict]]:
        """Wait (bounded) for the sample response to ``seq``.  Returns
        ``("ok", header, views)`` / ``("garbled", ..)`` / ``("timeout",
        ..)``, or ``("stopped", ..)`` when ``stop()`` cuts the wait —
        never raises into the sample loop."""
        with self._lock:
            while True:
                if seq in self._pending:
                    self._expected.discard(seq)
                    header, views = self._pending.pop(seq)
                    return "ok", header, views
                if self._garbled_pending > 0:
                    # a CRC-failed frame arrived since we started
                    # waiting; it may have been our response — retry
                    # with a fresh seq (bounded by the caller's rounds)
                    self._garbled_pending -= 1
                    self._expected.discard(seq)
                    return "garbled", None, None
                if stop is not None and stop():
                    self._expected.discard(seq)
                    return "stopped", None, None
                if deadline.expired or self._closed:
                    self._expected.discard(seq)
                    return "timeout", None, None
                self._cond.wait(deadline.poll_timeout(0.05))

    def await_save(self, seq: int, deadline: Deadline) -> Optional[dict]:
        with self._lock:
            while True:
                if seq in self._pending_save:
                    return self._pending_save.pop(seq)
                if deadline.expired or self._closed:
                    return None
                self._cond.wait(deadline.poll_timeout(0.2))

    # ------------------------------------------------------------- health
    def take_stats(self) -> Optional[Tuple[int, np.ndarray]]:
        with self._lock:
            return self.stats

    def stats_fresh(self) -> bool:
        return time.monotonic() - self.stats_t < _STATS_STALE_AFTER

    def usable_for_sample(self) -> bool:
        """May this draw route strata to the link right now?  Connected
        and unpartitioned, with a CLOSED circuit — or the half-open
        probe slot (one per cooldown; its success re-closes)."""
        with self._lock:
            if not self.connected or self.fatal:
                return False
        if self.partitioned():
            return False
        if self.breaker.state == CLOSED:
            return True
        return self.breaker.allow_attempt()

    def snapshot(self) -> dict:
        circuit = STATE_NAMES[self.breaker.state]
        with self._lock:
            return dict(shard=self.s, connected=self.connected,
                        epoch=self.epoch, attaches=self.attaches,
                        reconnects=max(0, self.attaches - 1),
                        circuit=circuit,
                        garbled=self.garbled,
                        stale_tokens=self.stale_tokens,
                        pending=len(self._pending),
                        stats_fresh=self.stats_fresh(),
                        partitioned=self.partitioned())


# --------------------------------------------------------------------------
# trainer-side: the coordinator plane
# --------------------------------------------------------------------------

class NetShardedReplayPlane:
    """The socket twin of :class:`~r2d2_tpu_torch.parallel.replay_shards.
    ShardedReplayPlane`: same facade (``add`` / ``ready`` /
    ``sample_batch`` / ``update_priorities`` / ``stats`` / snapshots /
    ``make_loops``), the transport swapped for per-shard TCP links and
    the failure story upgraded for a network (module docstring).

    Two modes, one wire path:

    - **managed loopback** (``cfg.replay_hosts`` empty): the plane
      spawns K local ``ShardServer`` processes on ephemeral 127.0.0.1
      ports; the ``replay_watch`` loop respawns the dead (restored from
      the latest replay snapshot through the attached Checkpointer),
      links repoint to the respawn's new port, and chaos kills/stalls
      drill the whole story in-process.
    - **remote attach** (``replay_hosts`` set): the shards are operator-
      run shard servers (:func:`run_shard_server`); the plane only ever
      connects, reconnects and degrades — respawn is the remote
      operator's (or their supervisor's) job, and a returning shard
      re-attaches through the epoch handshake.
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
        self.shard_cfg = shard_slice_config(cfg)
        self.leaves_per_shard = self.shard_cfg.num_sequences
        self.rng = (rng if rng is not None
                    else np.random.default_rng(cfg.seed))
        self.managed = not cfg.replay_hosts
        self.hosts: List[Tuple[str, int]] = (
            [("127.0.0.1", 0)] * self.K if self.managed
            else parse_replay_hosts(cfg.replay_hosts))

        self.ingest_spec = net_ingest_spec(self.shard_cfg, action_dim)
        self.rsp_spec = net_sample_response_spec(self.shard_cfg,
                                                 action_dim,
                                                 cfg.batch_size)
        self.stats_spec = net_stats_spec(len(NET_STAT_FIELDS))

        self.ctx = mp.get_context("spawn")
        self.stop_event = self.ctx.Event()
        self._stopping = False
        self._watch_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.stats_merger = CounterMerger(self.K, NET_STAT_FIELDS)
        # the cross-process trace slab (telemetry/tracing.py): train()
        # hands it over before start(); managed shard s writes slot
        # trace_slot_base + s
        self.trace_slab = None
        self.trace_slot_base = 0
        self.links: List[Optional[ShardLink]] = [None] * self.K
        self.procs: List[Optional[mp.Process]] = [None] * self.K
        self.restarts = [0] * self.K
        self._port_qs: List[Any] = [None] * self.K
        self.failed = False
        self._closed = False
        self._routed = [0] * self.K     # per-epoch save expectations
        self._fb_sent = [0] * self.K

        self.registry = MetricsRegistry()
        self.checkpointer = None
        self.chaos = None
        # pinned host batches (train() sets it for a CUDA learner)
        self.pin_batches = False

        self._lock = threading.Lock()
        self.env_steps = 0
        self.training_steps = 0
        self.sum_loss = 0.0
        self.num_episodes = 0
        self.episode_reward = 0.0
        self.corrupt_blocks = 0
        self.blocks_routed = 0
        self.dropped_blocks = 0
        self.shard_respawns = 0
        self.sample_timeouts = 0
        self.sample_stops = 0           # draws cut by the fabric's stop
        self.sample_retries = 0
        self.garbled_responses = 0
        self.redraws = 0
        self.stale_feedback = 0
        self.reconnects = 0
        self.epoch_drops = 0
        self.partitions = 0             # chaos partitions injected
        self._route_ptr = 0
        self._armed_restore: Optional[Tuple[str, Dict[str, Any]]] = None
        self._last_sizes = np.zeros(self.K)
        self._pending_draw: Optional[Dict[str, Any]] = None

    # ----------------------------------------------------------- lifecycle
    def set_registry(self, registry: MetricsRegistry) -> None:
        self.registry = registry

    def _on_circuit_transition(self, name: str, old: int, new: int) -> None:
        # name is "replay_net<s>"; the label carries the shard id
        self.registry.set_gauge("replay.net.circuit_state", float(new),
                                link=name[len("replay_net"):])

    def _on_link_attached(self, s: int, epoch: int,
                          prev_epoch: Optional[int],
                          reattach: bool) -> None:
        """Rx-thread callback on a successful handshake."""
        with self._lock:
            if prev_epoch is not None and epoch != prev_epoch:
                # the shard restarted/restored since we last spoke: the
                # routed/feedback expectations of the dead epoch are
                # void (its stream died with it)
                self._routed[s] = 0
                self._fb_sent[s] = 0
            if reattach:
                self.reconnects += 1
        if reattach:
            self.registry.inc("replay.net.reconnects", shard=str(s))
            log.info("replay net link%d: re-attached (epoch %s)", s, epoch)

    def _stop_requested(self) -> bool:
        return self._stopping

    def _spawn(self, s: int, restore=None, wait: bool = True) -> None:
        """(Re)provision managed shard ``s``: spawn the server process;
        with ``wait`` read its bound port and (re)point the link (start()
        spawns all first, then binds, so the children's imports
        overlap)."""
        port_q = self.ctx.Queue()
        trace_info = None
        if self.trace_slab is not None:
            trace_info = self.trace_slab.writer_info(
                self.trace_slot_base + s, incarnation=self.restarts[s],
                name=f"netshard{s}")
        p = self.ctx.Process(
            target=_net_shard_main, name=f"replay_netshard{s}",
            args=(self.shard_cfg, self.action_dim, s, self.restarts[s],
                  "127.0.0.1", 0, port_q, self.stop_event, restore,
                  trace_info),
            daemon=True)
        p.start()
        self.procs[s] = p
        self._port_qs[s] = port_q
        if wait:
            self._bind_port(s)

    def _bind_port(self, s: int) -> None:
        try:
            port = self._port_qs[s].get(timeout=60.0)
        except Empty:
            raise RuntimeError(
                f"replay net-shard{s} never reported its port — spawn "
                "wedged") from None
        with self._lock:
            self._routed[s] = 0
            self._fb_sent[s] = 0
        self.hosts[s] = ("127.0.0.1", port)
        if self.links[s] is None:
            self.links[s] = ShardLink(self, s, "127.0.0.1", port)
        else:
            self.links[s].repoint("127.0.0.1", port)

    def _restore_for(self, s: int):
        """Mirror of the shm plane's restore resolution (armed by
        ``read_state`` at boot, the Checkpointer's latest otherwise)."""
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
        if self.managed:
            for s in range(self.K):
                self._spawn(s, restore=self._restore_for(s), wait=False)
            for s in range(self.K):
                self._bind_port(s)
            self._armed_restore = None
        else:
            for s in range(self.K):
                host, port = self.hosts[s]
                self.links[s] = ShardLink(self, s, host, port)
        # bounded wait for every link's first gossip reading — actors
        # start producing the moment the fabric is up
        deadline = Deadline(wait_ready)
        while not deadline.expired and not self._stopping:
            if all(lk is not None and lk.take_stats() is not None
                   for lk in self.links):
                return
            if any(lk is not None and lk.fatal for lk in self.links):
                raise RuntimeError(
                    "a replay shard rejected the attach (geometry/token "
                    "mismatch) — the trainer and shard configs drifted")
            time.sleep(0.05)
        log.warning("replay net plane: not every shard link published "
                    "stats within %.0fs — continuing degraded",
                    wait_ready)

    def watch_once(self) -> int:
        """Managed mode: respawn dead shard processes (restart-budgeted,
        restored from the latest snapshot).  Attach mode: links reconnect
        themselves — nothing to do here."""
        if self._stopping or not self.managed:
            return 0
        restarted = 0
        with self._watch_lock:
            for s, p in enumerate(self.procs):
                if p is None or p.is_alive():
                    continue
                if self.restarts[s] >= self.max_restarts:
                    self.failed = True
                    raise RuntimeError(
                        f"replay net-shard{s} died (exitcode {p.exitcode})"
                        f" with its restart budget ({self.max_restarts}) "
                        "exhausted")
                self.restarts[s] += 1
                with self._lock:
                    self.shard_respawns += 1
                restarted += 1
                restore = self._restore_for(s)
                self.registry.inc("replay.shard.respawns", shard=str(s))
                log.warning(
                    "replay net-shard%d died — respawning (%s)", s,
                    "restoring its slots from the latest snapshot"
                    if restore is not None else
                    "no usable snapshot: cold, slots re-ingest fresh")
                self._spawn(s, restore=restore)
        return restarted

    def make_loops(self, stop: Callable[[], bool]):
        def replay_watch():
            while not stop():
                self.watch_once()
                time.sleep(0.25)

        return [("replay_watch", replay_watch)]

    def shutdown(self, timeout: float = 10.0) -> None:
        if self._closed:
            return
        self._closed = True
        self._stopping = True
        # links close BEFORE the children are stopped: a dying server's
        # FIN landing on a still-open link would read as a failure
        # (warning + breaker) on a perfectly healthy shutdown
        for lk in self.links:
            if lk is not None:
                lk.close()
        if self.managed:
            bounded_event_set(self.stop_event, name="replay-net-stop")
        for p in self.procs:
            if p is None:
                continue
            p.join(timeout)
            if p.is_alive():
                p.terminate()
                p.join(2.0)

    # -------------------------------------------------------------- ingest
    def add(self, block: Block, priorities: np.ndarray,
            episode_reward: Optional[float]) -> None:
        """Route one block to its owning shard over the wire (the
        BlockSink signature).  An unreachable/partitioned link drops the
        block after the bounded send budget — crash-lost experience,
        counted, never a wedged actor sink."""
        with self._lock:
            s = self._route_ptr % self.K
            self._route_ptr = (self._route_ptr + 1) % self.cfg.num_blocks
        link = self.links[s]
        if link is None or link.partitioned() or not link.connected:
            with self._lock:
                self.dropped_blocks += 1
            self.registry.inc("replay.net.dropped_blocks", shard=str(s))
            return
        t0 = time.perf_counter()
        ok = link.send_block(block, priorities, episode_reward)
        with self._lock:
            if not ok:
                self.dropped_blocks += 1
                self.registry.inc("replay.net.dropped_blocks",
                                  shard=str(s))
                return
            self._routed[s] += 1
            self.blocks_routed += 1
            self.env_steps += int(block.learning_steps.sum())
            if episode_reward is not None:
                self.episode_reward += float(episode_reward)
                self.num_episodes += 1
        if block.trace_id and EVENTS.armed:
            # cross-host lineage hop: the ingest frame carries the flow
            # id, so the shard's ring events continue the same chain
            EVENTS.complete("replay.net.route", t0,
                            time.perf_counter() - t0,
                            flow=block.trace_id, fph="t", arg=s)

    def note_corrupt_block(self) -> None:
        with self._lock:
            self.corrupt_blocks += 1

    # ------------------------------------------------------- mass vector
    def poll_shard_stats(self) -> Dict[str, Any]:
        """Merge every link's last gossip reading into the coordinator
        view.  ``healthy`` marks links whose mass may receive strata
        right now — connected, unpartitioned, gossip fresh."""
        with self._stats_lock:
            healthy = np.zeros(self.K, bool)
            for s, lk in enumerate(self.links):
                if lk is None:
                    continue
                got = lk.take_stats()
                if got is not None:
                    self.stats_merger.update(s, *got)
                healthy[s] = (lk.connected and not lk.partitioned()
                              and lk.stats_fresh())
            per = self.stats_merger.per_slot()
            masses = np.array([row.get("tree_mass", 0.0) for row in per])
            sizes = np.array([row.get("size", 0.0) for row in per])
            self._last_sizes = sizes
            return dict(masses=masses, sizes=sizes, healthy=healthy,
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
    def _fire_link_chaos(self, s: int) -> None:
        """Per-(draw, shard) opportunity for the socket-level fault
        sites — traffic-aligned, so ``at=``/``every=`` land under real
        sampling load."""
        chaos, link = self.chaos, self.links[s]
        if chaos is None or link is None:
            return
        dur = chaos.net_partition_seconds()
        if dur > 0:
            with self._lock:
                self.partitions += 1
            self.registry.inc("replay.net.partitions", shard=str(s))
            link.partition_for(dur)
        dur = chaos.net_delay_seconds()
        if dur > 0:
            link.delay_for(dur)
        dur = chaos.net_half_open_seconds()
        if dur > 0:
            link.half_open_for(dur)

    def _issue_requests(self, counts: np.ndarray,
                        pipelined: bool) -> Dict[int, Tuple]:
        """Post one SAMPLE_REQ per shard with a nonzero allocation.
        Returns ``{shard: (seq, n, epoch, t_issue)}`` for the posted
        ones; an unusable link's rows are simply not requested (the
        collect loop redistributes them)."""
        requests: Dict[int, Tuple] = {}
        for s, n in enumerate(counts):
            n = int(n)
            if n <= 0:
                continue
            self._fire_link_chaos(s)
            link = self.links[s]
            if link is None or not link.usable_for_sample():
                continue
            seq = link.new_seq()
            link.expect(seq)
            epoch = link.epoch
            frame = encode_frame((), (NMSG_SAMPLE_REQ, epoch, seq, n))
            if link.send(frame):
                requests[s] = (seq, n, epoch, time.perf_counter())
            else:
                link.cancel(seq)
                link.breaker.record_failure()
        if pipelined:
            self.registry.inc("replay.net.pipelined_draws")
        return requests

    def _issue_draw(self, B: int) -> Optional[Dict[str, Any]]:
        st = self.poll_shard_stats()
        masses = st["masses"] * st["healthy"]
        if st["mass_total"] <= 0:
            raise RuntimeError(
                "sample_batch on an empty replay plane; wait for add() "
                "(use `ready` to gate on learning_starts)")
        if masses.sum() <= 0:
            return None     # everything partitioned/unreachable: retry
        counts = allocate_strata(masses, B, self.rng)
        return dict(B=B, masses=masses,
                    requests=self._issue_requests(counts, pipelined=False))

    def sample_batch(self, batch_size: Optional[int] = None,
                     stop: Optional[Callable[[], bool]] = None
                     ) -> Optional[Dict[str, np.ndarray]]:
        """Assemble one batch via pipelined per-shard sample RPCs.

        The draw consumed here was usually issued at the END of the
        previous call (the double-buffer: its responses landed while the
        learner was busy), and the next draw's requests go out before
        this one returns.  A garbled response retries the shard with a
        fresh seq; a timeout / stale-epoch response / partitioned link
        redistributes its rows over the remaining healthy mass —
        bounded rounds, full batches or None (never a stall, never a
        partial batch into the learner's compiled shapes).
        """
        cfg = self.cfg
        B = batch_size or cfg.batch_size
        draw = self._pending_draw
        self._pending_draw = None
        if draw is not None and draw["B"] != B:
            draw = None     # geometry changed: discard the prefetch
        if draw is None:
            draw = self._issue_draw(B)
            if draw is None:
                return None
        out, parts, have = self._collect(draw, stop)
        # pipeline: issue the NEXT draw before assembling this one, so
        # its responses ride the links while the learner consumes
        if have >= B and not self._stopping:
            try:
                self._pending_draw = self._issue_draw(B)
            except RuntimeError:
                self._pending_draw = None
        if have < B:
            return None
        ptrs: Dict[int, Tuple[int, int]] = {}
        for p in parts:
            ptrs.setdefault(p["shard"], (p["block_ptr"], p["epoch"]))
        with self._lock:
            env_steps = self.env_steps
        return finish_batch(cfg, out, parts, self.leaves_per_shard, ptrs,
                            env_steps)

    def _collect(self, draw: Dict[str, Any],
                 stop: Optional[Callable[[], bool]]):
        cfg = self.cfg
        B = draw["B"]
        masses = draw["masses"].copy()
        requests = draw["requests"]
        out = alloc_batch(self.rsp_spec, B, self.pin_batches)
        parts: List[Dict[str, Any]] = []
        have = 0
        for _round in range(_REDIST_ROUNDS):
            retry_counts = np.zeros(self.K, np.int64)
            for s, (seq, n, epoch, t0) in requests.items():
                link = self.links[s]
                verdict, header, views = link.await_response(
                    seq, Deadline(cfg.replay_sample_timeout), stop)
                if verdict == "ok" and int(header[1]) != epoch:
                    # the shard restarted between issue and reply: its
                    # rows were drawn from a ring that no longer exists
                    verdict = "timeout"
                    with self._lock:
                        self.epoch_drops += 1
                    self.registry.inc("replay.net.epoch_drops",
                                      shard=str(s))
                if verdict == "ok":
                    link.breaker.record_success()
                    self.registry.observe("replay.net.rtt_s",
                                          time.perf_counter() - t0)
                    served = int(views["rsp_n"][0])
                    take = min(served, B - have)
                    for name in BATCH_ROW_FIELDS + ("ages",):
                        out[name][have:have + take] = views[name][:take]
                    if take > 0:
                        parts.append(dict(
                            n=take, shard=s, off=have, epoch=epoch,
                            block_ptr=int(views["rsp_block_ptr"][0])))
                        have += take
                    short = n - take
                    if short > 0:
                        # drained empty under a stale mass view: move
                        # the shortfall to shards that have mass
                        masses[s] = 0.0
                        with self._lock:
                            self.redraws += short
                        self.registry.inc("replay.net.redraws", short,
                                          shard=str(s))
                elif verdict == "garbled":
                    with self._lock:
                        self.garbled_responses += 1
                        self.sample_retries += 1
                    self.registry.inc("replay.net.garbled", shard=str(s))
                    retry_counts[s] = n     # same shard, fresh seq
                elif verdict == "stopped":
                    # the fabric is stopping: no link is at fault and no
                    # row is redrawn (the JAX package counts a timeout
                    # and redraws); the batch comes out as before, None
                    with self._lock:
                        self.sample_stops += 1
                    self.registry.inc("replay.net.sample_stops",
                                      shard=str(s))
                    masses[s] = 0.0
                else:   # timeout: suspect — redistribute off this shard
                    link.breaker.record_failure()
                    with self._lock:
                        self.sample_timeouts += 1
                        self.redraws += n
                    self.registry.inc("replay.net.sample_timeouts",
                                      shard=str(s))
                    masses[s] = 0.0
            shortfall = B - have - int(retry_counts.sum())
            if shortfall > 0 and masses.sum() > 0:
                retry_counts = retry_counts + allocate_strata(
                    masses, shortfall, self.rng)
            if have >= B or retry_counts.sum() == 0:
                break
            requests = self._issue_requests(retry_counts, pipelined=True)
            if not requests:
                break
        else:
            # the round budget ran out right after issuing one more
            # wave: nothing will ever await those requests — cancel
            # them so their (batch-sized) responses don't pin frame
            # bodies in the pending map forever
            for s, (seq, _n, _e, _t) in requests.items():
                self.links[s].cancel(seq)
        return out, parts, have

    # ------------------------------------------------------------ feedback
    def update_priorities(self, idxes: np.ndarray, priorities: np.ndarray,
                          old_ptr: Any, loss: float) -> None:
        """Fan the learner's priority feedback back over the wire.  Rows
        whose shard re-attached under a new epoch since the sample are
        dropped-and-counted on THIS side; the shard's own epoch check
        drops anything that slips through (frames in flight across a
        respawn)."""
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
                continue
            ptr, epoch = entry
            link = self.links[s]
            rows = int(m.sum())
            if (link is None or not link.connected
                    or link.epoch != epoch or link.partitioned()):
                with self._lock:
                    self.stale_feedback += rows
                self.registry.inc("replay.net.stale_feedback", rows,
                                  shard=str(s))
                continue
            fields = {name: np.zeros(shape, dtype)
                      for name, shape, dtype in
                      net_feedback_spec(self.cfg.batch_size)}
            fields["fb_idxes"][:rows] = idxes[m] % self.leaves_per_shard
            fields["fb_prios"][:rows] = priorities[m]
            fields["fb_ptr"][0] = int(ptr)
            fields["fb_loss"][0] = float(loss)
            frame = encode_frame(net_feedback_spec(self.cfg.batch_size),
                                 (NMSG_PRIO, epoch, link.new_seq(), rows),
                                 fields)
            if link.send(frame):
                with self._lock:
                    self._fb_sent[s] += 1
            else:
                with self._lock:
                    self.stale_feedback += rows
                self.registry.inc("replay.net.stale_feedback", rows,
                                  shard=str(s))

    # ------------------------------------------------------------ snapshot
    STATE_COUNTERS = ("env_steps", "training_steps", "sum_loss",
                      "num_episodes", "episode_reward", "corrupt_blocks",
                      "blocks_routed", "dropped_blocks", "shard_respawns",
                      "_route_ptr")

    def write_state(self, path: str) -> Dict[str, Any]:
        """Per-shard snapshot fan-out over the save RPC: each shard runs
        its drain-then-save and writes its ring payload to
        ``path + ".shardN"`` ON ITS OWN FILESYSTEM (loopback shards
        share the trainer's — the tier-1 path; genuinely remote shards
        snapshot host-locally).  The meta is
        byte-compatible with the shm plane's, so snapshots interop
        across transports."""
        import json

        if self.managed and any(p is None or not p.is_alive()
                                for p in self.procs):
            # a shard that died right before this snapshot is respawned
            # here (the shm plane's rule) — then give its link a bounded
            # window to re-attach before the fan-out checks connectivity
            self.watch_once()
        attach_deadline = Deadline(10.0)
        while (not attach_deadline.expired
               and any(lk is None or not lk.connected
                       for lk in self.links)):
            time.sleep(0.05)
        with self._lock:
            expectations = [(self._routed[s], self._fb_sent[s])
                            for s in range(self.K)]
            counters = {k: getattr(self, k) for k in self.STATE_COUNTERS}
        seqs = []
        for s in range(self.K):
            link = self.links[s]
            if link is None or not link.connected:
                raise RuntimeError(
                    f"replay net-shard{s} is unreachable — snapshot "
                    "would be partial; retry after it re-attaches")
            blocks_expected, fb_expected = expectations[s]
            fields = {name: np.zeros(shape, dtype)
                      for name, shape, dtype in net_save_spec()}
            put_str(fields, "save_path", "save_path_len",
                    f"{path}.shard{s}")
            fields["save_blocks"][0] = blocks_expected
            fields["save_fb"][0] = fb_expected
            seq = link.new_seq()
            if not link.send(encode_frame(
                    net_save_spec(), (NMSG_SAVE, link.epoch, seq, 0),
                    fields)):
                raise RuntimeError(
                    f"replay net-shard{s}: save request could not be "
                    "sent; retry after it re-attaches")
            seqs.append(seq)
        metas: List[Optional[Dict[str, Any]]] = [None] * self.K
        for s in range(self.K):
            meta = self.links[s].await_save(
                seqs[s], Deadline(_SAVE_DRAIN_BUDGET + 30.0))
            if meta is None:
                raise RuntimeError(
                    f"replay net-shard{s}: no snapshot within budget")
            if "error" in meta:
                raise RuntimeError(
                    f"replay net-shard{s} snapshot failed: "
                    f"{meta['error']}")
            metas[s] = meta
        with open(path, "w") as f:
            json.dump(dict(kind="sharded", shards=self.K), f)
        return dict(kind="sharded", shards=self.K, shard_metas=metas,
                    plane_counters=counters,
                    rng_state=self.rng.bit_generator.state)

    def read_state(self, path: str, meta: Dict[str, Any]) -> None:
        """Validate a sharded snapshot (the shm plane's contract —
        snapshots interop across transports) and arm the per-shard
        restores for a MANAGED :meth:`start`.  Attach mode cannot push
        ring state over the wire: remote shards restore from their own
        host-local snapshots, so a resume here raises and the caller
        warns-and-continues cold."""
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
        if not self.managed:
            # the topology matches, so the PLANE counters and draw RNG
            # genuinely resume — restored BEFORE raising, so the error
            # message below stays true; only the ring state stays with
            # the remote shards' own snapshots
            with self._lock:
                for k, v in (meta.get("plane_counters") or {}).items():
                    if k in self.STATE_COUNTERS:
                        setattr(self, k, type(getattr(self, k))(v))
                if meta.get("rng_state") is not None:
                    self.rng.bit_generator.state = meta["rng_state"]
            raise ValueError(
                "remote replay shards restore from their own host-local "
                "snapshots (run their shard servers pointing at them); "
                "the trainer resumes its plane counters only")
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
        """The plane's verdict for ``/healthz`` / the log entry /
        r2d2_top: the shm plane's shard-health schema plus the
        ``net`` link table (connection, circuit, epoch, reconnects)."""
        st = self.poll_shard_stats()
        links = [lk.snapshot() if lk is not None
                 else dict(shard=s, connected=False, circuit="open",
                           epoch=None, reconnects=0, garbled=0,
                           stale_tokens=0, pending=0, stats_fresh=False,
                           partitioned=False, attaches=0)
                 for s, lk in enumerate(self.links)]
        if self.managed:
            alive = sum(1 for p in self.procs
                        if p is not None and p.is_alive())
        else:
            alive = sum(1 for row in links if row["connected"])
        connected = sum(1 for row in links if row["connected"])
        degraded_links = sum(
            1 for row in links
            if not row["connected"] or row["partitioned"]
            or row["circuit"] != "closed" or not row["stats_fresh"])
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
                sample_stops=self.sample_stops,
                sample_retries=self.sample_retries,
                garbled_responses=self.garbled_responses,
                redraws=self.redraws,
                stale_feedback=self.stale_feedback,
                degraded=(alive < self.K or connected < self.K
                          or degraded_links > 0),
                net=dict(
                    transport="socket",
                    managed=self.managed,
                    connected=connected,
                    links=links,
                    reconnects=self.reconnects,
                    # combined (trainer + shard) human-facing total; the
                    # registry absorption reads shard_epoch_drops so the
                    # live trainer-side replay.net.epoch_drops{shard}
                    # series is never double-counted
                    epoch_drops=(self.epoch_drops
                                 + int(st["totals"].get("epoch_drops",
                                                        0))),
                    shard_epoch_drops=int(st["totals"].get("epoch_drops",
                                                           0)),
                    partitions=self.partitions,
                    shard_garbled=int(st["totals"].get("net_garbled", 0)),
                    prio_batches=int(st["totals"].get("prio_batches", 0)),
                ),
            )
        for s in range(self.K):
            self.registry.set_gauge("replay.shard.mass",
                                    float(st["masses"][s]), shard=str(s))
            self.registry.set_gauge("replay.shard.size",
                                    float(st["sizes"][s]), shard=str(s))
            self.registry.set_gauge(
                "replay.net.connected",
                1.0 if links[s]["connected"] else 0.0, shard=str(s))
            # pipeline depth: responses received-but-unconsumed per link
            self.registry.observe("replay.net.backlog",
                                  float(links[s]["pending"]))
        return out
