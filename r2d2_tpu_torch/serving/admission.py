"""Admission control for the session tier: bounded queue, deadlines,
breaker.

The resilience layer's lesson (utils/resilience.py) applied to
external traffic: overload and partial failure are normal, and the
correct response is never an unbounded wait — it is *bounded queueing*
(a full pending queue sheds with ``STATUS_SHED``/429, counted in
``serving.rejected``), *per-request deadlines* (a request that sat past
``cfg.serve_request_deadline`` is answered ``STATUS_EXPIRED``/408
instead of served stale — the client already gave up on it), and a
*circuit breaker* around the act path itself (an act executable that
starts failing opens the circuit; while open every act request sheds
fast instead of queueing behind a broken device, and one half-open
probe batch per cooldown re-closes it).

Health is three-state through the existing ``/healthz`` contract
(docs/OBSERVABILITY.md): ``ok``; ``degraded`` (HTTP 200 — the tier is
shedding, evicting or running an open circuit, i.e. degrading by
design, and must NOT be evicted by a load balancer for it); ``failing``
(HTTP 503 — the serve loop itself is dead).  The server composes the
final verdict; this module contributes the admission-side signals.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.utils.resilience import CLOSED, CircuitBreaker

# how long a degrade signal (a shed, an eviction, a reap burst) keeps
# /healthz reporting "degraded" after the event — long enough for a
# scrape cadence to observe it, short enough to recover the "ok" verdict
# once the pressure passes
DEGRADE_WINDOW_S = 15.0


class Request:
    """One queued act request: the decoded payload (copied out of the
    frame — the frame buffer is the reader's), its provenance, and its
    admission clock."""

    __slots__ = ("conn_id", "sid", "seq", "reset", "obs", "last_action",
                 "last_reward", "recv_ts")

    def __init__(self, conn_id: int, sid: int, seq: int, reset: bool,
                 obs: np.ndarray, last_action: np.ndarray,
                 last_reward: float, recv_ts: Optional[float] = None):
        self.conn_id = conn_id
        self.sid = sid
        self.seq = seq
        self.reset = reset
        self.obs = obs
        self.last_action = last_action
        self.last_reward = last_reward
        self.recv_ts = time.monotonic() if recv_ts is None else recv_ts


class AdmissionController:
    """Bounded pending queue + request deadlines + the act breaker."""

    def __init__(self, cfg: Config,
                 breaker: Optional[CircuitBreaker] = None,
                 on_transition=None):
        self.cfg = cfg
        self.limit = int(cfg.serve_pending_max)
        self.deadline_s = float(cfg.serve_request_deadline)
        self._lock = threading.Lock()
        self._pending: deque = deque()
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            name="serving.act", cooldown=2.0, on_transition=on_transition)
        self.rejected = 0          # 429 sheds (queue full / breaker open)
        self.expired = 0           # 408 deadline drops
        self._last_degrade = 0.0   # monotonic ts of the last shed/derate

    # ------------------------------------------------------------- enqueue
    def submit(self, req: Request) -> bool:
        """Admit one act request into the pending queue.  False = shed
        (queue at its bound, or the act circuit is open) — the caller
        replies ``STATUS_SHED`` NOW; the client never waits on a queue
        that cannot drain.  A HALF_OPEN circuit admits normally: the
        batch loop's ``allow_attempt`` turns the next batch into the
        probe."""
        from r2d2_tpu_torch.utils.resilience import OPEN

        if self.breaker.state == OPEN:
            with self._lock:
                self.rejected += 1
                self._last_degrade = time.monotonic()
            return False
        with self._lock:
            if len(self._pending) >= self.limit:
                self.rejected += 1
                self._last_degrade = time.monotonic()
                return False
            self._pending.append(req)
            return True

    def depth(self) -> int:
        with self._lock:
            return len(self._pending)

    def requeue_front(self, reqs: List[Request]) -> None:
        """Return drained-but-unserved requests to the FRONT of the queue
        in their original order (the batcher serves one request per
        session per turn — a pipelined second step waits one turn, and
        its deadline still runs from its original arrival)."""
        with self._lock:
            for req in reversed(reqs):
                self._pending.appendleft(req)

    # --------------------------------------------------------------- drain
    def drain(self, max_n: int, now: Optional[float] = None
              ) -> Tuple[List[Request], List[Request]]:
        """Pop up to ``max_n`` serviceable requests: ``(ready, expired)``.
        Expired requests (older than the per-request deadline) never
        reach the act path — they are answered ``STATUS_EXPIRED`` and
        counted; serving them would burn batch capacity on replies the
        client has already written off."""
        now = time.monotonic() if now is None else now
        ready: List[Request] = []
        expired: List[Request] = []
        with self._lock:
            while self._pending and len(ready) < max_n:
                req = self._pending.popleft()
                if now - req.recv_ts > self.deadline_s:
                    expired.append(req)
                    self.expired += 1
                    self._last_degrade = now
                else:
                    ready.append(req)
        return ready, expired

    # -------------------------------------------------------------- health
    def note_degrade(self) -> None:
        """An eviction / reap burst / act failure happened: hold the
        ``degraded`` verdict for the observation window."""
        with self._lock:
            self._last_degrade = time.monotonic()

    def degraded(self) -> bool:
        with self._lock:
            recent = (time.monotonic() - self._last_degrade
                      < DEGRADE_WINDOW_S and self._last_degrade > 0)
        return recent or self.breaker.state != CLOSED

    def stats(self) -> dict:
        with self._lock:
            return dict(pending=len(self._pending), rejected=self.rejected,
                        expired=self.expired,
                        circuit=self.breaker.state_name)
