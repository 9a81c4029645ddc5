"""Session-resident recurrent state under an LRU budget.

The R2D2 policy is recurrent: serving it to episodic clients means the
server must carry each live episode's LSTM state ``(2, layers, H)``
between that client's requests — the client only ever ships one step's
``(obs, last_action, last_reward)``.  The :class:`SessionStore` owns
that state for up to ``cfg.serve_max_sessions`` concurrent sessions:

- **one preallocated pool** ``(max_sessions, 2, layers, H) float32`` —
  a session holds a slot; gather/scatter for a batch is one fancy-indexed
  read/write, never per-session allocation.
- **LRU eviction**: admitting past the budget evicts the least-recently-
  used session *that has no request in flight* (evicting under a pending
  request would serve the request on a zeroed slot — the one corruption
  this tier can never emit; if every session is in flight the admit is
  shed instead).  An evicted session's next request answers
  ``STATUS_GONE``: the client re-opens and restarts its episode.
- **idle reaping**: sessions untouched for ``cfg.serve_session_idle_s``
  are reaped (abandoned clients must never pin hidden-state slots), and
  a disconnect reaps every session the connection owned immediately.

- **snapshot/restore**: the full store (pool rows + per-session meta +
  the accounting counters) round-trips through ``Checkpointer
  .save_sessions`` so a server restart resumes live episodes bit-exact.

Port of ``r2d2_tpu/serving/store.py``.

Accounting invariant: ``admitted == completed + reaped + evicted + live``
— every admitted session leaves the store through exactly one of the
three exits or is still live.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from r2d2_tpu_torch.config import Config


class _Session:
    __slots__ = ("sid", "slot", "owner", "steps", "last_used", "pending")

    def __init__(self, sid: int, slot: int, owner: Optional[int],
                 now: float):
        self.sid = sid
        self.slot = slot
        self.owner = owner          # connection id; None after a restore
        self.steps = 0              # served act steps (telemetry only)
        self.last_used = now        # monotonic; idle-reap clock
        self.pending = 0            # requests in flight (eviction guard)


class SessionStore:
    """Session-keyed server-resident hidden state (module docstring).

    Thread-safe: the reader threads admit/complete/mark-pending while
    the batch loop gathers/scatters/reaps — one lock, scalar work plus
    the batch-sized pool reads/writes inside it."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.max_sessions = int(cfg.serve_max_sessions)
        self.hidden = np.zeros(
            (self.max_sessions, 2, cfg.lstm_layers, cfg.hidden_dim),
            np.float32)
        self._lock = threading.Lock()
        self._sessions: "OrderedDict[int, _Session]" = OrderedDict()
        self._free: List[int] = list(range(self.max_sessions - 1, -1, -1))
        # lifetime accounting (the invariant in the module docstring)
        self.admitted = 0
        self.completed = 0
        self.reaped = 0
        self.evicted = 0

    # ------------------------------------------------------------ admission
    def admit(self, sid: int, owner: Optional[int] = None,
              now: Optional[float] = None) -> Tuple[str, Optional[int]]:
        """Admit session ``sid``.  Returns ``(verdict, evicted_sid)``:
        ``("ok", None)`` on a free slot, ``("ok", victim)`` when the LRU
        victim was evicted to make room, ``("exists", None)`` for a
        re-open of a live session (its state is kept — the client is
        retrying an open whose ack it lost), and ``("shed", None)`` when
        the store is full of in-flight sessions (nothing is safely
        evictable)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if sid in self._sessions:
                return "exists", None
            victim = None
            if not self._free:
                for cand_id, cand in self._sessions.items():
                    if cand.pending == 0:
                        victim = cand_id
                        break
                if victim is None:
                    return "shed", None
                v = self._sessions.pop(victim)
                self.hidden[v.slot] = 0.0   # no state leaks across owners
                self._free.append(v.slot)
                self.evicted += 1
            slot = self._free.pop()
            self.hidden[slot] = 0.0
            self._sessions[sid] = _Session(sid, slot, owner, now)
            self.admitted += 1
            return "ok", victim

    def release(self, sid: int, reason: str) -> bool:
        """Remove ``sid`` and free its slot.  ``reason`` picks the
        accounting exit: ``"completed"`` (client closed), ``"reaped"``
        (idle timeout / disconnect), ``"evicted"`` is admit()'s business
        and not accepted here."""
        if reason not in ("completed", "reaped"):
            raise ValueError(f"unknown release reason {reason!r}")
        with self._lock:
            return self._release_locked(sid, reason)

    def _release_locked(self, sid: int, reason: str) -> bool:
        s = self._sessions.pop(sid, None)
        if s is None:
            return False
        self.hidden[s.slot] = 0.0
        self._free.append(s.slot)
        if reason == "completed":
            self.completed += 1
        else:
            self.reaped += 1
        return True

    # ---------------------------------------------------------- in-flight
    def mark_pending(self, sid: int) -> bool:
        """A request for ``sid`` entered the pending queue: pin it
        against eviction until the reply is written.  False = unknown
        session (evicted/never admitted — answer ``STATUS_GONE``)."""
        with self._lock:
            s = self._sessions.get(sid)
            if s is None:
                return False
            s.pending += 1
            return True

    def clear_pending(self, sid: int) -> None:
        with self._lock:
            s = self._sessions.get(sid)
            if s is not None and s.pending > 0:
                s.pending -= 1

    # ------------------------------------------------------ gather/scatter
    def gather(self, sids: List[int], reset_mask: np.ndarray,
               now: Optional[float] = None
               ) -> Tuple[List[int], np.ndarray]:
        """Batch-read the hidden rows for ``sids`` (applying each row's
        episode-reset zero first), marking every session used-now (LRU
        touch).  Returns ``(kept_indices, hidden_batch)`` — a session
        that vanished between submit and dispatch (owner disconnect
        reaped it) is skipped, and its request answers ``STATUS_GONE``.
        """
        now = time.monotonic() if now is None else now
        kept: List[int] = []
        slots: List[int] = []
        with self._lock:
            for i, sid in enumerate(sids):
                s = self._sessions.get(sid)
                if s is None:
                    continue
                if reset_mask[i]:
                    self.hidden[s.slot] = 0.0
                s.last_used = now
                self._sessions.move_to_end(sid)
                kept.append(i)
                slots.append(s.slot)
            # fancy indexing already materialises a fresh array — no
            # extra copy on the hot path
            batch = self.hidden[slots] if slots else np.zeros(
                (0, *self.hidden.shape[1:]), np.float32)
        return kept, batch

    def scatter(self, sids: List[int], new_hidden: np.ndarray) -> None:
        """Write the post-step hidden rows back (skipping sessions that
        vanished mid-act) and count the served step."""
        with self._lock:
            for i, sid in enumerate(sids):
                s = self._sessions.get(sid)
                if s is None:
                    continue   # reaped mid-act: its slot may be reused
                self.hidden[s.slot] = new_hidden[i]
                s.steps += 1

    # -------------------------------------------------------------- reaping
    def reap_idle(self, idle_s: float,
                  now: Optional[float] = None) -> List[int]:
        """Release every session idle past ``idle_s`` with no request in
        flight (an in-flight straggler is the batcher's to answer — the
        race goes to the active side)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            # one atomic pass: a request that lands between the staleness
            # check and the release would reap an ACTIVE session — the
            # pending pin decides the race in the active side's favour
            stale = [sid for sid, s in self._sessions.items()
                     if s.pending == 0 and now - s.last_used > idle_s]
            return [sid for sid in stale
                    if self._release_locked(sid, "reaped")]

    def reap_owner(self, owner: int) -> List[int]:
        """A connection died: release every session it owned (mid-episode
        disconnects must never leak hidden-state slots).  In-flight
        requests of a reaped session resolve as skips at gather/scatter
        time — the reply had nowhere to go anyway."""
        with self._lock:
            mine = [sid for sid, s in self._sessions.items()
                    if s.owner == owner]
            return [sid for sid in mine
                    if self._release_locked(sid, "reaped")]

    def adopt(self, sid: int, owner: int) -> None:
        """Bind a restored (owner-less) session to the connection now
        driving it, so a later disconnect reaps it normally."""
        with self._lock:
            s = self._sessions.get(sid)
            if s is not None and s.owner is None:
                s.owner = owner

    # ------------------------------------------------------------- introspect
    def live(self) -> int:
        with self._lock:
            return len(self._sessions)

    def counts(self) -> Dict[str, int]:
        """The accounting quadruple plus ``live`` — the invariant
        ``admitted == completed + reaped + evicted + live`` holds at any
        quiescent point (and at every point: each transition moves one
        session between exactly two terms under the lock)."""
        with self._lock:
            return dict(admitted=self.admitted, completed=self.completed,
                        reaped=self.reaped, evicted=self.evicted,
                        live=len(self._sessions))

    # ------------------------------------------------------------- snapshot
    def state(self) -> Dict[str, object]:
        """Everything a restart needs to resume live episodes bit-exact:
        per-session (sid, steps) in LRU order, the hidden rows packed
        densely in that order, and the lifetime counters (so the
        accounting invariant survives the restart)."""
        with self._lock:
            sids = np.asarray(list(self._sessions), np.int64)
            steps = np.asarray([s.steps for s in self._sessions.values()],
                               np.int64)
            slots = [s.slot for s in self._sessions.values()]
            return dict(
                sids=sids, steps=steps,
                hidden=self.hidden[slots] if slots else
                np.zeros((0, *self.hidden.shape[1:]), np.float32),
                counters=dict(admitted=self.admitted,
                              completed=self.completed,
                              reaped=self.reaped, evicted=self.evicted))

    def load_state(self, state: Dict[str, object]) -> None:
        """Restore a :meth:`state` snapshot into an EMPTY store of the
        same geometry.  Sessions come back owner-less (the connections
        died with the old server) with a fresh idle clock — the first
        act re-binds them (:meth:`adopt`); hidden rows are bit-exact."""
        hidden = np.asarray(state["hidden"], np.float32)
        if hidden.shape[1:] != self.hidden.shape[1:]:
            raise ValueError(
                f"session snapshot hidden {hidden.shape[1:]} does not "
                f"match this store's {self.hidden.shape[1:]}")
        now = time.monotonic()
        with self._lock:
            if self._sessions:
                raise RuntimeError("load_state into a non-empty store")
            if len(state["sids"]) > self.max_sessions:
                raise ValueError(
                    f"snapshot has {len(state['sids'])} sessions, budget "
                    f"is {self.max_sessions}")
            for sid, steps, row in zip(state["sids"], state["steps"],
                                       hidden):
                slot = self._free.pop()
                self.hidden[slot] = row
                s = _Session(int(sid), slot, None, now)
                s.steps = int(steps)
                self._sessions[int(sid)] = s
            c = state["counters"]
            self.admitted = int(c["admitted"])
            self.completed = int(c["completed"])
            self.reaped = int(c["reaped"])
            self.evicted = int(c["evicted"])
