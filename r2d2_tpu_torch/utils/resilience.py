"""Degraded-mode primitives: deadlines, retries, circuit breakers.
Port of ``r2d2_tpu/utils/resilience.py``, whole.

- :func:`bounded_event_set` — a ``multiprocessing.Event.set()`` that a
  SIGKILLed child holding the event's lock cannot wedge.
- :class:`Deadline` — a monotonic time budget that composes (``remaining``
  feeds the next wait's timeout), replacing ad-hoc ``time.time() + X``
  arithmetic at every bounded-wait site.
- :class:`RetryPolicy` — jittered exponential backoff with a bounded
  attempt count.  Deterministic given its seed (the same numpy generator
  as the reference, so the delays are bitwise its delays).
- :class:`CircuitBreaker` — the classic closed → open → half-open state
  machine.  ``record_failure`` past the threshold opens the circuit;
  while open, callers take their local fallback path instead of waiting
  on a dead remote; after ``cooldown`` seconds one probe per cooldown is
  allowed through (half-open), and its success closes the circuit again.
  Transitions are surfaced through an ``on_transition`` callback so the
  owning plane can wire them into telemetry.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

import numpy as np

log = logging.getLogger(__name__)

# CircuitBreaker states (gauge-friendly integer codes: the slab publishes
# the state as a float and the registry renders it as a gauge)
CLOSED = 0
OPEN = 1
HALF_OPEN = 2

STATE_NAMES = {CLOSED: "closed", OPEN: "open", HALF_OPEN: "half_open"}


def bounded_event_set(event, timeout: float = 2.0, name: str = "") -> bool:
    """Best-effort ``multiprocessing.Event.set()`` with a hard bound.

    A SIGKILLed subprocess can die while holding the event's internal
    condition lock, after which a plain ``set()`` blocks its caller
    forever.  The set therefore runs on a daemon thread that is abandoned
    on timeout.  Returns False when the lock never came free; callers fall
    through to their terminate/join path, which reaps the children
    regardless.  The trainer never *reads* a child-shared event (it
    mirrors the flag in a plain bool); this bounds the one write a
    graceful drain needs."""
    t = threading.Thread(target=event.set, daemon=True,  # graftlint: disable=thread-discipline -- the whole point is a thread the caller can ABANDON when a SIGKILL-corrupted event lock never comes free; supervision would add a restart loop around an unbounded wait
                         name=f"event-set-{name}" if name else "event-set")
    t.start()
    t.join(timeout)
    if t.is_alive():
        log.warning(
            "event.set()%s did not complete within %.1fs — a killed "
            "subprocess likely died holding the event's lock; "
            "abandoning the set and relying on terminate/join to reap "
            "the children", f" ({name})" if name else "", timeout)
        return False
    return True


class Deadline:
    """A monotonic time budget.

    ``Deadline(2.0)`` expires 2 seconds from construction; ``expired`` is
    the check.  ``budget <= 0`` means *unbounded*, so call sites can take
    a config knob directly without special-casing "disabled".
    """

    def __init__(self, budget: float):
        self.budget = float(budget)
        self._t0 = time.monotonic()

    @property
    def expired(self) -> bool:
        return self.budget > 0 and time.monotonic() - self._t0 > self.budget

    def elapsed(self) -> float:
        return time.monotonic() - self._t0

    def remaining(self, default: float = float("inf")) -> float:
        """Seconds left (0 once expired); ``default`` when unbounded."""
        if self.budget <= 0:
            return default
        return max(0.0, self.budget - (time.monotonic() - self._t0))

    def poll_timeout(self, step: float) -> float:
        """A wait-step that never overshoots the budget: ``min(step,
        remaining)``, floored at a millisecond so a just-expired deadline
        still gets one non-busy poll before the caller sees ``expired``."""
        return max(0.001, min(step, self.remaining(step)))


class RetryPolicy:
    """Bounded retries with jittered exponential backoff.

    ``attempts`` counts TOTAL tries (1 = no retry at all).  Delay before
    retry ``i`` (1-based) is ``base * 2**(i-1)``, capped at ``max_delay``,
    with multiplicative jitter in ``[1-jitter, 1+jitter]`` drawn from a
    seeded generator — deterministic per policy instance, so a chaos soak
    replays.  Call sites own their retry loops and take :meth:`backoff`
    for the sleep schedule.
    """

    def __init__(self, attempts: int = 3, base: float = 0.05,
                 max_delay: float = 2.0, jitter: float = 0.2,
                 seed: int = 0):
        if attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {attempts}")
        self.attempts = int(attempts)
        self.base = float(base)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self._rng = np.random.default_rng([seed, 0x5E51])

    def backoff(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (1-based: the delay after the
        ``attempt``-th failure)."""
        d = min(self.max_delay, self.base * (2.0 ** max(0, attempt - 1)))
        if self.jitter > 0:
            d *= 1.0 + self.jitter * float(self._rng.uniform(-1.0, 1.0))
        return max(0.0, d)


class CircuitBreaker:
    """closed → open → half-open failure gate (module docstring).

    Thread-safe.  The owner calls :meth:`allow_attempt` before each
    remote call: ``True`` means "try the remote" (closed, or half-open
    granting this caller THE probe slot), ``False`` means "take the local
    fallback".  After the call, :meth:`record_success` /
    :meth:`record_failure` advance the machine.  ``on_transition(name,
    old_state, new_state)`` is invoked OUTSIDE the lock on every state
    change — wire it to a registry/stats sink.
    """

    def __init__(self, name: str = "", failure_threshold: int = 1,
                 cooldown: float = 5.0,
                 on_transition: Optional[Callable[[str, int, int], None]]
                 = None):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.name = name
        self.failure_threshold = int(failure_threshold)
        self.cooldown = float(cooldown)
        self.on_transition = on_transition
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0          # consecutive failures while closed
        self._opened_at = 0.0
        self._probe_out = False     # half-open: one probe in flight
        # lazy-transition callbacks queued under the lock, flushed
        # outside it by whichever public call observed the flip
        self._pending = []
        self.opens = 0              # total closed/half-open -> open edges
        self.probes = 0             # half-open attempts granted

    # ------------------------------------------------------------- state
    @property
    def state(self) -> int:
        with self._lock:
            s = self._effective_state()
            cbs = self._drain()
        for cb in cbs:
            cb()
        return s

    @property
    def state_name(self) -> str:
        return STATE_NAMES[self.state]

    def _effective_state(self) -> int:
        """Lock held.  OPEN lazily becomes HALF_OPEN once the cooldown
        elapses — there is no timer thread; the next caller observes the
        flip (and flushes its queued on_transition outside the lock, so
        the circuit_state gauge really does show all three states)."""
        if (self._state == OPEN
                and time.monotonic() - self._opened_at >= self.cooldown):
            cb = self._transition(HALF_OPEN)
            self._probe_out = False
            if cb is not None:
                self._pending.append(cb)
        return self._state

    def _drain(self) -> list:
        """Lock held; take the queued lazy-transition callbacks."""
        cbs, self._pending = self._pending, []
        return cbs

    def _transition(self, new: int):
        """Lock held; returns the callback to run outside the lock."""
        old, self._state = self._state, new
        if new == OPEN:
            self._opened_at = time.monotonic()
            self.opens += 1
        cb = self.on_transition
        if cb is None or old == new:
            return None
        return lambda: cb(self.name, old, new)

    # ------------------------------------------------------------- gates
    def allow_attempt(self) -> bool:
        """May the caller try the remote right now?  Closed: yes.
        Open (cooling down): no — degrade locally.  Half-open: yes for
        exactly one caller per cooldown window (the probe)."""
        with self._lock:
            s = self._effective_state()
            if s == CLOSED:
                out = True
            elif s == HALF_OPEN and not self._probe_out:
                self._probe_out = True
                self.probes += 1
                out = True
            else:
                out = False
            cbs = self._drain()
        for cb in cbs:
            cb()
        return out

    def record_success(self) -> None:
        """A remote call completed: closes the circuit from any state."""
        with self._lock:
            self._effective_state()   # observe a pending half-open flip
            self._failures = 0
            self._probe_out = False
            cbs = self._drain()
            cb = self._transition(CLOSED)
            if cb is not None:
                cbs.append(cb)
        for cb in cbs:
            cb()

    def record_failure(self) -> None:
        """A remote call failed terminally (its bounded retries are the
        caller's business — count ONE failure per exhausted call).
        Opens at ``failure_threshold`` consecutive failures; a failed
        half-open probe re-opens immediately (cooldown restarts)."""
        with self._lock:
            s = self._effective_state()
            cbs = self._drain()
            cb = None
            if s == HALF_OPEN:
                self._probe_out = False
                cb = self._transition(OPEN)
            else:
                self._failures += 1
                if s == CLOSED and self._failures >= self.failure_threshold:
                    cb = self._transition(OPEN)
            if cb is not None:
                cbs.append(cb)
        for cb in cbs:
            cb()

    def snapshot(self) -> dict:
        with self._lock:
            s = self._effective_state()
            cbs = self._drain()
            snap = dict(state=s, state_name=STATE_NAMES[s],
                        opens=self.opens, probes=self.probes,
                        failures=self._failures)
        for cb in cbs:
            cb()
        return snap
