"""Failure detection and recovery for the fabric's threads (port of
``r2d2_tpu/utils/supervisor.py``).

The reference has none: its helper threads are fire-and-forget daemons
(worker.py:78-85,319) and a dead actor silently starves its queue.  Here
every fabric thread runs under a :class:`Supervisor` that:

- catches and records uncaught exceptions per thread (kind, message,
  traceback, timestamp),
- restarts the thread up to ``max_restarts`` times with a small backoff
  (crash loops escalate instead of spinning),
- exposes ``health()`` — a structured liveness snapshot suitable for the
  log loop — and ``failed`` to let the orchestrator stop the run when a
  plane is irrecoverably down instead of hanging.

Recovery is safe because every fabric loop is written to be re-enterable:
state lives in the lock-protected ReplayBuffer / ParamStore / queues, not
in thread locals, so a restarted loop resumes exactly where the dead one
left off.
"""
from __future__ import annotations

import threading
import time
import traceback
from typing import Callable, Dict, List, Optional


class SupervisedThread:
    """One named, restartable worker loop."""

    def __init__(self, name: str, target: Callable[[], None],
                 max_restarts: int, backoff: float,
                 on_giveup: Optional[Callable[[str], None]] = None):
        self.name = name
        self.target = target
        self.max_restarts = max_restarts
        self.backoff = backoff
        self.on_giveup = on_giveup
        self.restarts = 0
        self.errors: List[Dict[str, object]] = []
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._gave_up = False
        self._stopping = False
        self._pending_timer: Optional[threading.Timer] = None

    def _run(self) -> None:
        try:
            self.target()
        except BaseException as e:  # noqa: BLE001 — supervision boundary
            with self._lock:
                self.errors.append(dict(
                    error=type(e).__name__, message=str(e),
                    traceback=traceback.format_exc(), time=time.time()))
                if self._stopping:
                    return
                if self.restarts >= self.max_restarts:
                    self._gave_up = True
                else:
                    self.restarts += 1
                    delay = self.backoff * self.restarts
                    t = threading.Timer(delay, self.start)
                    t.daemon = True
                    self._pending_timer = t
                    t.start()
                    return
            if self.on_giveup is not None:
                self.on_giveup(self.name)

    def stop(self) -> None:
        """Inhibit further restarts and cancel any pending backoff timer.
        Does not interrupt a currently running target — loops are expected
        to observe the fabric's stop() predicate."""
        with self._lock:
            self._stopping = True
            if self._pending_timer is not None:
                self._pending_timer.cancel()
                self._pending_timer = None

    def start(self) -> None:
        with self._lock:
            if self._stopping:  # raced with stop(): timer fired pre-cancel
                return
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name=self.name)
            self._thread.start()

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def gave_up(self) -> bool:
        with self._lock:
            return self._gave_up

    def join(self, timeout: float) -> None:
        if self._thread is not None:
            self._thread.join(timeout)


class Supervisor:
    """Supervises the fabric's worker threads.

    ``start(name, loop)`` registers and launches a restartable thread;
    ``health()`` reports liveness/restart/error state; ``any_failed`` is
    True once any thread exhausted its restart budget (the orchestrator
    treats that as a stop condition — the reference would simply hang).
    """

    def __init__(self, max_restarts: int = 3, backoff: float = 0.5,
                 on_giveup: Optional[Callable[[str], None]] = None):
        self.max_restarts = max_restarts
        self.backoff = backoff
        self.threads: Dict[str, SupervisedThread] = {}
        self._failed = threading.Event()
        # optional observer invoked (with the thread name) when a thread
        # exhausts its budget — train() wires it to the telemetry
        # registry so the give-up is stamped (``supervisor.gaveup``)
        # even though the log loop may be the very thread that died
        self._on_giveup_cb = on_giveup

    def _giveup(self, name: str) -> None:
        self._failed.set()
        if self._on_giveup_cb is not None:
            try:
                self._on_giveup_cb(name)
            except Exception:  # an observer must never mask the failure
                pass

    def start(self, name: str, loop: Callable[[], None]) -> SupervisedThread:
        if name in self.threads:
            # silent replacement would orphan the old SupervisedThread —
            # its live loop and any pending backoff timer keep running
            # OUTSIDE supervision (unjoinable, uncancellable at shutdown)
            raise ValueError(
                f"thread {name!r} is already supervised; stop() it first "
                "or pick a distinct name")
        t = SupervisedThread(name, loop, self.max_restarts, self.backoff,
                             on_giveup=self._giveup)
        self.threads[name] = t
        t.start()
        return t

    @property
    def any_failed(self) -> bool:
        return self._failed.is_set()

    def health(self) -> Dict[str, Dict[str, object]]:
        out: Dict[str, Dict[str, object]] = {}
        for name, t in self.threads.items():
            with t._lock:
                last = t.errors[-1] if t.errors else None
                out[name] = dict(
                    alive=t.alive, restarts=t.restarts,
                    gave_up=t._gave_up,
                    last_error=(None if last is None
                                else f"{last['error']}: {last['message']}"))
        return out

    def join_all(self, timeout: float) -> None:
        """Stop supervision (no further restarts, pending backoff timers
        cancelled), then join every live thread."""
        for t in self.threads.values():
            t.stop()
        for t in self.threads.values():
            t.join(timeout)


class Heartbeat:
    """Liveness pulse for a loop that thread-alive checks can't supervise
    (the learner runs on the caller's own thread): the loop calls
    :meth:`beat` every iteration; a watchdog reads :meth:`age` and treats
    a large value as a stall — frozen thread, wedged device call.  Plain
    float assignment is GIL-atomic, so no lock."""

    def __init__(self):
        self._last = time.time()

    def beat(self) -> None:
        self._last = time.time()

    def age(self) -> float:
        return time.time() - self._last
