"""Tracing and profiling instrumentation.  Port of
``r2d2_tpu/utils/trace.py``: ``Tracer``, ``TransferCounter``,
``TransferGuard`` and ``device_profile``.  ``RetraceGuard`` has nothing to
count here: the port compiles nothing (it waits for a CUDA-graph capture
of the hot loops, ROADMAP.md A item 10).

- :class:`Tracer` — in-process stage timers, gauges and counters.  Spans
  record wall-time per stage as exponential moving averages with counts
  AND a fixed log-bucket histogram per span (p50/p95/p99 surfaced in
  ``snapshot()``).  Each span doubles as a complete event on the
  process's trace ring whenever a capture window is armed
  (telemetry/tracing.py).
- :func:`device_profile` — a context manager around ``torch.profiler``
  that writes a Chrome trace of the CPU and CUDA timeline of a region.
- :class:`TransferCounter` — named thread-safe counters.
  :data:`HOST_TRANSFERS` counts the device<->host crossings of the hot
  loops, so "the batcher puts once and fetches once per batch" is an
  assertable invariant; :data:`KERNEL_LAUNCHES` counts the hand-written
  kernels' launches.
- :class:`TransferGuard` — :data:`TRANSFER_GUARD` enforces the counted
  contract: armed, each dispatch/fetch window runs under
  ``torch.cuda.set_sync_debug_mode("error")``, so a synchronizing call
  that is not a declared crossing (``HOST_TRANSFERS.allowed(...)`` or
  ``TRANSFER_GUARD.allow()``) raises :class:`TransferGuardTripped`
  instead of stalling the stream.

Everything is thread-safe and allocation-light: spans cost two
``perf_counter`` calls and a locked float update per use.
"""
from __future__ import annotations

import bisect
import contextlib
import threading
import time
import os
from typing import Any, Dict, Iterator, Optional

# fixed log-spaced span-duration buckets (seconds, 4 per decade from
# 10 µs to 100 s): every span shares them, so the per-update cost is one
# bisect + one int increment and the percentile read needs no samples
_SPAN_BOUNDS = tuple(10.0 ** (e / 4.0) for e in range(-20, 9))


class _Stat:
    __slots__ = ("count", "total", "ewma", "last", "buckets")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.ewma = 0.0
        self.last = 0.0
        self.buckets = [0] * (len(_SPAN_BOUNDS) + 1)

    def update(self, dt: float, alpha: float) -> None:
        self.count += 1
        self.total += dt
        self.last = dt
        self.ewma = dt if self.count == 1 else (
            alpha * dt + (1.0 - alpha) * self.ewma)
        self.buckets[bisect.bisect_left(_SPAN_BOUNDS, dt)] += 1

    def percentile(self, q: float) -> float:
        """Approximate quantile from the fixed buckets: linear
        interpolation inside the bucket the rank lands in (the +Inf
        bucket answers its finite lower edge — conservative)."""
        rank = q * self.count
        cum = 0
        for i, c in enumerate(self.buckets):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = _SPAN_BOUNDS[i - 1] if i > 0 else 0.0
                hi = (_SPAN_BOUNDS[i] if i < len(_SPAN_BOUNDS)
                      else _SPAN_BOUNDS[-1])
                frac = min(1.0, max(0.0, (rank - cum) / c))
                return lo + (hi - lo) * frac
            cum += c
        return 0.0


class Tracer:
    """Stage timers + gauges.

    >>> tracer = Tracer()
    >>> with tracer.span("serving.act"):
    ...     ...
    >>> tracer.gauge("batch_queue", 5)
    >>> tracer.snapshot()["span.serving.act.ewma_ms"]
    """

    def __init__(self, alpha: float = 0.05, events=None):
        self._alpha = alpha
        self._spans: Dict[str, _Stat] = {}
        self._gauges: Dict[str, float] = {}
        self._counters: Dict[str, int] = {}
        self._lock = threading.Lock()
        if events is None:
            # the process-wide event recorder (telemetry/tracing.py):
            # every span doubles as a Chrome-trace slice while a capture
            # window is armed
            from r2d2_tpu_torch.telemetry.tracing import EVENTS

            events = EVENTS
        self._event_sink = events

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                stat = self._spans.get(name)
                if stat is None:
                    stat = self._spans[name] = _Stat()
                stat.update(dt, self._alpha)
            events = self._event_sink
            if events.armed:
                events.complete(name, t0, dt)

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def incr(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + by

    def snapshot(self) -> Dict[str, float]:
        """Flat dict: span.<name>.{ewma_ms,mean_ms,count,p50_ms,p95_ms,
        p99_ms}, gauge.<name>, counter.<name>.  The percentiles come from
        each span's fixed log-bucket histogram, so no samples are kept."""
        out: Dict[str, float] = {}
        with self._lock:
            for name, s in self._spans.items():
                out[f"span.{name}.ewma_ms"] = s.ewma * 1e3
                out[f"span.{name}.mean_ms"] = (s.total / s.count) * 1e3
                out[f"span.{name}.count"] = s.count
                out[f"span.{name}.p50_ms"] = s.percentile(0.50) * 1e3
                out[f"span.{name}.p95_ms"] = s.percentile(0.95) * 1e3
                out[f"span.{name}.p99_ms"] = s.percentile(0.99) * 1e3
            for name, v in self._gauges.items():
                out[f"gauge.{name}"] = v
            for name, v in self._counters.items():
                out[f"counter.{name}"] = v
        return out


class TransferCounter:
    """Named counters for device↔host crossings on the hot loops."""

    def __init__(self):
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    @contextlib.contextmanager
    def allowed(self, name: str, n: int = 1) -> Iterator[None]:
        """A declared-transfer span: tick the counter AND lower an armed
        guard's sync check for the span (:meth:`TransferGuard.allow`), so
        the one sanctioned copy or fetch it wraps neither trips the guard
        nor escapes the count.  Disarmed, this is exactly ``count()``."""
        self.count(name, n)
        with TRANSFER_GUARD.allow():
            yield

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()


class TransferGuardTripped(RuntimeError):
    """A synchronizing device<->host call inside a guard window that no
    declared crossing covered; the message names the window."""


# torch's message for a synchronizing call under sync-debug mode "error"
_SYNC_ERROR = "synchronizing CUDA operation"


class TransferGuard:
    """Scoped enforcement of the declared-transfer budget (one put per
    dispatch, one fetch per harvest) on the hot loops.

    Each dispatch/fetch window wraps its body in ``disallow(where)``;
    the declared crossings inside run under ``HOST_TRANSFERS.allowed``
    (or :meth:`allow`).  Armed, an open window sets
    ``torch.cuda.set_sync_debug_mode("error")``, so any call that makes
    the host wait on the card — ``.item()``, ``.cpu()``, ``nonzero``, a
    device-to-host copy, a copy from pageable host memory — raises, and
    :meth:`disallow` re-raises it as :class:`TransferGuardTripped` naming
    the window.  A non-blocking copy from pinned memory waits on nothing
    and passes.

    torch holds ONE sync-debug mode for the whole process (JAX's transfer
    guard is per thread), so the guard counts across threads: the mode
    is "error" while at least one window is open in any thread AND no
    declared crossing is open in any thread.  A declared crossing in one
    thread therefore never trips on another thread's window; the price
    is that an undeclared sync in a window goes unseen while another
    thread's declared crossing is open, and that an undeclared sync in a
    thread outside any window raises a plain ``RuntimeError`` while a
    window is open elsewhere.  Disarmed (the default) every window is a
    free pass-through and the mode is never touched; on a process
    without CUDA the windows are counted and nothing can trip.  Arm
    after the guarded work has run once (library handles created).
    """

    def __init__(self):
        self._armed = 0
        self._open = 0          # windows open while armed, every thread
        self._allow = 0         # declared crossings open while armed
        self._mode: Optional[int] = None   # the mode set by this guard
        self._base = 0          # the mode found when the first window
        self._windows: Dict[str, int] = {}
        self._trips: Dict[str, int] = {}
        self._lock = threading.Lock()

    @property
    def armed(self) -> bool:
        return self._armed > 0

    @contextlib.contextmanager
    def arm(self) -> Iterator[None]:
        with self._lock:
            self._armed += 1
        try:
            yield
        finally:
            with self._lock:
                self._armed -= 1

    def _apply_locked(self) -> None:
        """Set the process's sync-debug mode to what the open windows and
        crossings ask for (CUDA processes only)."""
        import torch

        if not torch.cuda.is_initialized():
            return
        want = 2 if (self._open > 0 and self._allow == 0) else self._base
        if want != self._mode:
            torch.cuda.set_sync_debug_mode(want)
            self._mode = want

    @contextlib.contextmanager
    def disallow(self, where: str) -> Iterator[None]:
        """Enforcement window: armed, a synchronizing call inside that no
        declared crossing covers raises :class:`TransferGuardTripped`
        naming the window.  Disarmed: free pass-through."""
        if not self.armed:
            yield
            return
        import torch

        with self._lock:
            self._windows[where] = self._windows.get(where, 0) + 1
            if self._open == 0 and torch.cuda.is_initialized():
                self._base = torch.cuda.get_sync_debug_mode()
                self._mode = self._base
            self._open += 1
            self._apply_locked()
        try:
            yield
        except RuntimeError as e:
            if isinstance(e, TransferGuardTripped) or _SYNC_ERROR not in str(
                    e):
                raise
            with self._lock:
                self._trips[where] = self._trips.get(where, 0) + 1
            raise TransferGuardTripped(
                f"undeclared device<->host transfer inside guard window "
                f"{where!r}: {e}") from e
        finally:
            with self._lock:
                self._open -= 1
                self._apply_locked()

    @contextlib.contextmanager
    def allow(self) -> Iterator[None]:
        """A sanctioned-crossing span: lowers the sync check for every
        thread while it is open (normally entered through
        :meth:`TransferCounter.allowed`, which also counts it)."""
        if not self.armed:
            yield
            return
        with self._lock:
            self._allow += 1
            self._apply_locked()
        try:
            yield
        finally:
            with self._lock:
                self._allow -= 1
                self._apply_locked()

    def snapshot(self) -> Dict[str, int]:
        """``window.<name>`` = windows entered while armed, ``trip.<name>``
        = undeclared syncs caught (a non-zero trip is the failure
        signal)."""
        with self._lock:
            out = {f"window.{k}": v for k, v in self._windows.items()}
            out.update({f"trip.{k}": v for k, v in self._trips.items()})
            return out

    def reset(self) -> None:
        with self._lock:
            self._windows.clear()
            self._trips.clear()


# process-wide instances: the serving batcher ticks HOST_TRANSFERS around
# its one H2D put and its one D2H fetch per batch; every CUDA kernel
# wrapper (ops/) ticks KERNEL_LAUNCHES under its kernel's name once per
# launch call, so a run can show its hot path went through the kernels;
# the hot loops open TRANSFER_GUARD windows around their dispatch and
# fetch bodies.  Subprocesses get fresh instances after spawn
HOST_TRANSFERS = TransferCounter()
KERNEL_LAUNCHES = TransferCounter()
TRANSFER_GUARD = TransferGuard()


@contextlib.contextmanager
def device_profile(log_dir: Optional[str],
                   require_cuda: bool = False) -> Iterator[Any]:
    """Capture a ``torch.profiler`` trace of the region (CPU ops, and CUDA
    kernels when a card is visible) into ``log_dir/trace.json``, viewable
    in Perfetto or ``chrome://tracing``; yields the profiler.  No-op
    (yields None) when ``log_dir`` is None, so call sites can be
    unconditional.  ``require_cuda`` raises before recording when the
    profiler cannot record CUDA activity in this process."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = (torch.cuda.is_available() and ProfilerActivity.CUDA
            in torch.profiler.supported_activities())
    if require_cuda and not cuda:
        raise RuntimeError("torch.profiler cannot record CUDA activity in "
                           "this process")
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
