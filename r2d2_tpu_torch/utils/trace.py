"""Tracing and profiling instrumentation.  Port of
``r2d2_tpu/utils/trace.py``: ``Tracer``, ``RetraceGuard``,
``TransferCounter``, ``TransferGuard`` and ``device_profile``.

- :class:`Tracer` — in-process stage timers, gauges and counters.  Spans
  record wall-time per stage as exponential moving averages with counts
  AND a fixed log-bucket histogram per span (p50/p95/p99 surfaced in
  ``snapshot()``).  Each span doubles as a complete event on the
  process's trace ring whenever a capture window is armed
  (telemetry/tracing.py).
- :func:`device_profile` — a context manager around ``torch.profiler``
  that writes a Chrome trace of the CPU and CUDA timeline of a region.
- :class:`RetraceGuard` — :data:`RETRACES` counts the programs each entry
  point builds against a budget (ROADMAP.md A item 10).  JAX counts
  traces; the port has no tracer, so a "trace" is a CUDA-graph capture
  where the entry captures one (on a card the learner's meshless steps
  and the acts, utils/graphs.py), and elsewhere the first call with a
  new input :func:`signature` — what ``jax.jit`` retraces on.
- :class:`TransferCounter` — named thread-safe counters.
  :data:`HOST_TRANSFERS` counts the device<->host crossings of the hot
  loops, so "the batcher puts once and fetches once per batch" is an
  assertable invariant; :data:`KERNEL_LAUNCHES` counts the hand-written
  kernels' launches (a CUDA graph's replay adds the launches its capture
  recorded, :meth:`TransferCounter.recording`).
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
import dataclasses
import threading
import time
import os
from typing import Any, Dict, Hashable, Iterator, List, Optional, Tuple

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
                events.complete(name, t0, dt)  # graftlint: disable=telemetry-discipline -- pass-through bridge; span() call sites pass literal names

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


def signature(tree: Any) -> Hashable:
    """What ``jax.jit`` retraces on, for a tree of call arguments: the
    structure (dict keys, sequence lengths, dataclass fields), each
    tensor's shape, dtype and device (a DTensor's placements too), each
    array's shape and dtype, and the type of any other leaf — a Python
    scalar's value, like a weak-typed JAX scalar's, changes no program."""
    import torch

    if isinstance(tree, torch.Tensor):
        return (tree.shape, tree.dtype, tree.device,
                getattr(tree, "placements", None))
    if isinstance(tree, dict):
        return tuple((k, signature(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(signature(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return (type(tree).__name__,) + tuple(
            signature(getattr(tree, f.name))
            for f in dataclasses.fields(tree))
    shape, dtype = getattr(tree, "shape", None), getattr(tree, "dtype", None)
    if shape is not None and dtype is not None:
        return (tuple(shape), str(dtype))
    return None if tree is None else type(tree).__name__


class RetraceBudgetExceeded(AssertionError):
    """A compiled entry point traced more often than its declared budget."""


class _RetraceEntry:
    __slots__ = ("name", "budget", "traces")

    def __init__(self, name: str, budget: int):
        self.name = name
        self.budget = budget
        self.traces = 0


class RetraceGuard:
    """Counts traces per entry-point *instance*.

    ``wrap(name, fn, budget)`` returns a wrapper that counts a trace on
    the first call with each new :func:`signature` of its arguments (plus
    ``key(*args, **kwargs)`` when given: the variant a non-tensor argument
    selects), as ``jax.jit`` traces once per input signature.  An entry
    that builds its own programs (a CUDA-graph capture) takes an entry
    from :meth:`register` and counts each build itself.  Each wrap or
    register creates a fresh entry, so two learners built in one process
    do not share a counter — the budget is "traces per instance", which
    for the fabric's static-shape entry points is 1 (plus slack).

    The process-wide :data:`RETRACES` instance is what production entry
    points register with; tests that deliberately provoke retraces use a
    private ``RetraceGuard()`` so they never trip the global assertion.
    """

    def __init__(self, default_budget: int = 2):
        self.default_budget = default_budget
        self._entries: List[_RetraceEntry] = []
        self._lock = threading.Lock()

    def register(self, name: str, budget: Optional[int] = None
                 ) -> _RetraceEntry:
        """A fresh entry whose owner adds to ``traces`` per program it
        builds."""
        entry = _RetraceEntry(name, self.default_budget
                              if budget is None else budget)
        with self._lock:
            self._entries.append(entry)
        return entry

    def wrap(self, name: str, fn, budget: Optional[int] = None, key=None):
        entry = self.register(name, budget)
        seen: set = set()

        def traced(*args, **kwargs):
            sig = signature((args, kwargs))
            if key is not None:
                sig = (sig, key(*args, **kwargs))
            if sig not in seen:
                seen.add(sig)
                entry.traces += 1  # int += is GIL-atomic enough for a counter
            return fn(*args, **kwargs)

        traced.__name__ = getattr(fn, "__name__", name)
        traced.__qualname__ = traced.__name__
        traced.__wrapped__ = fn
        return traced

    def counts(self) -> Dict[str, int]:
        """name → max traces observed on any single instance."""
        out: Dict[str, int] = {}
        with self._lock:
            for e in self._entries:
                out[e.name] = max(out.get(e.name, 0), e.traces)
        return out

    def entries(self) -> List[Tuple[str, int, int]]:
        """(name, traces, budget) of every instance, in the order they
        were built."""
        with self._lock:
            return [(e.name, e.traces, e.budget) for e in self._entries]

    def over_budget(self) -> List[Tuple[str, int, int]]:
        """(name, traces, budget) for every instance past its budget."""
        with self._lock:
            return [(e.name, e.traces, e.budget)
                    for e in self._entries if e.traces > e.budget]

    def assert_within_budgets(self) -> None:
        bad = self.over_budget()
        if bad:
            raise RetraceBudgetExceeded(
                "jitted entry points exceeded their retrace budgets: "
                + "; ".join(f"{n} traced {t}x (budget {b})"
                            for n, t, b in bad))

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()


class TransferCounter:
    """Named counters for device↔host crossings on the hot loops."""

    def __init__(self):
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    def count(self, name: str, n: int = 1) -> None:
        rec = getattr(self._local, "rec", None)
        if rec is not None:
            rec[name] = rec.get(name, 0) + n
            return
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    @contextlib.contextmanager
    def recording(self) -> Iterator[Dict[str, int]]:
        """Counts made on this thread inside go to the yielded dict and
        not to the counters: a CUDA-graph capture records the launches its
        graph holds, and each replay adds them (utils/graphs.py)."""
        prev = getattr(self._local, "rec", None)
        rec = self._local.rec = {}
        try:
            yield rec
        finally:
            self._local.rec = prev

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


# process-wide instances: entry points register with RETRACES when they
# are built; the serving batcher ticks HOST_TRANSFERS around its one H2D
# put and its one D2H fetch per batch; every CUDA kernel wrapper (ops/)
# ticks KERNEL_LAUNCHES under its kernel's name once per launch call, so
# a run can show its hot path went through the kernels; the hot loops
# open TRANSFER_GUARD windows around their dispatch and fetch bodies.
# Subprocesses get fresh instances after spawn
RETRACES = RetraceGuard()
HOST_TRANSFERS = TransferCounter()
KERNEL_LAUNCHES = TransferCounter()
TRANSFER_GUARD = TransferGuard()


class ProfilerGate:
    """A profiler's start and stop against CUDA-graph captures and
    launches: a profiler stopped on one thread while another launched a
    graph hung both on the card (the ``/profilez`` window over a training
    fabric).  Captures and launches enter :meth:`shared`, any number at
    once on any threads, so one entry's graphs never queue behind
    another's; a profiler's start or stop enters :meth:`exclusive`, which
    holds new shared entries back, waits for those in flight and runs
    alone."""

    def __init__(self):
        self._cond = threading.Condition()
        self._writer = threading.Lock()
        self._shared = 0
        self._exclusive = False

    @contextlib.contextmanager
    def shared(self) -> Iterator[None]:
        with self._cond:
            while self._exclusive:
                self._cond.wait(0.1)
            self._shared += 1
        try:
            yield
        finally:
            with self._cond:
                self._shared -= 1
                if not self._shared:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self) -> Iterator[None]:
        with self._writer:
            with self._cond:
                self._exclusive = True
                while self._shared:
                    self._cond.wait(0.1)
            try:
                yield
            finally:
                with self._cond:
                    self._exclusive = False
                    self._cond.notify_all()


# entered shared around every CUDA-graph capture and launch
# (utils/graphs.py), exclusive around torch.profiler's start and stop
# (device_profile)
PROFILER_LOCK = ProfilerGate()


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
    prof = profile(activities=activities)
    with PROFILER_LOCK.exclusive():
        prof.__enter__()
    try:
        yield prof
    finally:
        with PROFILER_LOCK.exclusive():
            prof.__exit__(None, None, None)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
