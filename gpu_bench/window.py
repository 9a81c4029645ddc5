"""The measured window, kept by the tracer the run hands to ``train()``.

The port's learner ends a ``learner.result_sync`` span each time a
result reaches the host: one update on host-staged batches, one
super-step of k updates on the device ring.  :class:`WindowTracer` keeps
each such end time.  The window opens at the first result once set-up is
over — the check's copies taken and no graph captured since the result
before — and lasts ``seconds``: ``stop()`` turns true at its close.  With
``profile`` the run goes on past the close for a traced stretch:
``torch.profiler`` starts at the first result after the close and stops
at the first result ``trace_seconds`` after it is up, on the learner's
thread, so that neither its start nor its slow stop falls inside the
window; ``stop()`` turns true then.  Every span that ends in the traced
stretch is kept with its thread, so that idle time on the device can be
laid against what the host was doing.

Span totals and counts are read at the opening and the close, so a
per-layer mean is over the window alone."""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from r2d2_tpu_torch.utils.trace import RETRACES, Tracer

RESULT_SPAN = "learner.result_sync"
# how long past its planned end a traced stretch may run before the run
# stops all the same (the profiler's start takes a few seconds)
TRACE_GRACE = 60.0


def _traces() -> int:
    return sum(t for _, t, _ in RETRACES.entries())


class WindowTracer(Tracer):
    def __init__(self, seconds: float, ready: Callable[[], bool],
                 setup_limit: float, profile: bool = False,
                 trace_seconds: float = 0.0):
        super().__init__()
        self.seconds = seconds
        self._ready = ready
        self.setup_limit = setup_limit
        self.results: List[float] = []
        self.t_open: Optional[float] = None
        self.t_close: Optional[float] = None
        self._last_traces = -1
        self.profile = profile
        self.trace_seconds = trace_seconds
        self.profiler = None
        self.t_prof: Tuple[Optional[float], Optional[float]] = (None, None)
        self.host_spans: List[Tuple[str, str, float, float]] = []
        self.at_open: Dict[str, Tuple[int, float]] = {}
        self.at_close: Dict[str, Tuple[int, float]] = {}
        self._t_start = time.perf_counter()

    # ------------------------------------------------------------ spans
    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        with super().span(name):
            yield
        t1 = time.perf_counter()
        if self.profiler is not None and self.t_prof[1] is None:
            self.host_spans.append((name, threading.current_thread().name,
                                    t0, t1))
        if name == RESULT_SPAN:
            self._result(t1)

    def _totals(self) -> Dict[str, Tuple[int, float]]:
        with self._lock:
            return {k: (s.count, s.total) for k, s in self._spans.items()}

    def _result(self, t: float) -> None:
        if self.t_open is None:
            traces = _traces()
            settled = traces == self._last_traces
            self._last_traces = traces
            if not (settled and self._ready()):
                return
            self.t_open = t
            self.at_open = self._totals()
            return
        self.results.append(t)
        end = self.t_open + self.seconds
        if self.t_close is None:
            if t >= end:
                self.t_close = end
                self.at_close = self._totals()
                if self.profile:
                    self._start_profiler()
        elif (self.profiler is not None and self.t_prof[1] is None
              and t >= self.t_prof[0] + self.trace_seconds):
            self._stop_profiler()

    # ------------------------------------------------------------ stop
    def stop(self) -> bool:
        now = time.perf_counter()
        if self.t_open is None:
            return now - self._t_start > self.setup_limit
        end = self.t_open + self.seconds
        if not self.profile or now > end + self.trace_seconds + TRACE_GRACE:
            return now >= end
        return self.t_prof[1] is not None

    # ------------------------------------------------------------ profile
    def _start_profiler(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        from r2d2_tpu_torch.utils.trace import PROFILER_LOCK

        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        with PROFILER_LOCK.exclusive():
            prof.__enter__()
            torch.cuda.synchronize()
        self.profiler = prof
        self.t_prof = (time.perf_counter(), None)

    def _stop_profiler(self) -> None:
        import torch

        from r2d2_tpu_torch.utils.trace import PROFILER_LOCK

        with PROFILER_LOCK.exclusive():
            torch.cuda.synchronize()
            self.t_prof = (self.t_prof[0], time.perf_counter())
            self.profiler.__exit__(None, None, None)

    def finish(self) -> None:
        """Stop a profiler still running when the run ended, and read the
        span totals at the close if no result came after it."""
        if self.t_open is not None and self.t_close is None:
            self.t_close = self.t_open + self.seconds
            self.at_close = self._totals()
        if self.profiler is not None and self.t_prof[1] is None:
            self._stop_profiler()

    # ------------------------------------------------------------ reads
    def window_results(self) -> List[float]:
        """End times of the results inside the window."""
        if self.t_open is None:
            return []
        end = self.t_open + self.seconds
        return [t for t in self.results if t <= end]

    def intervals(self) -> List[float]:
        """Wall time between consecutive results in the window, the first
        from the opening."""
        ts = [self.t_open] + self.window_results()
        return [b - a for a, b in zip(ts, ts[1:])]

    def span_mean_ms(self, name: str) -> Optional[float]:
        """Mean duration of ``name`` over the window (None: no span)."""
        c1, s1 = self.at_close.get(name, (0, 0.0))
        c0, s0 = self.at_open.get(name, (0, 0.0))
        if c1 - c0 <= 0:
            return None
        return (s1 - s0) / (c1 - c0) * 1e3
