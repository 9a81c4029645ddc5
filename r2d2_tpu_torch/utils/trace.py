"""Tracing and profiling instrumentation.  Port of the ``Tracer``,
``TransferCounter`` and ``device_profile`` parts of
``r2d2_tpu/utils/trace.py``; ``RetraceGuard`` and ``TransferGuard`` wait
for the telemetry slice (ROADMAP.md A, item 10).

- :class:`Tracer` — in-process stage timers and gauges.  Spans record
  wall-time per stage as exponential moving averages with counts AND a
  fixed log-bucket histogram per span (p50/p95/p99 surfaced in
  ``snapshot()``).
- :func:`device_profile` — a context manager around ``torch.profiler``
  that writes a Chrome trace of the CPU and CUDA timeline of a region.
- :class:`TransferCounter` — named thread-safe counters.
  :data:`HOST_TRANSFERS` counts the device<->host crossings of the serving
  hot loop, so "the batcher puts once and fetches once per batch" is an
  assertable invariant; :data:`KERNEL_LAUNCHES` counts the hand-written
  kernels' launches.

Everything is thread-safe and allocation-light: spans cost two
``perf_counter`` calls and a locked float update per use.
"""
from __future__ import annotations

import bisect
import contextlib
import threading
import time
import os
from typing import Dict, Iterator, Optional

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

    def __init__(self, alpha: float = 0.05):
        self._alpha = alpha
        self._spans: Dict[str, _Stat] = {}
        self._gauges: Dict[str, float] = {}
        self._lock = threading.Lock()

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

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def snapshot(self) -> Dict[str, float]:
        """Flat dict: span.<name>.{ewma_ms,mean_ms,count,p50_ms,p95_ms,
        p99_ms}, gauge.<name>.  The percentiles come from
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
        """A declared-transfer span: tick the counter around the one
        sanctioned host<->device copy it wraps."""
        self.count(name, n)
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


# process-wide instances: the serving batcher ticks HOST_TRANSFERS around
# its one H2D put and its one D2H fetch per batch; every CUDA kernel
# wrapper (ops/) ticks KERNEL_LAUNCHES under its kernel's name once per
# launch call, so a run can show its hot path went through the kernels
HOST_TRANSFERS = TransferCounter()
KERNEL_LAUNCHES = TransferCounter()


@contextlib.contextmanager
def device_profile(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the region (CPU ops, and CUDA
    kernels when a card is visible) into ``log_dir/trace.json``, viewable
    in Perfetto or ``chrome://tracing``.  No-op when ``log_dir`` is None,
    so call sites can be unconditional."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
