"""Metrics registry: counters, gauges, histograms (port of
``r2d2_tpu/telemetry/registry.py``; its rendering to ``/statusz`` and
``/metrics`` and the bulk absorbers wait for the telemetry slice).

ONE labeled namespace with exactly three metric kinds (the Prometheus
data model):

- **counter** — monotone accumulator.  Two write paths: :meth:`inc`
  (event increments) and :meth:`counter_max` (absorbing an *absolute*
  external counter, e.g. ``buffer.training_steps`` — the registry keeps
  the running max so re-absorbing the same snapshot is idempotent and a
  restarted source can never drag the series backwards).
- **gauge** — instantaneous value (:meth:`set_gauge`), may go down.
- **histogram** — fixed upper-bound buckets, allocation-light: one
  ``bisect`` + three scalar adds per :meth:`observe`, no per-sample
  storage — safe in the ingest hot loop.

Metric names are dotted lowercase (``serving.requests``); labels are
keyword arguments (``fleet="0"``).  Every call site passes the name as a
string literal, so a grep for a metric name finds its producers.

Thread-safe throughout: one lock, scalar work inside it.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, Mapping, Sequence, Tuple

# seconds-scale latency buckets — the default when a histogram is not
# explicitly declared with its own bounds
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)

LabelKey = Tuple[Tuple[str, str], ...]
MetricKey = Tuple[str, LabelKey]


def _label_key(labels: Mapping[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Histogram:
    __slots__ = ("bounds", "counts", "total", "count")

    def __init__(self, bounds: Sequence[float]):
        self.bounds = [float(b) for b in bounds]   # ascending upper edges
        self.counts = [0] * (len(self.bounds) + 1)  # +1: the +Inf bucket
        self.total = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.total += value
        self.count += 1


class MetricsRegistry:
    """Thread-safe named counters / gauges / histograms (module doc)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[MetricKey, float] = {}
        self._gauges: Dict[MetricKey, float] = {}
        self._histograms: Dict[MetricKey, _Histogram] = {}
        self._hist_bounds: Dict[str, Sequence[float]] = {}

    # ------------------------------------------------------------- writes
    def inc(self, name: str, n: float = 1, **labels) -> None:
        """Add ``n`` (>= 0) to a counter."""
        if n < 0:
            raise ValueError(f"counter {name!r}: negative increment {n}")
        key = (name, _label_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def counter_max(self, name: str, value: float, **labels) -> None:
        """Absorb an ABSOLUTE external counter: the stored value becomes
        ``max(current, value)``, so repeated scrapes of the same source
        are idempotent and the series never regresses."""
        key = (name, _label_key(labels))
        with self._lock:
            cur = self._counters.get(key, 0)
            if value > cur:
                self._counters[key] = value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            self._gauges[key] = float(value)

    def declare_histogram(self, name: str,
                          buckets: Sequence[float]) -> None:
        """Pin a histogram's bucket bounds (ascending upper edges); must
        run before the first :meth:`observe` of that name."""
        with self._lock:
            self._hist_bounds[name] = tuple(float(b) for b in buckets)

    def observe(self, name: str, value: float, **labels) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                h = self._histograms[key] = _Histogram(
                    self._hist_bounds.get(name, DEFAULT_BUCKETS))
            h.observe(float(value))

    def observe_many(self, name: str, values, **labels) -> None:
        """Vectorised :meth:`observe` for a batch of samples (e.g. the
        per-row block ages of one sampled batch): one lock acquisition
        and one ``np.searchsorted`` pass instead of ``len(values)``
        locked bisects."""
        import numpy as np

        values = np.asarray(values, np.float64).ravel()
        if values.size == 0:
            return
        key = (name, _label_key(labels))
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                h = self._histograms[key] = _Histogram(
                    self._hist_bounds.get(name, DEFAULT_BUCKETS))
            idx = np.searchsorted(h.bounds, values, side="left")
            for i, c in zip(*np.unique(idx, return_counts=True)):
                h.counts[int(i)] += int(c)
            h.total += float(values.sum())
            h.count += int(values.size)

    # -------------------------------------------------------------- reads
    def get_counter(self, name: str, **labels) -> float:
        with self._lock:
            return self._counters.get((name, _label_key(labels)), 0)
