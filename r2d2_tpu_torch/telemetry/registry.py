"""Cross-plane metrics registry: counters, gauges, histograms (port of
``r2d2_tpu/telemetry/registry.py``, copied whole).

The fabric's observability before this module was a pile of disjoint
ad-hoc surfaces — ``Tracer`` spans, the ``RETRACES``/``HOST_TRANSFERS``
guard counters, ``ReplayBuffer.stats()``, chaos fire counts, supervisor
health dicts — each with its own shape and none scrapeable.  The
:class:`MetricsRegistry` absorbs all of them into ONE labeled namespace
with exactly three metric kinds (the Prometheus data model):

- **counter** — monotone accumulator.  Two write paths: :meth:`inc`
  (event increments) and :meth:`counter_max` (absorbing an *absolute*
  external counter, e.g. ``buffer.training_steps`` — the registry keeps
  the running max so re-absorbing the same snapshot is idempotent and a
  restarted source can never drag the series backwards).
- **gauge** — instantaneous value (:meth:`set_gauge`), may go down.
- **histogram** — fixed upper-bound buckets, allocation-light: one
  ``bisect`` + three scalar adds per :meth:`observe`, no per-sample
  storage — safe in the ingest hot loop.

Metric names are dotted lowercase (``actor.env_steps``); labels are
keyword arguments (``fleet="0"``).  Every call site passes the name as a
string literal — the namespace is a registry, not a format-string
free-for-all, so a grep for a metric name always finds its producers.

Rendering: :meth:`snapshot` (plain JSON-able dict — the ``/statusz``
payload) and :meth:`render_prometheus` (text exposition format 0.0.4 —
the ``/metrics`` payload).  Prometheus names are sanitized from the
dotted form (``actor.env_steps`` → ``r2d2_actor_env_steps_total``).

Thread-safe throughout: one lock, scalar work inside it.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

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

    def to_dict(self) -> dict:
        return dict(buckets=list(self.bounds), counts=list(self.counts),
                    sum=self.total, count=self.count)


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

    def absorb_histogram(self, name: str, bounds: Sequence[float],
                         counts: Sequence[float],
                         total: Optional[float] = None, **labels) -> None:
        """Absorb an ABSOLUTE cumulative bucket-count vector from a
        monotone external source (e.g. the learnhealth diag's in-graph
        |TD| histogram): per-bucket max-merge — the :meth:`counter_max`
        idempotence rule applied bucketwise, so re-absorbing the same
        snapshot never double-counts and a restarted scrape never drags
        a bucket backwards.  ``counts`` must align to ``bounds`` plus
        the trailing +Inf bucket; ``total`` is the histogram's running
        value sum (kept monotone the same way)."""
        bounds_f = [float(b) for b in bounds]
        if len(counts) != len(bounds_f) + 1:
            raise ValueError(
                f"histogram {name!r}: {len(counts)} counts for "
                f"{len(bounds_f)} bounds (+Inf bucket expected)")
        key = (name, _label_key(labels))
        with self._lock:
            h = self._histograms.get(key)
            if h is None or h.bounds != bounds_f:
                h = self._histograms[key] = _Histogram(bounds_f)
            for i, c in enumerate(counts):
                h.counts[i] = max(h.counts[i], int(c))
            h.count = sum(h.counts)
            if total is not None:
                h.total = max(h.total, float(total))

    # bulk absorption of the pre-existing flat-dict surfaces ---------------
    def absorb_gauges(self, prefix: str,
                      mapping: Mapping[str, float], **labels) -> None:
        """Every numeric entry of ``mapping`` becomes gauge
        ``<prefix>.<key>`` — the Tracer-snapshot / health-dict path."""
        for k, v in mapping.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            self.set_gauge(f"{prefix}.{k}", v, **labels)

    def absorb_counters(self, prefix: str,
                        mapping: Mapping[str, float], **labels) -> None:
        """Every numeric entry becomes counter ``<prefix>.<key>`` via
        :meth:`counter_max` (the entries are absolute totals)."""
        for k, v in mapping.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            self.counter_max(f"{prefix}.{k}", v, **labels)

    # -------------------------------------------------------------- reads
    def get_counter(self, name: str, **labels) -> float:
        with self._lock:
            return self._counters.get((name, _label_key(labels)), 0)

    def get_gauge(self, name: str, **labels) -> Optional[float]:
        with self._lock:
            return self._gauges.get((name, _label_key(labels)))

    def snapshot(self) -> dict:
        """Plain JSON-able dump — the ``/statusz`` payload.  Keys are
        ``name{k=v,...}`` strings (label-free metrics keep the bare
        name)."""
        def fmt(key: MetricKey) -> str:
            name, labels = key
            if not labels:
                return name
            return name + "{" + ",".join(f"{k}={v}"
                                         for k, v in labels) + "}"

        with self._lock:
            return dict(
                counters={fmt(k): v for k, v in
                          sorted(self._counters.items())},
                gauges={fmt(k): v for k, v in sorted(self._gauges.items())},
                histograms={fmt(k): h.to_dict() for k, h in
                            sorted(self._histograms.items())},
            )

    # -------------------------------------------------- prometheus render
    @staticmethod
    def _prom_name(name: str, kind: str) -> str:
        out = ["r2d2_"]
        for ch in name:
            out.append(ch if ch.isalnum() or ch == "_" else "_")
        base = "".join(out)
        if kind == "counter" and not base.endswith("_total"):
            base += "_total"
        return base

    @staticmethod
    def _prom_labels(labels: LabelKey, extra: str = "") -> str:
        if not labels and not extra:
            return ""
        parts = [f'{k}="' + v.replace("\\", r"\\").replace('"', r'\"')
                 .replace("\n", r"\n") + '"' for k, v in labels]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}"

    @staticmethod
    def _prom_value(v: float) -> str:
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        return repr(float(v)) if isinstance(v, float) and v != int(v) \
            else str(int(v))

    def render_prometheus(self) -> str:
        """Text exposition format 0.0.4 (the ``/metrics`` body): one
        ``# TYPE`` line per metric family, label values escaped, and the
        histogram bucket/sum/count triple per Prometheus convention."""
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            hists = sorted(self._histograms.items())
        lines: List[str] = []
        typed: set = set()

        for kind, series in (("counter", counters), ("gauge", gauges)):
            for (name, labels), v in series:
                pname = self._prom_name(name, kind)
                if pname not in typed:
                    lines.append(f"# TYPE {pname} {kind}")
                    typed.add(pname)
                lines.append(pname + self._prom_labels(labels) + " "
                             + self._prom_value(v))
        for (name, labels), h in hists:
            base = self._prom_name(name, "histogram")
            if base not in typed:
                lines.append(f"# TYPE {base} histogram")
                typed.add(base)
            cum = 0
            for edge, c in zip(list(h.bounds) + ["+Inf"],
                               h.counts):
                cum += c
                le = ("+Inf" if edge == "+Inf"
                      else self._prom_value(float(edge)))
                lines.append(
                    base + "_bucket"
                    + self._prom_labels(labels, f'le="{le}"') + f" {cum}")
            lines.append(base + "_sum" + self._prom_labels(labels)
                         + " " + self._prom_value(h.total))
            lines.append(base + "_count" + self._prom_labels(labels)
                         + f" {h.count}")
        return "\n".join(lines) + "\n"
