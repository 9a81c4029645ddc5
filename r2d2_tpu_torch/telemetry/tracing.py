"""Stand-in for ``r2d2_tpu/telemetry/tracing.py``'s ``EVENTS`` writer.

The ported replay buffer and actor keep the reference's lineage hooks
(``if EVENTS.armed: ...``), so the real cross-process event rings can slot
in unchanged when the telemetry slice ports them (ROADMAP.md A, item 10).
Until then the writer is always disarmed: every hook is one attribute
check, and nothing is recorded.
"""
from __future__ import annotations


class _DisarmedEvents:
    """The disarmed fast path of the reference's event writer."""

    armed = False

    def next_trace_id(self) -> int:
        return 0

    def instant(self, name: str, **kw) -> None:
        pass

    def complete(self, name: str, t0: float, dur: float, **kw) -> None:
        pass


EVENTS = _DisarmedEvents()
