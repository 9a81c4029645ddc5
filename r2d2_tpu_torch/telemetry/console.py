"""The ONE console rendering of a stats entry (port of
``r2d2_tpu/telemetry/console.py``, copied whole).

``train()``'s verbose log line and the live terminal view
(tools/r2d2_top.py) previously could not share formatting — the line was
an inline f-string in ``log_loop``.  Both now render through
:func:`format_entry`, so the operator sees the same line whether they
are watching the training process's stdout, tailing the JSONL run log,
or polling the HTTP endpoint.
"""
from __future__ import annotations

from typing import Any, Dict


def format_entry(entry: Dict[str, Any], prefix: str = "[r2d2]") -> str:
    """One status line from a stats entry (the ``log_loop`` schema;
    missing keys render as zeros so partial entries — e.g. an early
    scrape — still format)."""
    ret = entry.get("mean_episode_return", float("nan"))
    line = (f"{prefix} updates={entry.get('training_steps', 0)} "
            f"({entry.get('updates_per_sec', 0.0):.1f}/s) "
            f"buffer={entry.get('buffer_size', 0)} "
            f"env_steps={entry.get('env_steps', 0)} "
            f"return={float(ret):.1f} "
            f"loss={entry.get('mean_loss', float('nan')):.4f}")
    fleet = entry.get("fleet")
    if fleet:
        line += f" fleets={fleet.get('alive', 0)}/{fleet.get('fleets', 0)}"
        stats = fleet.get("stats") or {}
        totals = stats.get("totals") or {}
        if totals.get("env_steps"):
            line += f" fleet_env_steps={int(totals['env_steps'])}"
    trace = entry.get("trace") or {}
    p95 = trace.get("span.learner.step_dispatch.p95_ms")
    if p95 is not None:
        # span-histogram percentiles (utils/trace.Tracer): the learner's
        # dispatch latency tail, visible without a trace dump
        line += f" step_p95={p95:.1f}ms"
        wait95 = trace.get("span.learner.batch_wait.p95_ms")
        if wait95 is not None:
            line += f" wait_p95={wait95:.1f}ms"
    rs = entry.get("replay_shards")
    if rs:
        line += f" shards={rs.get('alive', 0)}/{rs.get('shards', 0)}"
        respawns = sum(rs.get("respawns", []))
        if respawns:
            line += f" shard_respawns={respawns}"
        if rs.get("sample_timeouts"):
            line += f" shard_timeouts={rs['sample_timeouts']}"
        net = rs.get("net")
        if net:
            # cross-host transport: link connectivity at a glance, plus
            # the partition-story counters when they are non-zero
            line += f" net={net.get('connected', 0)}/{rs.get('shards', 0)}"
            if net.get("reconnects"):
                line += f" reconnects={net['reconnects']}"
            if net.get("epoch_drops"):
                line += f" epoch_drops={net['epoch_drops']}"
    if entry.get("corrupt_blocks"):
        line += f" corrupt_blocks={entry['corrupt_blocks']}"
    lh = entry.get("learnhealth") or {}
    if lh.get("armed_steps") and lh.get("dq_mean") is not None:
        # the paper's stored-vs-recomputed-state ΔQ, from the newest
        # armed in-graph diagnostic (telemetry/learnhealth.py)
        line += f" dq={lh['dq_mean']:.4f}"
    alerts = entry.get("alerts") or {}
    fired = {k: v for k, v in alerts.items() if v}
    if fired:
        line += " ALERTS[" + ",".join(
            f"{k}={v}" for k, v in sorted(fired.items())) + "]"
    age = entry.get("learner_heartbeat_age")
    if age is not None and age > 5.0:
        line += f" heartbeat_age={age:.1f}s"
    return line
