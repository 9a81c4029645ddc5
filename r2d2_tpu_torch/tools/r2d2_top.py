"""r2d2_top: live terminal view of a training run's telemetry.

Port of ``tools/r2d2_top.py``.  Tails either source of truth (they carry
the same entries):

    python -m r2d2_tpu_torch.tools.r2d2_top <ckpt_dir | run.jsonl>   # the JSONL run log
    python -m r2d2_tpu_torch.tools.r2d2_top --url http://127.0.0.1:9109   # /statusz

Options: ``--interval SECS`` (default 2), ``--once`` (render one frame
and exit — scripting/tests).  Renders through the SAME
``telemetry.console.format_entry`` path as ``train()``'s verbose line,
plus a health/fleet summary when present; the frame is the reference
tool's, line for line.  Stdlib only: it imports neither torch nor numpy,
and reads ``/statusz`` with no proxy lookup (the exporter binds
loopback).
"""
import json
import os
import sys
import time
import urllib.request

from r2d2_tpu_torch.telemetry.console import format_entry
from r2d2_tpu_torch.telemetry.runlog import tail_entry


def resolve_jsonl(path: str) -> str:
    """Accept a checkpoint dir (appends telemetry/run.jsonl) or a direct
    JSONL path."""
    if os.path.isdir(path):
        return os.path.join(path, "telemetry", "run.jsonl")
    return path


def fetch_statusz(url: str) -> dict:
    # no proxy: an http_proxy in the environment must not reroute a
    # loopback scrape
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(url.rstrip("/") + "/statusz", timeout=5) as resp:
        return json.loads(resp.read().decode("utf-8"))


def render(entry, health=None) -> str:
    """One frame: the shared console line + health/fleet detail."""
    if not entry:
        return "[r2d2] (no telemetry yet)"
    lines = [format_entry(entry)]
    health = health if health is not None else dict(
        threads=entry.get("health") or {})
    threads = health.get("threads") or {}
    dead = [n for n, h in threads.items() if not h.get("alive")]
    restarts = sum(h.get("restarts", 0) for h in threads.values())
    # three-state verdict (docs/OBSERVABILITY.md): ok / degraded / failing
    if not health.get("ok", True):
        verdict = "  ** NOT OK **"
    elif health.get("status") == "degraded" or health.get("degraded"):
        verdict = "  ** DEGRADED **"
    else:
        verdict = ""
    lines.append(f"  fabric: {len(threads)} threads"
                 + (f", DEAD: {','.join(sorted(dead))}" if dead else "")
                 + (f", restarts={restarts}" if restarts else "")
                 + verdict)
    fleet = entry.get("fleet")
    if fleet:
        stats = (fleet.get("stats") or {}).get("totals") or {}
        lines.append(
            f"  fleet: alive={fleet.get('alive')}/{fleet.get('fleets')} "
            f"restarts={sum(fleet.get('restarts', []))} "
            f"blocks={fleet.get('blocks_ingested', 0)} "
            f"corrupt={fleet.get('blocks_corrupt', 0)} "
            f"actor_env_steps={int(stats.get('env_steps', 0))}")
        res = fleet.get("resilience") or {}
        if (res.get("circuits_open") or res.get("circuit_opens")
                or res.get("max_stale_params_s", 0) > 1.0):
            lines.append(
                "  resilience: "
                f"circuits_open={res.get('circuits_open', 0)} "
                f"opens={int(res.get('circuit_opens', 0))} "
                f"retries={int(res.get('retries', 0))} "
                f"local_acts={int(res.get('local_acts', 0))} "
                f"stale_params_s={res.get('max_stale_params_s', 0.0)}")
    pop = (fleet or {}).get("population")
    if pop:
        for row in pop.get("members", []):
            lines.append(
                f"  member {row.get('member')} {row.get('name', '')} "
                f"[{row.get('game', '')}] lanes={row.get('lanes', 0)} "
                f"env_steps={row.get('env_steps', 0)} "
                f"blocks={row.get('blocks', 0)} "
                f"episodes={row.get('episodes', 0)}")
    league = entry.get("league")
    if league:
        h = league.get("health") or {}
        verdict = ("  ** SIDECAR FAILED **" if h.get("failed")
                   else "" if h.get("alive", True) else "  (respawning)")
        lines.append(
            f"  league: rows={league.get('rows', 0)} "
            f"sweeps={league.get('sweeps', 0)} "
            f"last_step={league.get('last_step', -1)}" + verdict)
        for row in league.get("table") or []:
            best = row.get("best_reward")
            lines.append(
                f"    #{row.get('member')} {row.get('name', '')} "
                f"[{row.get('game', '')}] "
                f"last={row.get('last_reward', 0.0):.1f}"
                f"@{row.get('last_step', -1)} "
                + (f"best={best:.1f}@{row.get('best_step', -1)} "
                   if best is not None else "")
                + f"evals={row.get('evals', 0)}")
    lh = entry.get("learnhealth") or {}
    if lh.get("armed_steps"):
        # newest armed in-graph diagnostics (telemetry/learnhealth.py)
        lines.append(
            "  learnhealth: "
            f"dq={lh.get('dq_mean', float('nan')):.4f}"
            f"/{lh.get('dq_max', float('nan')):.4f} "
            f"grad_norm={lh.get('grad_norm', float('nan')):.3g} "
            f"target_lag={lh.get('target_lag', float('nan')):.3g} "
            f"max|Q|={lh.get('max_abs_q', float('nan')):.3g} "
            f"armed={lh.get('armed_steps', 0)}")
    rh = entry.get("replay_health") or {}
    prio_rows = (rh.get("shards")
                 if rh.get("shards") is not None
                 else [dict(rh["priorities"], shard=None)]
                 if rh.get("priorities") else [])
    for row in prio_rows:
        tag = ("" if row.get("shard") is None
               else f" shard{row['shard']}")
        lines.append(
            f"  replay{tag}: ess={row.get('ess', 0.0):.1f} "
            f"({100.0 * row.get('ess_frac', 0.0):.1f}% of "
            f"{row.get('positive_leaves', 0)} leaves) "
            f"ratio={rh.get('replay_ratio', 0.0):.2f}")
    alerts = {k: v for k, v in (entry.get("alerts") or {}).items() if v}
    if alerts:
        lines.append("  ** ALERTS ** " + " ".join(
            f"{k}={v}" for k, v in sorted(alerts.items())))
    chaos = entry.get("chaos")
    if chaos:
        lines.append("  chaos: " + " ".join(f"{k}={v}"
                                            for k, v in sorted(chaos.items())))
    return "\n".join(lines)


def main(argv=None) -> int:
    url, source, interval, once = None, None, 2.0, False
    args = list(sys.argv[1:] if argv is None else argv)
    while args:
        a = args.pop(0)
        if a == "--url":
            url = args.pop(0)
        elif a == "--interval":
            interval = float(args.pop(0))
        elif a == "--once":
            once = True
        else:
            source = a
    if (url is None) == (source is None):
        print(__doc__)
        return 2
    while True:
        if url is not None:
            try:
                status = fetch_statusz(url)
                frame = render(status.get("last_entry") or {},
                               health=status.get("health"))
            except OSError as e:
                frame = f"[r2d2] endpoint unreachable: {e}"
        else:
            frame = render(tail_entry(resolve_jsonl(source)))
        print(frame, flush=True)
        if once:
            return 0
        time.sleep(interval)


if __name__ == "__main__":
    sys.exit(main())
