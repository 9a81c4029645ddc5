"""The trainer-side telemetry plane: registry + run log + exporter.

Port of ``r2d2_tpu/telemetry/plane.py``: the same entry absorption, the
same metric names.  The guard surfaces it absorbs are the port's
(``HOST_TRANSFERS``, ``KERNEL_LAUNCHES``, ``TRANSFER_GUARD``'s
``window.*``/``trip.*`` counters, and ``RETRACES``' traces per entry
point as ``retraces.max_traces{entry_point}``: on a card a learner
step's CUDA-graph captures, elsewhere its input signatures; ROADMAP.md
A item 10).

One :class:`Telemetry` object per ``train()`` call, wired by the fabric:

- owns the :class:`~r2d2_tpu_torch.telemetry.registry.MetricsRegistry` every
  plane writes into (``train()`` hands the same instance to the process
  fleet plane so respawn/ingest/serve counters land in the shared
  namespace),
- owns the persistent JSONL :class:`~r2d2_tpu_torch.telemetry.runlog.RunLog`
  under ``<ckpt_dir>/telemetry/`` (absent without a checkpoint dir —
  ephemeral runs still get the registry and exporter),
- optionally owns the HTTP exporter (``cfg.telemetry_port``), whose
  supervised loop ``train()`` registers like any other fabric thread.

:meth:`record` is the single scrape point, called once per log
interval from ``log_loop`` with the assembled stats entry: it absorbs
the entry into the registry (spans → gauges, stats → monotone counters,
supervisor/fleet health → labeled gauges, chaos fires → counters, the
RETRACES / HOST_TRANSFERS guard surfaces), then appends the entry to
the run log.  Everything the registry learns is therefore also in the
durable JSONL record — the exporter and the file never disagree by more
than one interval.
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional

from r2d2_tpu_torch.telemetry.exporter import TelemetryExporter, make_exporter
from r2d2_tpu_torch.telemetry.registry import MetricsRegistry
from r2d2_tpu_torch.telemetry.runlog import RunLog


class Telemetry:
    """Registry + run log + exporter for one training run."""

    def __init__(self, cfg, checkpoint_dir: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.cfg = cfg
        self.registry = registry if registry is not None else (
            MetricsRegistry())
        self.runlog: Optional[RunLog] = None
        if checkpoint_dir:
            self.runlog = RunLog(
                os.path.join(checkpoint_dir, "telemetry"),
                max_bytes=cfg.telemetry_log_max_bytes)
        self.exporter: Optional[TelemetryExporter] = None
        self._bound_port = 0
        self.last_entry: Dict[str, Any] = {}

    # ------------------------------------------------------------ exporter
    def serve(self, health_fn, routes=None) -> Optional[TelemetryExporter]:
        """Arm the HTTP exporter per ``cfg.telemetry_port`` (None when
        disabled).  ``/statusz`` carries the newest recorded entry;
        ``routes`` adds trigger endpoints (``/tracez``/``/profilez`` —
        exporter module docstring)."""
        self.exporter = make_exporter(
            self.cfg, self.registry, health_fn,
            status_fn=lambda: dict(last_entry=self.last_entry),
            routes=routes)
        if self.exporter is not None:
            self._bound_port = self.exporter.port
        return self.exporter

    @property
    def port(self) -> int:
        """The exporter's bound port (0 = exporter never armed); stays
        readable after close so the run's metrics can report it."""
        return self._bound_port

    # -------------------------------------------------------------- scrape
    def record(self, entry: Dict[str, Any]) -> None:
        """Absorb one ``log_loop`` stats entry into the registry, then
        persist it to the run log (module docstring)."""
        reg = self.registry
        # headline counters (absolute values → monotone absorption)
        reg.counter_max("learner.training_steps",
                        entry.get("training_steps", 0))
        reg.counter_max("replay.env_steps", entry.get("env_steps", 0))
        # headline gauges
        reg.set_gauge("replay.buffer_size", entry.get("buffer_size", 0))
        reg.set_gauge("learner.updates_per_sec",
                      entry.get("updates_per_sec", 0.0))
        reg.set_gauge("learner.mean_loss",
                      entry.get("mean_loss", float("nan")))
        reg.set_gauge("actor.mean_episode_return",
                      entry.get("mean_episode_return", float("nan")))
        reg.set_gauge("learner.heartbeat_age_seconds",
                      entry.get("learner_heartbeat_age", 0.0))
        if "telemetry_port" in entry:
            reg.set_gauge("telemetry.port", entry["telemetry_port"])
        # interval deltas are genuine counter increments
        if entry.get("interval_episodes"):
            reg.inc("actor.episodes_finished", entry["interval_episodes"])
        # tracer spans/gauges/counters ride along as telemetry gauges
        reg.absorb_gauges("trace", entry.get("trace", {}))
        # supervisor thread health, one labeled series per thread
        for name, h in (entry.get("health") or {}).items():
            reg.set_gauge("fabric.thread_alive",
                          1.0 if h.get("alive") else 0.0, thread=name)
            reg.counter_max("fabric.thread_restarts",
                            h.get("restarts", 0), thread=name)
            if h.get("gave_up"):
                # belt over the Supervisor's own on_giveup stamp (the
                # log loop may be the thread that died — then only the
                # callback path records it)
                reg.counter_max("supervisor.gaveup", 1, thread=name)
        # chaos fires
        for kind, n in (entry.get("chaos") or {}).items():
            reg.counter_max("chaos.fires", n, kind=kind)
        # process-fleet plane health (incl. the slab-merged actor stats)
        fleet = entry.get("fleet")
        if fleet:
            reg.set_gauge("fleet.alive", fleet.get("alive", 0))
            reg.set_gauge("fleet.total", fleet.get("fleets", 0))
            reg.counter_max("fleet.restarts",
                            sum(fleet.get("restarts", [])))
            reg.counter_max("ingest.blocks",
                            fleet.get("blocks_ingested", 0))
            reg.counter_max("ingest.frames",
                            fleet.get("frames_ingested", 0))
            reg.counter_max("ingest.blocks_corrupt",
                            fleet.get("blocks_corrupt", 0))
            # slab-merged actor stats: env steps / blocks / episodes are
            # genuine monotone counters; the reward SUM legally decreases
            # (negative rewards) so it must travel as a gauge —
            # counter_max would clamp it at its historical max and never
            # export a negative value at all
            totals = (fleet.get("stats") or {}).get("totals", {})
            reg.counter_max("actor.env_steps",
                            totals.get("env_steps", 0))
            reg.counter_max("actor.blocks_produced",
                            totals.get("blocks_produced", 0))
            reg.counter_max("actor.episodes", totals.get("episodes", 0))
            if "episode_reward_sum" in totals:
                reg.set_gauge("actor.episode_reward_sum",
                              totals["episode_reward_sum"])
            for f, row in enumerate(
                    (fleet.get("stats") or {}).get("per_fleet", [])):
                lbl = str(f)
                reg.counter_max("actor.fleet.env_steps",
                                row.get("env_steps", 0), fleet=lbl)
                reg.counter_max("actor.fleet.blocks_produced",
                                row.get("blocks_produced", 0), fleet=lbl)
                reg.counter_max("actor.fleet.episodes",
                                row.get("episodes", 0), fleet=lbl)
                reg.set_gauge("actor.fleet.episode_reward_sum",
                              row.get("episode_reward_sum", 0.0),
                              fleet=lbl)
                reg.set_gauge("actor.fleet.param_version",
                              row.get("param_version", 0), fleet=lbl)
            svc = fleet.get("service")
            if svc:
                reg.counter_max("serve.batches", svc.get("batches", 0))
                reg.counter_max("serve.lanes_served",
                                svc.get("lanes_served", 0))
                reg.counter_max("serve.requests_corrupt",
                                svc.get("requests_corrupt", 0))
                reg.counter_max("serve.partial_batches",
                                svc.get("partial_batches", 0))
                reg.counter_max("serve.stale_requests",
                                svc.get("stale_requests", 0))
                reg.counter_max("serve.resyncs", svc.get("resyncs", 0))
                reg.set_gauge("serve.last_batch_lanes",
                              svc.get("last_batch_lanes", 0))
                reg.set_gauge("serve.param_version",
                              svc.get("param_version", 0))
            # population plane (league/population.py): per-member rows of
            # the slab-merged fleet counters — fleet f ↔ member f, folded
            # monotone through respawns by the CounterMerger upstream
            pop = fleet.get("population")
            if pop:
                for row in pop.get("members", []):
                    lbl = str(row.get("member", 0))
                    reg.counter_max("population.env_steps",
                                    row.get("env_steps", 0), member=lbl)
                    reg.counter_max("population.blocks",
                                    row.get("blocks", 0), member=lbl)
                    reg.counter_max("population.episodes",
                                    row.get("episodes", 0), member=lbl)
                    # reward sums legally decrease (negative rewards):
                    # gauge, the actor.episode_reward_sum rule
                    reg.set_gauge("population.episode_reward_sum",
                                  row.get("episode_reward_sum", 0.0),
                                  member=lbl)
                    reg.set_gauge("population.lanes",
                                  row.get("lanes", 0), member=lbl)
            # degraded-mode resilience plane (utils/resilience.py): the
            # fleets' act-RPC failover state merged from the stats slab
            # plus the plane's param-staleness watchdog
            res = fleet.get("resilience")
            if res:
                reg.counter_max("resilience.retries",
                                res.get("retries", 0))
                reg.counter_max("resilience.circuit_opens",
                                res.get("circuit_opens", 0))
                reg.counter_max("resilience.local_acts",
                                res.get("local_acts", 0))
                reg.set_gauge("resilience.degraded",
                              1.0 if res.get("degraded") else 0.0)
                reg.set_gauge("fleet.max_stale_params_s",
                              res.get("max_stale_params_s", 0.0))
                for f, st in enumerate(res.get("circuit_states", [])):
                    reg.set_gauge("resilience.circuit_state", st,
                                  fleet=str(f))
        # sharded replay plane (parallel/replay_shards.py): shard health
        # + the coordinator's routing/RPC counters under replay.shard.*.
        # Event counters the plane already writes LIVE with a {shard}
        # label (respawns, dropped_blocks, sample_timeouts, redraws,
        # garbled_responses, stale_feedback) are NOT re-absorbed here
        # unlabeled: two label schemas under one name double-count every
        # event in any sum() over the metric — per-shard series plus
        # label aggregation are the one view
        rs = entry.get("replay_shards")
        if rs:
            reg.set_gauge("replay.shard.total", rs.get("shards", 0))
            reg.set_gauge("replay.shard.alive", rs.get("alive", 0))
            reg.counter_max("replay.shard.blocks_routed",
                            rs.get("blocks_routed", 0))
            reg.counter_max("replay.shard.corrupt_blocks",
                            rs.get("corrupt_blocks", 0))
            reg.counter_max("replay.shard.sample_retries",
                            rs.get("sample_retries", 0))
            for sh, m in enumerate(rs.get("masses", [])):
                reg.set_gauge("replay.shard.mass", m, shard=str(sh))
            for sh, n in enumerate(rs.get("sizes", [])):
                reg.set_gauge("replay.shard.size", n, shard=str(sh))
            for sh, n in enumerate(rs.get("per_shard_corrupt", [])):
                reg.counter_max("replay.shard.shard_corrupt_blocks", n,
                                shard=str(sh))
            # cross-host transport (parallel/replay_net.py): the link
            # table's aggregates — per-link circuit_state / connected /
            # event counters are plane-written LIVE with labels, so only
            # the unlabeled aggregates absorb here (the two-schema
            # double-count rule above)
            net = rs.get("net")
            if net:
                reg.set_gauge("replay.net.links_connected",
                              net.get("connected", 0))
                reg.counter_max("replay.net.shard_epoch_drops",
                                net.get("shard_epoch_drops", 0))
                reg.counter_max("replay.net.shard_garbled",
                                net.get("shard_garbled", 0))
                reg.counter_max("replay.net.prio_batches",
                                net.get("prio_batches", 0))
        # shard-health drive-by on the base stats schema (zero on the
        # in-process path — replay.corrupt_blocks also covers the K=1
        # buffer's wire-format drops); shard_respawns stays entry/console
        # only: as a registry name it would flatten onto the same
        # Prometheus series as the plane's replay.shard.respawns{shard}
        if "corrupt_blocks" in entry:
            reg.counter_max("replay.corrupt_blocks",
                            entry["corrupt_blocks"])
        # league standings (league/eval_service.py): the sidecar's
        # durable record is league.jsonl; these gauges are the scrape
        # view — per-member latest/best scores plus sidecar liveness.
        # sidecar_respawns is inc'd at the respawn event site (the
        # fleet.respawns rule), so it is deliberately NOT re-absorbed
        lg = entry.get("league")
        if lg:
            h = lg.get("health") or {}
            reg.set_gauge("league.sidecar_alive",
                          1.0 if h.get("alive") else 0.0)
            reg.set_gauge("league.sidecar_failed",
                          1.0 if h.get("failed") else 0.0)
            reg.counter_max("league.rows", lg.get("rows", 0))
            reg.counter_max("league.sweeps", lg.get("sweeps", 0))
            reg.set_gauge("league.last_step",
                          max(0, lg.get("last_step", 0)))
            for row in lg.get("table", []):
                lbl = str(row.get("member", 0))
                reg.counter_max("league.evals", row.get("evals", 0),
                                member=lbl)
                reg.set_gauge("league.last_reward",
                              row.get("last_reward", 0.0), member=lbl)
                if row.get("best_reward") is not None:
                    reg.set_gauge("league.best_reward",
                                  row["best_reward"], member=lbl)
        # anakin fused-loop surface (train._train_anakin's log loop): the
        # transport is single-process by construction, so its counters
        # publish straight through the registry — no shm slab involved
        an = entry.get("anakin")
        if an:
            reg.counter_max("anakin.super_steps", an.get("super_steps", 0))
            reg.counter_max("anakin.frames", an.get("frames", 0))
            reg.set_gauge("anakin.frames_per_sec",
                          an.get("frames_per_sec", 0.0))
            reg.counter_max("actor.env_steps", entry.get("env_steps", 0))
            reg.counter_max("actor.blocks_produced", an.get("blocks", 0))
            reg.counter_max("actor.episodes", an.get("episodes_total", 0))
            reg.set_gauge("anakin.ring_fill", entry.get("buffer_size", 0))
            # in-graph greedy eval lane (cfg.anakin_eval_interval): the
            # return gauge stays absent until the first eval dispatch
            # (last_eval_return is NaN before it — a NaN gauge would
            # poison /metrics parsers)
            reg.counter_max("anakin.eval_episodes",
                            an.get("eval_episodes", 0))
            ev = an.get("eval_return")
            if ev is not None and math.isfinite(ev):
                reg.set_gauge("anakin.eval_return", ev)
        # learning-health plane (telemetry/learnhealth.py): the
        # monitor's snapshot — latest armed in-graph diag scalars as
        # gauges, cumulative sentry/spike counters, and the |TD| /
        # IS-weight histograms absorbed bucketwise-monotone.  Alert
        # fires are NOT re-absorbed here: the AlertEngine stamps
        # learnhealth.alert{rule} at the fire site (the fleet.respawns
        # rule — the log loop may never tick again after a trip)
        lh = entry.get("learnhealth")
        if lh:
            reg.absorb_counters("learnhealth", {
                k: lh[k] for k in ("armed_steps", "nonfinite",
                                   "loss_spikes", "loss_count")
                if k in lh})
            reg.absorb_gauges("learnhealth", {
                k: lh[k] for k in ("loss_ewma", "dq_ewma", "dq_mean",
                                   "dq_max", "grad_norm", "update_norm",
                                   "param_norm", "target_lag",
                                   "max_abs_q")
                if isinstance(lh.get(k), (int, float))})
            from r2d2_tpu_torch.telemetry.learnhealth import (
                IS_WEIGHT_EDGES,
                TD_ABS_EDGES,
            )

            if lh.get("td_hist"):
                reg.absorb_histogram("learnhealth.td_abs", TD_ABS_EDGES,
                                     lh["td_hist"],
                                     total=lh.get("td_sum"))
            if lh.get("is_hist"):
                reg.absorb_histogram("learnhealth.is_weight",
                                     IS_WEIGHT_EDGES, lh["is_hist"],
                                     total=lh.get("is_sum"))
        # replay data-health: the PER distribution's ESS + priority
        # histogram (per ring, or per shard on the sharded plane), the
        # replay-ratio gauge, per-member sample fractions
        rh = entry.get("replay_health")
        if rh:
            reg.set_gauge("learnhealth.replay.ratio",
                          rh.get("replay_ratio", 0.0))
            spm = rh.get("samples_per_member") or {}
            total_s = sum(spm.values())
            if total_s:
                for m, c in spm.items():
                    reg.set_gauge("learnhealth.replay.sample_fraction",
                                  c / total_s, member=str(m))

            def _prio_row(row, **lbl):
                reg.set_gauge("learnhealth.replay.ess",
                              row.get("ess", 0.0), **lbl)
                reg.set_gauge("learnhealth.replay.ess_frac",
                              row.get("ess_frac", 0.0), **lbl)
                reg.set_gauge("learnhealth.replay.positive_leaves",
                              row.get("positive_leaves", 0), **lbl)
                edges = list(row.get("edges", rh.get("edges") or []))
                for i, c in enumerate(row.get("hist", [])):
                    le = (str(edges[i]) if i < len(edges) else "+Inf")
                    # snapshot of the CURRENT leaf distribution (not a
                    # cumulative counter): per-bucket gauges, le label
                    reg.set_gauge("learnhealth.replay.priorities", c,
                                  le=le, **lbl)

            if rh.get("shards") is not None:
                for row in rh["shards"]:
                    _prio_row(row, shard=str(row.get("shard", 0)))
            elif rh.get("priorities"):
                _prio_row(rh["priorities"])
        # the runtime surfaces (utils/trace.py process-wide views): the
        # counted host<->device crossings, the hand-written kernels'
        # launches, the transfer guard's windows and trips (a non-zero
        # trip is the failure signal) and each entry point's traces
        from r2d2_tpu_torch.utils.trace import (
            HOST_TRANSFERS,
            KERNEL_LAUNCHES,
            RETRACES,
            TRANSFER_GUARD,
        )

        reg.absorb_counters("host_transfers", HOST_TRANSFERS.snapshot())
        reg.absorb_counters("kernel_launches", KERNEL_LAUNCHES.snapshot())
        reg.absorb_counters("transfer_guard", TRANSFER_GUARD.snapshot())
        for name, traces in RETRACES.counts().items():
            reg.set_gauge("retraces.max_traces", traces, entry_point=name)

        self.last_entry = entry
        if self.runlog is not None:
            self.runlog.append(entry)

    def close_exporter(self) -> None:
        """Stop serving scrapes (train()'s fabric teardown calls this
        before joining the supervised loops — the loop is close-driven,
        not stop-driven, so a stalled run stays scrapeable until here)."""
        if self.exporter is not None:
            self.exporter.close()
            self.exporter = None

    def close(self) -> None:
        self.close_exporter()
        if self.runlog is not None:
            self.runlog.close()
