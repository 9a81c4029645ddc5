"""Learning-health plane, host side: the monitor and the alert engine.

Port of ``r2d2_tpu/telemetry/learnhealth.py``: the in-graph diagnostic
vector (:func:`make_diag_fn`: the paper's ΔQ stored-vs-zero-state
divergence, |TD| and IS-weight fixed-bucket histograms, grad/update/param
global norms, target lag, max|Q| and a non-finite sentry, computed on the
device inside an armed train step), the
:class:`LearnHealthMonitor` (harvested losses → the NaN sentry and the
loss-spike EWMA; a non-finite loss trips a clean fabric stop and fires
the ``nonfinite`` alert at once), the replay data-health math
(:func:`priority_health`, :func:`replay_ratio`), the declarative rules
(:func:`build_rules`) and the :class:`AlertEngine` with its
``learnhealth.alert{rule}`` counters, durable ``alerts.jsonl`` rows and
``/alertz`` payload, and :func:`read_alerts`.

The vector rides each drivetrain's existing result fetch (concatenated
into the same flat vector), so the per-dispatch ``HOST_TRANSFERS`` counts
do not change with the diagnostics on.  Module-level code is numpy and
the standard library only (replay shard subprocesses import this for the
data-health vocabulary); :func:`make_diag_fn` imports torch.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from r2d2_tpu_torch.telemetry.runlog import RunLog

# ---------------------------------------------------------------------------
# the in-graph diagnostic vector layout
# ---------------------------------------------------------------------------

# scalar slots, in wire order.  "armed" is 1.0 on cadence steps and the
# whole vector is zeros otherwise (the lax.cond disarmed branch).
DIAG_SCALARS = (
    "armed",          # 1.0 when this step computed diagnostics
    "loss",           # the step's scalar loss (copy)
    "nonfinite",      # NaN/Inf sentry: non-finite elements in loss+grads
    "grad_norm",      # global L2 norm of the gradients
    "update_norm",    # global L2 norm of the optimizer updates
    "param_norm",     # global L2 norm of the updated params
    "target_lag",     # global L2 norm of (params - target_params)
    "max_abs_q",      # max |Q| over the full online unroll
    "dq_mean",        # ΔQ: masked mean |Q_stored - Q_zero| (paper diag)
    "dq_max",         # ΔQ: masked max
    "td_abs_sum",     # masked sum of |TD| (the histogram's _sum)
    "is_weight_sum",  # sum of IS weights (the histogram's _sum)
)

# fixed bucket upper edges (ascending; +Inf bucket implied) — shared by
# the in-graph bucketize and the registry histograms so the counts land
# in a declared histogram unchanged.  |TD| under value rescaling lives
# in ~[1e-3, 10]; IS weights are min-normalised into (0, 1].
TD_ABS_EDGES = (0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0)
IS_WEIGHT_EDGES = (0.05, 0.1, 0.2, 0.4, 0.6, 0.8, 0.95)

_TD_LO = len(DIAG_SCALARS)
_TD_HI = _TD_LO + len(TD_ABS_EDGES) + 1
_IS_LO = _TD_HI
_IS_HI = _IS_LO + len(IS_WEIGHT_EDGES) + 1
DIAG_SIZE = _IS_HI

_SCALAR_IDX = {name: i for i, name in enumerate(DIAG_SCALARS)}

# fixed bucket upper edges for the replay-side priority-distribution
# histogram (sum-tree leaf masses, i.e. td^alpha)
PRIO_EDGES = (1e-3, 3e-3, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0)


def diag_enabled(cfg) -> bool:
    """Whether the train-step drivetrains carry the diagnostic vector."""
    return getattr(cfg, "learnhealth_interval", 0) > 0


def make_diag_fn(cfg, net) -> Callable[..., Any]:
    """The diagnostic bundle of one armed train step.

    Returns ``diag(params, batch, loss, grads, updates, new_params,
    new_target, aux, q_zero=None) -> (DIAG_SIZE,) f32`` on the loss's
    device, where ``aux`` is ``loss_and_priorities(..., with_aux=True)``'s
    ``(td, mask, q_learn, max_abs_q)`` and ``params`` the PRE-update
    params that produced ``q_learn``.  The train step updates its params
    in place, so it runs the ΔQ re-unroll first,
    ``diag.zero_state_unroll(params, batch)``, and passes the result as
    ``q_zero`` (``params`` is then unused).  ``grads``, ``updates``,
    ``new_params`` and ``new_target`` are name -> tensor dicts; every
    norm and the non-finite count cover every leaf (DTensor leaves are
    reduced over their shards by DTensor).  Call under ``no_grad``.

    ``net`` must be the step's LOSS net (the scan recurrence,
    ``learner.step._loss_net``).
    """
    import torch

    from r2d2_tpu_torch.learner.step import (
        _gather_time,
        _unroll,
        _window_indices,
    )
    from r2d2_tpu_torch.models.network import unshard
    from r2d2_tpu_torch.parallel.sharding import full

    # the edges on each device, made once: a CUDA-graph capture of an
    # armed step (learner/graphs.py) may copy nothing from the host
    edge_tensors: Dict[Any, Any] = {}

    def bucketize(values, weights, edges):
        # right=False is jnp's side="left", bisect_left: the registry
        # _Histogram's bucket rule, so the counts merge into a declared
        # histogram without re-binning
        e = edge_tensors.get((edges, values.device))
        if e is None:
            e = edge_tensors[(edges, values.device)] = torch.tensor(
                edges, dtype=torch.float32, device=values.device)
        idx = torch.searchsorted(e, values.reshape(-1).contiguous(),
                                 right=False)
        return torch.zeros(len(edges) + 1, dtype=torch.float32,
                           device=values.device).scatter_add_(
            0, idx, weights.reshape(-1).to(torch.float32))

    def global_norm(tree) -> torch.Tensor:
        return full(torch.sqrt(sum(torch.sum(v * v)
                                   for v in tree.values())))

    def nonfinite_count(loss, grads) -> torch.Tensor:
        total = (~torch.isfinite(loss)).to(torch.float32)
        for g in grads.values():
            total = total + full((~torch.isfinite(g)).sum()).to(
                torch.float32)
        return total

    def zero_state_unroll(params, batch):
        # the paper's ΔQ: the SAME window re-unrolled from a zero initial
        # state with the SAME pre-update params
        with torch.no_grad():
            q = _unroll(net, params, dict(
                batch, hidden=torch.zeros_like(batch["hidden"])))
        return unshard(q, -1)

    def diag(params, batch, loss, grads, updates, new_params, new_target,
             aux, q_zero=None):
        td, mask, q_learn, max_abs_q = aux
        if q_zero is None:
            q_zero = zero_state_unroll(params, batch)
        td, mask, q_learn = full(td), full(mask), full(q_learn)
        q_zero = full(q_zero)
        w = full(batch["is_weights"])
        idx_online, _, m = _window_indices(
            cfg, full(batch["burn_in"]), full(batch["learning"]),
            full(batch["forward"]))
        dq = torch.abs(q_learn - _gather_time(q_zero, idx_online))
        dq_masked = torch.where(m[:, :, None], dq, torch.zeros_like(dq))
        denom = torch.clamp(m.sum() * dq.shape[-1], min=1)
        dq_mean = dq_masked.sum() / denom
        dq_max = dq_masked.max()
        abs_td = torch.abs(td)
        td_abs = torch.where(mask, abs_td, torch.zeros_like(abs_td))
        td_counts = bucketize(abs_td, mask, TD_ABS_EDGES)
        is_counts = bucketize(w, torch.ones_like(w), IS_WEIGHT_EDGES)
        lag = global_norm({k: new_params[k] - new_target[k]
                           for k in new_params})
        f32 = torch.float32
        scalars = torch.stack([
            torch.ones((), dtype=f32, device=td.device),
            full(loss).to(f32),
            nonfinite_count(full(loss), grads),
            global_norm(grads).to(f32),
            global_norm(updates).to(f32),
            global_norm(new_params).to(f32),
            lag.to(f32),
            full(max_abs_q).to(f32),
            dq_mean.to(f32),
            dq_max.to(f32),
            td_abs.sum().to(f32),
            w.sum().to(f32),
        ])
        return torch.cat([scalars, td_counts, is_counts])

    diag.zero_state_unroll = zero_state_unroll
    return diag


def empty_diag():
    """The disarmed branch's zeros vector (host twin for tests)."""
    return np.zeros(DIAG_SIZE, np.float32)


# ---------------------------------------------------------------------------
# replay data-health math (shared by the in-process buffer and the shard
# owner processes — numpy only)
# ---------------------------------------------------------------------------

def priority_health(leaves) -> Dict[str, Any]:
    """ESS + fixed-bucket histogram of one sum-tree leaf vector.

    ``ess = (Σp)² / Σp²`` over the positive leaves — the effective
    sample size of the PER sampling distribution; ``ess_frac`` is it
    normalised by the positive-leaf count (1.0 = uniform, → 0 as a few
    leaves dominate — the "priority ESS collapse" failure mode the alert
    engine watches)."""
    leaves = np.asarray(leaves, np.float64).ravel()
    pos = leaves[leaves > 0]
    n = int(pos.size)
    if n == 0:
        return dict(ess=0.0, ess_frac=1.0, positive_leaves=0, mass=0.0,
                    hist=[0] * (len(PRIO_EDGES) + 1),
                    edges=list(PRIO_EDGES))
    ess = float(pos.sum() ** 2 / np.square(pos).sum())
    idx = np.searchsorted(np.asarray(PRIO_EDGES), pos, side="left")
    hist = np.bincount(idx, minlength=len(PRIO_EDGES) + 1)
    return dict(ess=ess, ess_frac=ess / n, positive_leaves=n,
                mass=float(pos.sum()), hist=[int(c) for c in hist],
                edges=list(PRIO_EDGES))


def replay_ratio(cfg, training_steps: int, env_steps: int) -> float:
    """Samples consumed per transition inserted: how many times the
    average stored step has been trained on so far (cumulative)."""
    if env_steps <= 0:
        return 0.0
    return (training_steps * cfg.batch_size * cfg.learning_steps
            / float(env_steps))


# ---------------------------------------------------------------------------
# host-side monitor
# ---------------------------------------------------------------------------

# diag scalars surfaced as latest-value gauges (the rest are counters /
# histogram sums handled separately)
_GAUGE_SCALARS = ("grad_norm", "update_norm", "param_norm", "target_lag",
                  "max_abs_q", "dq_mean", "dq_max")


class LearnHealthMonitor:
    """Absorbs harvested losses + armed diag vectors on the learner
    thread; snapshotted by the log loop.  A non-finite observation trips
    :attr:`tripped` (the scaffold's stop predicate polls it) and fires
    the ``nonfinite`` alert immediately through the attached engine —
    the log loop may never tick again once the fabric drains."""

    LOSS_EWMA_ALPHA = 0.02
    LOSS_WARMUP = 20         # samples before the spike rule may fire
    _NONFINITE_CAP = 10 ** 9  # a NaN param tree counts millions of elems

    def __init__(self, cfg, engine: Optional["AlertEngine"] = None):
        self.cfg = cfg
        self.engine = engine
        self.enabled = diag_enabled(cfg)
        self._lock = threading.Lock()
        self._loss_count = 0
        self._loss_ewma = 0.0
        self._last_loss = float("nan")
        self._spikes = 0
        self._nonfinite = 0
        self._tripped = False
        self._armed_steps = 0
        self._scalars: Dict[str, float] = {}
        self._dq_ewma: Optional[float] = None
        self._td_counts = np.zeros(len(TD_ABS_EDGES) + 1, np.int64)
        self._td_sum = 0.0
        self._is_counts = np.zeros(len(IS_WEIGHT_EDGES) + 1, np.int64)
        self._is_sum = 0.0

    @property
    def tripped(self) -> bool:
        """True once a non-finite loss/grad was observed — the fabric
        must stop cleanly (drain-then-save) instead of training on
        through poisoned numerics."""
        return self._tripped

    # ------------------------------------------------------------ writes
    def note_losses(self, losses) -> None:
        """Absorb one harvest's losses (every dispatch — the host half
        of the NaN sentry plus the loss-spike EWMA)."""
        losses = np.asarray(losses, np.float64).ravel()
        factor = self.cfg.alert_loss_spike_factor
        fire_snap = None
        with self._lock:
            for v in losses:
                v = float(v)
                if not np.isfinite(v):
                    self._nonfinite += 1
                    if not self._tripped:
                        self._tripped = True
                        fire_snap = self._snapshot_locked()
                    continue
                self._last_loss = float(v)
                if (self._loss_count >= self.LOSS_WARMUP
                        and self._loss_ewma > 1e-12
                        and v > factor * self._loss_ewma):
                    self._spikes += 1
                self._loss_count += 1
                a = self.LOSS_EWMA_ALPHA
                self._loss_ewma = (v if self._loss_count == 1
                                   else a * v + (1 - a) * self._loss_ewma)
        self._maybe_fire(fire_snap)

    def absorb_diags(self, diags) -> None:
        """Absorb one harvest's diag vectors ((n, DIAG_SIZE) or flat);
        disarmed rows (armed == 0) are skipped."""
        rows = np.asarray(diags, np.float64).reshape(-1, DIAG_SIZE)
        fire_snap = None
        with self._lock:
            for r in rows:
                if r[_SCALAR_IDX["armed"]] < 0.5:
                    continue
                self._armed_steps += 1
                for name in _GAUGE_SCALARS:
                    self._scalars[name] = float(r[_SCALAR_IDX[name]])
                dq = float(r[_SCALAR_IDX["dq_mean"]])
                self._dq_ewma = (dq if self._dq_ewma is None
                                 else 0.1 * dq + 0.9 * self._dq_ewma)
                self._td_counts += r[_TD_LO:_TD_HI].astype(np.int64)
                self._td_sum += float(r[_SCALAR_IDX["td_abs_sum"]])
                self._is_counts += r[_IS_LO:_IS_HI].astype(np.int64)
                self._is_sum += float(r[_SCALAR_IDX["is_weight_sum"]])
                nonfin = r[_SCALAR_IDX["nonfinite"]]
                if nonfin > 0:
                    self._nonfinite += int(min(nonfin,
                                               self._NONFINITE_CAP))
                    if not self._tripped:
                        self._tripped = True
                        fire_snap = self._snapshot_locked()
        self._maybe_fire(fire_snap)

    def _maybe_fire(self, snap) -> None:
        # outside the lock: the engine takes its own lock + file I/O
        if snap is not None and self.engine is not None:
            self.engine.evaluate(dict(learnhealth=snap))

    # ------------------------------------------------------------- reads
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(
            enabled=self.enabled,
            armed_steps=self._armed_steps,
            nonfinite=self._nonfinite,
            loss_spikes=self._spikes,
            loss_count=self._loss_count,
            last_loss=self._last_loss,
            td_hist=[int(c) for c in self._td_counts],
            td_sum=self._td_sum,
            is_hist=[int(c) for c in self._is_counts],
            is_sum=self._is_sum,
        )
        if self._loss_count:
            out["loss_ewma"] = self._loss_ewma
        if self._dq_ewma is not None:
            out["dq_ewma"] = self._dq_ewma
        out.update(self._scalars)
        return out


# ---------------------------------------------------------------------------
# declarative alert engine
# ---------------------------------------------------------------------------

class AlertRule:
    """One declarative learning-health rule.

    ``name`` MUST be a string literal at the construction site and
    ``threshold`` must be a ``cfg``-derived value, never an inline magic
    number — both enforced by the ``telemetry-discipline`` graftlint
    rule.  ``check(rule, ctx)`` returns None (quiet) or a dict with
    ``value``/``detail``; delta rules keep their cursor on
    :attr:`last`, edge rules their level on :attr:`active`."""

    def __init__(self, name: str, check: Callable[["AlertRule", Dict],
                                                  Optional[Dict]],
                 threshold: Optional[float] = None):
        self.name = name
        self.check = check
        self.threshold = threshold
        self.active = False      # edge rules: currently in violation
        self.last = 0.0          # delta rules: last absorbed counter


def _replay_rows(ctx) -> List[Dict[str, Any]]:
    """Per-ring priority-health rows of the ctx's replay view: one row
    for the in-process buffer, one per shard for the sharded plane."""
    replay = ctx.get("replay") or {}
    if replay.get("shards") is not None:
        return [row for row in replay["shards"]]
    pr = replay.get("priorities")
    return [pr] if pr else []


def build_rules(cfg) -> List[AlertRule]:
    """The standing rule set, thresholds drawn from cfg: ``nonfinite``
    and ``loss_spike`` always armed (delta rules over the monitor's
    cumulative counters); ``dq_drift`` / ``ess_collapse`` /
    ``replay_ratio`` armed by their nonzero cfg thresholds (edge rules —
    they fire on the transition into violation, not every interval)."""
    rules: List[AlertRule] = []

    def nonfinite_check(rule, ctx):
        cur = (ctx.get("learnhealth") or {}).get("nonfinite", 0)
        rule.active = cur > 0
        if cur > rule.last:
            rule.last = cur
            return dict(value=cur,
                        detail="non-finite loss/grad elements observed")
        return None

    rules.append(AlertRule("nonfinite", check=nonfinite_check))

    def spike_check(rule, ctx):
        lh = ctx.get("learnhealth") or {}
        cur = lh.get("loss_spikes", 0)
        if cur > rule.last:
            rule.last = cur
            return dict(value=lh.get("last_loss"),
                        detail="loss above %.1fx its EWMA (%.5g)"
                               % (cfg.alert_loss_spike_factor,
                                  lh.get("loss_ewma", float("nan"))))
        return None

    rules.append(AlertRule("loss_spike", check=spike_check,
                           threshold=cfg.alert_loss_spike_factor))

    if cfg.alert_dq_budget > 0:
        def dq_check(rule, ctx):
            dq = (ctx.get("learnhealth") or {}).get("dq_mean")
            if dq is None:
                return None   # no armed diag in this ctx: keep the
                              # edge level latched, never reset it
            over = dq > cfg.alert_dq_budget
            fired = over and not rule.active
            rule.active = over
            if fired:
                return dict(value=dq,
                            detail="stored-vs-recomputed-state ΔQ above "
                                   "budget")
            return None

        rules.append(AlertRule("dq_drift", check=dq_check,
                               threshold=cfg.alert_dq_budget))

    if cfg.alert_ess_min > 0:
        def ess_check(rule, ctx):
            worst = None
            for row in _replay_rows(ctx):
                if row.get("positive_leaves", 0) < cfg.batch_size:
                    continue   # warmup: a near-empty ring is not collapse
                f = row.get("ess_frac")
                if f is not None and (worst is None or f < worst):
                    worst = f
            if worst is None:
                # no replay view in this ctx (partial evaluation — e.g.
                # the monitor's immediate nonfinite path, or a one-off
                # data_health failure): keep the edge level latched —
                # resetting it would re-fire a duplicate alert on the
                # next full evaluation with no actual transition
                return None
            over = worst < cfg.alert_ess_min
            fired = over and not rule.active
            rule.active = over
            if fired:
                return dict(value=worst,
                            detail="PER effective-sample-size fraction "
                                   "collapsed")
            return None

        rules.append(AlertRule("ess_collapse", check=ess_check,
                               threshold=cfg.alert_ess_min))

    if cfg.alert_replay_ratio_max > 0:
        def ratio_check(rule, ctx):
            replay = ctx.get("replay") or {}
            ratio = replay.get("replay_ratio")
            if not ratio or not ctx.get("training_steps"):
                return None    # nothing trained yet: no band to be in
            over = (ratio > cfg.alert_replay_ratio_max
                    or ratio < cfg.alert_replay_ratio_min)
            fired = over and not rule.active
            rule.active = over
            if fired:
                return dict(value=ratio,
                            detail="replay ratio out of the configured "
                                   "band")
            return None

        rules.append(AlertRule("replay_ratio", check=ratio_check,
                               threshold=cfg.alert_replay_ratio_max))
    return rules


class AlertEngine:
    """Evaluates the declarative rule set each log interval (plus the
    monitor's immediate non-finite path) and owns the three alert
    surfaces: ``learnhealth.alert{rule}`` counters, the durable
    ``alerts.jsonl`` row stream, and the ``/alertz`` status payload."""

    def __init__(self, cfg, registry, log_dir: Optional[str] = None):
        self.cfg = cfg
        self.registry = registry
        self.rules = build_rules(cfg)
        self._lock = threading.RLock()
        self._counts: Dict[str, int] = {}
        self._recent: collections.deque = collections.deque(maxlen=64)
        self._log: Optional[RunLog] = None
        if log_dir:
            self._log = RunLog(log_dir, filename="alerts.jsonl",
                               max_bytes=max(1024,
                                             cfg.telemetry_log_max_bytes))

    @property
    def nonfinite_active(self) -> bool:
        """The one rule that degrades /healthz: non-finite numerics mean
        the checkpoint stream is suspect and an operator must look."""
        with self._lock:
            return self._counts.get("nonfinite", 0) > 0

    # ------------------------------------------------------------ engine
    def evaluate(self, ctx: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Run every rule over one context snapshot; returns the fired
        rows (already counted, logged and registry-stamped)."""
        fired: List[Dict[str, Any]] = []
        with self._lock:
            for rule in self.rules:
                try:
                    res = rule.check(rule, ctx)
                except Exception:   # a rule must never kill the log loop
                    continue
                if not res:
                    continue
                fired.append(self._emit(rule.name, rule.threshold, res,
                                        ctx.get("training_steps")))
        return fired

    def fire(self, name: str, value: Optional[float] = None,
             threshold: Optional[float] = None, detail: str = "") -> None:
        """Manual fire path (drills/tests); ``name`` must be a string
        literal at the call site (graftlint telemetry-discipline)."""
        with self._lock:
            self._emit(name, threshold, dict(value=value, detail=detail),
                       None)

    def _emit(self, name, threshold, res, step) -> Dict[str, Any]:
        row = dict(kind="alert", rule=name, time=time.time(), step=step,
                   value=res.get("value"), threshold=threshold,
                   detail=res.get("detail", ""))
        self._counts[name] = self._counts.get(name, 0) + 1
        self._recent.append(row)
        # the rule name is bounded vocabulary, so it travels as a label
        self.registry.inc("learnhealth.alert", rule=name)
        if self._log is not None:
            self._log.append(row)
        return row

    # ------------------------------------------------------------- reads
    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def active(self) -> List[str]:
        with self._lock:
            return [r.name for r in self.rules if r.active]

    def status(self) -> Dict[str, Any]:
        """The ``/alertz`` payload: armed rules + thresholds, cumulative
        counts, currently-active edge rules, newest rows."""
        with self._lock:
            return dict(
                rules=[dict(rule=r.name, threshold=r.threshold,
                            active=r.active,
                            fired=self._counts.get(r.name, 0))
                       for r in self.rules],
                counts=dict(self._counts),
                active=[r.name for r in self.rules if r.active],
                recent=list(self._recent),
            )

    def route(self, params: Dict[str, str]):
        """Exporter trigger-route adapter (``GET /alertz``)."""
        return 200, self.status()

    def close(self) -> None:
        if self._log is not None:
            self._log.close()


def read_alerts(checkpoint_dir: str):
    """Stream the durable alert rows of a run (oldest first, rotated
    segments included, torn tail skipped) — tooling/tests twin of the
    engine's writer."""
    import os

    from r2d2_tpu_torch.telemetry.runlog import read_entries

    path = os.path.join(checkpoint_dir, "telemetry", "alerts.jsonl")
    return [e for e in read_entries(path) if e.get("kind") == "alert"]
