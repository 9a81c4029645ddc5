"""The standing evaluation service: a checkpoint-following eval sidecar.

Port of ``r2d2_tpu/league/eval_service.py``.  Training never stops to
measure itself: a *sidecar* process follows the run's checkpoints and
scores every population member on each.  Two halves:

- :func:`_sidecar_main` — the subprocess body.  Pinned to the CPU (it
  never touches the trainer's card: it hides every CUDA device before
  anything can open a context, and raises if one is already there), it
  polls the run's ``Checkpointer`` for complete steps (the meta sidecar
  commits last, and ``Learner._save`` never rewrites a complete step, so
  a live saver never changes a step under this reader), restores each new
  ``step_N/state.pt`` once, and runs batched lockstep rollouts per member
  on that member's held-out suite (``league/scenarios.py``) through the
  plain recurrence on the CPU (``make_host_act_fn`` over the fleets' f32
  twin).  Every (checkpoint, member) score appends one JSON line to
  ``<ckpt_dir>/telemetry/league.jsonl`` (the run log's conventions:
  append on resume, torn-line-tolerant readers, size-capped rotation).
  A respawned sidecar reads that file first and resumes the cursor where
  its predecessor stopped: no duplicate rows, no skipped members.  Each
  sweep (one checkpoint, every member) is bounded by
  ``cfg.league_eval_deadline``: a slow suite yields and the remaining
  members resume next poll.
- :class:`EvalSidecar` — the trainer-side supervisor: spawn, the
  ``eval_watch`` fabric loop that respawns a dead sidecar up to its
  restart budget, the league table for ``/statusz`` and the ``league.*``
  metrics.  An exhausted budget marks the sidecar ``failed``, which
  **degrades** ``/healthz`` (HTTP 200) and nothing else: evaluation never
  stops training.

The JAX package pins its sidecar to the CPU backend the same way; it is
the one part of the port's training path that acts on the CPU by design.
"""
from __future__ import annotations

import logging
import multiprocessing as mp
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.telemetry.registry import MetricsRegistry

log = logging.getLogger(__name__)

LEAGUE_FILENAME = "league.jsonl"
# HOST_TRANSFERS name of the sidecar's acts (on the CPU: a copy, counted
# like every act)
LEAGUE_ACT = "league.act_fetch"


def league_path(checkpoint_dir: str) -> str:
    return os.path.join(checkpoint_dir, "telemetry", LEAGUE_FILENAME)


def read_league(checkpoint_dir: str) -> List[Dict[str, Any]]:
    """Every league row on disk, oldest first, across rotated segments;
    a torn final line (a sidecar killed mid-append) is skipped."""
    from r2d2_tpu_torch.telemetry.runlog import read_entries

    return list(read_entries(league_path(checkpoint_dir)))


def league_table(entries: List[Dict[str, Any]],
                 num_members: Optional[int] = None) -> Dict[str, Any]:
    """League rows → the standings an operator reads.

    Returns ``table`` (one row per member — latest and best scores,
    ranked best first), ``sweeps`` (checkpoints every member has been
    scored on), ``last_step`` and ``rows``.  ``num_members`` pins the
    sweep-completeness denominator (a member that has not scored yet holds
    sweeps at 0); by default, the members seen in the rows."""
    per: Dict[int, Dict[str, Any]] = {}
    covered: Dict[int, set] = {}
    total = 0
    for e in entries:
        if e.get("kind") != "eval":
            continue
        total += 1
        m = int(e["member"])
        r = per.get(m)
        if r is None:
            r = per[m] = dict(member=m, name=e.get("member_name", ""),
                              game=e.get("game", ""), evals=0,
                              last_step=-1, last_reward=0.0,
                              best_step=-1, best_reward=None)
        r["evals"] += 1
        step, reward = int(e["step"]), float(e["mean_reward"])
        if step >= r["last_step"]:
            r["last_step"], r["last_reward"] = step, reward
        if r["best_reward"] is None or reward > r["best_reward"]:
            r["best_step"], r["best_reward"] = step, reward
        covered.setdefault(step, set()).add(m)
    n = num_members if num_members is not None else len(per)
    sweeps = (sum(1 for ms in covered.values() if len(ms) >= n)
              if n else 0)
    table = sorted(per.values(),
                   key=lambda r: (-(r["best_reward"]
                                    if r["best_reward"] is not None
                                    else float("-inf")), r["member"]))
    return dict(table=table, sweeps=sweeps, rows=total,
                last_step=max(covered) if covered else -1)


# --------------------------------------------------------------------------
# the sidecar subprocess
# --------------------------------------------------------------------------

def card_handles(pid: str = "self") -> List[str]:
    """The NVIDIA device files (``/dev/nvidia*``) a process has open or
    mapped, read from ``/proc``: a CUDA context opens and maps them, and
    nothing else in this program does.  (The driver *library* is no sign:
    a CUDA build of torch maps ``libcuda`` on import, through
    ``libcaffe2_nvrtc.so``.)  Empty where ``/proc`` is missing."""
    out = set()
    try:
        with open(f"/proc/{pid}/maps") as f:
            out.update(line.split()[-1] for line in f
                       if "/dev/nvidia" in line)
        fd_dir = f"/proc/{pid}/fd"
        for fd in os.listdir(fd_dir):
            try:
                target = os.readlink(os.path.join(fd_dir, fd))
            except OSError:
                continue
            if target.startswith("/dev/nvidia"):
                out.add(target)
    except OSError:
        pass
    return sorted(out)


def _pin_to_cpu() -> None:
    """Hide every CUDA device from this process before anything can open a
    context (torch initialises CUDA lazily, at its first CUDA call), and
    refuse to run if a context is already here: ``torch.cuda.
    is_initialized``, or an NVIDIA device file open or mapped."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import torch

    # one intra-op thread: the sidecar shares the host with the trainer
    # and the fleets, and its batches are a few lanes
    torch.set_num_threads(1)
    held = card_handles()
    if torch.cuda.is_initialized() or held:
        raise RuntimeError(
            "eval sidecar: a CUDA context exists in this process before "
            f"the CPU pin ({held}); the sidecar must never touch the "
            "trainer's card")


def _sidecar_main(cfg: Config, checkpoint_dir: str, action_dim: int,
                  stop_event, incarnation: int = 0,
                  run_once: bool = False) -> None:
    """Sidecar body (module-level: spawn-picklable).  ``run_once=True``
    drains every pending (checkpoint, member) pair and returns, in the
    calling process and without the CPU pin — the mode the tests (and
    cursor-resume drills) drive."""
    if not run_once:
        _pin_to_cpu()

    from r2d2_tpu_torch.actor import make_host_act_fn
    from r2d2_tpu_torch.checkpoint import Checkpointer, check_arch_compat
    from r2d2_tpu_torch.evaluate import run_episodes
    from r2d2_tpu_torch.league.population import build_members
    from r2d2_tpu_torch.league.scenarios import (
        HELD_OUT_SEED_BASE,
        close_suite,
        member_suite,
    )
    from r2d2_tpu_torch.models.network import create_network
    from r2d2_tpu_torch.parallel.actor_procs import fleet_act_config
    from r2d2_tpu_torch.telemetry.runlog import RunLog, read_entries
    from r2d2_tpu_torch.utils.resilience import Deadline

    ckpt = Checkpointer(checkpoint_dir)
    members = build_members(cfg)
    # one CPU act twin for every member (the arch fields are population-
    # invariant): float32, the plain recurrence, the fleets' twin
    net = create_network(fleet_act_config(cfg), action_dim, device="cpu")
    act_fn = make_host_act_fn(net, LEAGUE_ACT)
    path = league_path(checkpoint_dir)
    # the checkpoint cursor IS the league file: a respawn re-reads it and
    # never re-scores a (step, member) pair its predecessor committed
    scored = {(int(e["step"]), int(e["member"]))
              for e in read_entries(path) if e.get("kind") == "eval"}
    skipped: set = set()   # arch-incompatible steps, never retried
    restore_failures: Dict[int, int] = {}   # transient-vs-doomed steps
    lg = RunLog(os.path.dirname(path), filename=LEAGUE_FILENAME,
                max_bytes=cfg.telemetry_log_max_bytes)

    def pending() -> Dict[int, List[Any]]:
        by_step: Dict[int, List[Any]] = {}
        for step in ckpt.steps():      # complete steps only (meta-gated)
            if step in skipped:
                continue
            todo = [m for m in members
                    if (step, m.member_id) not in scored]
            if todo:
                by_step[step] = todo
        return by_step

    try:
        while not stop_event.is_set():
            by_step = pending()
            for step in sorted(by_step):
                if stop_event.is_set():
                    break
                # per-sweep budget: a slow suite yields and the remaining
                # members resume next poll (run_once: unbounded)
                deadline = Deadline(0.0 if run_once
                                    else cfg.league_eval_deadline)
                meta = ckpt.peek_meta(step)
                try:
                    check_arch_compat(cfg, meta)
                except ValueError as e:
                    log.warning("league: step %d skipped (%s)", step, e)
                    skipped.add(step)
                    continue
                try:
                    state, _ = ckpt.restore(step)
                except Exception as e:
                    # retention GC'd under us is a transient race (the step
                    # drops out of steps() next poll); a persistently torn
                    # payload under a committed sidecar is not, and would
                    # re-restore at poll speed forever: three strikes,
                    # then the step is skipped like an arch mismatch
                    n = restore_failures[step] = (
                        restore_failures.get(step, 0) + 1)
                    log.warning("league: step %d restore failed "
                                "(attempt %d/3: %s)", step, n, e)
                    if run_once or n >= 3:
                        skipped.add(step)
                    continue
                params = state.params
                for m in by_step[step]:
                    if stop_event.is_set() or deadline.expired:
                        break
                    envs = member_suite(m.cfg, m.member_id,
                                        cfg.league_eval_episodes,
                                        action_dim)
                    # exploration stream deterministic per (step, member),
                    # so a respawned sidecar re-running an uncommitted
                    # eval reproduces it exactly
                    rng = np.random.default_rng(
                        [HELD_OUT_SEED_BASE, m.member_id, step])
                    try:
                        returns = run_episodes(
                            m.cfg, net, params, envs,
                            epsilon=m.cfg.test_epsilon, rng=rng,
                            act_fn=act_fn)
                    finally:
                        close_suite(envs)
                    lg.append(dict(
                        kind="eval", time=time.time(), step=int(step),
                        member=m.member_id, member_name=m.name,
                        game=m.cfg.game_name, episodes=len(returns),
                        mean_reward=float(np.mean(returns)),
                        env_frames=(int(meta.get("env_steps", 0))
                                    * cfg.frameskip),
                        minutes=float(meta.get("minutes", 0.0)),
                        incarnation=int(incarnation)))
                    scored.add((step, m.member_id))
            if run_once:
                if not pending():
                    return
                continue
            stop_event.wait(cfg.league_eval_interval)
    finally:
        lg.close()


# --------------------------------------------------------------------------
# trainer-side supervision
# --------------------------------------------------------------------------

class EvalSidecar:
    """Spawns and supervises the eval sidecar subprocess.

    :meth:`start` spawns; :meth:`make_loops` returns the supervised
    ``eval_watch`` loop (respawn with the cursor resumed, up to
    ``max_restarts``; an exhausted budget sets :attr:`failed`, which
    degrades /healthz and touches nothing else); :meth:`shutdown` stops
    the child.  :meth:`status` is the league table the log loop puts in
    its entries (→ /statusz, the run log) and the telemetry plane absorbs
    as ``league.*`` metrics."""

    def __init__(self, cfg: Config, checkpoint_dir: str, action_dim: int,
                 registry: Optional[MetricsRegistry] = None,
                 max_restarts: int = 3):
        from r2d2_tpu_torch.league.population import build_members

        self.cfg = cfg
        self.checkpoint_dir = checkpoint_dir
        self.action_dim = action_dim
        self.registry = registry if registry is not None else (
            MetricsRegistry())
        self.max_restarts = max_restarts
        self.num_members = len(build_members(cfg))
        self.ctx = mp.get_context("spawn")
        self.proc: Optional[mp.Process] = None
        self._child_stop = None   # the live child's private poll event
        self.restarts = 0
        self.failed = False
        self._stopping = False
        self._table_ts = 0.0
        self._table: Dict[str, Any] = league_table([], self.num_members)

    # ------------------------------------------------------------ lifecycle
    def _spawn(self) -> None:
        # the stop event is SPAWN-PRIVATE and the trainer never calls
        # set()/wait()/is_set() on it: a SIGKILLed child (the
        # kill_eval_sidecar drill) can die holding the event's internal
        # lock, and any trainer-side operation on it could then hang the
        # teardown.  Stop is SIGTERM (shutdown()); the event only gives the
        # child its poll sleep, each incarnation gets a fresh one, and the
        # trainer merely holds the reference so the semaphore outlives
        # the child's attach.  (A SIGTERM mid-append at worst tears
        # league.jsonl's final line: readers skip it, and the eval re-runs
        # on the next spawn, deterministically.)
        self._child_stop = self.ctx.Event()
        self.proc = self.ctx.Process(
            target=_sidecar_main, name="eval_sidecar",
            args=(self.cfg, self.checkpoint_dir, self.action_dim,
                  self._child_stop, self.restarts),
            daemon=True)
        self.proc.start()

    def start(self) -> None:
        self._spawn()

    def watch_once(self) -> int:
        """Respawn a dead sidecar (the cursor resumes from league.jsonl).
        Returns the restarts performed.  An exhausted budget sets
        :attr:`failed` and does not raise: a dead evaluator degrades
        /healthz, never stops the fabric."""
        if self._stopping or self.failed:
            return 0
        p = self.proc
        if p is None or p.is_alive():
            return 0
        if self.restarts >= self.max_restarts:
            self.failed = True
            log.error(
                "eval sidecar died (exitcode %s) with its restart budget "
                "(%d) exhausted — league evaluation STOPS; training "
                "continues, /healthz degrades", p.exitcode,
                self.max_restarts)
            return 0
        self.restarts += 1
        self.registry.inc("league.sidecar_respawns")
        log.warning(
            "eval sidecar died (exitcode %s) — respawn %d/%d; the "
            "checkpoint cursor resumes from league.jsonl", p.exitcode,
            self.restarts, self.max_restarts)
        self._spawn()
        return 1

    def make_loops(self, stop):
        """The supervised watchdog loop for ``train()``'s fabric."""

        def eval_watch():
            while not stop():
                self.watch_once()
                time.sleep(0.25)

        return [("eval_watch", eval_watch)]

    def shutdown(self, timeout: float = 5.0) -> None:
        """SIGTERM → join → SIGKILL, with no shared stop flag toward the
        child (see :meth:`_spawn`): nothing here can block on a lock a
        killed child may have corrupted."""
        self._stopping = True
        p = self.proc
        if p is not None:
            if p.is_alive():
                p.terminate()
            p.join(timeout)
            if p.is_alive():
                p.kill()
                p.join(2.0)

    # ---------------------------------------------------------------- state
    def health(self) -> Dict[str, Any]:
        alive = self.proc is not None and self.proc.is_alive()
        return dict(alive=alive, restarts=self.restarts,
                    failed=self.failed,
                    # dead now (before a respawn) or failed for good:
                    # either way the run is blind to policy quality —
                    # degraded, not failing
                    degraded=self.failed or not alive)

    def status(self, max_age: float = 1.0) -> Dict[str, Any]:
        """League standings + sidecar health (the log entry's and
        /statusz's payload).  The table re-reads league.jsonl at most once
        per ``max_age`` seconds: rows arrive at checkpoint cadence, not
        scrape cadence."""
        now = time.monotonic()
        if now - self._table_ts > max_age:
            self._table_ts = now
            try:
                self._table = league_table(
                    read_league(self.checkpoint_dir), self.num_members)
            except OSError:
                pass   # keep the previous standings on a racing rotate
        return dict(self._table, health=self.health(),
                    members=self.num_members)
