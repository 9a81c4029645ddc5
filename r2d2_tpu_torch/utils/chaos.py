"""Deterministic fault injection for the training fabric.

Port of ``r2d2_tpu/utils/chaos.py``, copied whole: the same spec grammar,
the same kinds in the same order, so one spec and seed fire the same
opportunities in either package.  Every plane the sites live in is
ported, so the port's ``train()`` takes every kind and refuses none.


Podracer-style systems treat preemption as routine; the only way the
recovery paths stay honest is to force the failures on purpose.  A
:class:`ChaosInjector` is built from ``cfg.chaos_spec`` (empty string =
disabled, the production default) and wired through ``train()`` so every
recovery path the fabric claims to have can be exercised under load:

- ``kill_fleet``    — SIGKILL a random live fleet subprocess (the process
                      watchdog must respawn it on its lane shard).
- ``garble_block``  — flip bytes inside a random shm block slot (the CRC32
                      integrity word must catch it; the trainer drops the
                      block and bumps ``ReplayBuffer.stats()['corrupt_blocks']``).
- ``truncate_ckpt`` — abort a checkpoint save mid-write (payload truncated
                      / replay meta never committed; restore must skip the
                      partial step).
- ``freeze_learner``— sleep inside the learner's stop-poll for ``dur``
                      seconds (the heartbeat watchdog must detect the
                      stall and stop the fabric).
- ``freeze_service``— sleep inside the serve-plane's ``inference_serve``
                      fabric loop for ``dur`` seconds: every serve-mode
                      fleet's act RPCs start timing out, their circuit
                      breakers must open and the fleets must degrade to
                      local inference (utils/resilience.py), then
                      re-attach after the thaw — zero fleet deaths.
- ``drop_act_response``   — the service serves a batch but never posts
                      one fleet's response token (simulates a lost
                      wakeup); the fleet's bounded retry must re-request
                      and be answered, never wedging the lockstep fleet.
- ``garble_act_response`` — flip bytes inside one fleet's response
                      region AFTER its CRC32 was written; the fleet must
                      detect the mismatch and retry (bounded).
- ``stall_pump``    — sleep inside the param-pump fabric loop for
                      ``dur`` seconds: fleets keep training on frozen
                      weights, which the staleness watchdog must surface
                      as ``fleet.stale_params_s`` / a degraded health
                      verdict instead of silence.
- ``wedge_dispatch``— (anakin transport) stall the fused-loop harvest
                      for ``dur`` seconds, simulating a wedged device
                      dispatch; the bounded dispatch deadline
                      (``cfg.dispatch_deadline``) must snapshot-then-
                      abort instead of training on through a flaky
                      device or hanging forever.
- ``kill_replay_shard``   — (sharded replay, ``cfg.replay_shards`` > 1)
                      SIGKILL a random live replay shard owner process;
                      the ``replay_watch`` loop must respawn it on its
                      slot slice and restore it from the latest replay
                      snapshot (degraded: cold, its slots re-ingest
                      fresh) — the learner keeps sampling from the
                      surviving shards throughout.
- ``garble_sample_response`` — flip bytes in a shard's preassembled
                      sample-batch response after its CRC32 landed; the
                      trainer-side verification must catch it and the
                      bounded retry must re-request (never a torn batch
                      into the learner).
- ``stall_shard``   — SIGSTOP a random replay shard for ``dur`` seconds
                      (then SIGCONT): the sample RPC deadline
                      (``cfg.replay_sample_timeout``) must fire and the
                      stalled shard's rows redistribute over the healthy
                      shards' mass — zero learner stalls.
- ``kill_session_client`` — (session tier, tools/session_load_gen.py)
                      a load-gen worker drops its connection abruptly,
                      abandoning every session it owned mid-episode;
                      the SessionServer must reap them on the
                      disconnect (``serving.reaped``) — hidden-state
                      slots never leak, and the tier's health stays
                      ``ok``/``degraded``.
- ``slow_session_client`` — (session tier) one load-gen session
                      freezes for ``dur`` seconds mid-episode — a
                      straggler.  Continuous batching must keep serving
                      everyone else (the batch is whatever is pending,
                      never a lockstep window a straggler can hold
                      hostage); the session either resumes or idle-
                      reaps.
- ``poison_params`` — overwrite one learner param leaf with NaN on the
                      learner thread (the learnhealth NaN-sentry drill,
                      telemetry/learnhealth.py): the in-graph sentry /
                      host loss check must fire the ``nonfinite`` alert,
                      degrade /healthz and stop the fabric CLEANLY
                      (drain-then-save) instead of crashing the learner
                      or training on through poisoned numerics.
- ``kill_eval_sidecar`` — (league plane, ``cfg.league_eval``) SIGKILL
                      the standing eval sidecar mid-sweep; the
                      ``eval_watch`` loop must respawn it with its
                      checkpoint cursor resumed from league.jsonl (no
                      duplicate rows, no skipped members), training
                      throughput untouched; an exhausted respawn budget
                      degrades /healthz, never the fabric.
- ``partition_shard_link`` — (socket replay, ``replay_transport=
                      "socket"``) blackhole one shard link in BOTH
                      directions for ``dur`` seconds, the socket left
                      standing — a real partition.  The shard's gossip
                      goes stale and its RPCs time out; its mass must
                      leave the view, its strata redistribute over the
                      reachable shards (zero learner stalls), blocks
                      routed to it drop-with-count, and at the heal the
                      link must re-attach with no stale response or
                      feedback ever applied (epoch/seq guards).
- ``delay_shard_link``    — (socket replay) one rtt spike: the link's
                      receiver sleeps ``dur`` before its next dispatch.
                      Below the RPC deadline it must only show up in
                      the replay.net.rtt_s histogram; above it, it must
                      behave exactly like a partition (bounded,
                      redistributed, healed).
- ``half_open_shard``     — (socket replay) the classic half-open peer:
                      for ``dur`` seconds the trainer's sends are
                      silently lost while receives still work.  Sample
                      requests vanish → the deadline fires and rows
                      redistribute; the circuit opens after repeated
                      losses and the probe re-closes it at the heal —
                      never a wedge, never a torn frame.
- ``garble_net_frame``    — (socket replay) flip bytes in a received
                      frame before decode; the frame CRC must catch
                      every one (dropped + counted in
                      replay.net.garbled) and a garbled sample response
                      must be re-requested by the bounded retry — torn
                      frames never reach the ring or the learner.

Spec grammar — semicolon-separated ``kind[:key=val[,key=val...]]``::

    kill_fleet:every=500;garble_block:p=0.01;freeze_learner:at=40,dur=3

Per-kind firing controls (an *opportunity* is one call site visit):

- ``p=<float>``   fire with probability p per opportunity (seeded draw)
- ``every=<int>`` fire on every Nth opportunity
- ``at=<int>``    fire exactly once, on the Nth opportunity
- ``n=<int>``     cap total fires (default: 1 for ``at``, unlimited else)
- ``dur=<float>`` freeze/stall duration in seconds (``freeze_learner``,
                  ``freeze_service``, ``stall_pump``, ``wedge_dispatch``)

Everything is deterministic given (spec, seed): each kind gets its own
counter and a PCG64 stream seeded from (seed, kind), so a chaos soak is
replayable.
"""
from __future__ import annotations

import logging
import math
import threading
import time
from typing import Any, Dict, Optional

import numpy as np

log = logging.getLogger(__name__)

# order matters: each kind's RNG stream is seeded from (seed, index), so
# append new kinds at the END to keep existing soak replays stable
_KINDS = ("kill_fleet", "garble_block", "truncate_ckpt", "freeze_learner",
          "freeze_service", "drop_act_response", "garble_act_response",
          "stall_pump", "wedge_dispatch", "kill_replay_shard",
          "garble_sample_response", "stall_shard", "kill_session_client",
          "slow_session_client", "kill_eval_sidecar", "poison_params",
          "partition_shard_link", "delay_shard_link", "half_open_shard",
          "garble_net_frame")


def parse_spec(spec: str) -> Dict[str, Dict[str, float]]:
    """``chaos_spec`` string → {kind: params}.  Raises ValueError on an
    unknown kind or a malformed clause (Config validation calls this so a
    typo fails at construction, not mid-run)."""
    out: Dict[str, Dict[str, float]] = {}
    for clause in filter(None, (c.strip() for c in spec.split(";"))):
        kind, _, raw = clause.partition(":")
        kind = kind.strip()
        if kind not in _KINDS:
            raise ValueError(
                f"unknown chaos kind {kind!r} (expected one of {_KINDS})")
        params: Dict[str, float] = {}
        for kv in filter(None, (p.strip() for p in raw.split(","))):
            key, _, val = kv.partition("=")
            if key not in ("p", "every", "at", "n", "dur"):
                raise ValueError(f"unknown chaos param {key!r} in {clause!r}")
            params[key] = float(val)
        if not any(k in params for k in ("p", "every", "at")):
            raise ValueError(
                f"chaos clause {clause!r} needs a trigger (p=/every=/at=)")
        out[kind] = params
    return out


class ChaosInjector:
    """Seeded, counter-deterministic fault firing (see module docstring).
    Thread-safe: call sites live on different fabric threads."""

    def __init__(self, spec: str, seed: int = 0):
        self.kinds = parse_spec(spec)
        self._lock = threading.Lock()
        self._opportunities = {k: 0 for k in self.kinds}
        self._fires = {k: 0 for k in self.kinds}
        self._rngs = {
            k: np.random.default_rng([seed, i])
            for i, k in enumerate(_KINDS) if k in self.kinds
        }

    def __bool__(self) -> bool:
        return bool(self.kinds)

    def enabled(self, kind: str) -> bool:
        return kind in self.kinds

    def fire(self, kind: str) -> Optional[Dict[str, float]]:
        """One opportunity for ``kind``: returns the clause params when the
        fault fires, else None."""
        prm = self.kinds.get(kind)
        if prm is None:
            return None
        with self._lock:
            self._opportunities[kind] += 1
            opp = self._opportunities[kind]
            cap = prm.get("n", 1.0 if "at" in prm else math.inf)
            if self._fires[kind] >= cap:
                return None
            if "at" in prm:
                hit = opp == int(prm["at"])
            elif "every" in prm:
                hit = opp % max(1, int(prm["every"])) == 0
            else:
                hit = float(self._rngs[kind].random()) < prm["p"]
            if not hit:
                return None
            self._fires[kind] += 1
        log.warning("chaos: firing %s (opportunity %d)", kind, opp)
        return prm

    def counts(self) -> Dict[str, int]:
        """Fires per kind so far — surfaced in train() metrics/logs."""
        with self._lock:
            return dict(self._fires)

    # ---------------------------------------------------------- call sites
    def maybe_kill_fleet(self, plane: Any) -> Optional[int]:
        """SIGKILL a random live fleet process of a ProcessFleetPlane.
        Returns the killed fleet id, or None."""
        if self.fire("kill_fleet") is None:
            return None
        live = [f for f, p in enumerate(plane.procs)
                if p is not None and p.is_alive()]
        if not live:
            return None
        f = int(live[self._rngs["kill_fleet"].integers(len(live))])
        log.warning("chaos: SIGKILL fleet%d (pid %s)", f, plane.procs[f].pid)
        plane.procs[f].kill()
        return f

    def maybe_garble_block(self, plane: Any) -> Optional[int]:
        """Flip 64 bytes at a random offset inside a random slot of a
        random fleet's shm slab.  An in-flight block whose CRC was already
        written shows up as a mismatch at ingest (dropped + counted); a
        free slot is harmlessly overwritten by the next producer write.
        Returns the garbled fleet id, or None."""
        if self.fire("garble_block") is None:
            return None
        rng = self._rngs["garble_block"]
        # capture (fleet, channel) together: the fleet watchdog may retire
        # a channel concurrently, and .index() on a retired object would
        # crash the chaos loop mid-drill
        chans = [(f, c) for f, c in enumerate(plane.channels)
                 if c is not None]
        if not chans:
            return None
        f, ch = chans[int(rng.integers(len(chans)))]
        slot = int(rng.integers(ch.num_slots))
        lo = slot * ch.slot_nbytes + int(rng.integers(
            max(1, ch.slot_nbytes - 64)))
        try:
            buf = np.frombuffer(ch.shm.buf, np.uint8)
            buf[lo:lo + 64] ^= 0xFF
        except (ValueError, TypeError):  # channel closed under us
            return None
        return f

    def learner_freeze_seconds(self) -> float:
        """Seconds the learner's stop-poll should sleep this iteration
        (0.0 = no freeze injected)."""
        prm = self.fire("freeze_learner")
        return float(prm.get("dur", 2.0)) if prm else 0.0

    def service_freeze_seconds(self) -> float:
        """Seconds the ``inference_serve`` fabric loop should sleep (0.0
        = no freeze) — the serve-plane failover drill: the fleets' act
        RPCs must time out, open their circuits and degrade to local
        inference until the thaw.  One opportunity per SERVED batch (not
        per idle poll), so ``at=N`` lands the freeze under real traffic
        rather than during spawn/warm-up."""
        prm = self.fire("freeze_service")
        return float(prm.get("dur", 2.0)) if prm else 0.0

    def pump_stall_seconds(self) -> float:
        """Seconds the param-pump fabric loop should sleep this iteration
        (0.0 = no stall) — the staleness-watchdog drill."""
        prm = self.fire("stall_pump")
        return float(prm.get("dur", 2.0)) if prm else 0.0

    def dispatch_wedge_seconds(self) -> float:
        """Seconds the anakin harvest should stall this dispatch (0.0 =
        no wedge) — the bounded dispatch-deadline drill."""
        prm = self.fire("wedge_dispatch")
        return float(prm.get("dur", 2.0)) if prm else 0.0

    def maybe_kill_replay_shard(self, plane: Any) -> Optional[int]:
        """SIGKILL a random live shard of a ShardedReplayPlane — the
        respawn-with-restore drill.  Returns the killed shard id, or
        None."""
        if self.fire("kill_replay_shard") is None:
            return None
        live = [s for s, p in enumerate(plane.procs)
                if p is not None and p.is_alive()]
        if not live:
            return None
        s = int(live[self._rngs["kill_replay_shard"].integers(len(live))])
        log.warning("chaos: SIGKILL replay shard%d (pid %s)", s,
                    plane.procs[s].pid)
        plane.procs[s].kill()
        return s

    def garble_sample_response(self) -> bool:
        """One opportunity per received sample-RPC response (the sharded
        replay plane's receipt path): True = flip response bytes AFTER
        the shard's CRC landed — trainer-side verification must catch it
        and the bounded retry must re-request."""
        return self.fire("garble_sample_response") is not None

    def maybe_stall_shard(self, plane: Any) -> Optional[int]:
        """SIGSTOP a random live replay shard for ``dur`` seconds, then
        SIGCONT — the sample-RPC-deadline drill (the caller's thread
        sleeps through the stall; the shard itself is frozen).  Returns
        the stalled shard id, or None."""
        import os
        import signal as _signal

        prm = self.fire("stall_shard")
        if prm is None:
            return None
        live = [s for s, p in enumerate(plane.procs)
                if p is not None and p.is_alive()]
        if not live:
            return None
        s = int(live[self._rngs["stall_shard"].integers(len(live))])
        p = plane.procs[s]
        dur = float(prm.get("dur", 2.0))
        log.warning("chaos: SIGSTOP replay shard%d for %.1fs", s, dur)
        try:
            os.kill(p.pid, _signal.SIGSTOP)
            time.sleep(dur)
        finally:
            try:
                os.kill(p.pid, _signal.SIGCONT)
            except (ProcessLookupError, OSError):
                pass   # died while stopped: the watchdog takes over
        return s

    def maybe_kill_eval_sidecar(self, sidecar: Any) -> bool:
        """SIGKILL the league eval sidecar subprocess mid-sweep — the
        cursor-resume drill: the ``eval_watch`` respawn must continue
        the checkpoint cursor from league.jsonl with no duplicate rows,
        and training throughput must be unaffected.  Returns True when
        the kill landed."""
        if self.fire("kill_eval_sidecar") is None:
            return False
        p = getattr(sidecar, "proc", None)
        if p is None or not p.is_alive():
            return False
        log.warning("chaos: SIGKILL eval sidecar (pid %s)", p.pid)
        p.kill()
        return True

    def poison_params_now(self) -> bool:
        """One opportunity per learner stop-poll: True = the trainer
        must overwrite one param leaf with NaN (``Learner.poison_params``
        — runs on the learner thread, so the donated state handle cannot
        race a dispatch).  The learnhealth plane must then fire the
        ``nonfinite`` alert and stop the fabric cleanly."""
        return self.fire("poison_params") is not None

    def session_client_kill(self) -> bool:
        """One opportunity per load-gen client step burst: True = the
        worker must DROP its connection without closing its sessions
        (mid-episode abandon) — the SessionServer's disconnect reap must
        free every owned hidden slot (tools/session_load_gen.py)."""
        return self.fire("kill_session_client") is not None

    def session_client_slow_seconds(self) -> float:
        """Seconds one load-gen session should freeze mid-episode (0.0 =
        no straggler injected) — the continuous batch must keep serving
        the other sessions at full rate meanwhile."""
        prm = self.fire("slow_session_client")
        return float(prm.get("dur", 2.0)) if prm else 0.0

    def net_partition_seconds(self) -> float:
        """Seconds one replay shard link should be blackholed in both
        directions (0.0 = no partition).  One opportunity per sample
        request issued to a shard (traffic-aligned — ``at=``/``every=``
        land under real sampling load); the fired link is the one the
        request was headed for (parallel/replay_net.py)."""
        prm = self.fire("partition_shard_link")
        return float(prm.get("dur", 2.0)) if prm else 0.0

    def net_delay_seconds(self) -> float:
        """Seconds the link's receiver should sleep before its next
        dispatch (0.0 = no spike) — the rtt-spike drill."""
        prm = self.fire("delay_shard_link")
        return float(prm.get("dur", 0.5)) if prm else 0.0

    def net_half_open_seconds(self) -> float:
        """Seconds the trainer's sends to one link should be silently
        lost while receives still work (0.0 = healthy) — the half-open
        peer drill."""
        prm = self.fire("half_open_shard")
        return float(prm.get("dur", 1.0)) if prm else 0.0

    def garble_net_frame(self) -> bool:
        """One opportunity per received net frame (the socket replay
        link's dispatch path): True = flip frame bytes ahead of decode —
        the frame CRC must catch it and, for a sample response, the
        bounded retry must re-request."""
        return self.fire("garble_net_frame") is not None

    def drop_response(self) -> bool:
        """One opportunity per served response token: True = the service
        must NOT post this token (the fleet's bounded retry recovers)."""
        return self.fire("drop_act_response") is not None

    def garble_response(self) -> bool:
        """One opportunity per served response: True = the service flips
        response bytes AFTER the CRC landed (fleet-side CRC verification
        must catch it and retry)."""
        return self.fire("garble_act_response") is not None
