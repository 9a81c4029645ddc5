"""The port's degraded-mode primitives and the stats slab against the JAX
package's, on the CPU.

- ``RetryPolicy`` delays, ``Deadline.poll_timeout``, the
  ``CircuitBreaker`` state machine and ``bounded_event_set`` outcomes
  equal the reference's (the jitter comes from the same seeded numpy
  generator, so the delays are bitwise equal);
- the stats slab's bytes cross between the packages in both directions
  (a JAX fleet can publish to a torch trainer and the other way round),
  and the ``CounterMerger`` folds respawns exactly as the reference's;
- the fleet plane's degraded-mode verdict: param staleness and an open
  circuit published through the slab degrade its health.

Mirrors the primitive and health halves of tests/test_resilience.py.
"""
import threading
import time

import numpy as np
import pytest
import torch

from r2d2_tpu.telemetry import slab as jslab
from r2d2_tpu.utils import resilience as jres
from r2d2_tpu_torch import train as ttrain
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.parallel.actor_procs import ProcessFleetPlane
from r2d2_tpu_torch.telemetry import slab as tslab
from r2d2_tpu_torch.utils import resilience as tres
from r2d2_tpu_torch.utils.store import ParamStore

# the env factory spawned fleets unpickle: the port's own default
# (module-level, it imports nothing of JAX): fake lanes, 4 actions
make_fake_env = ttrain._default_env_factory
A = 4

RETRY_CASES = [dict(seed=0), dict(seed=3, attempts=6, base=0.1,
                                  max_delay=10.0, jitter=0.2),
               dict(seed=7 + 7_577, attempts=3, base=0.05, max_delay=1.0),
               dict(seed=11, attempts=8, base=1.0, max_delay=1.5,
                    jitter=0.0)]


@pytest.mark.parametrize("kw", RETRY_CASES,
                         ids=[str(c["seed"]) for c in RETRY_CASES])
def test_retry_policy_delays_bitwise_equal_jax(kw):
    ours, ref = tres.RetryPolicy(**kw), jres.RetryPolicy(**kw)
    assert ours.attempts == ref.attempts
    got = [ours.backoff(i) for i in range(1, 12)]
    want = [ref.backoff(i) for i in range(1, 12)]
    assert got == want
    for i, d in enumerate(got[:ours.attempts - 1]):
        nominal = min(ours.max_delay, ours.base * 2 ** i)
        assert (1 - ours.jitter) * nominal - 1e-12 <= d \
            <= (1 + ours.jitter) * nominal + 1e-12


def test_retry_policy_refuses_no_attempt():
    for mod in (tres, jres):
        with pytest.raises(ValueError, match="attempts"):
            mod.RetryPolicy(attempts=0)


def test_deadline_poll_timeout_matches_jax():
    for budget in (0.15, 0.0):
        ours, ref = tres.Deadline(budget), jres.Deadline(budget)
        assert ours.poll_timeout(0.2) == pytest.approx(
            ref.poll_timeout(0.2), abs=0.02)
    d = tres.Deadline(0.05)
    time.sleep(0.08)
    assert d.expired and d.poll_timeout(0.2) == 0.001
    assert tres.Deadline(0.0).poll_timeout(0.2) == 0.2


def test_circuit_breaker_transitions_and_snapshot_match_jax():
    """The same scripted sequence through both breakers: the same
    transitions in the same order and the same snapshots."""
    logs = ([], [])
    ours = tres.CircuitBreaker(name="t", failure_threshold=2, cooldown=0.2,
                               on_transition=lambda *a: logs[0].append(a))
    ref = jres.CircuitBreaker(name="t", failure_threshold=2, cooldown=0.2,
                              on_transition=lambda *a: logs[1].append(a))
    script = ["allow", "fail", "fail", "allow", "sleep", "allow", "allow",
              "fail", "sleep", "allow", "ok", "fail", "ok", "fail"]
    for op in script:
        if op == "sleep":
            time.sleep(0.25)
            continue
        row = []
        for b in (ours, ref):
            if op == "allow":
                row.append(b.allow_attempt())
            elif op == "fail":
                b.record_failure()
                row.append(b.state)
            else:
                b.record_success()
                row.append(b.state)
        assert row[0] == row[1], op
    assert logs[0] == logs[1] and len(logs[0]) == 5
    snap, want = ours.snapshot(), ref.snapshot()
    assert snap == want
    assert snap["opens"] == 2 and snap["probes"] == 2
    assert snap["state_name"] == "closed"


class _WedgedEvent:
    """An event whose ``set`` never returns (a lock a killed child held)."""

    def __init__(self):
        self.release = threading.Event()

    def set(self):
        self.release.wait(30)


def test_bounded_event_set_outcomes_match_jax():
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    for mod in (tres, jres):
        ev = ctx.Event()
        assert mod.bounded_event_set(ev, name="ok") is True
        assert ev.is_set()
        wedged = _WedgedEvent()
        t0 = time.monotonic()
        assert mod.bounded_event_set(wedged, timeout=0.2,
                                     name="wedged") is False
        assert time.monotonic() - t0 < 5
        wedged.release.set()


# ----------------------------------------------------------- stats slab

def test_stats_slab_fields_and_layout_equal_jax():
    assert tslab.FLEET_STAT_FIELDS == jslab.FLEET_STAT_FIELDS
    ours, ref = tslab.StatsSlab(3), jslab.StatsSlab(3)
    try:
        assert ours.slot_nbytes == ref.slot_nbytes
        assert ours.offsets == ref.offsets
    finally:
        ours.close()
        ref.close()


@pytest.mark.parametrize("writer_pkg,reader_pkg",
                         [("torch", "jax"), ("jax", "torch")])
def test_stats_slab_crosses_packages_bitwise(writer_pkg, reader_pkg):
    """A slot one package publishes is read by the other: same seq, same
    values, CRC accepted; a garbled slot is refused by both readers."""
    pkgs = dict(torch=tslab, jax=jslab)
    slab = pkgs[reader_pkg].StatsSlab(2)
    writer = pkgs[writer_pkg].StatsSlabWriter(slab.writer_info(1))
    try:
        stats = dict(env_steps=1234, blocks_produced=17, episodes=3,
                     episode_reward_sum=-2.5, param_version=9,
                     incarnation=1, act_retries=2, circuit_opens=1,
                     local_acts=40, circuit_state=2.0)
        writer.publish(stats)
        writer.publish(dict(stats, env_steps=1300))
        seq, values = slab.read(1)
        assert seq == 2
        want = [float(dict(stats, env_steps=1300)[n])
                for n, _ in jslab.FLEET_STAT_FIELDS]
        np.testing.assert_array_equal(values, np.asarray(want))
        assert slab.read(0) is None
        buf = np.frombuffer(slab.shm.buf, np.uint8)
        buf[slab.slot_nbytes + slab.offsets["values"]] ^= 0xFF
        del buf
        assert slab.read(1) is None
        assert pkgs[writer_pkg].StatsSlab.read(slab, 1) is None
    finally:
        writer.close()
        slab.close()


def test_counter_merger_folds_respawns_like_jax():
    """The same readings — a respawn (incarnation bump), a restart
    without one (seq regression), a stale re-read — through both
    mergers give the same totals, rows and incarnation counts."""
    fields = jslab.FLEET_STAT_FIELDS
    names = [n for n, _ in fields]

    def vec(**kw):
        return np.asarray([float(kw.get(n, 0.0)) for n in names])

    readings = [
        (0, 1, vec(env_steps=10, episodes=1, param_version=1)),
        (1, 1, vec(env_steps=5, param_version=1)),
        (0, 2, vec(env_steps=30, episodes=2, param_version=2)),
        (0, 2, vec(env_steps=30, episodes=2, param_version=2)),
        (0, 1, vec(env_steps=4, incarnation=1, param_version=2)),
        (1, 1, vec(env_steps=2, param_version=3)),
        (0, 3, vec(env_steps=9, incarnation=1, param_version=3)),
    ]
    ours, ref = tslab.CounterMerger(2), jslab.CounterMerger(2)
    for slot, seq, v in readings:
        assert ours.update(slot, seq, v) == ref.update(slot, seq, v)
        assert ours.totals() == ref.totals()
    assert ours.per_slot() == ref.per_slot()
    # slot 1's second reading repeats seq 1: already merged, not a restart
    assert ours.incarnations() == ref.incarnations() == [1, 0]
    assert ours.totals()["env_steps"] == 30 + 9 + 5


# ---------------------------------------------- the plane's health verdict

def _plane(**kw):
    cfg = port_test_config(game_name="Fake", num_actors=2,
                           actor_transport="process", act_device="cpu",
                           **kw)
    return ProcessFleetPlane(cfg, A, make_fake_env, [0.4, 0.3])


def test_param_staleness_watchdog_degrades_health():
    """A fleet reporting an older version than the newest published one
    accrues staleness from when it first fell behind; past the budget the
    verdict degrades, and catching up clears it.  No clock before a
    fleet's first report."""
    plane = _plane(actor_fleets=2, actor_inference="serve")
    plane.param_store = ParamStore({"w": torch.zeros(2)})   # version 1
    plane.stale_params_budget = 0.15
    w0 = tslab.StatsSlabWriter(plane.stats_slab.writer_info(0))
    w1 = tslab.StatsSlabWriter(plane.stats_slab.writer_info(1))
    try:
        res = plane.resilience_health()
        assert res["stale_params_s"] == [0.0, 0.0] and not res["degraded"]
        w0.publish(dict(env_steps=10, param_version=1))
        w1.publish(dict(env_steps=10, param_version=1))
        assert not plane.resilience_health()["degraded"]
        plane.param_store.publish({"w": torch.ones(2)})     # version 2
        w0.publish(dict(env_steps=20, param_version=2))
        w1.publish(dict(env_steps=20, param_version=1))
        res = plane.resilience_health()
        assert res["stale_params_s"][0] == 0.0
        time.sleep(0.25)
        res = plane.resilience_health()
        assert res["stale_params_s"][1] > plane.stale_params_budget
        assert res["degraded"]
        # a newer publish must not restart fleet 1's clock
        plane.param_store.publish({"w": torch.full((2,), 2.0)})
        w0.publish(dict(env_steps=25, param_version=3))
        prev = res["stale_params_s"][1]
        res = plane.resilience_health()
        assert res["stale_params_s"][1] >= prev and res["degraded"]
        assert plane.registry.get_gauge("fleet.stale_params_s",
                                        fleet="1") > 0
        w1.publish(dict(env_steps=30, param_version=3))
        res = plane.resilience_health()
        assert res["stale_params_s"] == [0.0, 0.0] and not res["degraded"]
    finally:
        w0.close()
        w1.close()
        plane.stats_slab.close()


def test_circuit_state_from_slab_degrades_health():
    """A serve fleet publishing an open circuit flips the verdict to
    degraded and surfaces the merged resilience counters."""
    plane = _plane(actor_inference="serve")
    plane.param_store = ParamStore({"w": torch.zeros(2)})
    w0 = tslab.StatsSlabWriter(plane.stats_slab.writer_info(0))
    try:
        w0.publish(dict(env_steps=5, param_version=1, act_retries=4,
                        circuit_opens=2, local_acts=123,
                        circuit_state=float(tres.OPEN)))
        res = plane.resilience_health()
        assert res["circuit_states"] == [tres.OPEN]
        assert res["circuits_open"] == 1 and res["degraded"]
        assert (res["retries"], res["circuit_opens"],
                res["local_acts"]) == (4, 2, 123)
        assert plane.health()["resilience"]["degraded"]
    finally:
        w0.close()
        plane.stats_slab.close()
