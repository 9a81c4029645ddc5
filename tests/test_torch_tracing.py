"""The port's cross-process tracing and transfer guard against the JAX
package's, on the CPU.

- The trace slab: the same events written by each package's
  ``EventTracer`` lay out the same bytes, and each package's
  ``TraceSlab.harvest`` reads the other's slab.
- ``merge_tracks``: the same Chrome-trace JSON for the same rings.
- Bad slots: a torn slot is dropped and counted; a bumped ``capture_id``
  resets a writer's ring.
- The capture controllers and their ``/tracez`` and ``/profilez`` routes
  answer as the reference's (200 arming, 409 while busy, 200 status).
- The transfer guard: the window counts of one scripted anakin run equal
  the reference's ``TRANSFER_GUARD.snapshot()`` with the reference armed
  on the CPU; the cross-thread mode counting.  The sync-debug mode itself
  only fires on a card (tests/test_torch_cuda.py and chip_smoke.py).
"""
import importlib
import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from r2d2_tpu.learner.anakin import run_anakin_loop as jax_run_anakin_loop
from r2d2_tpu.telemetry import tracing as jtr
from r2d2_tpu.utils.trace import TRANSFER_GUARD as JAX_GUARD
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.learner.anakin import AnakinPlane, run_anakin_loop
from r2d2_tpu_torch.learner.learner import Learner
from r2d2_tpu_torch.learner.step import create_train_state
from r2d2_tpu_torch.models import create_network, params_from_flax
from r2d2_tpu_torch.replay.device_ring import DeviceRing
from r2d2_tpu_torch.telemetry import tracing as ttr
from r2d2_tpu_torch.utils import trace as tutrace
from r2d2_tpu_torch.utils.trace import (
    HOST_TRANSFERS,
    TRANSFER_GUARD,
    Tracer,
    TransferGuard,
)

from test_anakin import anakin_config as jax_anakin_config
from test_anakin import build_plane as jax_build_plane

# the modules (each package's ``train`` attribute is the function)
ttrain = importlib.import_module("r2d2_tpu_torch.train")
jtrain = importlib.import_module("r2d2_tpu.train")
CAP = 64
CLOCK = (1000.25, 1.7e9)
# (kind, name, ts, dur, flow, fph, arg)
SCRIPT = [
    ("X", "block.env_steps+cut", 1000.5, 0.25, (1 << 48) | 7, "s", 3),
    ("X", "fleet.block_send", 1000.8, 0.01, (1 << 48) | 7, "t", 0),
    ("X", "learner.step_dispatch", 1001.0, 0.125, 0, "", 0),
    ("X", "ingest.block", 1001.2, 0.002, (1 << 48) | 7, "t", 1),
]


def record(tracer, script=SCRIPT):
    for _, name, ts, dur, flow, fph, arg in script:
        tracer.complete(name, ts, dur, flow=flow, fph=fph, arg=arg)


def write_slab(mod, slots=2, events=SCRIPT):
    """A slab of ``mod`` (either package's tracing module) with a writer of
    the same package in each slot, armed for capture 1, the events
    recorded against a fixed clock pair, flushed."""
    slab = mod.TraceSlab(slots, CAP)
    slab.set_armed(True, capture_id=1)
    writers = []
    for s in range(slots):
        w = mod.EventTracer()
        w.attach(slab.writer_info(s, incarnation=s + 2, name=f"fleet{s}"))
        w._views["clock"][0], w._views["clock"][1] = CLOCK
        w.t0_perf, w.t0_wall = CLOCK
        record(w, events[s:])
        w.flush()
        writers.append(w)
    return slab, writers


def close(slab, writers):
    for w in writers:
        w.detach()
    slab.close()


def raw(slab) -> bytes:
    return bytes(slab.shm.buf[:slab.ctrl_nbytes
                              + slab.num_slots * slab.slot_nbytes])


def assert_tracks_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert {k: v for k, v in x.items() if k != "events"} == {
            k: v for k, v in y.items() if k != "events"}
        for f in ttr.EVENT_DTYPE.names:
            np.testing.assert_array_equal(x["events"][f], y["events"][f])


# ------------------------------------------------------------- the wire

def test_event_dtype_and_layout_match_the_reference():
    assert ttr.EVENT_DTYPE == jtr.EVENT_DTYPE
    assert ttr._CTRL_SPEC == jtr._CTRL_SPEC
    assert ttr._slot_spec(CAP) == jtr._slot_spec(CAP)


def test_slabs_are_byte_identical_and_cross_harvest():
    """Each package writes the same events into its own slab: the bytes
    are equal, and each package's harvest reads the other's slab."""
    pslab, pw = write_slab(ttr)
    jslab, jw = write_slab(jtr)
    try:
        assert raw(pslab) == raw(jslab)
        ptracks, pdrop = pslab.harvest()
        jtracks, jdrop = jslab.harvest()
        assert pdrop == jdrop == 0 and len(ptracks) == 2
        assert_tracks_equal(ptracks, jtracks)
        # the port's bytes under the reference's harvester, and back
        n = len(raw(pslab))
        jslab.shm.buf[:n] = raw(pslab)
        assert_tracks_equal(jslab.harvest()[0], ptracks)
        pslab.shm.buf[:n] = raw(jslab)
        assert_tracks_equal(pslab.harvest()[0], jtracks)
    finally:
        close(pslab, pw)
        close(jslab, jw)


def test_merge_tracks_matches_the_reference():
    pslab, pw = write_slab(ttr)
    try:
        tracks, _ = pslab.harvest()
        got = ttr.merge_tracks(tracks)
        want = jtr.merge_tracks(tracks)
        assert json.dumps(got, sort_keys=True) == json.dumps(
            want, sort_keys=True)
        flows = [e for e in got["traceEvents"] if e.get("cat") == "block"]
        assert {e["ph"] for e in flows} == {"s", "t"}
    finally:
        close(pslab, pw)


def test_ring_overflow_keeps_the_newest_in_order():
    """A ring past its capacity keeps the newest ``capacity`` events,
    oldest first, and counts the overflow — as the reference's."""
    script = [("X", f"e{i}", 1000.0 + i, 0.001, 0, "", i)
              for i in range(CAP + 5)]
    for mod in (ttr, jtr):
        slab = mod.TraceSlab(1, CAP)
        slab.set_armed(True, capture_id=1)
        w = mod.EventTracer()
        w.attach(slab.writer_info(0, 0, "trainer"))
        record(w, script)
        w.flush()
        (track,), dropped = slab.harvest()
        assert dropped == 0 and track["overflow"] == 5
        assert track["events"]["arg"].tolist() == list(range(5, CAP + 5))
        close(slab, [w])


def test_torn_slot_is_dropped_and_counted():
    pslab, pw = write_slab(ttr)
    try:
        # a byte of slot 1's event region changes after its CRC landed
        v = pslab._slot_views(1)
        v["events"].view(np.uint8)[3] ^= 0xFF
        tracks, dropped = pslab.harvest()
        assert dropped == 1 and [t["slot"] for t in tracks] == [0]
        j = jtr.TraceSlab(2, CAP)
        try:
            j.shm.buf[:len(raw(pslab))] = raw(pslab)
            assert j.harvest()[1] == 1
        finally:
            j.close()
    finally:
        close(pslab, pw)


def test_bumped_capture_id_resets_the_ring():
    slab = ttr.TraceSlab(1, CAP)
    w = ttr.EventTracer()
    try:
        w.attach(slab.writer_info(0, 0, "fleet0"))
        assert not w.armed
        w.instant("ignored")           # disarmed: nothing recorded
        slab.set_armed(True, capture_id=1)
        w.poll()
        record(w)
        w.flush()
        assert len(slab.harvest()[0][0]["events"]) == len(SCRIPT)
        slab.set_armed(True, capture_id=2)
        w.poll()
        w.instant("after")
        w.flush()
        (track,), _ = slab.harvest()
        assert [e.decode() for e in track["events"]["name"]] == ["after"]
        slab.set_armed(False)
        w.poll()
        assert not w.armed
    finally:
        close(slab, [w])


def test_trace_ids_are_incarnation_tagged():
    for mod in (ttr, jtr):
        slab = mod.TraceSlab(3, CAP)
        a, b = mod.EventTracer(), mod.EventTracer()
        a.attach(slab.writer_info(2, 0, "fleet1"))
        b.attach(slab.writer_info(2, 1, "fleet1"))
        ids = {a.next_trace_id(), b.next_trace_id()}
        assert len(ids) == 2 and all(i >> 48 == 3 for i in ids)
        close(slab, [a, b])
    assert ttr.EVENTS.armed is False


def test_tracer_spans_become_events_and_count():
    ev = ttr.EventTracer(capacity=16, name="local")
    tr = Tracer(events=ev)
    with tr.span("learner.dispatch"):
        pass
    assert len(ev.local_events()) == 0       # disarmed: nothing recorded
    ev.arm_local(1)
    with tr.span("learner.dispatch"):
        pass
    tr.incr("learner.stage", 2)
    got = ev.local_events()
    assert [e.decode() for e in got["name"]] == ["learner.dispatch"]
    assert got["ph"][0] == b"X" and got["dur"][0] >= 0
    snap = tr.snapshot()
    assert snap["span.learner.dispatch.count"] == 2
    assert snap["counter.learner.stage"] == 2


# ---------------------------------------------------- the controllers

def scaffold_routes(mod, tmp_path, device=None):
    """Either package's scaffold with its tracing loops built; its
    routes."""
    if mod is ttrain:
        cfg = port_test_config(telemetry_port=0)
        sc = mod._HostScaffold(cfg, str(tmp_path))
        sc.tracing_loops(1, lambda: 0, device or "cpu")
        return sc, sc.routes
    from r2d2_tpu.config import test_config as jax_test_config

    sc = mod._HostScaffold(jax_test_config(telemetry_port=0),
                           str(tmp_path))
    sc.tracing_loops(1, lambda: 0)
    return sc, sc.trace_routes


@pytest.mark.parametrize("route,arg", [("/tracez", "steps"),
                                       ("/profilez", "secs")])
def test_trigger_routes_answer_as_the_reference(tmp_path, route, arg):
    """Arming answers 200, a second arm 409 while the window is open, a
    bare GET 200 with the status — the reference's codes and keys."""
    got = {}
    for mod in (ttrain, jtrain):
        sc, routes = scaffold_routes(mod, tmp_path / mod.__name__)
        try:
            first = routes[route]({arg: "2"})
            second = routes[route]({arg: "2"})
            status = routes[route]({})
            got[mod] = (first[0], sorted(first[1]), second[0],
                        sorted(second[1]), status[0], sorted(status[1]))
        finally:
            sc.close()
    assert got[ttrain] == got[jtrain]
    assert got[ttrain][0] == 200 and got[ttrain][2] == 409


def test_trace_controller_dumps_a_capture(tmp_path):
    """A window of 2 steps closes when the step counter passes it: the
    dump holds the trainer's track, and a new window may then open."""
    steps = [0]
    slab = ttr.TraceSlab(2, CAP)
    ev = ttr.EventTracer()
    ev.attach(slab.writer_info(0, 0, "trainer"))
    fleet = ttr.EventTracer()
    fleet.attach(slab.writer_info(1, 0, "fleet0"))
    ctl = ttr.TraceController(slab, lambda: steps[0], str(tmp_path),
                              tracer=ev)
    ctl.GRACE_SECONDS = 0.01
    try:
        assert ctl.arm(2)["armed"]
        fleet.poll()
        assert ev.armed and fleet.armed
        Tracer(events=ev).span("learner.step_dispatch").__enter__()
        record(fleet)
        fleet.flush()
        assert ctl.poll() is None             # the target not reached
        steps[0] = 2
        path = ctl.poll()
        assert path and os.path.basename(path) == "trace_1.json"
        with open(path) as f:
            trace = json.load(f)
        names = {e["args"]["name"] for e in trace["traceEvents"]
                 if e["name"] == "process_name"}
        assert names == {"trainer", "fleet0"}
        assert ctl.last["dropped_slabs"] == 0
        assert ctl.arm(1)["capture_id"] == 2
    finally:
        fleet.detach()
        ev.detach()
        slab.close()


def test_capture_waits_for_a_writer_that_polls_the_disarm_late(tmp_path):
    """ROADMAP.md C 18: a fleet polls the disarm word only at the end of
    its burst, so at the window's close its slot can be torn (events
    recorded after its last flush) for longer than the grace and the
    reference's four re-reads; the harvest re-reads until the writer's
    flush lands and keeps its track."""
    steps = [0]
    slab = ttr.TraceSlab(2, CAP)
    ev = ttr.EventTracer()
    ev.attach(slab.writer_info(0, 0, "trainer"))
    fleet = ttr.EventTracer()
    fleet.attach(slab.writer_info(1, 0, "fleet0"))
    ctl = ttr.TraceController(slab, lambda: steps[0], str(tmp_path),
                              tracer=ev)
    ctl.GRACE_SECONDS = 0.01
    try:
        assert ctl.arm(1)["armed"]
        fleet.poll()
        record(fleet)
        fleet.flush()
        fleet.instant("mid.burst")      # recorded after the flush: torn
        steps[0] = 1
        late = threading.Timer(2.0, lambda: (fleet.poll(), fleet.flush()))
        late.start()
        t0 = time.monotonic()
        path = ctl.poll()
        late.join(5)
        assert 2.0 <= time.monotonic() - t0 < ctl.SETTLE_SECONDS
        assert ctl.last["dropped_slabs"] == 0 and ctl.last["tracks"] == 2
        with open(path) as f:
            trace = json.load(f)
        names = {e["args"]["name"] for e in trace["traceEvents"]
                 if e["name"] == "process_name"}
        assert names == {"trainer", "fleet0"}
    finally:
        fleet.detach()
        ev.detach()
        slab.close()


def test_profile_controller_on_the_cpu_and_refusing_without_cuda(tmp_path):
    """A CPU learner's profile writes a Chrome trace; a CUDA learner's
    profile in a process without CUDA raises and says so, and never
    writes a CPU-only trace."""
    cpu = ttr.ProfileController(str(tmp_path / "cpu"), device="cpu")
    assert cpu.arm(0.1)["armed"]
    path = cpu.poll()
    assert path.endswith("trace.json") and os.path.exists(path)
    assert cpu.status() == dict(armed=False, last=cpu.last)
    card = ttr.ProfileController(str(tmp_path / "card"), device="cuda")
    card.arm(0.1)
    with pytest.raises(RuntimeError, match="CUDA"):
        card.poll()
    assert "error" in card.last and not card.status()["armed"]
    assert not os.path.exists(tmp_path / "card" / "profile_1" / "trace.json")


# ------------------------------------------------------------ the guard

def test_guard_window_counts_match_the_reference_anakin_run():
    """One scripted anakin run (k = 2, 8 updates, the guard armed from the
    config after the warm-up) in each package: the same window counts,
    no trip, the guard disarmed after."""
    kw = dict(transfer_guard=True, training_steps=8)
    jcfg = jax_anakin_config(**kw)
    _, jplane, jlearner = jax_build_plane(jcfg)
    JAX_GUARD.reset()
    jax_run_anakin_loop(jlearner, jplane)
    want = JAX_GUARD.snapshot()

    cfg = port_test_config(game_name="Fake", actor_transport="anakin",
                           device_replay=True, in_graph_per=True,
                           num_actors=2, superstep_k=2, anakin_episode_len=12,
                           learning_starts=16, **kw)
    net = create_network(cfg, 4, device="cpu")
    state = create_train_state(cfg, params_from_flax(jax.device_get(
        jlearner.state.params)))
    plane = AnakinPlane(cfg, net, 4, DeviceRing(cfg, 4, device="cpu"))
    TRANSFER_GUARD.reset()
    m = run_anakin_loop(Learner(cfg, net, state), plane)
    got = TRANSFER_GUARD.snapshot()
    assert m["num_updates"] == 8 and not TRANSFER_GUARD.armed
    assert got == want == {"window.anakin.dispatch": 4,
                           "window.anakin.harvest": 4}


def test_guard_counts_windows_only_while_armed():
    g = TransferGuard()
    with g.disallow("learner.dispatch"):
        pass
    assert g.snapshot() == {}
    with g.arm():
        with g.disallow("learner.dispatch"), g.allow():
            pass
        with pytest.raises(ValueError):
            with g.disallow("learner.harvest"):
                raise ValueError("not a sync")
    assert g.snapshot() == {"window.learner.dispatch": 1,
                            "window.learner.harvest": 1}
    assert g._open == g._allow == 0


def test_guard_turns_a_sync_error_into_a_trip_naming_the_window():
    """The sync-debug mode's error (what torch raises on the card) inside
    a window becomes TransferGuardTripped with the window's name; any
    other RuntimeError passes through untouched."""
    g = TransferGuard()
    with g.arm():
        with pytest.raises(tutrace.TransferGuardTripped,
                           match="'anakin.dispatch'"):
            with g.disallow("anakin.dispatch"):
                raise RuntimeError("called a synchronizing CUDA operation")
        with pytest.raises(RuntimeError, match="other"):
            with g.disallow("anakin.harvest"):
                raise RuntimeError("other")
    assert g.snapshot() == {"window.anakin.dispatch": 1,
                            "trip.anakin.dispatch": 1,
                            "window.anakin.harvest": 1}


def test_guard_mode_is_counted_across_threads(monkeypatch):
    """One process-wide mode: "error" (2) while a window is open in any
    thread and no declared crossing is open in any thread; a declared
    crossing in another thread lowers it for its span; the mode found
    before the first window comes back after the last."""
    modes = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    g = TransferGuard()
    opened, crossed, done = (threading.Event() for _ in range(3))

    def other():
        opened.wait(5)
        with g.allow():
            crossed.set()
            done.wait(5)

    th = threading.Thread(target=other)
    th.start()
    with g.arm():
        with g.disallow("anakin.dispatch"):
            assert modes == [2]
            opened.set()
            crossed.wait(5)
            assert modes == [2, 0]
            done.set()
            th.join(5)
            assert modes == [2, 0, 2]
            with g.allow():
                assert modes == [2, 0, 2, 0]
            assert modes[-1] == 2
    assert modes[-1] == 0 and g._open == 0


def test_declared_crossings_lower_the_guard():
    """HOST_TRANSFERS.allowed opens the process guard's allow span."""
    with TRANSFER_GUARD.arm():
        with TRANSFER_GUARD.disallow("learner.harvest"):
            assert TRANSFER_GUARD._allow == 0
            with HOST_TRANSFERS.allowed("learner.result_fetch"):
                assert TRANSFER_GUARD._allow == 1
            assert TRANSFER_GUARD._allow == 0
