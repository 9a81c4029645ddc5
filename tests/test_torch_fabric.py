"""The port's threaded ``train()`` fabric and its planes, on the CPU.

- ``train()`` at ``test_config`` size (mlp torso, H=16, float32) with
  ``device="cpu"`` and ``act_device="cpu"``: every update's priorities fed
  back, the log entries written, ``/healthz`` and ``/metrics`` answered on
  an ephemeral port while it trains, the JAX package's metric keys;
- every branch of the reference's ``train()`` the port has not ported
  raises ``ValueError`` naming its ROADMAP.md item; the configurations
  the telemetry slice ported (the in-graph diagnostics, the trace slab,
  the transfer guard) train with their feature live, and anakin with
  ``league_eval`` warns and trains without the sidecar, as the
  reference;
- the chaos grammar and its firing sequence, the console line, the
  telemetry plane's registry absorption and the learning-health monitor
  and alert engine equal the JAX package's on the same inputs.

Mirrors tests/test_train_end_to_end.py's fabric e2e (slow-marked there:
the JAX step compiles; the port's does not, so this one takes seconds),
tests/test_chaos.py, tests/test_telemetry.py and tests/test_learnhealth.py.
"""
import contextlib
import http.client
import json
import os

import numpy as np
import pytest
import torch

from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu.telemetry import Telemetry as JaxTelemetry
from r2d2_tpu.telemetry import format_entry as jax_format_entry
from r2d2_tpu.telemetry import learnhealth as jax_lh
from r2d2_tpu.utils import chaos as jax_chaos
from r2d2_tpu_torch import train as ttrain
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.envs import FakeAtariEnv
from r2d2_tpu_torch.telemetry import learnhealth as lh
from r2d2_tpu_torch.telemetry.console import format_entry
from r2d2_tpu_torch.telemetry.plane import Telemetry
from r2d2_tpu_torch.telemetry.runlog import read_entries
from r2d2_tpu_torch.utils import chaos
from r2d2_tpu_torch.utils.trace import device_profile

A = 4

# the keys the JAX package's train() adds to the learner's metrics
# (r2d2_tpu/train.py, the thread transport on the host ring)
JAX_FABRIC_KEYS = {
    "num_updates", "env_steps", "minutes", "mean_loss", "buffer_size",
    "logs", "buffer_training_steps", "final_params", "restored_replay",
    "learner_stalled", "trace", "health", "telemetry_port",
    "fabric_failed", "learnhealth", "alerts", "healthz",
    "blocks_per_member"}


def env_factory(cfg, seed):
    return FakeAtariEnv(obs_shape=cfg.obs_shape, action_dim=A, seed=seed,
                        episode_len=32)


def cpu_config(**kw):
    return port_test_config(game_name="Fake", act_device="cpu", **kw)


def http_get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read().decode()
    finally:
        conn.close()


def test_train_fabric_feeds_back_logs_and_serves_telemetry(tmp_path):
    """20 updates through the threaded fabric: all 20 priority feedbacks
    reach the buffer, the log loop writes entries (in memory and to the
    JSONL run log), and the exporter answers /healthz, /metrics, /alertz,
    /tracez and /profilez on the ephemeral port while the run trains."""
    scraped = {}

    def log_sink(entry):
        if not scraped:
            port = entry["telemetry_port"]
            scraped["healthz"] = http_get(port, "/healthz")
            scraped["metrics"] = http_get(port, "/metrics")
            scraped["alertz"] = http_get(port, "/alertz")
            scraped["tracez"] = http_get(port, "/tracez")
            scraped["profilez"] = http_get(port, "/profilez")

    cfg = cpu_config(training_steps=20, prefetch_batches=2,
                     log_interval=0.2, telemetry_port=-1)
    ck = str(tmp_path / "ck")
    m = ttrain.train(cfg, env_factory=env_factory, checkpoint_dir=ck,
                     verbose=False, log_sink=log_sink, device="cpu",
                     max_wall_seconds=120)
    assert JAX_FABRIC_KEYS <= set(m)
    assert m["num_updates"] == 20 == m["buffer_training_steps"]
    assert np.isfinite(m["mean_loss"]) and not m["fabric_failed"]
    assert m["telemetry_port"] > 0 and len(m["logs"]) > 0
    assert m["learnhealth"]["loss_count"] == 20
    assert m["healthz"]["status"] == "ok" and m["alerts"] == {}
    assert all(h["restarts"] == 0 for h in m["health"].values())
    status, body = scraped["healthz"]
    assert status == 200 and json.loads(body)["status"] == "ok"
    status, body = scraped["metrics"]
    assert status == 200 and "r2d2_replay_buffer_size" in body
    assert scraped["alertz"][0] == 200
    for route in ("tracez", "profilez"):
        status, body = scraped[route]
        assert status == 200 and json.loads(body)["armed"] is False
    entries = list(read_entries(os.path.join(ck, "telemetry",
                                             "run.jsonl")))
    assert entries and entries[-1]["training_steps"] <= 20
    assert all(v.device.type == "cpu" for v in m["final_params"].values())


def test_train_needs_a_device_or_cuda(monkeypatch):
    """No device and no CUDA: train() raises, never moving to the CPU on
    its own (nor does acting under act_device='auto')."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.train(cpu_config(), env_factory=env_factory, verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.train(port_test_config(game_name="Fake"),
                     env_factory=env_factory, verbose=False, device="cpu")


REFUSALS = [
    (dict(device_replay=True, device_ring_layout="dp"), "item 7a"),
]


@pytest.mark.parametrize("kw,item", REFUSALS,
                         ids=[",".join(k) for k, _ in REFUSALS])
def test_unported_branches_raise_naming_their_roadmap_item(kw, item):
    with pytest.raises(ValueError, match=item):
        ttrain.train(cpu_config(**kw), env_factory=env_factory,
                     verbose=False, device="cpu")


ANAKIN = dict(actor_transport="anakin", num_actors=2, superstep_k=2,
              learning_starts=16, anakin_episode_len=12)
# the configurations check_unported refused until the telemetry slice
# (ROADMAP item 10) and C 14; each now trains with its feature live
FORMERLY_REFUSED = {
    "anakin-learnhealth": dict(learnhealth_interval=2, **ANAKIN),
    "learnhealth": dict(learnhealth_interval=2),
    "trace_steps": dict(trace_steps=3),
    "transfer_guard": dict(transfer_guard=True),
    "anakin-transfer_guard": dict(transfer_guard=True, **ANAKIN),
    "anakin-league_eval": dict(league_eval=True, **ANAKIN),
    "session_chaos": dict(chaos_spec="kill_session_client:every=1;"
                                     "slow_session_client:every=1,dur=1"),
}


@pytest.mark.parametrize("name", list(FORMERLY_REFUSED))
def test_formerly_refused_configs_train_with_their_feature_live(
        name, tmp_path):
    """The in-graph diagnostics absorb an armed row every 2nd update; a
    boot-time capture dumps one trace with the trainer's track; the
    anakin loop arms the transfer guard after its warm-up and counts its
    windows (the reference arms it in no other transport, so a threaded
    run counts none); anakin with ``league_eval`` warns, as the reference
    (r2d2_tpu/train.py:1044-1051), and trains without the sidecar; a
    spec naming the session load generator's sites trains and fires
    nothing, as the reference's train() (r2d2_tpu/train.py:824-830)."""
    from r2d2_tpu_torch.utils.trace import TRANSFER_GUARD

    kw = FORMERLY_REFUSED[name]
    steps = 8
    TRANSFER_GUARD.reset()
    warn = (pytest.warns(UserWarning, match="running without the eval "
                         "sidecar") if kw.get("league_eval")
            else contextlib.nullcontext())
    with warn:
        m = ttrain.train(cpu_config(training_steps=steps, **kw),
                         env_factory=(env_factory if "actor_transport"
                                      not in kw
                                      else ttrain._default_env_factory),
                         checkpoint_dir=str(tmp_path), verbose=False,
                         device="cpu", max_wall_seconds=120)
    assert m["num_updates"] == steps and np.isfinite(m["mean_loss"])
    assert not m["fabric_failed"]
    if "chaos_spec" in kw:
        assert not any(m["chaos"].values())
    lh_on = kw.get("learnhealth_interval", 0) > 0
    assert m["learnhealth"]["armed_steps"] == (steps // 2 if lh_on else 0)
    dumps = sorted(os.listdir(tmp_path / "telemetry"))
    traces = [d for d in dumps if d.startswith("trace_")]
    if kw.get("trace_steps"):
        assert traces == ["trace_1.json"]
        with open(tmp_path / "telemetry" / traces[0]) as f:
            trace = json.load(f)["traceEvents"]
        names = {e["name"] for e in trace}
        assert {"process_name", "learner.step_dispatch"} <= names
    else:
        assert traces == []
    windows = TRANSFER_GUARD.snapshot()
    if kw.get("transfer_guard") and kw.get("actor_transport"):
        dispatches = steps // kw["superstep_k"]
        assert windows == {"window.anakin.dispatch": dispatches,
                           "window.anakin.harvest": dispatches}
    else:
        assert windows == {}


def test_use_mesh_raises_naming_its_roadmap_item(monkeypatch):
    """The learner mesh refuses nothing the reference accepts: the
    session load generator's chaos sites (refused until ROADMAP item 11a)
    pass, the anakin mesh and in-graph PER over several ranks (item 7b)
    pass the check — from torchrun's WORLD_SIZE, before any process group
    exists — and the anakin mesh trains in a world of one with the
    session sites armed, firing none."""
    ttrain.check_unported(cpu_config(
        actor_transport="anakin", chaos_spec="slow_session_client:every=1"),
        use_mesh=True)
    monkeypatch.setenv("WORLD_SIZE", "2")
    ttrain.check_unported(cpu_config(device_replay=True, in_graph_per=True),
                          use_mesh=True)
    ttrain.check_unported(cpu_config(actor_transport="anakin"),
                          use_mesh=True)
    monkeypatch.delenv("WORLD_SIZE")
    m = ttrain.train(cpu_config(actor_transport="anakin", num_actors=2,
                                superstep_k=2, learning_starts=16,
                                anakin_episode_len=12, training_steps=4,
                                chaos_spec="slow_session_client:every=1"),
                     use_mesh=True, verbose=False, device="cpu",
                     max_wall_seconds=120)
    assert m["num_updates"] == 4 and np.isfinite(m["mean_loss"])
    assert not any(m["chaos"].values())
    assert not any(type(v).__name__ == "DTensor"
                   for v in m["final_params"].values())


@pytest.mark.parametrize("kw", [
    dict(), dict(device_replay=True, in_graph_per=True, superstep_k=2),
    dict(replay_shards=2)], ids=["host_staged", "in_graph_per", "shards"])
def test_use_mesh_trains_at_world_size_one(kw):
    """``use_mesh`` with no process group up trains in a world of one it
    creates (gloo on the CPU) and tears down: the state is DTensors, each
    update passes the collective gate, and in-graph PER runs because the
    one rank owns the whole ring."""
    import torch.distributed as dist

    from r2d2_tpu_torch.parallel.distributed import COLLECTIVE_CALLS

    COLLECTIVE_CALLS.clear()
    m = ttrain.train(cpu_config(training_steps=6, **kw),
                     env_factory=env_factory, use_mesh=True, verbose=False,
                     device="cpu", max_wall_seconds=120)
    assert m["num_updates"] == 6 and not m["fabric_failed"]
    assert np.isfinite(m["mean_loss"]) and m["healthz"]["status"] == "ok"
    assert not any(type(v).__name__ == "DTensor"
                   for v in m["final_params"].values())
    assert COLLECTIVE_CALLS["gate"] >= (3 if kw else 6)
    assert COLLECTIVE_CALLS["env_steps"] == 1
    assert not dist.is_initialized()


def test_every_chaos_kind_is_fired_or_refused():
    """The port's train() fires eighteen sites and the session load
    generator the other two kinds the grammar knows."""
    session = {"kill_session_client", "slow_session_client"}
    assert set(ttrain.CHAOS_SITES) | session == set(chaos._KINDS)
    assert not set(ttrain.CHAOS_SITES) & session
    assert chaos._KINDS == jax_chaos._KINDS


SPECS = [
    "",
    "kill_fleet:every=500;garble_block:p=0.01;freeze_learner:at=40,dur=3",
    "poison_params:at=5",
    " truncate_ckpt:every=2,n=3 ; ",
    "stall_pump:p=0.5,dur=0.25;wedge_dispatch:at=1",
    "bogus:p=1",
    "kill_fleet:x=1",
    "kill_fleet",
    "kill_fleet:dur=2",
    "freeze_learner:at=notanumber",
]


def _parse(mod, spec):
    try:
        return ("ok", mod.parse_spec(spec))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_matches_jax(spec):
    assert _parse(chaos, spec) == _parse(jax_chaos, spec)


@pytest.mark.parametrize("spec", SPECS[1:5])
def test_config_validates_chaos_spec_as_jax(spec):
    assert port_test_config(chaos_spec=spec).chaos_spec == spec
    with pytest.raises(ValueError):
        port_test_config(chaos_spec="bogus:p=1")


def test_chaos_firing_sequence_matches_jax():
    """Same spec and seed: the same opportunities fire, in both
    packages, for counted, periodic, one-shot and seeded-random kinds."""
    spec = ("freeze_learner:every=3,dur=0.5;poison_params:p=0.3;"
            "truncate_ckpt:at=4;stall_pump:p=0.5,n=2")
    port, ref = chaos.ChaosInjector(spec, 7), jax_chaos.ChaosInjector(spec, 7)
    for _ in range(25):
        for kind in ("freeze_learner", "poison_params", "truncate_ckpt",
                     "stall_pump", "kill_fleet"):
            assert port.fire(kind) == ref.fire(kind)
        assert port.learner_freeze_seconds() == ref.learner_freeze_seconds()
        assert port.poison_params_now() == ref.poison_params_now()
    assert port.counts() == ref.counts()


def _entry():
    return dict(
        time=123.0, buffer_size=640, env_steps=4096, training_steps=37,
        updates_per_sec=12.5, mean_episode_return=3.25, mean_loss=0.0123,
        interval_episodes=3,
        trace={"span.learner.step_dispatch.p95_ms": 41.5,
               "span.learner.batch_wait.p95_ms": 2.25,
               "span.learner.step_dispatch.mean_ms": 30.0,
               "gauge.batch_queue_depth": 4.0},
        health={"actor": dict(alive=True, restarts=1, gave_up=False),
                "log": dict(alive=False, restarts=3, gave_up=True)},
        learner_heartbeat_age=7.5, telemetry_port=9131,
        chaos={"freeze_learner": 2, "poison_params": 0},
        corrupt_blocks=2, shard_respawns=0,
        learnhealth=dict(enabled=False, armed_steps=0, nonfinite=1,
                         loss_spikes=2, loss_count=37, last_loss=0.5,
                         td_hist=[0] * 8, td_sum=0.0, is_hist=[0] * 8,
                         is_sum=0.0, loss_ewma=0.01),
        replay_health=dict(
            replay_ratio=1.75, samples_per_member={0: 30, 1: 10},
            priorities=dict(ess=12.0, ess_frac=0.6, positive_leaves=20,
                            mass=3.0, hist=[1, 2, 3, 4, 5, 0, 0, 0, 5, 0],
                            edges=list(lh.PRIO_EDGES))),
        alerts={"nonfinite": 1, "loss_spike": 0})


def test_format_entry_matches_jax():
    e = _entry()
    assert format_entry(e) == jax_format_entry(e)
    assert format_entry({}) == jax_format_entry({})
    assert format_entry(e, prefix="[x]") == jax_format_entry(e, prefix="[x]")


def test_telemetry_record_absorbs_as_jax(tmp_path):
    """One entry through both planes: the same registry contents (the
    process-wide guard surfaces aside: each package has its own) and the
    same JSONL record."""
    cfg = port_test_config()
    jcfg = jax_test_config()
    port = Telemetry(cfg, str(tmp_path / "port"))
    ref = JaxTelemetry(jcfg, str(tmp_path / "jax"))
    for t in (port, ref):
        t.record(_entry())
        t.close()

    def own(snap):
        skip = ("host_transfers.", "kernel_launches.", "transfer_guard.",
                "retraces.")
        return {kind: {k: v for k, v in series.items()
                       if not k.startswith(skip)}
                for kind, series in snap.items()}

    assert own(port.registry.snapshot()) == own(ref.registry.snapshot())
    assert port.registry.snapshot()["counters"]["chaos.fires{kind=freeze_learner}"] == 2
    rows = [list(read_entries(os.path.join(tmp_path, d, "telemetry",
                                           "run.jsonl")))
            for d in ("port", "jax")]
    assert rows[0] == rows[1] and len(rows[0]) == 1


def test_learnhealth_monitor_and_alerts_match_jax(tmp_path):
    """The same loss stream (a warm-up, a spike, a NaN) through both
    monitors and alert engines: equal snapshots, equal fired rules, a
    trip on the NaN, and the durable alert rows read back."""
    cfg = port_test_config(alert_loss_spike_factor=3.0,
                           alert_ess_min=0.5, alert_replay_ratio_max=4.0)
    jcfg = jax_test_config(alert_loss_spike_factor=3.0, alert_ess_min=0.5,
                           alert_replay_ratio_max=4.0)
    from r2d2_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
    from r2d2_tpu_torch.telemetry.registry import MetricsRegistry

    pe = lh.AlertEngine(cfg, MetricsRegistry(),
                        str(tmp_path / "p" / "telemetry"))
    je = jax_lh.AlertEngine(jcfg, JaxRegistry(),
                            str(tmp_path / "j" / "telemetry"))
    pm = lh.LearnHealthMonitor(cfg, engine=pe)
    jm = jax_lh.LearnHealthMonitor(jcfg, engine=je)
    losses = list(np.linspace(1.0, 0.5, 25)) + [9.0, 0.4, float("nan")]
    for i, v in enumerate(losses):
        for m in (pm, jm):
            m.note_losses(np.asarray([v]))
        assert pm.tripped == jm.tripped == (i == len(losses) - 1)
    leaves = np.concatenate([np.full(40, 1e-3), [5.0, 4.0]])
    replay = dict(replay_ratio=jax_lh.replay_ratio(jcfg, 100, 50),
                  priorities=jax_lh.priority_health(leaves))
    assert lh.priority_health(leaves) == replay["priorities"]
    assert lh.replay_ratio(cfg, 100, 50) == replay["replay_ratio"]
    for eng, mon in ((pe, pm), (je, jm)):
        eng.evaluate(dict(learnhealth=mon.snapshot(), replay=replay,
                          training_steps=100))
    ps, js = pm.snapshot(), jm.snapshot()
    assert set(ps) == set(js)
    for k in ps:
        np.testing.assert_equal(ps[k], js[k])
    assert pe.counts() == je.counts() == {"nonfinite": 1, "loss_spike": 1,
                                          "ess_collapse": 1,
                                          "replay_ratio": 1}
    assert pe.active() == je.active() and pe.nonfinite_active
    pe.close()
    je.close()
    rows = lh.read_alerts(str(tmp_path / "p"))
    want = jax_lh.read_alerts(str(tmp_path / "j"))
    assert [r["rule"] for r in rows] == [r["rule"] for r in want]
    assert [r["rule"] for r in rows] == ["nonfinite", "loss_spike",
                                         "ess_collapse", "replay_ratio"]


def test_device_profile_writes_a_trace(tmp_path):
    with device_profile(str(tmp_path / "prof")):
        torch.ones(8) @ torch.ones(8)
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    with device_profile(None):   # no-op when no directory is given
        pass
