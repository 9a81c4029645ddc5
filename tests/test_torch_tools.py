"""The port's ``tools/r2d2_top.py`` and ``tools/soak.py`` against the
reference tools (``tools/r2d2_top.py``, ``tools/soak.py``), on the CPU.

- ``render`` parity: the same entries and health go through both tools'
  ``render`` and give the same frame, line for line: a fleet (with its
  resilience row), a population, a league table, learnhealth, replay
  shards and a single priority tree, alerts and chaos, and the three
  health verdicts.
- ``--once`` over a ``run.jsonl`` (a checkpoint dir or the file), and
  ``--url`` against the port's exporter.
- The soak's configuration field for field the reference's, its three
  checks and its summary keys driven with ``train`` replaced, and its
  ``--dp`` refusal without the cards it needs.  The slow-marked tests run
  a real CPU soak and the ``--dp`` soak over 8 gloo ranks (dp = 4 x
  tp = 2).
"""
import ast
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import threading

import pytest

from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu_torch.telemetry.exporter import TelemetryExporter
from r2d2_tpu_torch.telemetry.registry import MetricsRegistry
from r2d2_tpu_torch.telemetry.runlog import RunLog
from r2d2_tpu_torch.tools import r2d2_top, soak

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_top():
    spec = importlib.util.spec_from_file_location(
        "ref_r2d2_top", os.path.join(REPO_ROOT, "tools", "r2d2_top.py"))
    top = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(top)
    return top


REF_TOP = _reference_top()

_FLEET = dict(alive=2, fleets=2, restarts=[0, 1], blocks_ingested=5,
              blocks_corrupt=0, stats=dict(totals=dict(env_steps=800)))
_BASE = dict(training_steps=12, updates_per_sec=3.0, buffer_size=64,
             env_steps=999, mean_episode_return=1.5, mean_loss=0.25)
_THREADS = {"learner": dict(alive=True, restarts=0),
            "actor0": dict(alive=False, restarts=2)}
ENTRIES = {
    "empty": ({}, None),
    "fleet": (dict(_BASE, fleet=_FLEET), dict(ok=False, threads={})),
    "fleet-resilience": (dict(_BASE, fleet=dict(
        _FLEET, resilience=dict(circuits_open=1, circuit_opens=3,
                                retries=7, local_acts=40,
                                max_stale_params_s=2.5))),
        dict(ok=True, status="degraded", threads=_THREADS)),
    "population": (dict(_BASE, fleet=dict(_FLEET, population=dict(members=[
        dict(member=0, name="base", game="Fake", lanes=4, env_steps=100,
             blocks=3, episodes=2),
        dict(member=1, name="low", game="Fake", lanes=4, env_steps=90,
             blocks=2, episodes=1)]))), None),
    "league": (dict(_BASE, league=dict(
        rows=4, sweeps=2, last_step=8,
        health=dict(alive=False, failed=False),
        table=[dict(member=0, name="base", game="Fake", last_reward=1.25,
                    last_step=8, best_reward=2.5, best_step=4, evals=2),
               dict(member=1, name="low", game="Fake", last_reward=0.5,
                    last_step=8, best_reward=None, evals=1)])),
        dict(ok=True, degraded=True, threads=_THREADS)),
    "league-failed": (dict(_BASE, league=dict(
        rows=0, sweeps=0, health=dict(failed=True), table=[])), None),
    "learnhealth": (dict(_BASE, learnhealth=dict(
        armed_steps=3, dq_mean=0.0125, dq_max=0.5, grad_norm=12.3456,
        target_lag=0.25, max_abs_q=7.5)), None),
    "replay-shards": (dict(_BASE, replay_health=dict(
        replay_ratio=1.75, shards=[
            dict(shard=0, ess=12.5, ess_frac=0.25, positive_leaves=50),
            dict(shard=1, ess=10.0, ess_frac=0.2, positive_leaves=50)]),
        replay_shards=dict(alive=2, shards=2, respawns=[0, 1])), None),
    "replay-one-tree": (dict(_BASE, replay_health=dict(
        replay_ratio=0.5, priorities=dict(ess=30.0, ess_frac=0.6,
                                          positive_leaves=50))), None),
    "alerts-chaos": (dict(_BASE, alerts=dict(nonfinite=0, dq_drift=2),
                          chaos=dict(freeze_service=1, kill_fleet=2)),
                     dict(ok=True, threads={})),
    "entry-health": (dict(_BASE, health=_THREADS), None),
}


@pytest.mark.parametrize("name", list(ENTRIES))
def test_render_matches_the_reference(name):
    entry, health = ENTRIES[name]
    frame = r2d2_top.render(entry, health=health)
    assert frame == REF_TOP.render(entry, health=health)
    if entry:
        assert frame.splitlines()[0] == r2d2_top.format_entry(entry)


def _write_log(tmp_path, entries):
    log = RunLog(str(tmp_path / "telemetry"))
    for e in entries:
        log.append(e)
    log.close()
    return log.path


@pytest.mark.parametrize("source", ["ckpt_dir", "jsonl"])
def test_once_tails_the_run_log(tmp_path, capsys, source):
    last = ENTRIES["league"][0]
    path = _write_log(tmp_path, [ENTRIES["fleet"][0], last])
    arg = str(tmp_path) if source == "ckpt_dir" else path
    assert r2d2_top.resolve_jsonl(arg) == path
    assert r2d2_top.main(["--once", arg]) == 0
    out = capsys.readouterr().out
    assert out == REF_TOP.render(last) + "\n"


def test_once_reads_statusz_from_the_ports_exporter(capsys):
    entry, health = ENTRIES["fleet-resilience"]
    exporter = TelemetryExporter(MetricsRegistry(), lambda: health,
                                 status_fn=lambda: dict(last_entry=entry))
    stop = threading.Event()

    def serve():
        while not stop.is_set():
            exporter.handle_once()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{exporter.port}"
        assert r2d2_top.main(["--once", "--url", url]) == 0
    finally:
        stop.set()
        t.join(5)
        exporter.close()
    out = capsys.readouterr().out
    assert out == REF_TOP.render(entry, health=health) + "\n"
    assert out.splitlines()[0] == r2d2_top.format_entry(entry)
    assert "DEGRADED" in out


def test_top_usage_and_unreachable_endpoint(capsys):
    assert r2d2_top.main([]) == 2
    assert r2d2_top.main(["--once", "--url", "http://127.0.0.1:9"]) == 0
    assert "endpoint unreachable" in capsys.readouterr().out


# ------------------------------------------------------------------ soak

def _reference_soak_source():
    with open(os.path.join(REPO_ROOT, "tools", "soak.py")) as f:
        return ast.parse(f.read())


def test_soak_config_is_the_references():
    """``soak_config`` is the reference's ``test_config(...)`` call
    (``tools/soak.py:69-79``), field for field, in both drivetrains."""
    tree = _reference_soak_source()
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "test_config")
    literal = {k.arg: eval(ast.unparse(k.value), {})  # constants only
               for k in call.keywords
               if k.arg and not isinstance(k.value, ast.Name)}
    assert [k.arg for k in call.keywords
            if isinstance(k.value, ast.Name)] == ["in_graph_per"]
    for ingraph in (False, True):
        want = dataclasses.asdict(jax_test_config(in_graph_per=ingraph,
                                                  **literal))
        got = dataclasses.asdict(soak.soak_config(ingraph))
        assert got == want
    cpu = soak.soak_config(device="cpu")
    assert cpu.act_device == "cpu"
    # --dp: the reference's own layout (tools/soak.py:78-79), 8 ranks
    dp = soak.soak_config(dp=True)
    assert dp.device_ring_layout == "dp" and dp.mesh_shape == (
        ("dp", 4), ("tp", 2))
    assert soak.DP_RANKS == 8


def _ref_summary_keys():
    tree = _reference_soak_source()
    for n in ast.walk(tree):
        if (isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)
                and n.targets[0].id == "summary"):
            return [k.arg for k in n.value.keywords]
    raise AssertionError("no summary in tools/soak.py")


# rates per log entry, the learner/buffer counters, fabric_failed → the
# expected verdicts (priorities exact, no decay) and SOAK PASS|FAIL
SOAK_CASES = {
    "steady": ([5.0, 6.0, 6.0, 6.0, 5.9, 6.1], 40, 40, False,
               True, True, "PASS"),
    "decayed": ([6.0, 6.0, 6.0, 6.0, 4.0, 4.0], 40, 40, False,
                True, False, "FAIL"),
    "short": ([0.0, 3.0], 10, 10, False, True, True, "PASS"),
    "no-updates": ([0.0, 0.0], 0, 0, False, True, False, "FAIL"),
    "lost-feedback": ([5.0, 5.0, 5.0], 40, 39, False, False, True, "FAIL"),
    "fabric-failed": ([5.0, 5.0, 5.0], 40, 40, True, True, True, "FAIL"),
}


@pytest.mark.parametrize("case", list(SOAK_CASES))
def test_soak_checks_and_summary(case, tmp_path, monkeypatch, capsys):
    from r2d2_tpu_torch import train as ttrain

    rates, updates, fed, failed, exact, steady, verdict = SOAK_CASES[case]
    seen = {}

    def fake_train(cfg, env_factory=None, use_mesh=False,
                   max_wall_seconds=None, verbose=True, log_sink=None,
                   device=None, **kw):
        seen.update(cfg=cfg, wall=max_wall_seconds, device=device,
                    mesh=use_mesh, env=env_factory(cfg, 3))
        for r in rates:
            log_sink(dict(updates_per_sec=r, training_steps=updates))
        return dict(num_updates=updates, env_steps=1234,
                    fabric_failed=failed, buffer_training_steps=fed,
                    health=dict(learner=dict(alive=True, restarts=0)),
                    mean_loss=0.5)

    monkeypatch.setattr(ttrain, "train", fake_train)
    if case != "steady":   # one case runs the real preflight
        monkeypatch.setattr("r2d2_tpu_torch.analysis.preflight",
                            lambda root: None)
    out = str(tmp_path / "soak.json")
    rc = soak.main(0.5, ingraph=case == "short", out=out, device="cpu")
    assert rc == (0 if verdict == "PASS" else 1)
    printed = capsys.readouterr().out
    assert printed.rstrip().splitlines()[-1] == f"SOAK {verdict}"
    with open(out) as f:
        summary = json.load(f)
    assert list(summary) == _ref_summary_keys()
    assert summary["priority_accounting_exact"] is exact
    assert summary["no_throughput_decay"] is steady
    assert summary["fabric_failed"] is failed
    assert summary["num_updates"] == updates and summary["env_steps"] == 1234
    assert json.loads(printed[:printed.rindex("SOAK")]) == summary
    with open(str(tmp_path / "soak.telemetry.jsonl")) as f:
        assert len(f.readlines()) == len(rates)
    assert seen["wall"] == 30.0 and seen["device"] == "cpu"
    assert not seen["mesh"] and seen["cfg"].in_graph_per is (
        case == "short")
    assert seen["env"].episode_len == 200


def test_soak_dp_refuses_without_its_cards(monkeypatch, tmp_path):
    """On the card, ``--dp`` needs one card a rank: with fewer it exits
    naming the ranks, before it writes anything, and never falls back to
    the CPU or to dp = 1."""
    import torch

    monkeypatch.setattr("r2d2_tpu_torch.analysis.preflight",
                        lambda root: None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def no_run(*a, **k):
        raise AssertionError("the ranks must not start")

    monkeypatch.setattr("r2d2_tpu_torch.tools.rank_worker.run_ranks",
                        no_run)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        soak.main(0.1, dp=True, device="cuda")
    msg = str(e.value.code)
    assert f"{soak.DP_RANKS} ranks" in msg and "has 1" in msg
    assert os.listdir(tmp_path) == []


def test_soak_parse_args_defaults_to_the_card():
    a = soak.parse_args([])
    assert (a.minutes, a.ingraph, a.dp, a.out, a.device) == (
        20.0, False, False, None, "cuda")
    a = soak.parse_args(["0.5", "--ingraph", "--dp", "--out", "x.json",
                         "--device", "cpu"])
    assert (a.minutes, a.ingraph, a.dp, a.out, a.device) == (
        0.5, True, True, "x.json", "cpu")


@pytest.mark.slow
@pytest.mark.parametrize("ingraph", [False, True])
def test_soak_on_the_cpu(ingraph, tmp_path):
    """A real soak of 0.3 minutes on the CPU, both drivetrains."""
    out = str(tmp_path / "soak.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = soak.main(0.3, ingraph=ingraph, out=out, device="cpu")
    assert rc == 0, buf.getvalue()[-2000:]
    with open(out) as f:
        summary = json.load(f)
    assert summary["num_updates"] > 0 and not summary["fabric_failed"]
    assert summary["priority_accounting_exact"]


@pytest.mark.slow
@pytest.mark.timeout(600)
def test_soak_dp_over_gloo_ranks(tmp_path):
    """``--dp`` over 8 gloo ranks (the reference's dp = 4 x tp = 2) for
    five minutes: every rank's priority accounting exact (a leader's
    buffer one feedback an update, a peer's none), no fabric failure,
    updates taken, no throughput decay, rank 0's entries in the artifact.
    The entries are 30 s long: each holds several super-steps of k = 4,
    so the thirds' medians resolve a 20 % change (at the reference's 10 s
    an entry holds one or two, and the medians differ by that
    quantum)."""
    out = str(tmp_path / "soak.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = soak.main(5.0, dp=True, out=out, device="cpu",
                       log_interval=30.0)
    with open(out) as f:
        summary = json.load(f)
    assert summary["num_updates"] > 0, buf.getvalue()[-2000:]
    assert summary["priority_accounting_exact"]
    assert not summary["fabric_failed"]
    assert summary["no_throughput_decay"], summary
    assert rc == 0
    assert buf.getvalue().rstrip().endswith("SOAK PASS")
    with open(str(tmp_path / "soak.telemetry.jsonl")) as f:
        entries = f.readlines()
    assert len([e for e in entries
                if json.loads(e)["updates_per_sec"] > 0]) >= 6
