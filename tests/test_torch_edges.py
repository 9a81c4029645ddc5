"""The port's edge modules against the JAX package's, on the CPU.

``utils/batch.synthetic_batch`` (bitwise), the one-lane ``Actor`` (its
block stream against JAX's ``Actor`` on converted params: integer and
reward fields bitwise, the q-derived priorities within 1e-5 and the
stored hiddens within 1e-6 — ``test_torch_actor.py``'s act tolerances),
the evaluator's follow mode and plot, the sweep (tests/test_sweep.py's
cases), the bench's composition and isolation (tests/test_bench.py's
cases), and ``param_dtype="bfloat16"``.  The slow-marked tests run one
round of every ``chaos_soak`` mode and a tiny ``replay_bench``.

``param_dtype="bfloat16"``: both packages keep bf16 params and cast them
to the compute dtype (float32 in ``test_config``) at use, so the forward
agrees as float32 does (1e-5).  Learner steps: the loss comes from the
same bf16 params (1e-5 relative); the gradients are computed in float32
and rounded to bf16 on both sides, where a last-bit difference of the
float32 sums can cross a bf16 rounding boundary, and the moments carry
that one-ulp difference of a gradient forward.  Over three clip + Adam
steps (measured on this CPU): the params within 6.5e-7 of each leaf's
largest magnitude (the held bound: 2^-8, one bf16 ulp), the moments
within 5.6e-3 of it (held: 2^-6, two ulps of a moment's largest entry).
"""
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu import actor as jactor
from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu.envs import FakeAtariEnv as JaxFakeEnv
from r2d2_tpu.learner import step as jstep
from r2d2_tpu.models.network import create_network as jax_create
from r2d2_tpu.models.network import init_params
from r2d2_tpu.parallel.sharding import pjit_train_step
from r2d2_tpu.utils.batch import synthetic_batch as jax_synthetic_batch
from r2d2_tpu.utils.store import ParamStore as JaxParamStore
from r2d2_tpu_torch import actor as tactor
from r2d2_tpu_torch import bench
from r2d2_tpu_torch import train as ttrain
from r2d2_tpu_torch.checkpoint import Checkpointer
from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.envs import FakeAtariEnv
from r2d2_tpu_torch.evaluate import evaluate_sweep
from r2d2_tpu_torch.learner import step as tstep
from r2d2_tpu_torch.models import create_network, params_from_flax
from r2d2_tpu_torch.models.convert import train_state_from_jax
from r2d2_tpu_torch.sweep import ATARI_57, run_sweep
from r2d2_tpu_torch.utils.batch import synthetic_batch
from r2d2_tpu_torch.utils.store import ParamStore

A = 4


def env_factory(cfg, seed):
    return FakeAtariEnv(obs_shape=cfg.stored_obs_shape, action_dim=A,
                        seed=seed)


def cpu_config(**kw):
    return port_test_config(game_name="Fake", act_device="cpu", **kw)


# ----------------------------------------------------------- synthetic batch

@pytest.mark.parametrize("cfg_kw", [
    dict(), dict(batch_size=3, lstm_layers=2),
    dict(obs_space_to_depth=True, obs_shape=(84, 84, 1), torso="nature")],
    ids=["test", "two_layers", "s2d"])
def test_synthetic_batch_is_bitwise_jax(cfg_kw):
    a = synthetic_batch(port_test_config(**cfg_kw), 6,
                        np.random.default_rng(3))
    b = jax_synthetic_batch(jax_test_config(**cfg_kw), 6,
                            np.random.default_rng(3))
    assert list(a) == list(b)
    for k in b:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------------------------- Actor

@pytest.mark.parametrize("episode_len", [10, 40])
def test_actor_block_stream_matches_jax(episode_len):
    """One env, ε 0.4, 60 steps, terminal and boundary cuts (and the
    13-step cap at episode_len 40) through the real act on converted
    params."""
    kw = dict(max_episode_steps=13, actor_update_interval=5)
    jcfg = jax_test_config(**kw)
    cfg = port_test_config(act_device="cpu", **kw)
    jnet = jax_create(jcfg, A)
    params = init_params(jcfg, jnet, jax.random.PRNGKey(4))
    net = create_network(cfg, A, device="cpu")
    sinks = ([], [])
    ref = jactor.Actor(jcfg, JaxFakeEnv(jcfg.obs_shape, A, episode_len,
                                        seed=1), 0.4,
                       jactor.make_act_fn(jcfg, jnet), JaxParamStore(params),
                       sink=lambda *item: sinks[0].append(item),
                       rng=np.random.default_rng(9))
    port = tactor.Actor(cfg, FakeAtariEnv(cfg.obs_shape, A, episode_len,
                                          seed=1), 0.4,
                        tactor.make_host_act_fn(net),
                        ParamStore(params_from_flax(jax.device_get(params))),
                        sink=lambda *item: sinks[1].append(item),
                        rng=np.random.default_rng(9))
    assert isinstance(port, tactor.VectorActor) and port.N == 1
    ref.run(60)
    port.run(60)
    want, got = sinks
    assert len(got) == len(want) > 0
    for (b, p, r), (bw, pw, rw) in zip(got, want):
        for f in bw.__dataclass_fields__:
            if f in ("cut_ts", "trace_id", "member_id"):
                continue
            x, y = getattr(b, f), getattr(bw, f)
            if f == "hidden":
                np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)
            elif isinstance(y, np.ndarray):
                assert x.dtype == y.dtype, f
                np.testing.assert_array_equal(x, y, err_msg=f)
            else:
                assert x == y, f
        np.testing.assert_allclose(p, pw, rtol=0, atol=1e-5)
        assert r == rw
    assert port.actor_steps == ref.actor_steps == 60


# ----------------------------------------------------- evaluator follow mode

def save_step(ck: Checkpointer, cfg, step: int) -> None:
    net = create_network(cfg, A, device="cpu",
                         generator=torch.Generator().manual_seed(step))
    ck.save(step, tstep.create_train_state(cfg, net.state_dict()),
            dict(env_steps=100 * step, minutes=0.5 * step))


@pytest.mark.parametrize("ending", ["stop", "timeout"])
def test_follow_mode_trails_a_run_and_ends(ending, tmp_path):
    """A checkpoint written after the sweep started is picked up; the
    curve file is rewritten as each record lands; the sweep ends on
    ``stop()`` (with a final drain) or after ``follow_timeout`` seconds
    without a new checkpoint; the plot is written (matplotlib imports
    here)."""
    pytest.importorskip("matplotlib")
    cfg = cpu_config(eval_episodes=1, max_episode_steps=8)
    ck = Checkpointer(str(tmp_path / "ck"))
    save_step(ck, cfg, 2)
    done = threading.Event()
    out_json, out_plot = str(tmp_path / "c.json"), str(tmp_path / "c.png")
    result = {}

    def run():
        result["curve"] = evaluate_sweep(
            cfg, ck.directory, env_factory, episodes=1, out_json=out_json,
            out_plot=out_plot, action_dim=A, follow=True,
            follow_timeout=(1.0 if ending == "timeout" else "default"),
            poll_interval=0.05,
            stop=done.is_set if ending == "stop" else None, device="cpu")

    th = threading.Thread(target=run)
    t0 = time.monotonic()
    th.start()
    deadline = time.monotonic() + 30
    while not os.path.exists(out_json) and time.monotonic() < deadline:
        time.sleep(0.02)
    with open(out_json) as f:
        assert [c["step"] for c in json.load(f)] == [2]
    save_step(ck, cfg, 4)
    if ending == "stop":
        time.sleep(0.3)
        save_step(ck, cfg, 6)
        done.set()
    th.join(30)
    assert not th.is_alive()
    want = [2, 4, 6] if ending == "stop" else [2, 4]
    assert [c["step"] for c in result["curve"]] == want
    with open(out_json) as f:
        assert json.load(f) == result["curve"]
    assert result["curve"][1]["env_frames"] == 400 * cfg.frameskip
    assert result["curve"][1]["minutes"] == 2.0
    assert os.path.getsize(out_plot) > 0
    if ending == "timeout":
        assert time.monotonic() - t0 >= 1.0


def test_plot_is_skipped_without_matplotlib(tmp_path, monkeypatch):
    import builtins

    from r2d2_tpu_torch import evaluate

    real = builtins.__import__

    def no_mpl(name, *a, **k):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    path = str(tmp_path / "c.png")
    assert evaluate._plot_curve(cpu_config(), [dict(
        step=1, env_frames=4, minutes=0.1, mean_reward=1.0)], path) is False
    assert not os.path.exists(path)


# ---------------------------------------------------------------- the sweep

def sweep_config():
    return cpu_config(training_steps=6, save_interval=3, eval_episodes=2,
                      max_episode_steps=12)


def test_atari57_list_is_57_games():
    assert len(ATARI_57) == 57 and len(set(ATARI_57)) == 57


def test_sweep_two_games_and_resume(tmp_path):
    cfg = sweep_config()
    out = str(tmp_path / "sweep")
    games = ["GameA", "GameB"]
    summary = run_sweep(games, cfg, out, env_factory=env_factory,
                        eval_episodes=1, verbose=False, device="cpu",
                        max_wall_seconds_per_game=120)
    assert set(summary) == set(games)
    for g in games:
        assert os.path.isdir(os.path.join(out, g))
        assert summary[g]["num_updates"] >= 6
        assert summary[g]["curve"], "evaluator produced no curve"
        assert summary[g]["final_reward"] is not None
        # the JAX package's summary keys
        assert set(summary[g]) == {"num_updates", "env_steps", "minutes",
                                   "mean_loss", "curve", "final_reward"}
    with open(os.path.join(out, "sweep.json")) as f:
        assert json.load(f) == json.loads(json.dumps(summary))

    def exploding_train(*a, **k):
        raise AssertionError("train_fn called for a completed game")

    assert run_sweep(games, cfg, out, env_factory=env_factory,
                     train_fn=exploding_train, verbose=False,
                     device="cpu") == json.loads(json.dumps(summary))


def test_sweep_reenters_partially_trained_game(tmp_path):
    """A game cut short records its partial num_updates and re-enters
    training on the next sweep instead of being skipped; the device goes
    to train_fn and to the evaluator."""
    cfg = sweep_config()
    out = str(tmp_path / "sweep")
    os.makedirs(out)
    with open(os.path.join(out, "sweep.json"), "w") as f:
        json.dump({"GameA": dict(num_updates=2, env_steps=100, minutes=0.1,
                                 mean_loss=1.0, curve=[],
                                 final_reward=None)}, f)
    calls = []

    def counting_train(*a, **k):
        calls.append(k["device"])
        return ttrain.train(*a, **k)

    summary = run_sweep(["GameA"], cfg, out, env_factory=env_factory,
                        train_fn=counting_train, eval_episodes=1,
                        verbose=False, device="cpu",
                        max_wall_seconds_per_game=120)
    assert calls == ["cpu"]
    assert summary["GameA"]["num_updates"] >= cfg.training_steps


# ------------------------------------------------------------------- bench

def fake_phases(failing=()):
    """A ``_run_phase`` stand-in: the micro children report an H100, the
    system and actor children their rates; labels in ``failing`` fail."""
    seen = []

    def run_phase(phase, timeout_s, extra=(), label=None):
        label = label or phase
        seen.append(label)
        if label in failing:
            return None, f"{label} phase failed (rc=1): injected"
        if phase == "micro":
            return (dict(learner_fps=123456.0, steps_per_sec=42.0,
                         flops=2e12, platform="gpu",
                         device_kind="NVIDIA H100 80GB HBM3"), "")
        if phase == "system":
            return dict(system_fps=2.0, top_spans={}, updates=3), ""
        return dict(actor_fps=2400.0), ""

    return run_phase, seen


def test_bench_headline_survives_actor_and_system_failures(monkeypatch,
                                                           capsys):
    """The headline learner metric survives failed actor and system
    children (the one JSON line must not be zeroed by a late failure)."""
    monkeypatch.setattr(bench, "_device_probe", lambda *a, **k: (True, ""))
    failing = ("system", "system_ingraph", "actor", "actor_process",
               "actor_process_serve")
    run_phase, _ = fake_phases(failing)
    monkeypatch.setattr(bench, "_run_phase", run_phase)
    bench._main_isolated(steps=1, warmup=0, system_seconds=0.1)
    result = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert result["metric"] == "learner_env_frames_per_sec"
    assert result["value"] == 123456.0
    assert result["vs_baseline"] == round(123456.0 / bench.NORTH_STAR_FPS, 3)
    assert result["actor_env_frames_per_sec"] == -1.0
    assert result["system_env_frames_per_sec"] == -1.0
    assert set(result["phase_errors"]) == set(failing)


def test_bench_json_line_is_the_only_stdout_line(monkeypatch, capsys):
    """The one JSON line goes to stdout alone; the platform line to
    stderr."""
    monkeypatch.setattr(bench, "_device_probe", lambda *a, **k: (True, ""))
    monkeypatch.setattr(bench, "_run_phase", fake_phases()[0])
    bench._main_isolated(steps=1, warmup=0, system_seconds=0.1)
    out = capsys.readouterr()
    lines = [ln for ln in out.out.splitlines() if ln.strip()]
    assert len(lines) == 1
    parsed = json.loads(lines[0])
    assert np.isclose(parsed["system_env_frames_per_sec"], 2.0)
    assert out.err.startswith("# platform=gpu kind=NVIDIA H100")


def test_bench_reports_unreachable_device_as_artifact(monkeypatch, capsys):
    """A card that does not answer yields a parseable JSON line and a
    nonzero exit rather than a hang with no artifact."""
    monkeypatch.setattr(bench, "_device_probe",
                        lambda *a, **k: (False, "probe timed out"))
    with pytest.raises(SystemExit) as ex:
        bench._main_isolated(steps=1, warmup=0, system_seconds=0.1)
    assert ex.value.code == 1
    result = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert result["value"] == -1.0
    assert "unreachable" in result["error"]


def test_device_probe_is_a_bounded_child_that_fails_without_a_card():
    """The probe brings up CUDA in a child, never in this process; on a
    machine without a card it reports the child's failure."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    ok, reason = bench._device_probe(timeout_s=120)
    assert not ok and "rc=" in reason


def test_isolated_bench_composes_phase_results(monkeypatch, capsys):
    """A wedged system phase surfaces as -1 + phase_errors while the
    already-banked micro headline survives; MFU from the micro child's
    FLOPs and card name against the H100's dense bf16 peak."""
    monkeypatch.setattr(bench, "_device_probe", lambda *a, **k: (True, ""))
    run_phase, seen = fake_phases(("system",))
    monkeypatch.setattr(bench, "_run_phase", run_phase)
    bench._main_isolated(steps=1, warmup=0, system_seconds=0.1)
    result = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert seen == ["micro", "micro_fused", "system", "system_ingraph",
                    "actor", "actor_process", "actor_process_serve"]
    assert result["value"] == 123456.0
    assert result["system_env_frames_per_sec"] == -1.0
    assert result["system_ingraph_env_frames_per_sec"] == 2.0
    assert set(result["phase_errors"]) == {"system"}
    for label in ("actor", "actor_process", "actor_process_serve"):
        assert result[f"{label}_env_frames_per_sec"] == 2400.0
    assert result["achieved_tflops"] == 84.0
    assert result["mfu"] == round(2e12 * 42.0 / 1e12 / 989.0, 4)


def test_isolated_bench_headline_failure_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(bench, "_device_probe", lambda *a, **k: (True, ""))
    monkeypatch.setattr(bench, "_run_phase",
                        lambda phase, t, extra=(), label=None:
                        (None, f"{label or phase} died"))
    with pytest.raises(SystemExit) as ex:
        bench._main_isolated(steps=1, warmup=0, system_seconds=0.1)
    assert ex.value.code == 1
    result = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert result["value"] == -1.0
    assert set(result["phase_errors"]) == {
        "micro", "micro_fused", "system", "system_ingraph", "actor",
        "actor_process", "actor_process_serve"}


def test_run_phase_parses_last_json_line(monkeypatch):
    """_run_phase picks the child's JSON result even when warnings or log
    lines surround it, and reports rc != 0 / no JSON as a reason."""
    import subprocess

    class FakeProc:
        def __init__(self, out, rc):
            self._out, self.returncode = out, rc

        def communicate(self, timeout=None):
            return self._out.encode(), b"some warning\n"

    def fake_popen(cmd, **kw):
        assert cmd[1:4] == ["-m", "r2d2_tpu_torch.bench", "--phase"]
        return FakeProc('log line\n{"actor_fps": 7.0}\n', 0)

    monkeypatch.setattr(subprocess, "Popen", fake_popen)
    assert bench._run_phase("actor", 5.0) == ({"actor_fps": 7.0}, "")
    monkeypatch.setattr(subprocess, "Popen",
                        lambda cmd, **kw: FakeProc("no json here\n", 0))
    res, err = bench._run_phase("actor", 5.0)
    assert res is None and "no JSON" in err
    monkeypatch.setattr(subprocess, "Popen",
                        lambda cmd, **kw: FakeProc("", 3))
    res, err = bench._run_phase("actor", 5.0)
    assert res is None and "rc=3" in err


def test_actor_plane_bench_fleet_split_counts_all_lanes(monkeypatch):
    """Every lane lands in exactly one fleet and every fleet runs its
    warm-up plus the timed iterations (on the CPU when asked)."""
    created = []
    real = tactor.VectorActor

    class Recording(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            created.append(self)

    monkeypatch.setattr(tactor, "VectorActor", Recording)
    fps = bench._actor_plane_bench(iterations=2, num_lanes=4, env_workers=0,
                                   fleets=2, act_device="cpu")
    assert fps > 0 and len(created) == 2
    assert sum(a.N for a in created) == 4
    assert all(a.actor_steps == 22 for a in created)


def test_flagship_flops_are_counted_on_a_step(monkeypatch):
    """FlopCounterMode counts the matmuls and convolutions of one train
    step's forward and backward; at a tiny width on the CPU the count is
    positive and stable from one step to the next."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = cpu_config()
    net = create_network(cfg, A, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    state = tstep.create_train_state(cfg, net.state_dict())
    step = tstep.make_train_step(cfg, net)
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(
        cfg, A, np.random.default_rng(0)).items()}
    counts = []
    for _ in range(2):
        with FlopCounterMode(display=False) as fc:
            state, loss, _ = step(state, batch)
        counts.append(fc.get_total_flops())
    assert counts[0] == counts[1] > 0


# ------------------------------------------------------ param_dtype bfloat16

def bf16_pair():
    """The JAX side's bf16 params, drawn in float32 and narrowed: its own
    bf16 init fails on the CPU (the orthogonal init's QR has no bf16
    LAPACK routine there)."""
    jcfg = jax_test_config(param_dtype="bfloat16")
    cfg = port_test_config(param_dtype="bfloat16", act_device="cpu")
    jnet = jax_create(jcfg, A)
    f32 = jax_create(jax_test_config(), A)

    def draw(seed):
        return jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                            init_params(jax_test_config(), f32,
                                        jax.random.PRNGKey(seed)))

    return jcfg, cfg, jnet, draw(2), draw(3)


def test_bf16_params_are_built_and_carried_across():
    jcfg, cfg, jnet, params, _ = bf16_pair()
    port = params_from_flax(jax.device_get(params))
    assert all(v.dtype == torch.bfloat16 for v in port.values())
    net = create_network(cfg, A, device="cpu")
    assert {v.dtype for v in net.state_dict().values()} == {torch.bfloat16}
    assert {k: v.shape for k, v in port.items()} == {
        k: v.shape for k, v in net.state_dict().items()}


def test_bf16_params_forward_matches_jax():
    jcfg, cfg, jnet, params, _ = bf16_pair()
    net = create_network(cfg, A, device="cpu")
    net.load_state_dict(params_from_flax(jax.device_get(params)))
    rng = np.random.default_rng(5)
    B, T = 3, 6
    args = (rng.integers(0, 255, (B, T, *cfg.obs_shape), dtype=np.uint8),
            np.eye(A, dtype=np.float32)[rng.integers(A, size=(B, T))],
            rng.normal(size=(B, T)).astype(np.float32),
            rng.normal(size=(B, 2, cfg.lstm_layers, cfg.hidden_dim)
                       ).astype(np.float32))
    jq, jh = jnet.apply(params, *(jnp.asarray(a) for a in args),
                        method=jnet.unroll)
    with torch.no_grad():
        q, h = net.unroll(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=0, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=1e-5)


def test_bf16_params_learner_step_matches_jax():
    """Three clip + Adam steps with bf16 params and bf16 moments on both
    sides (module docstring for the tolerances)."""
    from tests.test_torch_learner import make_batch, to_torch

    jcfg, cfg, jnet, params, target = bf16_pair()
    jstate = jstep.create_train_state(jcfg, params)
    jstate = jstate.replace(target_params=target)
    step_fn = pjit_train_step(jcfg, jnet, state_template=jstate)

    def port_state(st):
        s = jax.device_get(st)
        adam = s.opt_state[1][0]
        return train_state_from_jax(s.params, s.target_params, adam.mu,
                                    adam.nu, int(adam.count), int(s.step))

    state = port_state(jstate)
    assert state.opt_state.mu["head.adv_out.weight"].dtype == torch.bfloat16
    train_step = tstep.make_train_step(cfg, create_network(cfg, A,
                                                           device="cpu"))
    rng = np.random.default_rng(8)
    for _ in range(3):
        batch = make_batch(jcfg, rng, B=8)
        jstate, jloss, jprios = step_fn(jstate, batch)
        state, loss, prios = train_step(state, to_torch(batch))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(prios.numpy(), np.asarray(jprios),
                                   rtol=1e-5, atol=1e-5)
    ref = port_state(jstate)
    for name, tree, want, bound in (
            ("params", state.params, ref.params, 2 ** -8),
            ("mu", state.opt_state.mu, ref.opt_state.mu, 2 ** -6),
            ("nu", state.opt_state.nu, ref.opt_state.nu, 2 ** -6)):
        for k in want:
            got, exp = tree[k], want[k]
            assert got.dtype == exp.dtype == torch.bfloat16, (name, k)
            err = (got.float() - exp.float()).abs().max()
            assert err <= bound * exp.float().abs().max(), (name, k, err)


# --------------------------------------------------------------- slow tools

SOAK_MODES = ["", "--process", "--serve", "--anakin", "--shards",
              "--nethost", "--trace", "--sessions", "--league"]


@pytest.mark.slow
@pytest.mark.parametrize("mode", SOAK_MODES,
                         ids=[m.strip("-") or "default" for m in SOAK_MODES])
def test_chaos_soak_runs_one_round_per_mode(mode, tmp_path, capsys):
    """One short round of every mode on the CPU: the round's own
    invariants hold (the soak-level gates that need a longer soak — e.g.
    --nethost's >= 2 partitions — are not this test's)."""
    from r2d2_tpu_torch.tools import chaos_soak

    out = str(tmp_path / "soak.json")
    argv = ["0.1", "--device", "cpu", "--out", out] + ([mode] if mode else [])
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        chaos_soak.main(argv)
    finally:
        os.chdir(old)
    with open(out) as f:
        data = json.load(f)
    assert data["summary"]["rounds"] >= 1
    assert not [f for f in data["summary"]["failures"]
                if f.startswith("round ")]


@pytest.mark.slow
def test_replay_bench_tiny(tmp_path, monkeypatch):
    from r2d2_tpu_torch.tools import replay_bench

    monkeypatch.setattr(replay_bench, "INGEST_BLOCKS", 8)
    monkeypatch.setattr(replay_bench, "SAMPLE_BATCHES", 4)
    monkeypatch.setattr(replay_bench, "COMBINED_SECONDS", 0.5)
    real_cfg = replay_bench.bench_cfg
    monkeypatch.setattr(replay_bench, "bench_cfg", lambda **kw: real_cfg(
        **dict(dict(obs_shape=(12, 12, 1), batch_size=8), **kw)))
    out, doc = str(tmp_path / "r.json"), str(tmp_path / "r.md")
    assert replay_bench.main(["--out", out, "--doc", doc]) == 0
    with open(out) as f:
        data = json.load(f)
    assert [r["cell"] for r in data["results"]] == [
        "inprocess", "sharded_k1", "sharded_k2", "sharded_k4",
        "socket_k1", "socket_k2", "socket_k4"]
    assert all(r["sample_batches_per_sec"] > 0 for r in data["results"])
    assert "| socket_k4 |" in open(doc).read()
