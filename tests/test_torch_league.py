"""The port's league (``r2d2_tpu_torch/league``) against the JAX package's,
on the CPU at test sizes (mlp torso, H = 16, float32).

- ``build_members``, ``population_epsilons`` and ``assert_wire_compatible``
  equal JAX's for the same spec (members, overrides and epsilons exact),
  and the wire check raises on a forced layout change in both packages;
- ``league_table`` equals JAX's on the same rows (a partial sweep, the
  ``num_members`` denominator);
- ``member_suite``: held-out seeds, the adapter lane, the ``create_env``
  lanes byte for byte JAX's, and the adapter lane bitwise JAX's
  ``JittableEnvAdapter`` when fed JAX's reset draws;
- the sidecar (``run_once``) on the port's checkpoints: rows with the
  reference's keys and values (JAX's sidecar on the same params), the
  cursor resumed with no duplicates, arch-incompatible steps skipped, and
  each ``create_env`` lane's return exactly JAX's ``run_episodes``' on the
  same params (``models/convert.py``), seeds and rng — exact returns,
  with the q argmax checked to agree at every step;
- ``Learner._save`` never rewrites a complete step under a live follower;
- the population half of the process plane: each fleet's spec (member 1's
  ladder from ``population_epsilons``), the member tag on the block wire,
  and a member whose real game needs the ALE refused at ``train()``'s
  start, naming it;
- ``train()`` with a 2-member population and the sidecar: the
  kill-sidecar drill (``/healthz`` degraded, training on) and, ``slow``,
  the acceptance run with 2 live sweeps on ``/statusz``.

Spawned children unpickle their env factory by reference, so the train-
level runs use the port's default factory (``create_env``, the fake env),
whose module does not import JAX.
"""
import dataclasses
import http.client
import json
import multiprocessing as mp
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu.league import eval_service as jsvc
from r2d2_tpu.league import population as jpop
from r2d2_tpu.league import scenarios as jscen
from r2d2_tpu_torch import train as ttrain
from r2d2_tpu_torch.checkpoint import Checkpointer, arch_meta
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.league import eval_service as psvc
from r2d2_tpu_torch.league import population as ppop
from r2d2_tpu_torch.league import scenarios as pscen
from r2d2_tpu_torch.learner.step import create_train_state
from r2d2_tpu_torch.models import create_network, params_from_flax

A = 4
SPEC_2 = json.dumps([{"name": "base"},
                     {"name": "low", "preset": "low_resource"}])
SPEC_3 = json.dumps([{"name": "a", "seed": 11, "base_eps": 0.5},
                     {"preset": "low_resource", "eps_alpha": 3.0},
                     {"name": "c", "gamma": 0.95, "test_epsilon": 0.05}])
POP = dict(game_name="Fake", actor_transport="process", num_actors=4,
           actor_fleets=2, population_spec=SPEC_2)
ROW_KEYS = {"kind", "time", "step", "member", "member_name", "game",
            "episodes", "mean_reward", "env_frames", "minutes",
            "incarnation"}


def port_cfg(**kw):
    return port_test_config(**{**POP, "act_device": "cpu", **kw})


def jax_cfg(**kw):
    return jax_test_config(**{**POP, **kw})


def http_get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read().decode()
    finally:
        conn.close()


def poll(pred, seconds, interval=0.1):
    deadline = time.time() + seconds
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


# ------------------------------------------------------------ the members

MEMBER_CASES = [(SPEC_2, 4, 2), (SPEC_3, 7, 3), ("", 5, 1)]


@pytest.mark.parametrize("spec,actors,fleets", MEMBER_CASES,
                         ids=["two", "three_uneven", "degenerate"])
def test_members_and_epsilons_equal_jax(spec, actors, fleets):
    kw = dict(POP, population_spec=spec, num_actors=actors,
              actor_fleets=fleets)
    pcfg, jcfg = port_test_config(**kw), jax_test_config(**kw)
    pm, jm = ppop.build_members(pcfg), jpop.build_members(jcfg)
    assert len(pm) == len(jm) == fleets
    for p, j in zip(pm, jm):
        assert (p.member_id, p.name, p.preset, p.overrides) == (
            j.member_id, j.name, j.preset, j.overrides)
        for f in ("game_name", "seed", "base_eps", "eps_alpha", "gamma",
                  "test_epsilon", "max_episode_steps", "population_spec"):
            assert getattr(p.cfg, f) == getattr(j.cfg, f), f
    assert (ppop.population_epsilons(pcfg, pm)
            == jpop.population_epsilons(jcfg, jm))
    ppop.assert_wire_compatible(pcfg, pm, A)
    if not spec:
        assert pm[0].cfg is pcfg


def test_wire_compat_raises_on_a_forced_layout_change():
    """A member whose config changes the block slot layout (which the
    whitelist forbids, so it is forced past it here) is refused by both
    packages, naming it."""
    pcfg, jcfg = port_cfg(), jax_cfg()
    bad = []
    for pkg, cfg in ((ppop, pcfg), (jpop, jcfg)):
        members = pkg.build_members(cfg)
        members[1] = dataclasses.replace(
            members[1], cfg=dataclasses.replace(members[1].cfg,
                                                block_length=16))
        with pytest.raises(ValueError, match=r"member 1 \(low\) changes"):
            pkg.assert_wire_compatible(cfg, members, A)
        bad.append(members)
    with pytest.raises(ValueError, match="one fleet per member"):
        from r2d2_tpu_torch.parallel.actor_procs import ProcessFleetPlane

        ProcessFleetPlane(pcfg, A, ttrain._default_env_factory, [0.1] * 4,
                          members=bad[0][:1])


# ------------------------------------------------------- the league table

def _rows(seed, n_steps=4, members=(0, 1, 2), drop=0.3):
    rng = np.random.default_rng(seed)
    rows = []
    for step in range(2, 2 + 2 * n_steps, 2):
        for m in members:
            if rng.random() < drop:
                continue          # a partial sweep
            rows.append(dict(kind="eval", step=step, member=m,
                             member_name=f"m{m}", game="Fake",
                             mean_reward=float(rng.integers(-5, 20))))
    rows.append(dict(kind="other", step=99))
    return rows


@pytest.mark.parametrize("num_members", [None, 2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_league_table_equals_jax(seed, num_members):
    rows = _rows(seed)
    assert psvc.league_table(rows, num_members) == jsvc.league_table(
        rows, num_members)


def test_league_table_reference_case():
    rows = [dict(kind="eval", step=2, member=0, member_name="base",
                 game="Fake", mean_reward=1.0),
            dict(kind="eval", step=2, member=1, member_name="low",
                 game="Fake", mean_reward=5.0),
            dict(kind="eval", step=4, member=0, member_name="base",
                 game="Fake", mean_reward=3.0),
            dict(kind="other")]
    t = psvc.league_table(rows, num_members=2)
    assert t == jsvc.league_table(rows, num_members=2)
    assert t["rows"] == 3 and t["last_step"] == 4 and t["sweeps"] == 1
    assert [r["member"] for r in t["table"]] == [1, 0]
    assert psvc.league_table(rows[:1], num_members=2)["sweeps"] == 0
    assert psvc.league_table([], 2) == jsvc.league_table([], 2)


# ------------------------------------------------------------- the suites

def _step_all(envs, actions):
    out = []
    for env, a in zip(envs, actions):
        obs, r, term, trunc, _ = env.step(int(a))
        out.append((np.asarray(obs).tobytes(), r, term, trunc))
        if term or trunc:
            out.append(np.asarray(env.reset()[0]).tobytes())
    return out


@pytest.mark.parametrize("member_id", [0, 1])
def test_member_suite_lanes_equal_jax(member_id):
    """The held-out suite: the same seeds as JAX's (disjoint from
    training's and across members), ``episodes - 1`` create_env lanes byte
    for byte JAX's over 40 steps (a truncation and a reset included), and
    an adapter lane last."""
    E = 3
    assert pscen.HELD_OUT_SEED_BASE == jscen.HELD_OUT_SEED_BASE
    pcfg, jcfg = port_cfg(), jax_cfg()
    pm = ppop.build_members(pcfg)[member_id]
    jm = jpop.build_members(jcfg)[member_id]
    penvs = pscen.member_suite(pm.cfg, member_id, E, A)
    jenvs = jscen.member_suite(jm.cfg, member_id, E, A)
    assert isinstance(penvs[-1], pscen.JittableEnvAdapter)
    assert isinstance(jenvs[-1], jscen.JittableEnvAdapter)
    p0 = [np.asarray(e.reset()[0]).tobytes() for e in penvs[:-1]]
    j0 = [np.asarray(e.reset()[0]).tobytes() for e in jenvs[:-1]]
    assert p0 == j0
    rng = np.random.default_rng(member_id)
    for _ in range(40):
        acts = rng.integers(A, size=E - 1)
        assert _step_all(penvs[:-1], acts) == _step_all(jenvs[:-1], acts)
    pscen.close_suite(penvs)
    # held out: a training env (seed cfg.seed + lane) resets elsewhere
    train_env = ttrain._default_env_factory(pm.cfg, pm.cfg.seed)
    fresh = pscen.member_suite(pm.cfg, member_id, E, A)[0]
    assert ([train_env.reset()[0].tobytes() for _ in range(8)]
            != [fresh.reset()[0].tobytes() for _ in range(8)])


def test_member_suites_are_disjoint_across_members():
    cfg = port_cfg()
    e0 = pscen.member_suite(cfg, 0, 2, A)[0]
    e1 = pscen.member_suite(cfg, 1, 2, A)[0]
    assert ([e0.reset()[0].tobytes() for _ in range(8)]
            != [e1.reset()[0].tobytes() for _ in range(8)])


def test_adapter_lane_is_jax_adapter_with_jax_draws():
    """The adapter lane over the port's AnakinFakeEnv, fed the reset
    phases JAX's adapter drew: observations, rewards and truncation bit
    for bit JAX's over 70 steps (two truncations, three resets), the
    gym 5-tuple API, ``terminated`` always False."""
    cfg = port_cfg()
    padapt = pscen.member_suite(cfg, 0, 2, A)[-1]
    jadapt = jscen.member_suite(jax_cfg(), 0, 2, A)[-1]
    assert padapt.action_space.n == jadapt.action_space.n == A

    def reset_both():
        jobs, _ = jadapt.reset()
        phase = torch.tensor(np.asarray(jadapt._state["phase"]))
        pobs, _ = padapt.reset(draws={"phase": phase})
        assert pobs.shape == cfg.stored_obs_shape and pobs.dtype == np.uint8
        np.testing.assert_array_equal(pobs, np.asarray(jobs))

    reset_both()
    rng = np.random.default_rng(5)
    truncations = 0
    for t in range(70):
        a = int(rng.integers(A))
        po, pr, pterm, ptr, _ = padapt.step(a)
        jo, jr, jterm, jtr, _ = jadapt.step(a)
        np.testing.assert_array_equal(po, np.asarray(jo))
        assert (pr, pterm, ptr) == (jr, jterm, jtr) and not pterm
        if ptr:
            truncations += 1
            reset_both()
    assert truncations == 2
    with pytest.raises(ValueError, match="one lane"):
        from r2d2_tpu_torch.envs.anakin import AnakinFakeEnv

        pscen.JittableEnvAdapter(AnakinFakeEnv(num_lanes=2, device="cpu"))


def test_adapter_reset_stream_is_deterministic_per_seed():
    """Without injected draws the adapter's resets come from its own
    stream: the same seed replays the same phases, a reseed restarts it."""
    cfg = port_cfg()

    def phases(adapter, n):
        return [adapter.reset()[0].tobytes() for _ in range(n)]

    a = pscen.member_suite(cfg, 0, 2, A)[-1]
    b = pscen.member_suite(cfg, 0, 2, A)[-1]
    first = phases(a, 12)
    assert first == phases(b, 12) and len(set(first)) > 1
    a.reset(seed=a._seed)
    assert phases(a, 11) == first[1:]


# -------------------------------------------------------------- the sidecar

def _flax_params(seed):
    from r2d2_tpu.models.network import create_network as jax_create
    from r2d2_tpu.models.network import init_params

    jcfg = jax_cfg()
    return jax.device_get(init_params(jcfg, jax_create(jcfg, A),
                                      jax.random.PRNGKey(seed)))


def _save_port(ckdir, cfg, step, flax):
    state = create_train_state(cfg, params_from_flax(flax))
    Checkpointer(ckdir).save(step, state, meta=dict(
        env_steps=100 * step, minutes=0.1 * step, **arch_meta(cfg)))


def _save_jax(ckdir, cfg, step, flax):
    from r2d2_tpu.checkpoint import Checkpointer as JaxCheckpointer
    from r2d2_tpu.checkpoint import arch_meta as jax_arch_meta

    JaxCheckpointer(ckdir).save(step, {"params": flax}, meta=dict(
        env_steps=100 * step, minutes=0.1 * step, **jax_arch_meta(cfg)))


@pytest.fixture(scope="module")
def flax_params():
    return {seed: _flax_params(seed) for seed in (0, 1)}


def test_sidecar_rows_follow_and_resume_like_jax(tmp_path, flax_params):
    """Both sidecars drain the same two checkpoints: one row per (step,
    member), the reference's keys on every row and its values on every
    field the suite's adapter lane does not touch; a second port run (a
    respawn) adds nothing; a third checkpoint adds only its own rows."""
    pcfg = port_cfg(league_eval_episodes=2)
    jcfg = jax_cfg(league_eval_episodes=2)
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    for step in (2, 4):
        _save_port(pdir, pcfg, step, flax_params[0])
        _save_jax(jdir, jcfg, step, flax_params[0])
    psvc._sidecar_main(pcfg, pdir, A, threading.Event(), run_once=True)
    jsvc._sidecar_main(jcfg, jdir, A, threading.Event(), run_once=True)
    prows, jrows = psvc.read_league(pdir), jsvc.read_league(jdir)
    pairs = [(r["step"], r["member"]) for r in prows]
    assert sorted(pairs) == [(2, 0), (2, 1), (4, 0), (4, 1)]
    assert len(prows) == len(jrows)
    for p, j in zip(sorted(prows, key=lambda r: (r["step"], r["member"])),
                    sorted(jrows, key=lambda r: (r["step"], r["member"]))):
        assert set(p) == set(j) == ROW_KEYS
        for k in ROW_KEYS - {"time", "mean_reward"}:
            assert p[k] == j[k], k
        assert np.isfinite(p["mean_reward"])
    before = {(r["step"], r["member"]): r["mean_reward"] for r in prows}

    # a respawn resumes the cursor from league.jsonl: no new row
    psvc._sidecar_main(pcfg, pdir, A, threading.Event(), run_once=True,
                       incarnation=1)
    assert len(psvc.read_league(pdir)) == 4
    _save_port(pdir, pcfg, 6, flax_params[1])
    psvc._sidecar_main(pcfg, pdir, A, threading.Event(), run_once=True,
                       incarnation=1)
    rows = psvc.read_league(pdir)
    pairs = [(r["step"], r["member"]) for r in rows]
    assert len(rows) == 6 and len(set(pairs)) == 6
    assert all(r["incarnation"] == 1 for r in rows if r["step"] == 6)
    for r in rows:   # held-out determinism: the same eval, the same score
        if (r["step"], r["member"]) in before:
            assert r["mean_reward"] == before[(r["step"], r["member"])]
    t = psvc.league_table(rows, num_members=2)
    assert t["sweeps"] == 3 and len(t["table"]) == 2


def test_sidecar_pin_hides_the_card_and_refuses_a_live_context(
        monkeypatch):
    """The spawned sidecar's first act: CUDA_VISIBLE_DEVICES="" and one
    thread; a CUDA context already in the process (torch initialised, or
    an NVIDIA device file held) is refused rather than run beside."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    threads = torch.get_num_threads()
    try:
        psvc._pin_to_cpu()
        assert os.environ["CUDA_VISIBLE_DEVICES"] == ""
        assert torch.get_num_threads() == 1
        assert psvc.card_handles() == []
        initialized = torch.cuda.is_initialized
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        with pytest.raises(RuntimeError, match="never touch"):
            psvc._pin_to_cpu()
        monkeypatch.setattr(torch.cuda, "is_initialized", initialized)
        monkeypatch.setattr(psvc, "card_handles",
                            lambda pid="self": ["/dev/nvidiactl"])
        with pytest.raises(RuntimeError, match="nvidiactl"):
            psvc._pin_to_cpu()
    finally:
        torch.set_num_threads(threads)


def test_sidecar_skips_arch_incompatible_steps(tmp_path, flax_params):
    cfg = port_cfg(league_eval_episodes=1)
    d = str(tmp_path)
    _save_port(d, cfg, 2, flax_params[0])
    wide = cfg.replace(hidden_dim=cfg.hidden_dim * 2)
    net = create_network(wide, A, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    Checkpointer(d).save(4, create_train_state(wide, net.state_dict()),
                         meta=dict(env_steps=400, minutes=0.4,
                                   **arch_meta(wide)))
    psvc._sidecar_main(cfg, d, A, threading.Event(), run_once=True)
    assert sorted({r["step"] for r in psvc.read_league(d)}) == [2]


def test_sidecar_skips_a_torn_step_after_its_strikes(tmp_path, flax_params):
    """A committed step whose payload is torn: run_once skips it at the
    first failed restore and scores the rest."""
    cfg = port_cfg(league_eval_episodes=1)
    d = str(tmp_path)
    _save_port(d, cfg, 2, flax_params[0])
    _save_port(d, cfg, 4, flax_params[1])
    with open(tmp_path / "step_2" / "state.pt", "wb") as f:
        f.write(b"torn")
    psvc._sidecar_main(cfg, d, A, threading.Event(), run_once=True)
    assert sorted({r["step"] for r in psvc.read_league(d)}) == [4]


@pytest.mark.parametrize("member_id", [0, 1])
def test_sidecar_lane_returns_equal_jax_run_episodes(member_id, flax_params):
    """One sweep's rollouts as the sidecars run them: the member's suite,
    its test epsilon and the per-(step, member) rng.  Each create_env
    lane's return equals JAX's ``run_episodes`` on the same params
    exactly, with the greedy action (q argmax) checked to agree on those
    lanes at every step; the adapter lane's stream is the port's own."""
    from r2d2_tpu.evaluate import run_episodes as jax_run_episodes
    from r2d2_tpu.models.network import create_network as jax_create

    from r2d2_tpu_torch.actor import make_host_act_fn
    from r2d2_tpu_torch.evaluate import run_episodes
    from r2d2_tpu_torch.parallel.actor_procs import fleet_act_config

    E, step = 4, 6
    pcfg, jcfg = port_cfg(), jax_cfg()
    pm = ppop.build_members(pcfg)[member_id]
    jm = jpop.build_members(jcfg)[member_id]
    flax = flax_params[member_id]
    pnet = create_network(fleet_act_config(pcfg), A, device="cpu")
    p_act = make_host_act_fn(pnet, psvc.LEAGUE_ACT)
    seen = {"port": [], "jax": []}

    def recording(fn, key):
        def act(*args):
            q, h = fn(*args)
            seen[key].append(np.asarray(q).argmax(axis=1))
            return q, h
        return act

    from r2d2_tpu.actor import make_act_fn as jax_make_act_fn

    jnet = jax_create(jcfg, A)
    rng_seed = [pscen.HELD_OUT_SEED_BASE, member_id, step]
    pret = run_episodes(pm.cfg, pnet, params_from_flax(flax),
                        pscen.member_suite(pm.cfg, member_id, E, A),
                        epsilon=pm.cfg.test_epsilon,
                        rng=np.random.default_rng(rng_seed),
                        act_fn=recording(p_act, "port"))
    jret = jax_run_episodes(jm.cfg, jnet, flax,
                            jscen.member_suite(jm.cfg, member_id, E, A),
                            epsilon=jm.cfg.test_epsilon,
                            rng=np.random.default_rng(rng_seed),
                            act_fn=recording(jax_make_act_fn(jcfg, jnet),
                                             "jax"))
    assert len(seen["port"]) == len(seen["jax"]) > 0
    for p, j in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(p[:E - 1], j[:E - 1])
    assert pret[:E - 1] == jret[:E - 1]
    assert all(np.isfinite(pret))


# ------------------------------------------------- Learner._save follow pin

def test_learner_save_skip_complete_under_live_follower(tmp_path):
    """A saver thread saves steps 1..5, each twice (the epilogue's
    duplicate save lands on a cadence step), while a follower restores
    each step as soon as it is complete: every restore succeeds, and the
    checkpointer wrote each step exactly once."""
    from r2d2_tpu_torch.learner.learner import Learner

    cfg = port_test_config(act_device="cpu")
    net = create_network(cfg, A, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    ckpt = Checkpointer(str(tmp_path))
    saves = []
    real_save = ckpt.save
    ckpt.save = lambda step, st, meta=None: (
        saves.append(step), real_save(step, st, meta=meta))[-1]
    learner = Learner(cfg, net, create_train_state(cfg, net.state_dict()),
                      checkpointer=ckpt)
    steps = [1, 2, 3, 4, 5]
    failures, seen = [], set()

    def saver():
        t0 = time.time()
        for s in steps:
            learner._save(s, t0)
            learner._save(s, t0)      # the epilogue collision: skipped
            time.sleep(0.02)

    th = threading.Thread(target=saver)
    th.start()
    deadline = time.time() + 60
    try:
        while len(seen) < len(steps) and time.time() < deadline:
            s = ckpt.latest_step()
            if s is None or s in seen:
                time.sleep(0.002)
                continue
            try:
                state, meta = ckpt.restore(s)
                assert state.params and meta["step"] == s
            except Exception as e:    # a torn read is the regression
                failures.append((s, repr(e)))
            seen.add(s)
    finally:
        th.join(60)
    assert not failures, failures
    assert seen == set(steps) and sorted(saves) == steps


# -------------------------------------------- the population process plane

@pytest.mark.parametrize("mode", ["local", "serve"])
def test_each_fleet_runs_its_members_config_and_ladder(mode):
    """The plane's specs, read before any spawn: fleet f carries member
    f's id, its config and its own ladder from ``population_epsilons``
    (member 1's is the low_resource preset's, not the base ladder); the
    channel stays laid out under the base config."""
    from r2d2_tpu_torch.parallel.actor_procs import ProcessFleetPlane
    from r2d2_tpu_torch.utils.math import epsilon_ladder

    cfg = port_cfg(actor_inference=mode)
    members = ppop.build_members(cfg)
    eps = ppop.population_epsilons(cfg, members)
    plane = ProcessFleetPlane(cfg, A, ttrain._default_env_factory, eps,
                              members=members)
    try:
        assert [s.member_id for s in plane.specs] == [0, 1]
        assert plane.fleet_cfgs[1].gamma == 0.99
        assert plane.fleet_cfgs[1].base_eps == 0.3
        assert list(plane.specs[0].epsilons) == [
            epsilon_ladder(i, 2, cfg.base_eps, cfg.eps_alpha)
            for i in range(2)]
        assert list(plane.specs[1].epsilons) == [
            epsilon_ladder(i, 2, 0.3, 5.0) for i in range(2)]
        assert list(plane.specs[1].epsilons) != [
            epsilon_ladder(i, 4, cfg.base_eps, cfg.eps_alpha)
            for i in (2, 3)]
        pop = plane.population_health()["members"]
        assert [(r["member"], r["name"], r["preset"], r["lanes"])
                for r in pop] == [(0, "base", "default", 2),
                                  (1, "low", "low_resource", 2)]
    finally:
        plane.shutdown()
    bare = ProcessFleetPlane(cfg.replace(population_spec=""), A,
                             ttrain._default_env_factory, [0.1] * 4)
    try:
        assert bare.population_health() is None
        assert "population" not in bare.health()
    finally:
        bare.shutdown()


def test_block_wire_carries_the_member_tag():
    from r2d2_tpu_torch.parallel.actor_procs import (
        ShmBlockChannel,
        ShmBlockProducer,
    )
    from r2d2_tpu_torch.replay.block import LocalBuffer
    from test_torch_actor_procs import scripted_blocks

    cfg = port_cfg()
    ctx = mp.get_context("spawn")
    channel = ShmBlockChannel(cfg, A, num_slots=2, ctx=ctx)
    producer = ShmBlockProducer(cfg, A, channel.producer_info(),
                                ctx.Event(), src=1, member_id=3)
    try:
        blk, prios, ep = scripted_blocks(LocalBuffer, cfg, 1)[0]
        assert blk.member_id == 0
        producer.send(blk, prios, ep)
        b2, _, _, slot, src = channel.recv(timeout=10.0)
        assert b2.member_id == 3 and src == 1
        channel.release(slot)
    finally:
        producer.close()
        channel.close()


def test_a_real_game_member_needs_the_ale_and_is_named_at_start(tmp_path):
    """A member naming a real game on a host without ``ale_py``: train()
    refuses it at start-up, naming the member, before any fleet or the
    sidecar spawns."""
    from r2d2_tpu_torch.envs import atari_available

    assert not atari_available()
    spec = json.dumps([{"name": "base"}, {"name": "pong",
                                          "game_name": "Pong"}])
    for league in (True, False):
        with pytest.raises(ValueError, match=r"member 1 \(pong\)"):
            ttrain.train(port_cfg(population_spec=spec,
                                  league_eval=league),
                         checkpoint_dir=str(tmp_path), verbose=False,
                         device="cpu")


# ---------------------------------------------------------- train() level

def _league_cfg(**kw):
    return port_cfg(actor_inference="serve", league_eval=True,
                    league_eval_episodes=2, league_eval_interval=0.2,
                    training_steps=10 ** 9, save_interval=3,
                    log_interval=0.3, telemetry_port=-1,
                    learning_starts=16, **kw)


def _run(cfg, ckdir, log_sink, stop):
    result = {}

    def run():
        result["m"] = ttrain.train(cfg, checkpoint_dir=ckdir,
                                   max_wall_seconds=240, verbose=False,
                                   log_sink=log_sink, stop_fn=stop.is_set,
                                   device="cpu")

    th = threading.Thread(target=run)
    th.start()
    return th, result


@pytest.mark.timeout(300)
def test_chaos_kill_eval_sidecar_degrades_health_not_training(tmp_path):
    """kill_eval_sidecar at every chaos poll: the sidecar is killed as it
    spawns until its respawn budget runs out; /healthz then answers HTTP
    200 ``degraded`` with ``league.failed``, the learner keeps updating
    after that, and the run drains cleanly with both members' blocks in
    replay.

    The run is stopped only once the population rows show both members'
    blocks ingested: on a loaded host one member's fleet can fill the
    warm-up alone before the other member's child has started acting."""
    cfg = _league_cfg(chaos_spec="kill_eval_sidecar:every=1,n=1000000")
    failed_at, port, stop = {}, {}, threading.Event()

    def log_sink(e):
        port.setdefault("p", e.get("telemetry_port"))
        failed = ((e.get("league") or {}).get("health") or {}).get("failed")
        if failed and "steps" not in failed_at:
            failed_at["steps"] = e["training_steps"]
        failed_at["last"] = e["training_steps"]
        pop = (((e.get("fleet") or {}).get("population") or {})
               .get("members") or [])
        if len(pop) == 2 and all(r["blocks_ingested"] > 0 for r in pop):
            failed_at["both_members"] = True

    th, result = _run(cfg, str(tmp_path), log_sink, stop)
    try:
        assert poll(lambda: "steps" in failed_at, 150), \
            "the sidecar never exhausted its respawn budget"
        code, body = http_get(port["p"], "/healthz")
        health = json.loads(body)
        assert code == 200 and health["status"] == "degraded"
        assert health["league"]["failed"] is True
        assert poll(lambda: failed_at["last"] > failed_at["steps"], 150), \
            "no learner update after the sidecar failed"
        assert poll(lambda: "both_members" in failed_at, 150), \
            "a member's blocks never reached replay"
    finally:
        stop.set()
        th.join(150)
    assert not th.is_alive()
    m = result["m"]
    assert not m["fabric_failed"] and m["num_updates"] > 0
    assert m["chaos"]["kill_eval_sidecar"] >= 1
    assert m["league"]["health"]["failed"] is True
    assert m["healthz"]["status"] == "degraded"
    assert set(m["blocks_per_member"]) == {0, 1}
    assert all(v > 0 for v in m["blocks_per_member"].values())


@pytest.mark.slow
@pytest.mark.timeout(600)
def test_league_acceptance_e2e(tmp_path):
    """A 2-member population trains with the sidecar attached: >= 2
    complete sweeps and one table row per member on a live /statusz,
    both members' blocks in the population rows, the population.* and
    league.* series on /metrics, /healthz ok, league.jsonl without a
    duplicate (step, member) pair, and a clean drain."""
    cfg = _league_cfg()
    port, stop, live = {}, threading.Event(), {}

    def log_sink(e):
        port.setdefault("p", e.get("telemetry_port"))

    th, result = _run(cfg, str(tmp_path), log_sink, stop)
    try:
        assert poll(lambda: "p" in port, 120), "no telemetry port"

        def statusz():
            code, body = http_get(port["p"], "/statusz")
            entry = json.loads(body).get("last_entry") or {}
            live.update(league=entry.get("league") or {},
                        pop=((entry.get("fleet") or {}).get("population")
                             or {}).get("members") or [])
            return (live["league"].get("sweeps", 0) >= 2
                    and len(live["pop"]) == 2
                    and all(r["blocks"] > 0 for r in live["pop"]))

        assert poll(statusz, 240, interval=0.3), live
        assert live["league"]["members"] == 2
        assert len(live["league"]["table"]) == 2
        _, metrics = http_get(port["p"], "/metrics")
        code, body = http_get(port["p"], "/healthz")
        assert code == 200 and json.loads(body)["status"] == "ok"
    finally:
        stop.set()
        th.join(150)
    assert not th.is_alive()
    assert 'r2d2_population_env_steps_total{member="1"}' in metrics
    assert "r2d2_league_sweeps_total" in metrics
    m = result["m"]
    assert not m["fabric_failed"] and m["num_updates"] > 0
    assert set(m["blocks_per_member"]) == {0, 1}
    assert m["league"]["sweeps"] >= 2
    assert m["league"]["health"]["failed"] is False
    rows = psvc.read_league(str(tmp_path))
    pairs = [(r["step"], r["member"]) for r in rows]
    assert len(pairs) == len(set(pairs))
    assert all(set(r) == ROW_KEYS for r in rows)
    pop = m["fleet_health"]["population"]["members"]
    assert pop[1]["preset"] == "low_resource"
    assert all(r["env_steps"] > 0 and r["blocks"] > 0 for r in pop)
