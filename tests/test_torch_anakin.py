"""The port's fused on-device loop (``r2d2_tpu_torch/learner/anakin.py``)
against the JAX package's and the host block cutter, on the CPU.

Mirrors tests/test_anakin.py at ``test_config`` size (mlp torso, H=16,
float32), params crossing over through ``models/convert.py``:

1. **Blocks** — the port's debug rollout, replayed into the port's host
   ``LocalBuffer``: integer fields, obs streams, gamma tails and stored
   hiddens bitwise; n-step returns and priorities within 2e-5 (the host
   sums in float64).
2. **Rollout against JAX** — at ``base_eps = 1`` every action is an
   exploration draw, and the port is fed JAX's own exploration and reset
   draws, so both packages walk the same trajectory: ring arrays (but the
   stored hiddens), ``seq_meta``, ``first``, ``ptr``, ``fill``, the carry's
   integer fields and every obs byte bitwise; ``n_step_reward`` and the
   priorities within 2e-5 absolute; q and hiddens within 1e-5 (the
   network's f32 forward, XLA against torch).
3. **One super-step against JAX** (k = 2, E = 2) from JAX's carry, fed
   JAX's uniforms and draws: losses within 1e-5 relative; a leaf both
   packages scattered several values into may hold any of them (the rule
   of tests/test_torch_in_graph_per.py).
4. **Host crossings** — one ``anakin.result_fetch`` per dispatch and per
   rollout, whatever N, k and E are.
5. **Recovery** — snapshot → restore → continue is bitwise against an
   uninterrupted run; a geometry mismatch and a JAX-written snapshot are
   refused; ``train()`` resumes warm, and the ``wedge_dispatch`` drill
   ends in a clean abort with a snapshot.
"""
import os
import signal
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu.envs.anakin import AnakinFakeEnv as JaxFakeEnv
from r2d2_tpu.envs.anakin import AnakinGridEnv as JaxGridEnv
from r2d2_tpu.learner import anakin as janakin
from r2d2_tpu.learner import step as jstep
from r2d2_tpu.models.network import create_network as jax_create
from r2d2_tpu.models.network import init_params
from r2d2_tpu.replay.device_ring import DeviceRing as JaxDeviceRing
from r2d2_tpu_torch import train as ttrain
from r2d2_tpu_torch.checkpoint import Checkpointer
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.envs import FakeAtariEnv, GridWorldEnv
from r2d2_tpu_torch.envs import anakin as tenv
from r2d2_tpu_torch.learner import anakin as tanakin
from r2d2_tpu_torch.learner import step as tstep
from r2d2_tpu_torch.learner.learner import Learner
from r2d2_tpu_torch.models import create_network, params_from_flax
from r2d2_tpu_torch.replay.block import LocalBuffer
from r2d2_tpu_torch.replay.device_ring import DeviceRing
from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS

A = 4
TOL = dict(rtol=0, atol=1e-5)
RET_TOL = dict(rtol=0, atol=2e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
BASE = dict(game_name="Fake", actor_transport="anakin", device_replay=True,
            in_graph_per=True, num_actors=2, superstep_k=2,
            anakin_episode_len=12, training_steps=24, learning_starts=16)


def anakin_config(**kw):
    return port_test_config(**{**BASE, **kw})


def jax_anakin_config(**kw):
    return jax_test_config(**{**BASE, **kw})


def build_plane(cfg, seed=0):
    net = create_network(cfg, A, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    plane = tanakin.AnakinPlane(cfg, net, A, DeviceRing(cfg, A, device="cpu"))
    learner = Learner(cfg, net, tstep.create_train_state(cfg,
                                                         net.state_dict()))
    return net, plane, learner


def drive(learner, plane, dispatches):
    while not plane.ready:
        plane.rollout_step(learner.state.params)
    for _ in range(dispatches):
        learner.state, result = plane.dispatch(learner.state)
        plane.harvest(result)


def to_np(tree):
    return {k: np.asarray(v) for k, v in jax.device_get(tree).items()}


def state_arrays(state):
    return [t for d in (state.params, state.target_params,
                        state.opt_state.mu, state.opt_state.nu)
            for _, t in sorted(d.items())]


# ------------------------------------------------------------ block parity

@pytest.mark.parametrize("mode", ["burn_in_start", "seq_start"])
def test_blocks_match_local_buffer_oracle(mode):
    """Replay the debug rollout's recorded trajectory into host
    LocalBuffers and compare every emitted block with the ring slot the
    fused loop wrote — boundary cuts with bootstrap Q, episode-end cuts,
    burn-in carry-over, windows, stored hiddens, priorities and the PER
    leaf/metadata state."""
    cfg = anakin_config(num_actors=3, anakin_episode_len=13,
                        buffer_capacity=30 * 8, stored_hidden_mode=mode)
    N, K = cfg.num_actors, cfg.seqs_per_block
    net = create_network(cfg, A, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    params = {k: v.detach() for k, v in net.state_dict().items()}
    ring = DeviceRing(cfg, A, device="cpu")
    env = tenv.make_anakin_env(cfg, A, device="cpu")
    ast = tanakin.make_anakin_state(cfg, A, env, 11)
    init_obs = ast["obs"].numpy().copy()

    T = 40
    meta0 = ring.per_meta()
    (_, arrays, prios, seq_meta, first), tr = tanakin.make_debug_rollout(
        cfg, net, env, A, T)(params, ast, ring.snapshot(), ring.take_prios(),
                             meta0["seq_meta"], meta0["first"])
    tr = {k: v.numpy() for k, v in tr.items()}
    arrays = {k: v.numpy() for k, v in arrays.items()}
    prios, seq_meta, first = prios.numpy(), seq_meta.numpy(), first.numpy()

    lbs = [LocalBuffer(cfg, A) for _ in range(N)]
    for i in range(N):
        lbs[i].reset(init_obs[i])
    host_blocks = []  # (block, priorities) in ring-slot emission order
    for t in range(T):
        for i in range(N):           # boundary cuts first, lane order
            if tr["pending"][t][i]:
                host_blocks.append(lbs[i].finish(tr["q"][t][i]))
        for i in range(N):
            lbs[i].add(int(tr["actions"][t][i]), float(tr["reward"][t][i]),
                       tr["obs_step"][t][i], tr["q"][t][i],
                       tr["hidden"][t][i])
        for i in range(N):           # then episode-end cuts, lane order
            if tr["truncated"][t][i]:
                host_blocks.append(lbs[i].finish(None))
                lbs[i].reset(tr["obs_next"][t][i])

    assert len(host_blocks) > 6, "trajectory produced too few cuts"
    assert len(host_blocks) <= cfg.num_blocks, "test must not wrap the ring"
    for slot, (blk, pri, _ep) in enumerate(host_blocks):
        n_obs, n_steps = blk.obs.shape[0], blk.action.shape[0]
        k = blk.num_sequences
        for name, n in (("obs", n_obs), ("last_action", n_obs),
                        ("last_reward", n_obs), ("action", n_steps),
                        ("n_step_gamma", n_steps), ("hidden", k)):
            np.testing.assert_array_equal(getattr(blk, name),
                                          arrays[name][slot][:n],
                                          err_msg=name)
        np.testing.assert_allclose(blk.n_step_reward,
                                   arrays["n_step_reward"][slot][:n_steps],
                                   **RET_TOL)
        want_meta = np.stack([blk.burn_in_steps, blk.learning_steps,
                              blk.forward_steps], 1).astype(np.int32)
        np.testing.assert_array_equal(want_meta, seq_meta[slot][:k])
        assert first[slot] == int(blk.burn_in_steps[0])
        want_prios = (np.asarray(pri, np.float64)
                      ** cfg.prio_exponent).astype(np.float32)
        np.testing.assert_allclose(want_prios, prios[slot * K:(slot + 1) * K],
                                   **RET_TOL)
    # every leaf past the written slots is still zero (unsampleable)
    assert not prios[len(host_blocks) * K:].any()


# ------------------------------------------------------- parity with JAX

def jax_draws(jenv, kind, jast, steps, ep_len):
    """JAX's exploration draws (its actor's ``split(act_key, 3)`` chain)
    and reset draws (each lane's reset stream, in lockstep) for the next
    ``steps`` actor steps from carry ``jast``, as the port's per-step
    ``draws``; and the initial reset's values."""
    N = jast["env_t"].shape[0]
    key = jnp.asarray(jast["act_key"])
    acts = []
    for _ in range(steps):
        key, k1, k2 = jax.random.split(key, 3)
        acts.append((np.asarray(jax.random.uniform(k1, (N,))),
                     np.asarray(jax.random.randint(k2, (N,), 0, A,
                                                   dtype=jnp.int32))))
    t0 = np.asarray(jast["env_t"])
    assert (t0 == t0[0]).all()       # the lanes truncate in lockstep
    t0 = int(t0[0])
    n_resets = (t0 + steps) // ep_len + 1
    keys = np.array(jast["env_key"])
    table = []
    for _ in range(n_resets):
        row = []
        for lane in range(N):
            if kind == "fake":
                keys[lane], ph = jenv.host_phase_draw(keys[lane])
                row.append((ph,))
            else:
                keys[lane], ag, go = jenv.host_reset_draw(keys[lane])
                row.append((ag, go))
        table.append(np.asarray(row, np.int32))
    names = ("phase",) if kind == "fake" else ("agent", "goal")
    out = []
    for s in range(steps):
        j = max(0, (t0 + s + 1) // ep_len - 1)
        out.append(dict(
            u=torch.from_numpy(acts[s][0].copy()),
            rand_a=torch.from_numpy(acts[s][1].copy()),
            reset={n: torch.from_numpy(table[j][:, i].copy())
                   for i, n in enumerate(names)}))
    init = {n: torch.from_numpy(np.array(jast[f"env_{n}"])) for n in names}
    return out, init


def port_carry(cfg, env, jast_np, init):
    """The port's carry holding JAX's carry's values; its stream keys are
    the port's own (int64)."""
    ast = tanakin.make_anakin_state(cfg, A, env, 11, draws=init)
    for k, v in jast_np.items():
        if k not in ("env_key", "act_key"):
            assert ast[k].shape == v.shape and str(ast[k].dtype).endswith(
                str(v.dtype).replace("bool", "bool")), k
            ast[k] = torch.from_numpy(v.copy())
    return ast


def port_ring(cfg, jring_np):
    ring = DeviceRing(cfg, A, device="cpu")
    for k, v in jring_np["arrays"].items():
        ring.arrays[k].copy_(torch.from_numpy(v))
    ring.put_prios(torch.from_numpy(jring_np["prios"].copy()))
    ring.put_per_meta(torch.from_numpy(jring_np["seq_meta"].copy()),
                      torch.from_numpy(jring_np["first"].copy()))
    return ring


FLOAT_CARRY = ("hidden", "buf_hidden", "buf_qval")


def assert_carry_matches(ast, jast, skip=()):
    for k, v in jast.items():
        if k in ("env_key", "act_key") or k in skip:
            continue
        got = ast[k].numpy()
        if k in FLOAT_CARRY:
            np.testing.assert_allclose(got, v, **TOL, err_msg=k)
        else:
            np.testing.assert_array_equal(got, v, err_msg=k)


def assert_ring_matches(arrays, prios, seq_meta, first, jarr, jprios,
                        jmeta, jfirst, prio_check=True):
    for k, v in jarr.items():
        got = arrays[k].numpy()
        if k == "hidden":
            np.testing.assert_allclose(got, v, **TOL, err_msg=k)
        elif k == "n_step_reward":
            np.testing.assert_allclose(got, v, **RET_TOL, err_msg=k)
        else:
            np.testing.assert_array_equal(got, v, err_msg=k)
    np.testing.assert_array_equal(seq_meta.numpy(), jmeta)
    np.testing.assert_array_equal(first.numpy(), jfirst)
    if prio_check:
        np.testing.assert_allclose(prios.numpy(), jprios, **RET_TOL)


def jax_setup(kind, **kw):
    jcfg = jax_anakin_config(base_eps=1.0, anakin_env=kind, **kw)
    cfg = anakin_config(base_eps=1.0, anakin_env=kind, **kw)
    jnet = jax_create(jcfg, A)
    params = init_params(jcfg, jnet, jax.random.PRNGKey(0))
    jenv = (JaxFakeEnv if kind == "fake" else JaxGridEnv)(
        obs_shape=jcfg.stored_obs_shape, action_dim=A,
        episode_len=jcfg.anakin_episode_len, num_lanes=jcfg.num_actors)
    env = tenv.make_anakin_env(cfg, A, device="cpu")
    net = create_network(cfg, A, device="cpu")
    return jcfg, cfg, jnet, params, jenv, env, net


def jax_rollout(jcfg, jnet, params, jenv, T):
    """JAX's debug rollout (its default cond path) for T steps from a
    fresh carry: (initial carry, final carry and ring, trace), numpy."""
    jring = JaxDeviceRing(jcfg, A)
    jast = janakin.make_anakin_state(jcfg, A, jenv, jax.random.PRNGKey(11))
    jast0 = to_np(jast)
    meta = jring.per_meta()
    (jast1, jarr, jprios, jmeta, jfirst), jtr = janakin.make_debug_rollout(
        jcfg, jnet, jenv, A, T)(params, jast, jring.snapshot(),
                                jring.take_prios(), meta["seq_meta"],
                                meta["first"])
    ring = dict(arrays=to_np(jarr), prios=np.asarray(jprios),
                seq_meta=np.asarray(jmeta), first=np.asarray(jfirst))
    return jast0, to_np(jast1), ring, to_np(jtr)


@pytest.mark.parametrize("kind", ["fake", "grid"])
def test_rollout_matches_jax_debug_rollout(kind):
    """The port's rollout against JAX's ``make_debug_rollout`` (cond path)
    over 40 steps of 3 lanes (episodes of 13, blocks of 8: boundary and
    episode-end cuts), fed JAX's draws."""
    T = 40
    jcfg, cfg, jnet, params, jenv, env, net = jax_setup(
        kind, num_actors=3, anakin_episode_len=13, buffer_capacity=30 * 8)
    jast0, jast1, jring, jtr = jax_rollout(jcfg, jnet, params, jenv, T)
    draws, init = jax_draws(jenv, kind, jast0, T, cfg.anakin_episode_len)

    ring = DeviceRing(cfg, A, device="cpu")
    ast = tanakin.make_anakin_state(cfg, A, env, 11, draws=init)
    assert_carry_matches(ast, jast0)
    meta = ring.per_meta()
    (ast, arrays, prios, seq_meta, first), tr = tanakin.make_debug_rollout(
        cfg, net, env, A, T)(params_from_flax(jax.device_get(params)), ast,
                             ring.snapshot(), ring.take_prios(),
                             meta["seq_meta"], meta["first"], draws=draws)

    assert jtr["pending"].any() and jtr["truncated"].any()
    for k, v in jtr.items():
        if k in ("q", "hidden"):
            np.testing.assert_allclose(tr[k].numpy(), v, **TOL, err_msg=k)
        else:
            np.testing.assert_array_equal(tr[k].numpy(), v, err_msg=k)
    assert_carry_matches(ast, jast1)
    assert_ring_matches(arrays, prios, seq_meta, first, jring["arrays"],
                        jring["prios"], jring["seq_meta"], jring["first"])
    assert int(ast["fill"]) == int(ast["block_learning_total"].sum()) > 0


def test_super_step_matches_jax():
    """One super-step (k = 2, E = 2) from JAX's carry after a 40-step
    rollout, the port fed JAX's uniforms and actor draws: the losses, the
    stats and the ring, PER leaves and carry after it."""
    k, E, d = 2, 2, 5
    jcfg, cfg, jnet, params, jenv, env, net = jax_setup(
        "fake", num_actors=3, anakin_episode_len=13, buffer_capacity=30 * 8,
        superstep_k=k, anakin_env_steps_per_update=E)
    _, jast1, jring, _ = jax_rollout(jcfg, jnet, params, jenv, 40)
    draws, init = jax_draws(jenv, "fake", jast1, k * E,
                            cfg.anakin_episode_len)

    jss = janakin.make_anakin_super_step(jcfg, jnet, jenv, A)
    jring_dev = {k_: jnp.asarray(v) for k_, v in jring["arrays"].items()}
    (jts, jast2, jarr, jprios, jmeta, jfirst, jflat) = jss(
        jstep.create_train_state(jcfg, params),
        {k_: jnp.asarray(v) for k_, v in jast1.items()}, jring_dev,
        jnp.asarray(jring["prios"]), jnp.asarray(jring["seq_meta"]),
        jnp.asarray(jring["first"]), jnp.asarray(d, jnp.uint32))
    jflat = np.asarray(jflat)

    keys = jax.random.split(jax.random.fold_in(
        jax.random.PRNGKey(cfg.seed), jnp.asarray(d, jnp.uint32)), k)
    u = np.stack([np.asarray(jax.random.uniform(key, (cfg.batch_size,)))
                  for key in keys])
    ring = port_ring(cfg, jring)
    ast = port_carry(cfg, env, jast1, init)
    state = tstep.create_train_state(cfg, params_from_flax(
        jax.device_get(params)))
    ss = tanakin.make_anakin_super_step(cfg, net, env, A)
    meta = ring.per_meta()
    state, ast, arrays, prios, seq_meta, first, flat = ss(
        state, ast, ring.snapshot(), ring.take_prios(), meta["seq_meta"],
        meta["first"], d, uniforms=torch.from_numpy(u), draws=draws)

    assert state.step == int(jts.step) == k
    np.testing.assert_allclose(flat[:k].numpy(), jflat[:k], **LOSS_TOL)
    np.testing.assert_array_equal(flat[k:].numpy(), jflat[k:])
    assert_carry_matches(ast, to_np(jast2))
    assert_ring_matches(arrays, prios, seq_meta, first, to_np(jarr),
                        None, np.asarray(jmeta), np.asarray(jfirst),
                        prio_check=False)
    # the scattered leaves: equal within the learner tolerance, except
    # where a leaf drawn twice in one step took another of its values
    got, want = prios.numpy(), np.asarray(jprios)
    close = np.isclose(got, want, **LOSS_TOL)
    assert close.mean() > 0.95, np.flatnonzero(~close)
    np.testing.assert_array_equal(got == 0, want == 0)


# ------------------------------------------------- host-freedom guarantees

@pytest.mark.parametrize("kw", [
    dict(num_actors=2, superstep_k=2, anakin_env_steps_per_update=4),
    dict(num_actors=4, superstep_k=3, anakin_env_steps_per_update=2,
         anakin_eval_interval=2),
], ids=["n2-k2-e4", "n4-k3-e2-eval"])
def test_one_result_fetch_per_dispatch(kw):
    """The loop's device→host crossings are ONE result-vector fetch per
    dispatch and per warm-up rollout — not per lane, inner step or env
    step — and nothing goes up."""
    cfg = anakin_config(training_steps=10 ** 9, **kw)
    _, plane, learner = build_plane(cfg)
    HOST_TRANSFERS.reset()
    rollouts = 0
    while not plane.ready:
        plane.rollout_step(learner.state.params)
        rollouts += 1
    assert plane.dispatch_no == 0 and rollouts > 0
    assert HOST_TRANSFERS.snapshot() == {"anakin.result_fetch": rollouts}
    for _ in range(5):
        learner.state, result = plane.dispatch(learner.state)
        plane.harvest(result)
    assert HOST_TRANSFERS.snapshot() == {
        "anakin.result_fetch": rollouts + 5}
    assert plane.training_steps == 5 * cfg.superstep_k == learner.num_updates
    assert plane.frames == (rollouts + 5) * plane._frames_per_dispatch
    assert plane.fill == int(plane.state["block_learning_total"].sum())
    if cfg.anakin_eval_interval:
        # dispatches 0, 2, 4 ran the eval lane: one episode per lane each
        assert plane.eval_episodes_total == 3 * cfg.num_actors


def test_super_step_scatter_is_last_write():
    """A leaf drawn twice in one batch keeps its last value, on every
    device: the scatter is deterministic."""
    leaves = torch.zeros(6)
    idx = torch.tensor([4, 1, 4, 2, 4, 1])
    tstep.scatter_last(leaves, idx, torch.arange(6.0) + 1)
    assert leaves.tolist() == [0.0, 6.0, 4.0, 0.0, 5.0, 0.0]


# --------------------------------------------------------------- recovery

def test_snapshot_resume_bit_exact(tmp_path):
    """Snapshot → restore → continue reproduces an uninterrupted run
    bitwise: params, optimizer state, ring bytes, PER leaves, env state
    and streams, LSTM carry."""
    cfg = anakin_config(training_steps=10 ** 9)
    _, plane_a, learner_a = build_plane(cfg)
    drive(learner_a, plane_a, 4)

    _, plane_b, learner_b = build_plane(cfg)
    drive(learner_b, plane_b, 2)
    path = os.path.join(tmp_path, "anakin.bin")
    HOST_TRANSFERS.reset()
    meta = plane_b.write_state(path)
    assert HOST_TRANSFERS.snapshot() == {"anakin.snapshot_fetch": 1}
    assert meta["kind"] == "anakin"
    assert meta["counters"]["dispatch_no"] == 2

    _, plane_c, learner_c = build_plane(cfg, seed=1)   # other params
    plane_c.read_state(path, meta)
    learner_c.state = tstep.TrainState(
        step=learner_b.state.step,
        params={k: v.clone() for k, v in learner_b.state.params.items()},
        target_params={k: v.clone()
                       for k, v in learner_b.state.target_params.items()},
        opt_state=tstep.AdamState(
            count=learner_b.state.opt_state.count,
            mu={k: v.clone() for k, v in learner_b.state.opt_state.mu.items()},
            nu={k: v.clone()
                for k, v in learner_b.state.opt_state.nu.items()}))
    assert (plane_c.dispatch_no, plane_c.env_steps, plane_c.fill) == (
        plane_b.dispatch_no, plane_b.env_steps, plane_b.fill)
    drive(learner_c, plane_c, 2)

    for a, c in zip(state_arrays(learner_a.state),
                    state_arrays(learner_c.state)):
        assert torch.equal(a, c)
    snap_a, snap_c = plane_a._payload(), plane_c._payload()
    assert sorted(snap_a) == sorted(snap_c)
    for k in snap_a:
        np.testing.assert_array_equal(snap_a[k], snap_c[k], err_msg=k)
    assert plane_a.env_steps == plane_c.env_steps


def test_snapshot_rejects_geometry_mismatch_and_jax_snapshots(tmp_path):
    """Another geometry, another kind, and an anakin snapshot the JAX
    package wrote (its stream keys are uint32, the port's int64) are all
    refused — the caller then resumes cold."""
    cfg = anakin_config()
    _, plane, learner = build_plane(cfg)
    drive(learner, plane, 0)
    path = os.path.join(tmp_path, "anakin.bin")
    meta = plane.write_state(path)
    names = [k for k, _, _ in meta["layout"]]
    assert "state_env_key" in names and "ring_obs" in names
    assert {"per_prios", "per_seq_meta", "per_first"} <= set(names)

    _, plane2, _ = build_plane(anakin_config(num_actors=4))
    with pytest.raises(ValueError, match="layout mismatch"):
        plane2.read_state(path, meta)
    with pytest.raises(ValueError, match="not an anakin"):
        plane2.read_state(path, dict(meta, kind="replay"))

    jcfg = jax_anakin_config()
    jnet = jax_create(jcfg, A)
    jplane = janakin.AnakinPlane(jcfg, jnet, A, JaxDeviceRing(jcfg, A))
    jpath = os.path.join(tmp_path, "jax.bin")
    jmeta = jplane.write_state(jpath)
    assert sorted(k for k, _, _ in jmeta["layout"]) == sorted(names)
    with pytest.raises(ValueError, match="layout mismatch"):
        plane.read_state(jpath, jmeta)


# --------------------------------------------------------------- train()

def test_train_fast_plumbing(tmp_path):
    """The full train() branch on the CPU (telemetry, log loop, checkpoint
    cadence, drain-then-save), then a warm resume: counters continue."""
    ck = str(tmp_path / "ck")
    cfg = anakin_config(training_steps=24, log_interval=0.2,
                        save_interval=10, anakin_eval_interval=4)
    m = ttrain.train(cfg, checkpoint_dir=ck, verbose=False,
                     max_wall_seconds=120, device="cpu")
    assert m["num_updates"] == 24 == m["buffer_training_steps"]
    assert np.isfinite(m["mean_loss"]) and len(m["losses"]) == 24
    assert m["env_steps"] > 0 and m["anakin_frames"] > 0
    assert m["episodes"] > 0 and m["eval_episodes"] > 0
    assert not m["fabric_failed"] and not m["dispatch_wedged"]
    assert m["healthz"]["status"] == "ok"
    assert m["logs"] and m["logs"][-1]["anakin"]["super_steps"] <= 12
    assert m["anakin_super_steps"] == 12
    assert all(v.device.type == "cpu" for v in m["final_params"].values())
    ckp = Checkpointer(ck)
    assert {10, 20, 24} <= set(ckp.steps()) and ckp.replay_steps() == [24]
    meta, _, _ = ckp.restore_replay()
    assert meta["kind"] == "anakin"
    assert meta["counters"]["env_steps"] == m["env_steps"]

    m2 = ttrain.train(cfg.replace(training_steps=28), checkpoint_dir=ck,
                      resume=True, verbose=False, max_wall_seconds=120,
                      device="cpu")
    assert m2["restored_replay"] and m2["num_updates"] == 28
    assert m2["env_steps"] > m["env_steps"]
    assert m2["anakin_super_steps"] == 14
    assert m2["eval_episodes"] > m["eval_episodes"]


@pytest.mark.parametrize("stall,hard", [(0.45, False), (3.0, True)],
                         ids=["slow", "hard"])
def test_wedge_dispatch_drill_aborts_with_a_snapshot(tmp_path, stall, hard):
    """``wedge_dispatch`` stalls one harvest past ``dispatch_deadline``:
    a slow wedge drains and snapshots, a hard one walks away from the
    fetch and snapshots on a bounded thread; both abort cleanly, and the
    snapshot resumes."""
    ck = str(tmp_path / "ck")
    cfg = anakin_config(training_steps=10 ** 6, dispatch_deadline=0.3,
                        chaos_spec=f"wedge_dispatch:at=3,dur={stall}")
    m = ttrain.train(cfg, checkpoint_dir=ck, verbose=False,
                     max_wall_seconds=120, device="cpu")
    assert m["dispatch_wedged"] and not m["fabric_failed"]
    assert m["chaos"] == {"wedge_dispatch": 1}
    assert m["num_updates"] < 20
    ckp = Checkpointer(ck)
    steps = ckp.replay_steps()
    assert steps, "no snapshot at the wedged abort"
    meta, _, _ = ckp.restore_replay()
    assert meta["kind"] == "anakin"
    # a hard wedge walks away from the harvest it stalled and from the
    # dispatches in flight behind it: their counters never reach the host
    lost = cfg.superstep_k * (cfg.superstep_pipeline + 1) if hard else 0
    assert meta["counters"]["training_steps"] == m["num_updates"] - lost
    m2 = ttrain.train(cfg.replace(chaos_spec="", dispatch_deadline=0.0,
                                  training_steps=m["num_updates"] + 4),
                      checkpoint_dir=ck, resume=True, verbose=False,
                      max_wall_seconds=120, device="cpu")
    assert m2["restored_replay"] and not m2["dispatch_wedged"]
    assert m2["env_steps"] >= meta["counters"]["env_steps"]


def test_anakin_config_validation():
    with pytest.raises(ValueError, match="anakin_episode_len"):
        anakin_config(anakin_episode_len=100, max_episode_steps=50)
    with pytest.raises(ValueError, match="anakin_env_steps_per_update"):
        anakin_config(anakin_env_steps_per_update=0)
    cfg = anakin_config(num_actors=4, buffer_capacity=16, block_length=8,
                        learning_starts=8)
    net = create_network(cfg, A, device="cpu")
    with pytest.raises(ValueError, match="num_blocks"):
        tanakin.AnakinPlane(cfg, net, A, DeviceRing(cfg, A, device="cpu"))
    with pytest.raises(ValueError, match="in_graph_per"):
        tanakin.AnakinPlane(cfg.replace(in_graph_per=False), net, A,
                            DeviceRing(cfg, A, device="cpu"))
    with pytest.raises(ValueError, match="host env_factory"):
        ttrain.train(anakin_config(), env_factory=lambda c, s: None,
                     verbose=False, device="cpu")
    # the anakin transport keeps the mesh and the in-graph diagnostics
    # refused, by their ROADMAP items; wedge_dispatch is a fired site
    with pytest.raises(ValueError, match="item 7"):
        ttrain.train(anakin_config(), use_mesh=True, verbose=False,
                     device="cpu")
    with pytest.raises(ValueError, match="item 10"):
        ttrain.train(anakin_config(learnhealth_interval=10), verbose=False,
                     device="cpu")
    assert "wedge_dispatch" in ttrain.CHAOS_SITES


def test_real_game_name_warns_and_runs_the_device_env():
    """As in the JAX package, the anakin transport warns for a game other
    than "Fake" and trains on the env ``cfg.anakin_env`` selects."""
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        m = ttrain.train(anakin_config(game_name="Pong", training_steps=2,
                                       anakin_env="grid"),
                         verbose=False, device="cpu", max_wall_seconds=60)
    assert any("substituting the 'grid' device env for 'Pong'"
               in str(x.message) for x in w)
    assert m["num_updates"] == 2


# ------------------------------------------------------------------ slow

@pytest.mark.slow
def test_sigterm_resume_end_to_end(tmp_path):
    """SIGTERM a live anakin run; ``resume`` continues the loop state
    warm (ring fill, env state and streams, counters)."""
    ck = str(tmp_path / "ck")
    cfg = anakin_config(training_steps=10 ** 8, log_interval=0.2,
                        save_interval=10 ** 8)

    def sink(entry):
        if entry["training_steps"] >= 8:
            os.kill(os.getpid(), signal.SIGTERM)

    m = ttrain.train(cfg, checkpoint_dir=ck, verbose=False, log_sink=sink,
                     max_wall_seconds=240, device="cpu")
    assert 0 < m["num_updates"] < 10 ** 8 and not m["fabric_failed"]
    ckp = Checkpointer(ck)
    assert ckp.latest_step() is not None and ckp.replay_steps()
    meta, _, _ = ckp.restore_replay()
    assert meta["kind"] == "anakin"
    assert meta["counters"]["env_steps"] == m["env_steps"] > 0
    assert meta["counters"]["fill"] == m["buffer_size"] > 0
    m2 = ttrain.train(cfg.replace(training_steps=m["num_updates"]
                                  + 2 * cfg.superstep_k),
                      checkpoint_dir=ck, resume=True, verbose=False,
                      max_wall_seconds=240, device="cpu")
    assert m2["restored_replay"]
    assert m2["num_updates"] >= m["num_updates"] + 2 * cfg.superstep_k
    assert m2["env_steps"] > m["env_steps"]
    assert np.isfinite(m2["mean_loss"])


def _policy_beats_random(cfg, env_cls, margin):
    from r2d2_tpu_torch.evaluate import evaluate_params

    m = ttrain.train(cfg, verbose=False, max_wall_seconds=900, device="cpu")
    assert m["num_updates"] >= cfg.training_steps
    losses = np.asarray(m["losses"])
    assert np.isfinite(losses).all()

    def env_factory(c, seed):
        return env_cls(obs_shape=c.obs_shape, action_dim=A, seed=seed,
                       episode_len=c.anakin_episode_len)

    net = create_network(cfg, A, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    rand_score = evaluate_params(cfg, net, net.state_dict(), env_factory,
                                 episodes=5, epsilon=1.0, seed=11)
    score = evaluate_params(cfg, net, m["final_params"], env_factory,
                            episodes=5, epsilon=cfg.test_epsilon, seed=11)
    assert score > rand_score + margin, (score, rand_score)
    return m, losses


@pytest.mark.slow
def test_anakin_trains_and_policy_beats_random():
    """Anakin training reduces the loss, and the greedy policy beats a
    random one on the NUMPY fake env."""
    cfg = anakin_config(training_steps=2000, superstep_k=4,
                        anakin_episode_len=32, log_interval=1.0,
                        act_device="cpu")
    m, losses = _policy_beats_random(cfg, FakeAtariEnv, 0.0)
    assert losses[-100:].mean() < losses[:100].mean()


@pytest.mark.slow
def test_anakin_grid_trains_and_policy_beats_random():
    """The grid env through the unchanged fused loop learns a
    goal-seeking policy that beats random on the numpy oracle, and the
    eval lane's greedy return improves over the run."""
    cfg = anakin_config(training_steps=6000, superstep_k=4, num_actors=4,
                        anakin_episode_len=32, anakin_env="grid",
                        anakin_eval_interval=100, learning_starts=32,
                        gamma=0.95, lr=3e-4, buffer_capacity=320,
                        log_interval=2.0, act_device="cpu")
    m, _ = _policy_beats_random(cfg, GridWorldEnv, 2.0)
    evals = [e["anakin"]["eval_return"] for e in m["logs"]
             if e["anakin"]["eval_episodes"] > 0
             and np.isfinite(e["anakin"]["eval_return"])]
    assert len(evals) >= 3
    assert max(evals[len(evals) // 2:]) > evals[0] + 2.0, evals
