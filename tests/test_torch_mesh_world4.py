"""The learner mesh over four gloo ranks on the CPU.

The meshed step at a two-axis layout (dp = 2 × tp = 2: the batch split
over dp, the LSTM gate columns and dense outputs over tp) against the
meshless step and against JAX's ``pjit_train_step`` at the same layout on
the conftest's 8-device CPU mesh (3 steps, mlp torso, H = 16; the
tolerances of tests/test_torch_distributed.py), and ``train()`` over a
dp = 4 mesh end to end.  The ranks are processes of
``r2d2_tpu_torch.tools.rank_worker``, each with a deadline and a stack
dump.
"""
import jax
import numpy as np
import pytest
import torch

from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu.learner.step import create_train_state as jax_train_state
from r2d2_tpu.models.network import create_network as jax_create_network
from r2d2_tpu.models.network import init_params
from r2d2_tpu.parallel.mesh import make_mesh as jax_make_mesh
from r2d2_tpu.parallel.sharding import ShardingTable as JaxTable
from r2d2_tpu.parallel.sharding import pjit_train_step
from r2d2_tpu.parallel.sharding import shard_batch as jax_shard_batch
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.learner.step import create_train_state, make_train_step
from r2d2_tpu_torch.models.convert import params_from_flax
from r2d2_tpu_torch.models.network import create_network
from r2d2_tpu_torch.tools.rank_worker import run_ranks

A = 4
LAYOUT = (("dp", 2), ("tp", 2))


def make_batch(cfg, rng):
    B, T, L = cfg.batch_size, cfg.seq_len, cfg.learning_steps
    return dict(
        obs=rng.integers(0, 255, (B, T, *cfg.obs_shape), dtype=np.uint8),
        last_action=rng.random((B, T, A)).astype(np.float32),
        last_reward=rng.random((B, T)).astype(np.float32),
        hidden=rng.normal(size=(B, 2, cfg.lstm_layers, cfg.hidden_dim)
                          ).astype(np.float32),
        action=rng.integers(0, A, (B, L)).astype(np.int32),
        n_step_reward=rng.random((B, L)).astype(np.float32),
        n_step_gamma=np.full((B, L), 0.99, np.float32),
        burn_in=np.full(B, cfg.burn_in_steps, np.int32),
        learning=rng.integers(1, L + 1, B).astype(np.int32),
        forward=np.full(B, cfg.forward_steps, np.int32),
        is_weights=rng.uniform(0.3, 1.0, B).astype(np.float32),
    )


def test_dp2_tp2_step_matches_dp1_and_jax(tmp_path):
    jcfg = jax_test_config(mesh_shape=LAYOUT)
    jnet = jax_create_network(jcfg, A)
    flax = init_params(jcfg, jnet, jax.random.PRNGKey(7))
    params = {k: v.numpy() for k, v in params_from_flax(
        jax.device_get(flax)).items()}
    batches = [make_batch(jcfg, np.random.default_rng(30 + i))
               for i in range(3)]

    out = run_ranks("step", 4, str(tmp_path),
                    dict(params=params, batches=batches, cfg_kw={},
                         layouts=(LAYOUT,)), timeout=240)
    r = out[0][LAYOUT]
    assert all(o[LAYOUT]["losses"] == r["losses"] for o in out)
    # the gate columns are split over tp
    assert "S(1)" in "".join(r["placements"]["lstm_layers.0.wi"]) or (
        "Shard(dim=1)" in "".join(r["placements"]["lstm_layers.0.wi"]))

    cfg = port_test_config()
    net = create_network(cfg, A, device="cpu", lstm_impl="scan")
    state = create_train_state(cfg, {k: torch.from_numpy(v)
                                     for k, v in params.items()})
    step = make_train_step(cfg, net)
    table = JaxTable(jax_make_mesh(jcfg), jcfg)
    jstate = jax_train_state(jcfg, flax)
    jstep = pjit_train_step(jcfg, jnet, table, state_template=jstate)
    jst = table.place_state(jstate)
    for i, b in enumerate(batches):
        state, loss, p = step(state, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        jst, jloss, jp = jstep(jst, jax_shard_batch(table, dict(b)))
        got = np.concatenate(r["prios"][i])
        assert r["losses"][i] == pytest.approx(float(loss), rel=1e-5)
        assert r["losses"][i] == pytest.approx(float(jloss), rel=1e-5)
        np.testing.assert_allclose(got, p.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, np.asarray(jp), rtol=1e-4,
                                   atol=1e-6)
    want = {k: v.numpy() for k, v in params_from_flax(
        jax.device_get(jst.params)).items()}
    for k, v in state.params.items():
        np.testing.assert_allclose(r["params"][k], v.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(r["params"][k], want[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_four_rank_train_end_to_end(tmp_path):
    """``train(cfg, use_mesh=True)`` over dp = 4: every rank takes the
    eight updates together, ends with the same params, feeds back its own
    quarter of each batch, and the env steps are summed over the four."""
    steps = 8
    out = run_ranks("train", 4, str(tmp_path),
                    dict(cfg_kw=dict(training_steps=steps,
                                     log_interval=0.2)), timeout=200)
    B = port_test_config().batch_size
    for r in out:
        assert r["num_updates"] == steps and not r["fabric_failed"]
        assert r["fed"] == [B // 4] * steps
        assert r["collectives"]["gate"] == steps
        assert r["env_steps"] == out[0]["env_steps"] > 0
        assert all(np.array_equal(r["params"][k], out[0]["params"][k])
                   for k in r["params"])


def test_cross_rank_draw_at_dp4_equals_one_slab(tmp_path):
    """The cross-rank draw over four slabs of one ring (44 scripted
    blocks through the 20-slot ring, 5 blocks a slab): every rank draws
    the global strata bitwise those of one slab holding the ring, receives
    its quarter of ``gather_batch`` over the whole ring bit for bit, and
    the feedback's slabs concatenate to ``scatter_last``'s."""
    from r2d2_tpu_torch.learner import step as tstep
    from r2d2_tpu_torch.replay.device_ring import gather_batch
    from test_torch_cross_rank import N_BLOCKS, global_ring, task_args
    from test_torch_in_graph_per import filled

    cfg, _, ring, _, _ = filled(N_BLOCKS)
    g = global_ring(ring)
    args = task_args(cfg, g)
    out = run_ranks("cross_rank", 4, str(tmp_path), args, timeout=150)
    t = {k: torch.from_numpy(g[k]) for k in ("prios", "seq_meta", "first")}
    arrays = {k: torch.from_numpy(v) for k, v in g["arrays"].items()}
    B = cfg.batch_size
    for j, u in enumerate(args["us"]):
        idx, w, ints = tstep._in_graph_sample(
            cfg, torch.from_numpy(u), t["prios"], t["seq_meta"], t["first"])
        whole = gather_batch(cfg, arrays, ints, w)
        for r, res in enumerate(out):
            d = res["draws"][j]
            np.testing.assert_array_equal(d["idx"], idx.numpy())
            np.testing.assert_array_equal(d["ints"], ints.numpy())
            np.testing.assert_array_equal(d["w"], w.numpy())
            rows = slice(r * B // 4, (r + 1) * B // 4)
            for k, v in whole.items():
                np.testing.assert_array_equal(res["rows"][j][k],
                                              v.numpy()[rows], err_msg=k)
    want = t["prios"].clone()
    tstep.scatter_last(want, torch.from_numpy(args["fb_idx"]),
                       torch.from_numpy(args["fb_vals"]))
    np.testing.assert_array_equal(
        np.concatenate([r["feedback"] for r in out]), want.numpy())


def test_anakin_at_dp4_one_fetch_per_dispatch(tmp_path):
    """The anakin plane over four ranks, one lane each: one result fetch
    per rollout and per dispatch on every rank, finite losses, and the
    same gathered state and counters on all four."""
    from test_torch_anakin_mesh import BASE

    out = run_ranks("anakin", 4, str(tmp_path),
                    dict(cfg_kw=BASE, dispatches=2), timeout=150)
    for r in out:
        assert r["fetches"] == r["rollouts"] + 2
        assert np.isfinite(r["losses"]).all()
        assert r["counters"] == out[0]["counters"]
        for k, v in r["payload"].items():
            np.testing.assert_array_equal(v, out[0]["payload"][k],
                                          err_msg=k)
