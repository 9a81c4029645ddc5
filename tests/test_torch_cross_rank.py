"""The cross-rank draw (``parallel/cross_rank.py``) over two gloo ranks
on the CPU, against one slab holding the same ring and against the JAX
package.

One ring of 44 scripted blocks (it wraps the 20-slot ring of
``test_config`` twice, so every slab holds blocks) is split into dp slabs, one a
rank.  One spawn of ``r2d2_tpu_torch.tools.rank_worker`` serves the draw,
row, feedback and super-step checks; the dp = 1 side runs in this process
in a gloo world of one.  JAX's uniforms are recomputed from its threefry
keys and fed to the port.

Tolerances: indices, ints, exchanged rows and the feedback slab bitwise
(against one slab; JAX's indices and ints too); densities within 1e-7
relative and IS weights within 1e-6 of JAX's (as
tests/test_torch_in_graph_per.py); the dp = 2 super-step against dp = 1
and against JAX's dp-layout ``pjit_in_graph_per_super_step`` at
tests/test_in_graph_per.py's tolerances — loss 1e-5 relative, priorities
1e-4 relative / 1e-7 absolute, params 1e-4 / 1e-6.  JAX's scatter leaves
a leaf drawn twice in one step unspecified, so against JAX those leaves
are left out.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu.learner import step as jstep
from r2d2_tpu.models.network import create_network as jax_create
from r2d2_tpu.models.network import init_params
from r2d2_tpu.parallel.mesh import make_mesh as jax_make_mesh
from r2d2_tpu.parallel.sharding import ShardingTable as JaxTable
from r2d2_tpu.parallel.sharding import pjit_in_graph_per_super_step
from r2d2_tpu_torch.learner import step as tstep
from r2d2_tpu_torch.models import params_from_flax
from r2d2_tpu_torch.parallel.distributed import init_distributed
from r2d2_tpu_torch.replay.device_ring import gather_batch
from r2d2_tpu_torch.tools import rank_worker
from r2d2_tpu_torch.tools.rank_worker import run_ranks
from test_torch_in_graph_per import filled, jax_uniforms, make_jcfg

A = 4
K_STEPS, DISPATCH = 2, 5
N_BLOCKS = 44
LOSS_RTOL = 1e-5
PRIO_TOL = dict(rtol=1e-4, atol=1e-7)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)


@contextlib.contextmanager
def world_of_one():
    """A gloo group of this process alone, torn down on the way out."""
    init_distributed(store=dist.HashStore(), world_size=1, rank=0,
                     device="cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


def global_ring(ring):
    meta = ring.per_meta()
    return dict(arrays={k: v.numpy().copy() for k, v in ring.arrays.items()},
                prios=ring.take_prios().numpy().copy(),
                seq_meta=meta["seq_meta"].numpy().copy(),
                first=meta["first"].numpy().copy())


def task_args(cfg, g, params=None):
    B = cfg.batch_size
    us = np.stack([jax_uniforms(cfg.seed, d, 1, B)[0][0] for d in (0, 3)])
    rng = np.random.default_rng(7)
    live = np.flatnonzero(g["prios"] > 0)
    # duplicated leaves, on both slabs
    fb_idx = rng.choice(live, B).astype(np.int64)
    fb_idx[1], fb_idx[-1] = fb_idx[0], fb_idx[B // 2]
    fb_vals = rng.uniform(0.1, 2.0, B).astype(np.float32)
    uk, _ = jax_uniforms(cfg.seed, DISPATCH, K_STEPS, B)
    return dict(cfg_kw={}, ring=g, us=us, fb_idx=fb_idx, fb_vals=fb_vals,
                params=params, uniforms=uk)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ring, JAX's ring and params, and the two ranks' results."""
    cfg, _, ring, _, jring = filled(N_BLOCKS)
    jcfg = make_jcfg()
    flax = init_params(jcfg, jax_create(jcfg, A), jax.random.PRNGKey(0))
    params = {k: v.numpy() for k, v in params_from_flax(
        jax.device_get(flax)).items()}
    g = global_ring(ring)
    args = task_args(cfg, g, params)
    ranks = run_ranks("cross_rank", 2, str(tmp_path_factory.mktemp("cr")),
                      args, timeout=150)
    return dict(cfg=cfg, g=g, jring=jring, flax=flax, params=params,
                args=args, ranks=ranks)


def test_draw_at_dp2_equals_one_slab(world):
    """Both ranks draw the same global strata, bitwise those of the
    sampler over the concatenated slab, with the whole batch's IS
    normalisation."""
    cfg, g = world["cfg"], world["g"]
    for j, u in enumerate(world["args"]["us"]):
        idx, w, ints = tstep._in_graph_sample(
            cfg, torch.from_numpy(u), torch.from_numpy(g["prios"]),
            torch.from_numpy(g["seq_meta"]), torch.from_numpy(g["first"]))
        _, q, _ = tstep._in_graph_sample_raw(
            cfg, torch.from_numpy(u), torch.from_numpy(g["prios"]),
            torch.from_numpy(g["seq_meta"]), torch.from_numpy(g["first"]))
        for r in world["ranks"]:
            d = r["draws"][j]
            np.testing.assert_array_equal(d["idx"], idx.numpy())
            np.testing.assert_array_equal(d["ints"], ints.numpy())
            np.testing.assert_array_equal(d["q"], q.numpy())
            np.testing.assert_array_equal(d["w"], w.numpy())
    # both slabs hold blocks that this batch draws
    owners = set(world["ranks"][0]["draws"][0]["idx"]
                 // (g["prios"].size // 2))
    assert owners == {0, 1}


def test_draw_matches_jax(world):
    """With JAX's uniforms, the global draw is JAX's: indices and ints
    bitwise, densities to 1e-7, weights to 1e-6."""
    cfg, jring = world["cfg"], world["jring"]
    jcfg = make_jcfg()
    jmeta = jring.per_meta()
    np.testing.assert_array_equal(np.asarray(jring.take_prios()),
                                  world["g"]["prios"])
    for j, dispatch in enumerate((0, 3)):
        _, keys = jax_uniforms(cfg.seed, dispatch, 1, cfg.batch_size)
        jidx, jq, jints = jstep._in_graph_sample_raw(
            jcfg, keys[0], jring.take_prios(), jmeta["seq_meta"],
            jmeta["first"], cfg.batch_size)
        _, jw, _ = jstep._in_graph_sample(
            jcfg, keys[0], jring.take_prios(), jmeta["seq_meta"],
            jmeta["first"])
        d = world["ranks"][1]["draws"][j]
        np.testing.assert_array_equal(d["idx"], np.asarray(jidx))
        np.testing.assert_array_equal(d["ints"], np.asarray(jints))
        np.testing.assert_allclose(d["q"], np.asarray(jq), rtol=1e-7)
        np.testing.assert_allclose(d["w"], np.asarray(jw), rtol=1e-6)


def test_exchange_rows_equal_the_whole_ring_gather(world):
    """Each rank's exchanged rows are its row slice of ``gather_batch``
    over the whole ring, bit for bit; each draw costs one leaf gather and
    one all_to_all per ring field."""
    cfg, g = world["cfg"], world["g"]
    arrays = {k: torch.from_numpy(v) for k, v in g["arrays"].items()}
    B = cfg.batch_size
    for j in range(len(world["args"]["us"])):
        d = world["ranks"][0]["draws"][j]
        whole = gather_batch(cfg, arrays, torch.from_numpy(d["ints"]),
                             torch.from_numpy(d["w"]))
        for r, res in enumerate(world["ranks"]):
            rows = slice(r * B // 2, (r + 1) * B // 2)
            got = res["rows"][j]
            assert set(got) == set(whole)
            for k, v in whole.items():
                assert got[k].dtype == v.numpy().dtype, k
                np.testing.assert_array_equal(got[k], v.numpy()[rows],
                                              err_msg=k)
    n = len(world["args"]["us"])
    for res in world["ranks"]:
        assert res["calls"]["draws"] == dict(all_gather=2 + n,
                                             all_to_all=7 * n)


def test_scatter_feedback_equals_scatter_last(world):
    """Feedback with duplicated leaves on both slabs: the concatenated
    slabs equal ``scatter_last`` over the whole leaf vector, bitwise, for
    one all_gather."""
    a, g = world["args"], world["g"]
    want = torch.from_numpy(g["prios"].copy())
    tstep.scatter_last(want, torch.from_numpy(a["fb_idx"]),
                       torch.from_numpy(a["fb_vals"]))
    got = np.concatenate([r["feedback"] for r in world["ranks"]])
    np.testing.assert_array_equal(got, want.numpy())
    assert (got != g["prios"]).any()
    for r in world["ranks"]:
        assert r["calls"]["feedback"] == dict(all_gather=1)


def test_super_step_dp2_matches_dp1_and_jax(world, tmp_path):
    """The meshed in-graph super-step (k = 2) over two slabs, against the
    same step over one rank holding the whole ring (the same strata) and
    against JAX's dp-layout pjit step on two virtual CPU devices fed the
    same dispatch."""
    cfg, g, args = world["cfg"], world["g"], world["args"]
    with world_of_one():
        one = rank_worker.task_cross_rank(**args)["super"]
    two = [r["super"] for r in world["ranks"]]
    assert two[0]["losses"].tolist() == two[1]["losses"].tolist()
    for j in range(K_STEPS):
        np.testing.assert_array_equal(two[0]["idx"][j], one["idx"][j])
        np.testing.assert_array_equal(two[1]["idx"][j], one["idx"][j])
    np.testing.assert_allclose(two[0]["losses"], one["losses"],
                               rtol=LOSS_RTOL)
    prios2 = np.concatenate([t["prios"] for t in two])
    np.testing.assert_allclose(prios2, one["prios"], **PRIO_TOL)
    for k, v in one["params"].items():
        np.testing.assert_allclose(two[0]["params"][k], v, **PARAM_TOL,
                                   err_msg=k)
        np.testing.assert_array_equal(two[0]["params"][k],
                                      two[1]["params"][k])
    for t in two + [one]:
        assert t["calls"] == dict(all_gather=2 + 2 * K_STEPS,
                                  all_to_all=7 * K_STEPS)

    # JAX's dp-layout step over its own copy of the ring
    jcfg = jax_test_config(device_replay=True, in_graph_per=True,
                           superstep_k=K_STEPS, mesh_shape=(("dp", 2),),
                           device_ring_layout="dp")
    jnet = jax_create(jcfg, A)
    table = JaxTable(jax_make_mesh(jcfg), jcfg)
    s0 = jstep.create_train_state(jcfg, world["flax"])
    fn = pjit_in_graph_per_super_step(jcfg, jnet, table, K_STEPS,
                                      state_template=s0, layout="dp")
    jring = world["jring"]
    jmeta = jring.per_meta()
    st, jprios, jlosses = fn(
        table.place_state(s0), jax.device_get(jring.snapshot()),
        np.asarray(jring.take_prios()), np.asarray(jmeta["seq_meta"]),
        np.asarray(jmeta["first"]), jnp.asarray(DISPATCH, jnp.uint32))
    np.testing.assert_allclose(two[0]["losses"], np.asarray(jlosses),
                               rtol=LOSS_RTOL)
    # leaves drawn twice within one step: unspecified in JAX
    twice = set()
    for idx in two[0]["idx"]:
        vals, counts = np.unique(idx, return_counts=True)
        twice |= set(vals[counts > 1].tolist())
    keep = np.ones(prios2.size, bool)
    keep[list(twice)] = False
    np.testing.assert_allclose(prios2[keep], np.asarray(jprios)[keep],
                               **PRIO_TOL)
    want = {k: v.numpy() for k, v in params_from_flax(
        jax.device_get(st.params)).items()}
    for k, v in two[0]["params"].items():
        np.testing.assert_allclose(v, want[k], **PARAM_TOL, err_msg=k)


def test_train_in_graph_per_over_two_ranks(tmp_path):
    """``train(cfg, use_mesh=True)`` with in-graph PER over two ranks,
    each holding its slab of the ring: every update on both ranks, finite
    and equal mean losses, equal summed env steps, the same params."""
    steps = 8
    r0, r1 = run_ranks("train", 2, str(tmp_path),
                       dict(cfg_kw=dict(device_replay=True,
                                        in_graph_per=True, superstep_k=2,
                                        training_steps=steps,
                                        log_interval=0.2)), timeout=150)
    for r in (r0, r1):
        assert r["num_updates"] == steps and not r["fabric_failed"]
        assert np.isfinite(r["mean_loss"])
        assert r["healthz"]["status"] == "ok"
        assert r["buffer_training_steps"] == steps
        assert r["fed"] == []       # priorities never leave the device
    assert r0["env_steps"] == r1["env_steps"] > 0
    assert r0["mean_loss"] == r1["mean_loss"]
    assert all(np.array_equal(r0["params"][k], r1["params"][k])
               for k in r0["params"])
    c = r0["collectives"]
    assert c == r1["collectives"] and c["ring"] == 2
