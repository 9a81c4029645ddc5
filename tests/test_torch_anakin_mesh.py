"""The anakin fused loop on the learner mesh, over gloo ranks on the CPU.

Mirrors tests/test_anakin_mesh.py.  A dp = 2 plane (two processes of
``r2d2_tpu_torch.tools.rank_worker``, each stepping two of the four lanes
over its slab of the ring) against the meshless plane (dp = 1) after four
dispatches: the trajectory — every integer and byte array of the carry,
the ring and the PER metadata — bitwise, floats to 1e-4 relative / 1e-5
absolute, params to 1e-4 / 1e-6, the PER mass to 1e-5 (JAX's
tolerances there).  The dp = 2 snapshot reads into the meshless plane bit
for bit and trains on.  One routed emit over two ranks against the
meshless emit (bitwise) and JAX's ``_make_emit`` (integers, bytes,
hiddens and discounts bitwise; n-step returns and priorities to 1e-5, the
port's anakin tolerance).  One result fetch per dispatch at dp = 1 and 2,
and ``train(..., use_mesh=True)`` over two ranks.
"""
import contextlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu.learner import anakin as janakin
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.learner import anakin as tanakin
from r2d2_tpu_torch.learner.learner import Learner
from r2d2_tpu_torch.learner.step import create_train_state
from r2d2_tpu_torch.models import create_network
from r2d2_tpu_torch.parallel.distributed import init_distributed
from r2d2_tpu_torch.replay.device_ring import DeviceRing
from r2d2_tpu_torch.tools import rank_worker
from r2d2_tpu_torch.tools.rank_worker import run_ranks
from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS

A = 4
DISPATCHES = 4
BASE = dict(game_name="Fake", actor_transport="anakin", device_replay=True,
            in_graph_per=True, num_actors=4, superstep_k=2,
            anakin_episode_len=12, training_steps=24, learning_starts=16,
            device_ring_layout="dp")
FLOAT_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)


def anakin_config(**kw):
    return port_test_config(**{**BASE, **kw})


@contextlib.contextmanager
def world_of_one():
    init_distributed(store=dist.HashStore(), world_size=1, rank=0,
                     device="cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


def meshless(cfg, seed=0):
    net = create_network(cfg, A, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    learner = Learner(cfg, net, create_train_state(cfg, net.state_dict()))
    plane = tanakin.AnakinPlane(cfg, net, A, DeviceRing(cfg, A,
                                                        device="cpu"))
    return plane, learner


def drive(plane, learner, dispatches):
    while not plane.ready:
        plane.rollout_step(learner.state.params)
    losses = []
    for _ in range(dispatches):
        learner.state, res = plane.dispatch(learner.state)
        losses.append(plane.harvest(res).tolist())
    return losses


def assert_payload_parity(a, b):
    assert sorted(a) == sorted(b)
    for k in sorted(a):
        if a[k].dtype.kind in "iub":        # the trajectory: bit for bit
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            np.testing.assert_allclose(a[k], b[k], **FLOAT_TOL, err_msg=k)


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    d = tmp_path_factory.mktemp("anakin_dp2")
    path = os.path.join(d, "anakin.bin")
    ranks = run_ranks("anakin", 2, str(d / "ranks"),
                      dict(cfg_kw=BASE, dispatches=DISPATCHES,
                           snap_path=path), timeout=150)
    plane, learner = meshless(anakin_config())
    losses = drive(plane, learner, DISPATCHES)
    return dict(ranks=ranks, path=path, plane=plane, learner=learner,
                losses=losses)


def test_dp2_content_parity_with_dp1(dp2):
    """dp = 2 against dp = 1 after four dispatches: the same trajectory
    bit for bit, floats and params at reduction round-off, the same PER
    mass; both ranks hold the same gathered state and counters."""
    r0, r1 = dp2["ranks"]
    np.testing.assert_allclose(r0["losses"], dp2["losses"], rtol=1e-4)
    assert r0["losses"] == r1["losses"]
    s1 = dp2["plane"]._payload()
    for r in (r0, r1):
        assert_payload_parity(s1, r["payload"])
        assert r["counters"] == r0["counters"]
    for k in s1:
        np.testing.assert_array_equal(r0["payload"][k], r1["payload"][k])
    np.testing.assert_allclose(float(s1["per_prios"].sum()),
                               float(r0["payload"]["per_prios"].sum()),
                               rtol=1e-5)
    for k, v in dp2["learner"].state.params.items():
        np.testing.assert_allclose(r0["params"][k], v.numpy(), **PARAM_TOL,
                                   err_msg=k)
    for f in ("env_steps", "fill", "blocks", "episodes_total",
              "training_steps", "dispatch_no"):
        assert r0["counters"][f] == getattr(dp2["plane"], f), f


def test_dp2_snapshot_resumes_on_dp1(dp2):
    """The layout-free snapshot: rank 0 writes the dp = 2 plane's gathered
    state, the meshless plane reads it back bit for bit, with the
    counters, and trains on."""
    r0 = dp2["ranks"][0]
    plane, learner = dp2["plane"], dp2["learner"]
    plane.read_state(dp2["path"], r0["meta"])
    got = plane._payload()
    for k, v in r0["payload"].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert plane.dispatch_no == r0["counters"]["dispatch_no"]
    assert plane.env_steps == r0["counters"]["env_steps"]
    for _ in range(2):
        learner.state, res = plane.dispatch(learner.state)
        assert np.isfinite(plane.harvest(res)).all()


def test_one_fetch_per_dispatch_at_dp1_and_dp2(dp2):
    """One ``anakin.result_fetch`` per rollout and per dispatch on every
    rank at dp = 2, and at dp = 1 on the mesh (a world of one), whose
    state is the meshless plane's bit for bit.  The collectives per
    dispatch are the design's: per actor step two emits, each one gather
    of the cut vector and one all_to_all of the blocks; per inner step
    the leaves and metadata gathered, seven row exchanges, the feedback
    gathered; one all_reduce of the lanes' counters."""
    cfg = anakin_config()
    k, E = cfg.superstep_k, cfg.anakin_env_steps_per_update
    steps = k * E
    for r in dp2["ranks"]:
        assert r["fetches"] == r["rollouts"] + DISPATCHES
        assert r["calls_rollout"] == dict(
            all_gather=2 * steps * r["rollouts"],
            all_to_all=2 * steps * r["rollouts"],
            all_reduce=r["rollouts"])
        assert r["calls_train"] == dict(
            all_gather=DISPATCHES * (2 * steps + 4 * k),
            all_to_all=DISPATCHES * (2 * steps + 7 * k),
            all_reduce=DISPATCHES)
    HOST_TRANSFERS.reset()
    with world_of_one():
        one = rank_worker.task_anakin(BASE, DISPATCHES)
    assert one["fetches"] == one["rollouts"] + DISPATCHES
    plane, learner = meshless(anakin_config())
    losses = drive(plane, learner, DISPATCHES)
    assert one["losses"] == losses
    ref = plane._payload()
    for k_, v in one["payload"].items():
        np.testing.assert_array_equal(v, ref[k_], err_msg=k_)


def test_routed_emit_matches_meshless_and_jax(tmp_path):
    """One emit whose window of slots crosses the slab boundary, cut
    lanes on both ranks: the routed slabs, concatenated, are the meshless
    emit's ring bit for bit, and JAX's ``_make_emit``'s from the same
    carry and cut vector."""
    cfg = anakin_config()
    jcfg = jax_test_config(**BASE)
    N, NB, K = cfg.num_actors, cfg.num_blocks, cfg.seqs_per_block
    cap, BL = cfg.max_block_steps, cfg.block_length
    layers, H = cfg.lstm_layers, cfg.hidden_dim
    rng = np.random.default_rng(3)
    ast = dict(
        buf_obs=rng.integers(0, 256, (N, cap, *cfg.stored_obs_shape),
                             dtype=np.uint8),
        buf_last_action=rng.random((N, cap, A)) < 0.3,
        buf_last_reward=rng.normal(size=(N, cap)).astype(np.float32),
        buf_hidden=rng.normal(size=(N, cap, 2, layers, H)).astype(
            np.float32),
        buf_action=rng.integers(0, A, (N, BL)).astype(np.uint8),
        buf_reward=rng.normal(size=(N, BL)).astype(np.float32),
        buf_qval=rng.normal(size=(N, BL + 1, A)).astype(np.float32),
        prefix=rng.integers(0, cfg.burn_in_steps + 1, N).astype(np.int32),
        size=np.array([BL, 3, BL, 5], np.int32),
        ptr=np.array(NB // 2 - 2, np.int32),
        block_learning_total=rng.integers(0, 9, NB).astype(np.int32),
        fill=np.array(100, np.int32), env_steps_d=np.array(0, np.int32),
        blocks_d=np.array(0, np.int32))
    ring = dict(
        arrays={k: (rng.integers(0, 256, v.shape, dtype=np.uint8)
                    if v.dtype == torch.uint8 else
                    rng.random(v.shape) < 0.5 if v.dtype == torch.bool
                    else rng.normal(size=v.shape).astype(np.float32))
                for k, v in DeviceRing(cfg, A, device="cpu").arrays.items()},
        prios=rng.uniform(0.1, 1, NB * K).astype(np.float32),
        seq_meta=rng.integers(0, 9, (NB, K, 3)).astype(np.int32),
        first=rng.integers(0, 9, NB).astype(np.int32))
    cut = np.array([True, False, True, True])
    last_q = rng.normal(size=(N, A)).astype(np.float32)

    ranks = run_ranks("emit", 2, str(tmp_path),
                      dict(cfg_kw=BASE, ast=ast, ring=ring, cut=cut,
                           last_q=last_q, done=False), timeout=90)
    routed = {k: np.concatenate([r["arrays"][k] for r in ranks])
              for k in ring["arrays"]}
    routed.update({k: np.concatenate([r[k] for r in ranks])
                   for k in ("prios", "seq_meta", "first")})

    # the meshless emit on the same carry
    t = {k: torch.from_numpy(np.array(v)) for k, v in ast.items()}
    arrays = {k: torch.from_numpy(v.copy()) for k, v in
              ring["arrays"].items()}
    per = {k: torch.from_numpy(ring[k].copy())
           for k in ("prios", "seq_meta", "first")}
    emit = tanakin._make_emit(cfg, A, False, torch.device("cpu"))
    out = emit(t, arrays, per["prios"], per["seq_meta"], per["first"],
               torch.from_numpy(cut), torch.from_numpy(last_q))
    want = {k: v.numpy() for k, v in arrays.items()}
    want.update({k: v.numpy() for k, v in per.items()})
    for k in want:
        np.testing.assert_array_equal(routed[k], want[k], err_msg=k)
        assert (routed[k] != {**ring["arrays"], **ring}[k]).any(), k
    for r in ranks:
        for k, v in r["carry"].items():
            np.testing.assert_array_equal(v, out[k].numpy(), err_msg=k)

    # JAX's emit (dp = 1): non-cut lanes dropped, cut lanes written
    jemit = janakin._make_emit(jcfg, A, False)
    jast, jarrays, jprios, jmeta, jfirst = jemit(
        {k: jnp.asarray(v) for k, v in ast.items()},
        {k: jnp.asarray(v) for k, v in ring["arrays"].items()},
        jnp.asarray(ring["prios"]), jnp.asarray(ring["seq_meta"]),
        jnp.asarray(ring["first"]), jnp.asarray(cut), jnp.asarray(last_q))
    jax_out = {k: np.asarray(v) for k, v in jarrays.items()}
    jax_out.update(prios=np.asarray(jprios), seq_meta=np.asarray(jmeta),
                   first=np.asarray(jfirst))
    for k, v in jax_out.items():
        if k in ("n_step_reward", "prios"):
            np.testing.assert_allclose(routed[k], v, rtol=0, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(routed[k], v, err_msg=k)
    for k in ("ptr", "fill", "env_steps_d", "blocks_d",
              "block_learning_total"):
        np.testing.assert_array_equal(ranks[0]["carry"][k],
                                      np.asarray(jast[k]), err_msg=k)


def test_train_anakin_over_two_ranks(tmp_path):
    """``train(cfg, use_mesh=True)`` with the anakin transport over two
    ranks: every update on both, finite losses, the same counters and
    params on both ranks, /healthz ok."""
    kw = {k: v for k, v in BASE.items() if k != "game_name"}
    r0, r1 = run_ranks("train", 2, str(tmp_path),
                       dict(cfg_kw=dict(kw, training_steps=8,
                                        log_interval=0.2)), timeout=150)
    for r in (r0, r1):
        assert r["num_updates"] == 8 and not r["fabric_failed"]
        assert np.isfinite(r["mean_loss"])
        assert r["buffer_training_steps"] == 8
        assert r["healthz"]["status"] == "ok"
    assert r0["env_steps"] == r1["env_steps"] > 0
    assert r0["mean_loss"] == r1["mean_loss"]
    assert all(np.array_equal(r0["params"][k], r1["params"][k])
               for k in r0["params"])
    assert r0["collectives"]["gate"] == r1["collectives"]["gate"] > 0
