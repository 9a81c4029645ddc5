"""Dp groups that span ranks: the learner mesh at dp = 2 × tp = 2 and
dp = 2 × fsdp = 2 over four gloo ranks on the CPU.

A dp group is the ranks that share a dp coordinate; here each holds two.
Its leader (the lower rank) runs the group's data plane and broadcasts
each update's rows to its peer (``parallel/distributed.py:dp_group``,
``group_broadcast``).  Two spawns of ``r2d2_tpu_torch.tools.rank_worker``
task ``span`` — two ranks at dp = 2, four ranks at both spanning layouts
— each run, per layout, ``Learner.run`` over the same three global
batches, one in-graph super-step (k = 2) over the same ring with JAX's
uniforms, and the anakin plane for two dispatches.  Against dp = 2 alone:

- every rank of a group trains on its leader's staged rows bit for bit;
- the updates agree at the learner tolerances (loss 1e-5 relative,
  priorities 1e-4 / 1e-6, params 1e-4 / 1e-6: per-shard partial sums in
  another order), and with JAX's ``pjit_train_step`` on a one-process
  4-device CPU mesh at the same layout;
- only leaders feed priorities back, the rows dp = 2's, and the in-graph
  leaves they write equal dp = 2's slabs (1e-4 / 1e-7);
- the in-graph draw's indices are bitwise dp = 2's (which
  tests/test_torch_cross_rank.py ties to JAX's draw);
- the anakin trajectory (every integer and byte array) is bitwise
  dp = 2's, floats at tests/test_torch_anakin_mesh.py's tolerances, and
  the replicas of a group's slab are equal bit for bit;
- ``COLLECTIVE_CALLS["group_broadcast"]`` is one an update on the
  host-staged path, one an inner step in-graph, none in anakin — at
  dp = 2 too, where every group is one rank.

In a world of one: the broadcast's layout exchange, its refusals, and a
meshed ``train_sync`` that counts one broadcast an update.  ``-m slow``
adds ``train(cfg, use_mesh=True)`` at dp = 2 × tp = 2 in every drivetrain:
host ring, device-ring super-step, in-graph PER and anakin.
"""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu.learner.step import create_train_state as jax_train_state
from r2d2_tpu.models.network import create_network as jax_create_network
from r2d2_tpu.models.network import init_params
from r2d2_tpu.parallel.mesh import make_mesh as jax_make_mesh
from r2d2_tpu.parallel.sharding import ShardingTable as JaxTable
from r2d2_tpu.parallel.sharding import pjit_train_step
from r2d2_tpu.parallel.sharding import shard_batch as jax_shard_batch
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.learner.learner import DEVICE_BATCH_KEYS
from r2d2_tpu_torch.models.convert import params_from_flax
from r2d2_tpu_torch.parallel import distributed as pd
from r2d2_tpu_torch.parallel.mesh import make_mesh
from r2d2_tpu_torch.tools.rank_worker import run_ranks
from test_torch_anakin_mesh import BASE as ANAKIN_BASE
from test_torch_anakin_mesh import FLOAT_TOL
from test_torch_cross_rank import N_BLOCKS, global_ring
from test_torch_in_graph_per import filled, jax_uniforms
from test_torch_mesh_world4 import make_batch

A = 4
DP2 = (("dp", 2),)
TP = (("dp", 2), ("tp", 2))
FSDP = (("dp", 2), ("fsdp", 2))
STEPS, K, DISPATCHES = 3, 2, 2
LOSS_RTOL = 1e-5
PRIO_TOL = dict(rtol=1e-4, atol=1e-6)
LEAF_TOL = dict(rtol=1e-4, atol=1e-7)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def span(tmp_path_factory):
    """The inputs, and both spawns' results by layout and rank."""
    jcfg = jax_test_config(mesh_shape=TP)
    flax = init_params(jcfg, jax_create_network(jcfg, A),
                       jax.random.PRNGKey(11))
    params = {k: v.numpy() for k, v in params_from_flax(
        jax.device_get(flax)).items()}
    batches = [make_batch(jcfg, np.random.default_rng(50 + i))
               for i in range(STEPS)]
    cfg, _, ring, _, _ = filled(N_BLOCKS)
    uniforms, _ = jax_uniforms(cfg.seed, 5, K, cfg.batch_size)
    args = dict(params=params, batches=batches, ring=global_ring(ring),
                uniforms=uniforms.astype(np.float32), anakin_kw=ANAKIN_BASE,
                dispatches=DISPATCHES)
    two = run_ranks("span", 2, str(tmp_path_factory.mktemp("dp2")),
                    dict(args, layouts=[DP2]), timeout=150)
    four = run_ranks("span", 4, str(tmp_path_factory.mktemp("span")),
                     dict(args, layouts=[TP, FSDP]), timeout=240)
    return dict(flax=flax, batches=batches,
                ref=[r[DP2] for r in two],
                runs={lay: [r[lay] for r in four] for lay in (TP, FSDP)})


def _twin(span, r):
    """The dp = 2 rank that holds the same dp group as span rank ``r``."""
    return span["ref"][r["dp_index"]]


@pytest.mark.parametrize("layout", [TP, FSDP])
def test_every_rank_of_a_group_trains_on_the_leaders_rows(span, layout):
    ranks = span["runs"][layout]
    assert [(r["dp_index"], r["leader"]) for r in ranks] == [
        (0, True), (0, False), (1, True), (1, False)]
    assert [r["group"] for r in ranks] == [(0, 1), (0, 1), (2, 3), (2, 3)]
    per = port_test_config().batch_size // 2
    for r in ranks:
        rows = slice(r["dp_index"] * per, (r["dp_index"] + 1) * per)
        assert len(r["seen"]) == STEPS
        for seen, b in zip(r["seen"], span["batches"]):
            for k in DEVICE_BATCH_KEYS:
                np.testing.assert_array_equal(seen[k], b[k][rows],
                                              err_msg=k)
        # the dp = 2 rank of the same group saw the same bytes
        for seen, want in zip(r["seen"], _twin(span, r)["seen"]):
            for k in DEVICE_BATCH_KEYS:
                np.testing.assert_array_equal(seen[k], want[k], err_msg=k)


@pytest.mark.parametrize("layout", [TP, FSDP])
def test_update_matches_dp2_and_jax_at_the_same_layout(span, layout):
    ranks = span["runs"][layout]
    ref = span["ref"][0]
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
        np.testing.assert_allclose(r["losses"], ref["losses"],
                                   rtol=LOSS_RTOL)
        for k, v in ref["params"].items():
            np.testing.assert_allclose(r["params"][k], v, **PARAM_TOL,
                                       err_msg=k)
            np.testing.assert_array_equal(r["params"][k],
                                          ranks[0]["params"][k])
    jcfg = jax_test_config(mesh_shape=layout)
    jnet = jax_create_network(jcfg, A)
    table = JaxTable(jax_make_mesh(jcfg), jcfg)
    jstate = jax_train_state(jcfg, span["flax"])
    jstep = pjit_train_step(jcfg, jnet, table, state_template=jstate)
    jst = table.place_state(jstate)
    for i, b in enumerate(span["batches"]):
        jst, jloss, jp = jstep(jst, jax_shard_batch(table, dict(b)))
        assert ranks[0]["losses"][i] == pytest.approx(float(jloss),
                                                      rel=LOSS_RTOL)
        got = np.concatenate([ranks[0]["fed"][i][1],
                              ranks[2]["fed"][i][1]])
        np.testing.assert_allclose(got, np.asarray(jp), **PRIO_TOL)
    want = {k: v.numpy() for k, v in params_from_flax(
        jax.device_get(jst.params)).items()}
    for k, v in ranks[0]["params"].items():
        np.testing.assert_allclose(v, want[k], **PARAM_TOL, err_msg=k)


@pytest.mark.parametrize("layout", [TP, FSDP])
def test_only_leaders_feed_back_the_dp2_rows(span, layout):
    for r in span["runs"][layout]:
        ref = _twin(span, r)
        if not r["leader"]:
            assert r["fed"] == []
            assert r["in_graph"]["leaves"] is None
            continue
        assert len(r["fed"]) == STEPS
        for (idx, p), (ridx, rp) in zip(r["fed"], ref["fed"]):
            np.testing.assert_array_equal(idx, ridx)
            np.testing.assert_allclose(p, rp, **PRIO_TOL)
        np.testing.assert_allclose(r["in_graph"]["leaves"],
                                   ref["in_graph"]["leaves"], **LEAF_TOL)


@pytest.mark.parametrize("layout", [TP, FSDP])
def test_in_graph_draw_is_dp2s_bit_for_bit(span, layout):
    """Leaders draw over the leaders' dp axis; a peer receives the rows
    and their leaf indices from its leader: every rank records dp = 2's
    indices, and the two inner steps' losses agree."""
    ref = span["ref"][0]["in_graph"]
    for r in span["runs"][layout]:
        got = r["in_graph"]
        assert len(got["idx"]) == K
        for a, b in zip(got["idx"], ref["idx"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(got["losses"], ref["losses"],
                                   rtol=LOSS_RTOL)
        for k, v in ref["params"].items():
            np.testing.assert_allclose(got["params"][k], v, **PARAM_TOL,
                                       err_msg=k)


@pytest.mark.parametrize("layout", [TP, FSDP])
def test_anakin_trajectory_is_dp2s_and_the_replicas_agree(span, layout):
    ranks = span["runs"][layout]
    ref = span["ref"][0]["anakin"]
    for r in ranks:
        a = r["anakin"]
        np.testing.assert_allclose(a["losses"], ref["losses"], rtol=1e-4)
        assert a["counters"] == ref["counters"]
        assert sorted(a["payload"]) == sorted(ref["payload"])
        for k, v in ref["payload"].items():
            if v.dtype.kind in "iub":      # the trajectory: bit for bit
                np.testing.assert_array_equal(a["payload"][k], v,
                                              err_msg=k)
            else:
                np.testing.assert_allclose(a["payload"][k], v, **FLOAT_TOL,
                                           err_msg=k)
        for k, v in a["payload"].items():
            np.testing.assert_array_equal(v, ranks[0]["anakin"]["payload"]
                                          [k], err_msg=k)
        for k, v in ref["params"].items():
            np.testing.assert_allclose(a["params"][k], v, **PARAM_TOL,
                                       err_msg=k)
    # each group's two replicas of its slab, bit for bit
    for lead, peer in ((ranks[0], ranks[1]), (ranks[2], ranks[3])):
        slab = lead["anakin"]["slab"]
        assert slab and sorted(slab) == sorted(peer["anakin"]["slab"])
        for k, v in slab.items():
            np.testing.assert_array_equal(peer["anakin"]["slab"][k], v,
                                          err_msg=k)


@pytest.mark.parametrize("layout", [DP2, TP, FSDP])
def test_group_broadcast_counts(span, layout):
    """One broadcast an update on the host-staged path, one an inner step
    in-graph, none in anakin (every rank of a group steps its lanes); at
    dp = 2 every group is one rank and the broadcasts are still made."""
    ranks = span["ref"] if layout == DP2 else span["runs"][layout]
    for r in ranks:
        assert r["host_broadcasts"] == STEPS
        assert r["in_graph"]["broadcasts"] == K
        assert r["anakin"]["broadcasts"] == 0


@pytest.fixture
def world_of_one():
    pd.init_distributed(store=dist.HashStore(), world_size=1, rank=0,
                        device="cpu")
    pd.bind_learner_thread()
    try:
        yield make_mesh(port_test_config(), "cpu")
    finally:
        pd.unbind_learner_thread()
        dist.destroy_process_group()


def test_group_broadcast_in_a_world_of_one(world_of_one):
    """A group of one: the leader gets its own tensors back, the first
    call of a tag agrees the layout, a later call in another layout
    raises, and a leader that passes nothing raises; each call counts
    once."""
    span = pd.dp_group(world_of_one)
    assert (span.index, span.ranks, span.leader, span.is_leader,
            span.size) == (0, (0,), 0, True, 1)
    pd.COLLECTIVE_CALLS.clear()
    ts = [torch.arange(6, dtype=torch.int32).view(2, 3),
          torch.ones(5, dtype=torch.bool), torch.rand(3, 1)]
    got = pd.group_broadcast(span, ts, tag="t")
    assert all(a is b for a, b in zip(got, ts))
    assert span.layouts["t"] == [((2, 3), torch.int32), ((5,), torch.bool),
                                 ((3, 1), torch.float32)]
    pd.group_broadcast(span, ts, tag="t")
    with pytest.raises(ValueError, match="layout changed"):
        pd.group_broadcast(span, ts[:2], tag="t")
    with pytest.raises(ValueError, match="leader passes the tensors"):
        pd.group_broadcast(span, None, tag="t")
    assert pd.COLLECTIVE_CALLS["group_broadcast"] == 2


def test_meshed_train_sync_at_world_size_one_broadcasts_every_update():
    from r2d2_tpu_torch import train as ttrain

    steps = 3
    cfg = port_test_config(game_name="Fake", act_device="cpu",
                           training_steps=steps)
    pd.COLLECTIVE_CALLS.clear()
    m = ttrain.train_sync(cfg, use_mesh=True, device="cpu")
    assert m["num_updates"] == steps and len(m["losses"]) == steps
    assert pd.COLLECTIVE_CALLS["group_broadcast"] == steps
    assert pd.COLLECTIVE_CALLS["gate"] == steps


SPAN_RUNS = [
    dict(sync=True, mesh_shape=TP, training_steps=4),
    dict(mesh_shape=TP, training_steps=4, log_interval=0.2),
    dict(mesh_shape=TP, device_replay=True, superstep_k=2,
         device_ring_layout="dp", training_steps=4, log_interval=0.2),
    dict(mesh_shape=TP, device_replay=True, in_graph_per=True,
         superstep_k=2, device_ring_layout="dp", training_steps=4,
         log_interval=0.2),
    dict(ANAKIN_BASE, mesh_shape=TP, training_steps=4, log_interval=0.2),
]


@pytest.mark.slow
def test_train_at_dp2_tp2_in_every_drivetrain(tmp_path):
    """``train(cfg, use_mesh=True)`` (and ``train_sync``) over four ranks
    at dp = 2 × tp = 2: the host ring (sync and threaded), the device
    ring's host-sampled super-step, in-graph PER and anakin.  Every rank
    takes every update and ends with the same params; a leader's buffer
    counts one feedback an update, a peer has none; the env steps are
    the leaders' summed; the broadcasts follow the design's count."""
    out = run_ranks("span_train", 4, str(tmp_path),
                    dict(runs=SPAN_RUNS), timeout=280)
    for i, run in enumerate(SPAN_RUNS):
        ranks = [r[i] for r in out]
        anakin = run.get("actor_transport") == "anakin"
        for rank, r in enumerate(ranks):
            # anakin: every rank of a group steps the group's lanes
            peer = rank % 2 == 1 and not anakin
            updates = r["num_updates"]
            assert updates >= run["training_steps"], (run, r)
            assert not r["fabric_failed"]
            assert bool(r["peer"]) == peer
            assert r["env_steps"] == ranks[0]["env_steps"] > 0
            for k, v in r["params"].items():
                np.testing.assert_array_equal(v, ranks[0]["params"][k])
            c = r["collectives"]
            assert c == ranks[0]["collectives"]
            if anakin:
                assert "group_broadcast" not in c
            elif run.get("in_graph_per"):
                assert c["group_broadcast"] == updates
            else:
                assert c["group_broadcast"] == (
                    updates // run.get("superstep_k", 1))
            if not run.get("sync"):
                assert r["buffer_training_steps"] == (0 if peer
                                                      else updates)
