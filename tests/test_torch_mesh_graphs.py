"""The meshed entries as CUDA graphs (ROADMAP.md A's third host-bound
cut), checked on the CPU, where their graph-ready bodies run eagerly over
gloo ranks.

On a card the meshed train step, both meshed super-steps and the meshed
anakin entries each replay a CUDA graph that holds their collectives
(learner/graphs.py, utils/graphs.py).  These tests pin what a card run
rests on:

1. **Addresses** — a DTensor is keyed by its local shard's address
   (``utils/graphs.address``), which an optimizer step keeps.
2. **The graph-ready bodies** — each meshed entry, as its graph's users
   call it, against today's eager meshed entry from the same state:
   loss, priorities, the diag rows, every param and moment, the PER slab,
   the anakin carry and payload bit for bit, with learnhealth armed and
   disarmed and in both anakin lane layouts, over one gloo rank and two.
3. **Replayed counts** — a replay adds the collectives its capture
   recorded (the warm-up and the capture add none), and each entry issues
   the design's collectives per update, inner step and actor step.
4. **Trace counts** — the meshed entries' traces equal JAX's at the same
   layout.
"""
import contextlib
import threading

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu.learner import anakin as janakin
from r2d2_tpu.learner import step as jstep
from r2d2_tpu.learner.learner import Learner as JaxLearner
from r2d2_tpu.models.network import create_network as jax_create
from r2d2_tpu.models.network import init_params
from r2d2_tpu.parallel import sharding as jsharding
from r2d2_tpu.parallel.mesh import make_mesh as jax_make_mesh
from r2d2_tpu.replay.device_ring import DeviceRing as JaxDeviceRing
from r2d2_tpu.utils import trace as jtrace
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.learner import anakin as tanakin
from r2d2_tpu_torch.learner import graphs as tgraphs
from r2d2_tpu_torch.learner import step as tstep
from r2d2_tpu_torch.learner.learner import Learner
from r2d2_tpu_torch.models import create_network
from r2d2_tpu_torch.parallel.cross_rank import CROSS_RANK_CALLS, CrossRank
from r2d2_tpu_torch.parallel.distributed import (
    COLLECTIVE_CALLS,
    dp_group,
    init_distributed,
    local_rows,
)
from r2d2_tpu_torch.parallel.mesh import make_mesh
from r2d2_tpu_torch.parallel.sharding import (
    ShardingTable,
    full,
    gather_state,
    mesh_step,
    mesh_super_step,
    mesh_train_step,
)
from r2d2_tpu_torch.replay.device_ring import DeviceRing, gather_batch
from r2d2_tpu_torch.tools.rank_worker import run_ranks
from r2d2_tpu_torch.utils import graphs as ugraphs
from r2d2_tpu_torch.utils.trace import KERNEL_LAUNCHES, RetraceGuard

A = 4
ANAKIN = dict(game_name="Fake", actor_transport="anakin", device_replay=True,
              in_graph_per=True, num_actors=2, superstep_k=2,
              anakin_episode_len=12, training_steps=10 ** 9,
              learning_starts=16, anakin_eval_interval=2)


@contextlib.contextmanager
def world_of_one():
    init_distributed(store=dist.HashStore(), world_size=1, rank=0,
                     device="cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


def batch_of(cfg, seed):
    rng = np.random.default_rng(seed)
    B, T, L = cfg.batch_size, cfg.seq_len, cfg.learning_steps
    return dict(
        obs=rng.integers(0, 255, (B, T, *cfg.stored_obs_shape), np.uint8),
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
        is_weights=rng.uniform(0.3, 1.0, B).astype(np.float32))


def torch_batch(cfg, seed):
    return {k: torch.from_numpy(v) for k, v in batch_of(cfg, seed).items()}


def placed_pair(cfg, net, table):
    return tuple(table.place_state(tstep.create_train_state(
        cfg, net.state_dict())) for _ in range(2))


def same_state(a, b) -> bool:
    """Two DTensor states bit for bit: mirrors, device counters and every
    leaf gathered whole."""
    fa, fb = gather_state(a), gather_state(b)
    return (a.step == b.step and a.opt_state.count == b.opt_state.count
            and torch.equal(a.step_t, b.step_t)
            and torch.equal(a.opt_state.count_t, b.opt_state.count_t)
            and all(torch.equal(x[k], y[k]) for x, y in (
                (fa.params, fb.params), (fa.target_params, fb.target_params),
                (fa.opt_state.mu, fb.opt_state.mu),
                (fa.opt_state.nu, fb.opt_state.nu)) for k in x))


def todays_mesh_step(cfg, net, table):
    """The eager meshed train step as the port ran it before its graph: the
    rows wrapped as the dp-sharded DTensor batch, the step under implicit
    replication, the loss and the diag gathered whole, the priorities this
    rank's rows."""
    step = tstep.make_train_step(cfg, net,
                                 learnhealth=cfg.learnhealth_interval > 0)
    pl = table.batch_shardings()

    def run(state, batch):
        batch = {k: DTensor.from_local(v, table.mesh, list(pl[k]))
                 for k, v in batch.items()}
        with implicit_replication():
            out = step(state, batch)
        return ((out[0], full(out[1]), local_rows(out[2]))
                + tuple(full(x) for x in out[3:]))
    return run


def random_ring(cfg, seed=0):
    NB, K = cfg.num_blocks, cfg.seqs_per_block
    rng = np.random.default_rng(seed)
    arrays = {}
    for k, v in DeviceRing(cfg, A, device="cpu").arrays.items():
        if v.dtype == torch.uint8:
            t = torch.from_numpy(rng.integers(0, 256, v.shape,
                                              dtype=np.uint8))
        elif v.dtype == torch.bool:
            t = torch.from_numpy(rng.random(v.shape) < 0.5)
        else:
            t = torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
        arrays[k] = t % A if k == "action" else t
    prios = torch.from_numpy(rng.uniform(0.0, 2.0, NB * K).astype(np.float32))
    prios[::5] = 0.0
    seq_meta = torch.from_numpy(np.stack([
        rng.integers(0, cfg.burn_in_steps + 1, (NB, K)),
        rng.integers(1, cfg.learning_steps + 1, (NB, K)),
        rng.integers(1, cfg.forward_steps + 1, (NB, K))], -1)
        .astype(np.int32))
    first = torch.from_numpy(rng.integers(
        cfg.burn_in_steps, cfg.burn_in_steps + 3, NB).astype(np.int32))
    return arrays, prios, seq_meta, first


# ------------------------------------------------------------- addresses

def test_a_dtensors_address_is_its_local_shards_across_a_step():
    """Every leaf of a placed state keys by its local shard's address, and
    a meshed step (the optimizer writing each shard in place) keeps every
    one; a plain tensor keys by its own."""
    cfg = port_test_config()
    net = create_network(cfg, A, device="cpu")
    with world_of_one():
        table = ShardingTable(make_mesh(cfg, "cpu"), cfg)
        state, _ = placed_pair(cfg, net, table)
        step = mesh_train_step(cfg, net, table, state_template=state,
                               guard=RetraceGuard())
        step(state, torch_batch(cfg, 0))
        leaves = tgraphs._state_tensors(state)
        before = [ugraphs.address(t) for t in leaves]
        assert all(isinstance(v, DTensor) for v in state.params.values())
        assert before == [t.to_local().data_ptr() if isinstance(t, DTensor)
                          else t.data_ptr() for t in leaves]
        for seed in (1, 2):
            step(state, torch_batch(cfg, seed))
        assert [ugraphs.address(t) for t in leaves] == before
        clone = tgraphs._clone_state(state)
        assert all(isinstance(v, DTensor) and v.placements == w.placements
                   and torch.equal(v.full_tensor(), w.full_tensor())
                   and ugraphs.address(v) != ugraphs.address(w)
                   for v, w in zip(clone.params.values(),
                                   state.params.values()))


# --------------------------------------------------- graph-ready bodies

@pytest.mark.parametrize("lh", [0, 2])
def test_meshed_train_step_is_todays_eager_step(lh):
    """``mesh_train_step`` (its graph's body, eager here) against today's
    eager meshed step from the same DTensor state over six batches and
    three target syncs: loss, priorities, the diag rows (armed and
    disarmed) and the whole state bit for bit; a DTensor batch and its
    plain rows give the same step; one trace, two with the diagnostics."""
    cfg = port_test_config(learnhealth_interval=lh, target_net_update_interval=2)
    net = create_network(cfg, A, device="cpu")
    with world_of_one():
        table = ShardingTable(make_mesh(cfg, "cpu"), cfg)
        a, b = placed_pair(cfg, net, table)
        guard = RetraceGuard()
        graphed = mesh_train_step(cfg, net, table, state_template=a,
                                  guard=guard)
        today = todays_mesh_step(cfg, net, table)
        pl = table.batch_shardings()
        for seed in range(6):
            batch = torch_batch(cfg, seed)
            if seed % 2:
                batch = {k: DTensor.from_local(v, table.mesh, list(pl[k]))
                         for k, v in batch.items()}
            ga = graphed(a, batch)
            gb = today(b, {k: local_rows(v) for k, v in batch.items()})
            assert ga[0] is a and len(ga) == len(gb) == (4 if lh else 3)
            for x, y in zip(ga[1:], gb[1:]):
                assert not isinstance(x, DTensor) and torch.equal(x, y)
            assert same_state(a, b)
            if lh:
                assert bool(ga[3].any()) == (a.step % lh == 0)
        assert guard.counts() == {"learner.train_step": 2 if lh else 1}


@pytest.mark.parametrize("lh", [0, 2])
def test_meshed_super_steps_are_todays_eager_entries(lh):
    """Both meshed super-steps against today's eager entries from the same
    state and ring: the host-sampled one (``run`` on k gathered batches)
    against k of today's meshed steps, and the in-graph one over the
    cross-rank draw with the dp group's broadcast against the meshless
    in-graph super-step (what a world of one draws): losses, the diag
    rows, sampled indices, the priority slab and every param bit for bit,
    and the design's collectives per call."""
    cfg = port_test_config(device_replay=True, in_graph_per=True, superstep_k=3,
                      learnhealth_interval=lh, target_net_update_interval=2)
    k, B = cfg.superstep_k, cfg.batch_size
    net = create_network(cfg, A, device="cpu")
    arrays, prios, seq_meta, first = random_ring(cfg)
    with world_of_one():
        mesh = make_mesh(cfg, "cpu")
        table = ShardingTable(mesh, cfg)
        a, b = placed_pair(cfg, net, table)
        fused = mesh_super_step(cfg, net, table, k, state_template=a,
                                guard=RetraceGuard())
        today = todays_mesh_step(cfg, net, table)
        u = torch.rand((2, k, B), generator=torch.Generator().manual_seed(3))
        for d in range(2):
            batches = []
            for j in range(k):
                _, w, ints = tstep._in_graph_sample(cfg, u[d, j], prios,
                                                    seq_meta, first)
                batches.append(gather_batch(cfg, arrays, ints, w))
            got = fused.run(a, batches)
            want = [today(b, x)[1:] for x in batches]
            for col, ref in zip(got[1:], zip(*want)):
                assert torch.equal(col, torch.stack(ref))
            assert same_state(a, b)

        # in-graph: the meshed entry against the meshless one
        a, _ = placed_pair(cfg, net, table)
        plain_state = tstep.create_train_state(cfg, net.state_dict())
        cross = CrossRank(cfg, mesh, cfg.num_blocks, span=dp_group(mesh))
        meshed = tstep.make_in_graph_per_super_step_fn(
            cfg, net, k, train_step=mesh_step(cfg, net, table, a),
            cross=cross, learnhealth=lh > 0, guard=RetraceGuard())
        meshless = tstep.make_in_graph_per_super_step_fn(
            cfg, net, k, learnhealth=lh > 0, guard=RetraceGuard())
        pa, pb = prios.clone(), prios.clone()
        metas = []
        for d in range(2):
            ra, rb = [], []
            CROSS_RANK_CALLS.clear()
            COLLECTIVE_CALLS.clear()
            ga = meshed(a, arrays, pa, seq_meta, first, uniforms=u[d],
                        record=ra)
            calls = (dict(CROSS_RANK_CALLS),
                     COLLECTIVE_CALLS["group_broadcast"])
            gb = meshless(plain_state, arrays, pb, seq_meta, first,
                          uniforms=u[d], record=rb)
            metas.append([ugraphs.address(t) for t in cross.global_meta(
                seq_meta, first)])
            assert calls == (dict(all_gather=2 + 2 * k, all_to_all=7 * k),
                             k)
            assert len(ra) == k and all(torch.equal(x, y)
                                        for x, y in zip(ra, rb))
            for x, y in zip(ga[1:], gb[1:]):
                assert torch.equal(x, y)
            full_a = gather_state(a)
            assert all(torch.equal(full_a.params[n], plain_state.params[n])
                       for n in full_a.params)
        # the gathered metadata keeps its buffers, call after call
        assert metas[0] == metas[1]


def anakin_pair(cfg, table, replicate):
    net = create_network(cfg, A, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    learner = Learner(cfg, net, tstep.create_train_state(cfg,
                                                         net.state_dict()),
                      mesh=table.mesh, table=table)
    plane = tanakin.AnakinPlane(cfg, net, A, DeviceRing(
        cfg, A, device="cpu", layout="dp"), table=table,
        state_template=learner.state, replicate_lanes=replicate)
    lanes = (0, cfg.num_actors)
    roll = tanakin.make_anakin_rollout(cfg, net, plane.env, A,
                                       plane.roll_steps, lanes, plane.cross,
                                       replicate)
    step = tanakin.make_anakin_super_step(
        cfg, net, plane.env, A, lanes, plane.cross,
        mesh_step(cfg, net, table, learner.state), replicate)
    return plane, learner, roll, step


def copies_of(plane):
    arrays, prios, seq_meta, first = plane._handles()
    return ({k: v.clone() for k, v in plane.state.items()},
            {k: v.clone() for k, v in arrays.items()}, prios.clone(),
            seq_meta.clone(), first.clone())


def plane_is(plane, want) -> bool:
    ast, arrays, prios, seq_meta, first = want
    mine = plane._handles()
    return (all(torch.equal(plane.state[k], ast[k]) for k in ast)
            and all(torch.equal(mine[0][k], arrays[k]) for k in arrays)
            and torch.equal(mine[1], prios) and torch.equal(mine[2], seq_meta)
            and torch.equal(mine[3], first))


@pytest.mark.parametrize("replicate", [False, True],
                         ids=["split", "replicated"])
@pytest.mark.parametrize("lh", [0, 2])
def test_meshed_anakin_entries_are_todays_eager_functions(replicate, lh):
    """The meshed plane's entries (the carry written in place, the index a
    tensor: their graphs' bodies, eager here) against today's eager
    functions from copies of the same carry, ring, PER state and train
    state, with the lanes split over dp and with the replicated lane
    axis: every rollout and four dispatches (the eval lane on the first
    and third) bit for bit in the result vector, the carry, the ring, the
    PER state and the train state; the carry keeps its addresses; the
    design's collectives per rollout and dispatch."""
    cfg = port_test_config(**ANAKIN, learnhealth_interval=lh)
    with world_of_one():
        table = ShardingTable(make_mesh(cfg, "cpu"), cfg)
        plane, learner, roll, step = anakin_pair(cfg, table, replicate)
        assert plane.replicated_lanes == replicate
        carry = {k: v.data_ptr() for k, v in plane.state.items()}
        steps, k = plane.roll_steps, cfg.superstep_k
        per_roll = {} if replicate else dict(
            all_gather=2 * steps, all_to_all=2 * steps, all_reduce=1)
        per_dispatch = dict(all_gather=per_roll.get("all_gather", 0) + 4 * k,
                            all_to_all=per_roll.get("all_to_all", 0) + 7 * k)
        if not replicate:
            per_dispatch["all_reduce"] = 1
        rollouts = 0
        while not plane.ready:
            want = roll(learner.state.params, *copies_of(plane))
            CROSS_RANK_CALLS.clear()
            got = plane.rollout(learner.state.params, plane.state,
                                *plane._handles())
            assert dict(CROSS_RANK_CALLS) == per_roll
            plane._absorb(got[-1].numpy())
            assert torch.equal(got[-1], want[-1])
            assert plane_is(plane, want[:5])
            rollouts += 1
        assert rollouts >= 2
        for d in range(4):
            want = step(tgraphs._clone_state(learner.state),
                        *copies_of(plane), d)
            CROSS_RANK_CALLS.clear()
            learner.state, *rest = plane.super_step(
                learner.state, plane.state, *plane._handles(), d)
            assert dict(CROSS_RANK_CALLS) == per_dispatch
            assert torch.equal(rest[-1], want[-1])
            assert plane_is(plane, want[1:6])
            assert same_state(learner.state, want[0])
        assert carry == {k: v.data_ptr() for k, v in plane.state.items()}
        assert plane.super_step.graphs.entry.traces == 1
        assert plane.rollout.graphs.entry.traces == 1


@pytest.mark.slow
@pytest.mark.parametrize("lh", [0, 2])
def test_meshed_entries_over_two_ranks_are_their_plain_functions(tmp_path,
                                                                  lh):
    """Two gloo ranks: on each, ``mesh_train_step`` against ``mesh_step``
    over four batches, and the meshed anakin plane (two lanes a rank)
    against the plain rollout and super-step from copies, bit for bit;
    the same losses on both ranks; the design's collectives per rollout
    and dispatch (each rank's lanes' emits routed, the lane counters
    summed)."""
    cfg = port_test_config(mesh_shape=(("dp", 2),), learnhealth_interval=lh,
                      target_net_update_interval=2)
    net = create_network(cfg, A, device="cpu")
    params = {k: v.numpy() for k, v in net.state_dict().items()}
    anakin_kw = dict(ANAKIN, num_actors=4, learnhealth_interval=lh)
    ranks = run_ranks("mesh_graphs", 2, str(tmp_path), dict(
        cfg_kw=dict(learnhealth_interval=lh, target_net_update_interval=2),
        params=params, batches=[batch_of(cfg, s) for s in range(4)],
        anakin_kw=anakin_kw, dispatches=3), timeout=240)
    for r in ranks:
        assert r["step"]["same"] and r["anakin"]["same"]
        assert not r["anakin"]["replicated"]
        steps, k = r["anakin"]["roll_steps"], anakin_kw["superstep_k"]
        assert all(c == dict(all_gather=2 * steps, all_to_all=2 * steps,
                             all_reduce=1)
                   for c in r["anakin"]["calls"]["rollout"])
        assert all(c == dict(all_gather=2 * steps + 4 * k,
                             all_to_all=2 * steps + 7 * k, all_reduce=1)
                   for c in r["anakin"]["calls"]["dispatch"])
    assert ranks[0]["step"]["losses"] == ranks[1]["step"]["losses"]
    assert ranks[0]["anakin"]["losses"] == ranks[1]["anakin"]["losses"]


# -------------------------------------------------------- replayed counts

class _FakeGraph:
    replays = 0

    def replay(self):
        _FakeGraph.replays += 1

    def pool(self):
        return None


class _FakeStream:
    def wait_stream(self, other):
        return None


def test_a_replay_adds_the_collectives_its_capture_recorded(monkeypatch):
    """The capture path of ``utils/graphs.Graphs`` with the card's graph
    calls stubbed: the warm-up and the capture add nothing to the
    collective counters or the kernel launches, the first call counts its
    replay's, and every replay adds what the capture recorded — the
    counts a run is held to are those of the eager entry.  What another
    thread ticks meanwhile (the learner's gate beside an act's capture)
    lands in the counters and not in the graph's record."""
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **kw: contextlib.nullcontext())

    def entry(x):
        ugraphs.tick(CROSS_RANK_CALLS, "all_gather", 2)
        ugraphs.tick(CROSS_RANK_CALLS, "all_to_all", 7)
        ugraphs.tick(COLLECTIVE_CALLS, "group_broadcast")
        KERNEL_LAUNCHES.count("replayed_test_kernel", 3)
        other = threading.Thread(
            target=ugraphs.tick, args=(COLLECTIVE_CALLS, "gate"))
        other.start()
        other.join()
        return (x.get("u", torch.ones(3)) * 2,)

    guard = RetraceGuard()
    graphs = ugraphs.Graphs(guard.register("learner.test_entry"))
    CROSS_RANK_CALLS.clear()
    COLLECTIVE_CALLS.clear()
    k0 = KERNEL_LAUNCHES.get("replayed_test_kernel")
    cuda = torch.device("cuda")
    for n in (1, 2, 3):
        graphs.run("key", entry, dict(u=torch.ones(3)), cuda)
        assert dict(CROSS_RANK_CALLS) == dict(all_gather=2 * n,
                                              all_to_all=7 * n)
        # the warm-up's and the capture's other thread ticked for real
        assert dict(COLLECTIVE_CALLS) == dict(group_broadcast=n, gate=2)
        assert KERNEL_LAUNCHES.get("replayed_test_kernel") - k0 == 3 * n
    assert graphs.captures == 1 and guard.counts() == {
        "learner.test_entry": 1}
    # an eager_first entry: the first call is the eager run itself
    first = ugraphs.Graphs(guard.register("learner.test_first"))
    CROSS_RANK_CALLS.clear()
    for n in (1, 2):
        first.run("key", entry, {}, cuda, eager_first=True)
        assert dict(CROSS_RANK_CALLS) == dict(all_gather=2 * n,
                                              all_to_all=7 * n)
    # under eager() nothing is captured: the entry runs as on the CPU
    twin = ugraphs.Graphs(guard.register("learner.test_twin"))
    CROSS_RANK_CALLS.clear()
    with ugraphs.eager():
        out = twin.run("key", entry, dict(u=torch.ones(3)), cuda)
    assert twin.captures == 0 and torch.equal(out[0], torch.full((3,), 2.))
    assert dict(CROSS_RANK_CALLS) == dict(all_gather=2, all_to_all=7)


# ---------------------------------------------------------- trace counts

def test_meshed_trace_counts_equal_jax_at_the_same_layout(monkeypatch):
    """dp = 1: eight same-shape meshed updates trace the step once, as
    JAX's ``pjit_train_step``; the meshed anakin plane's warm-up rollouts
    and three dispatches (the eval lane on and off) trace the super-step
    once, as JAX's meshed plane, and the rollout once, where JAX's traces
    twice."""
    jguard, tguard = jtrace.RetraceGuard(), RetraceGuard()
    monkeypatch.setattr(jsharding, "RETRACES", jguard)
    monkeypatch.setattr(janakin, "RETRACES", jguard)
    monkeypatch.setattr(tgraphs, "RETRACES", tguard)

    jcfg = jax_test_config(mesh_shape=(("dp", 1),))
    jnet = jax_create(jcfg, A)
    jtable = jsharding.ShardingTable(jax_make_mesh(jcfg), jcfg)
    jstate = jstep.create_train_state(
        jcfg, init_params(jcfg, jnet, jax.random.PRNGKey(0)))
    jfn = jsharding.pjit_train_step(jcfg, jnet, jtable,
                                    state_template=jstate)
    jstate = jtable.place_state(jstate)
    cfg = port_test_config(mesh_shape=(("dp", 1),))
    net = create_network(cfg, A, device="cpu")
    with world_of_one():
        table = ShardingTable(make_mesh(cfg, "cpu"), cfg)
        state, _ = placed_pair(cfg, net, table)
        tfn = mesh_train_step(cfg, net, table, state_template=state)
        for seed in range(8):
            b = batch_of(cfg, seed)
            jstate = jfn(jstate, jsharding.shard_batch(jtable, b))[0]
            state = tfn(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})[0]
        assert tguard.counts() == jguard.counts() == {
            "learner.train_step": 1}

        jguard.reset()
        tguard.reset()
        jacfg = jax_test_config(**ANAKIN, mesh_shape=(("dp", 1),))
        janet = jax_create(jacfg, A)
        jatable = jsharding.ShardingTable(jax_make_mesh(jacfg), jacfg)
        jlearner = JaxLearner(jacfg, janet, jstep.create_train_state(
            jacfg, init_params(jacfg, janet, jax.random.PRNGKey(0))),
            mesh=jatable.mesh, table=jatable)
        jplane = janakin.AnakinPlane(jacfg, janet, A,
                                     JaxDeviceRing(jacfg, A), table=jatable,
                                     state_template=jlearner.state)
        acfg = port_test_config(**ANAKIN, mesh_shape=(("dp", 1),))
        atable = ShardingTable(make_mesh(acfg, "cpu"), acfg)
        plane, learner, _, _ = anakin_pair(acfg, atable, False)
        for p, lr in ((jplane, jlearner), (plane, learner)):
            while not p.ready:
                p.rollout_step(lr.state.params)
            for _ in range(3):
                lr.state, res = p.dispatch(lr.state)
                p.harvest(res)
        # JAX traces its meshed rollout twice: the first call's fresh carry
        # is uncommitted, its outputs sharded, and the second call's
        # input shardings differ; the port's carry keeps one layout
        assert {k: v for k, v in jguard.counts().items() if v} == {
            "learner.anakin_super_step": 1, "learner.anakin_rollout": 2}
        assert {k: v for k, v in tguard.counts().items() if v} == {
            "learner.anakin_super_step": 1, "learner.anakin_rollout": 1}
