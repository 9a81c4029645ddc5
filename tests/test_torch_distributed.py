"""The port's multi-rank runtime (parallel/distributed.py) and the meshed
train step (parallel/sharding.mesh_train_step), on gloo CPU ranks.

Mirrors tests/test_distributed.py: the single-process no-op, rows per
rank, ``host_local_batch`` equal to ``shard_batch``, the ``local_rows``
round trip and its de-duplication, and ``sync_counter`` /
``sync_min_array`` — here over two real ranks, spawned as processes of
``r2d2_tpu_torch.tools.rank_worker`` with a deadline and a stack dump.

Step parity over two ranks (3 steps, mlp torso, H = 16, a grad-norm clip
that binds): dp = 2, fsdp = 2 and tp = 2 each against the meshless step
(dp = 1), and each against JAX's ``pjit_train_step`` on the conftest's
8-device CPU mesh at the same layout, from the same converted params and
batches.  Tolerances: loss 1e-5 relative, priorities 1e-5, params 1e-4
relative — the reductions run in another order (per-shard partial sums),
so the trajectories agree to f32 round-off, not bits; against JAX,
PERF.md §2's learner tolerances.
"""
import threading

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
from r2d2_tpu_torch.checkpoint import Checkpointer
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.learner.learner import Learner
from r2d2_tpu_torch.learner.step import create_train_state, make_train_step
from r2d2_tpu_torch.models.convert import params_from_flax
from r2d2_tpu_torch.models.network import create_network
from r2d2_tpu_torch.parallel import distributed as pd
from r2d2_tpu_torch.parallel.mesh import make_mesh
from r2d2_tpu_torch.parallel.sharding import (
    DEVICE_BATCH_KEYS,
    ShardingTable,
    gather_state,
    mesh_train_step,
)
from r2d2_tpu_torch.tools.rank_worker import run_ranks

A = 4
STEPS = 3
# a clip that binds (the global norm of these batches' gradients is
# above it), so the norm over every shard is exercised
GRAD_NORM = 0.05
LAYOUTS = ((("dp", 2),), (("fsdp", 2),), (("tp", 2),))
IDS = ["dp2", "fsdp2", "tp2"]


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


@pytest.fixture(scope="module")
def case():
    """JAX's params (converted), the batches, the meshless port run and
    the two-rank meshed runs at every layout."""
    jcfg = jax_test_config(grad_norm=GRAD_NORM)
    jnet = jax_create_network(jcfg, A)
    flax = init_params(jcfg, jnet, jax.random.PRNGKey(2))
    params = {k: v.numpy() for k, v in params_from_flax(
        jax.device_get(flax)).items()}
    batches = [make_batch(jcfg, np.random.default_rng(10 + i))
               for i in range(STEPS)]

    cfg = port_test_config(grad_norm=GRAD_NORM)
    net = create_network(cfg, A, device="cpu", lstm_impl="scan")
    state = create_train_state(cfg, {k: torch.from_numpy(v)
                                     for k, v in params.items()})
    step = make_train_step(cfg, net)
    ref = dict(losses=[], prios=[])
    for b in batches:
        state, loss, p = step(state, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        ref["losses"].append(float(loss))
        ref["prios"].append(p.numpy())
    ref["params"] = {k: v.numpy() for k, v in state.params.items()}
    return dict(flax=flax, jcfg=jcfg, jnet=jnet, params=params,
                batches=batches, ref=ref)


@pytest.fixture(scope="module")
def meshed(case, tmp_path_factory):
    out = run_ranks(
        "step", 2, str(tmp_path_factory.mktemp("ranks_step")),
        dict(params=case["params"], batches=case["batches"],
             cfg_kw=dict(grad_norm=GRAD_NORM), layouts=LAYOUTS),
        timeout=240)
    # both ranks hold the same full results
    for lay in LAYOUTS:
        a, b = out[0][lay], out[1][lay]
        assert a["losses"] == b["losses"]
        assert all(np.array_equal(a["params"][k], b["params"][k])
                   for k in a["params"])
    return out[0]


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_meshed_step_matches_dp1(case, meshed, layout):
    r, ref = meshed[layout], case["ref"]
    np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-5)
    for got, want in zip(r["prios"], ref["prios"]):
        _close(np.concatenate(got), want, 1e-5, 1e-6, "priorities")
    for k, want in ref["params"].items():
        _close(r["params"][k], want, 1e-4, 1e-6, k)
    # the layout really shards: some leaf is split over the layout's axis
    assert any("S(" in "".join(pl) or "Shard" in "".join(pl)
               for pl in r["placements"].values())


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_meshed_step_matches_jax_at_the_same_layout(case, meshed, layout):
    jcfg = case["jcfg"].replace(mesh_shape=layout)
    table = JaxTable(jax_make_mesh(jcfg), jcfg)
    state = jax_train_state(jcfg, case["flax"])
    step = pjit_train_step(jcfg, case["jnet"], table, state_template=state)
    st = table.place_state(state)
    losses, prios = [], []
    for b in case["batches"]:
        st, loss, p = step(st, jax_shard_batch(table, dict(b)))
        losses.append(float(loss))
        prios.append(np.asarray(jax.device_get(p)))
    r = meshed[layout]
    np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
    for got, want in zip(r["prios"], prios):
        _close(np.concatenate(got), want, 1e-4, 1e-6, "priorities")
    want = {k: v.numpy() for k, v in params_from_flax(
        jax.device_get(st.params)).items()}
    for k, w in want.items():
        _close(r["params"][k], w, 1e-4, 1e-6, k)


def test_the_clip_binds(case):
    """The global norm of the first batch's gradients is above the clip,
    so the parity tests exercise the norm over every shard."""
    from r2d2_tpu_torch.learner.step import loss_and_priorities

    cfg = port_test_config(grad_norm=GRAD_NORM)
    net = create_network(cfg, A, device="cpu", lstm_impl="scan")
    params = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in case["params"].items()}
    loss, _ = loss_and_priorities(cfg, net, params, params, {
        k: torch.from_numpy(v) for k, v in case["batches"][0].items()})
    grads = torch.autograd.grad(loss, list(params.values()))
    assert float(torch.sqrt(sum((g * g).sum() for g in grads))) > GRAD_NORM


# ------------------------------------------------------- the runtime

def test_init_distributed_single_process_is_a_no_op(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert pd.init_distributed() == {"process_id": 0, "process_count": 1}
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torchrun"):
        pd.init_distributed(auto=True)


def test_rank_device_never_falls_back(monkeypatch):
    assert pd.rank_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert pd.rank_device("cuda") == torch.device("cuda", 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pd.rank_device()


def test_sync_is_the_identity_without_a_group():
    assert pd.sync_counter(7, "sum") == 7
    np.testing.assert_array_equal(pd.sync_min_array([1.5, 2.0]),
                                  [1.5, 2.0])
    t = torch.arange(4)
    assert pd.local_rows(t) is t


def test_collectives_at_two_ranks(tmp_path):
    cfg = port_test_config()
    batch = make_batch(cfg, np.random.default_rng(0))
    values = {0: dict(count=3, array=np.array([0.5, 2.0, -1.0])),
              1: dict(count=10, array=np.array([1.0, 1.0, -3.0])),
              "cfg": {}, "batch": batch}
    r0, r1 = run_ranks("collectives", 2, str(tmp_path),
                       dict(values=values), timeout=120)
    for r in (r0, r1):
        assert (r["sum"], r["max"], r["min"]) == (13, 10, 3)
        np.testing.assert_array_equal(r["min_array"], [0.5, 1.0, -3.0])
        assert r["sizes"] == dict(dp=2, fsdp=1, tp=1)
        assert tuple(r["names"]) == ("dp", "fsdp", "tp")
        assert r["host_bs"] == cfg.batch_size // 2
        assert r["batch_equal"]
    B = cfg.batch_size
    assert r0["rows"] == slice(0, B // 2) and r1["rows"] == slice(B // 2, B)
    # each rank's rows, once, in global order; a replicated tensor's too
    np.testing.assert_array_equal(
        np.concatenate([r0["local_rows"], r1["local_rows"]]),
        batch["is_weights"])
    np.testing.assert_array_equal(r0["local_rows_replicated"],
                                  r0["local_rows"])
    np.testing.assert_array_equal(r1["local_rows_replicated"],
                                  r1["local_rows"])


@pytest.fixture
def world_of_one():
    pd.init_distributed(store=dist.HashStore(), world_size=1, rank=0,
                        device="cpu")
    try:
        yield make_mesh(port_test_config(), "cpu")
    finally:
        pd.unbind_learner_thread()
        dist.destroy_process_group()


def test_only_the_learner_thread_issues_collectives(world_of_one):
    pd.bind_learner_thread()
    assert pd.sync_counter(2, "sum") == 2
    err = []

    def actor():
        try:
            pd.sync_min_array([1.0])
        except RuntimeError as e:
            err.append(str(e))

    t = threading.Thread(target=actor, name="actor0")
    t.start()
    t.join()
    assert err and "learner thread" in err[0]


def test_world_of_one_rows_and_local_batch(world_of_one):
    mesh = world_of_one
    cfg = port_test_config()
    assert pd.owned_dp_groups(mesh) == slice(0, 1)
    assert pd.host_batch_size(cfg, mesh) == cfg.batch_size
    batch = make_batch(cfg, np.random.default_rng(1))
    local = pd.host_local_batch(mesh, batch)
    assert set(local) == set(DEVICE_BATCH_KEYS)
    assert all(torch.equal(local[k].full_tensor(), torch.from_numpy(
        np.ascontiguousarray(batch[k]))) for k in local)
    g = pd.global_from_local_rows(mesh, np.ones((2, 8, 6), np.int32),
                                  (2, 8, 6), axis=1, offset=0)
    assert tuple(g.shape) == (2, 8, 6)
    with pytest.raises(ValueError, match="dp shard"):
        pd.global_from_local_rows(mesh, np.ones((2, 4, 6)), (2, 8, 6), 1, 0)


def _state_equal(a, b) -> bool:
    return (a.step == b.step and a.opt_state.count == b.opt_state.count
            and all(torch.equal(x[k], y[k])
                    for x, y in ((a.params, b.params),
                                 (a.target_params, b.target_params),
                                 (a.opt_state.mu, b.opt_state.mu),
                                 (a.opt_state.nu, b.opt_state.nu))
                    for k in x))


def test_checkpoints_cross_between_meshed_and_meshless(world_of_one,
                                                       tmp_path):
    """Rank 0 saves the gathered full state in the meshless byte layout:
    a meshed checkpoint restores without a mesh and a meshless one with a
    mesh, bit for bit."""
    mesh = world_of_one
    cfg = port_test_config()
    net = create_network(cfg, A, device="cpu",
                         generator=torch.Generator().manual_seed(4))
    batch = {k: torch.from_numpy(v) for k, v in make_batch(
        cfg, np.random.default_rng(4)).items()}
    meshed = Learner(cfg, net, create_train_state(cfg, net.state_dict()),
                     checkpointer=Checkpointer(str(tmp_path / "a")),
                     mesh=mesh)
    meshed.state, _, _ = meshed._step_fn(meshed.state, batch)
    meshed._save(1, 0.0)
    restored, _ = Checkpointer(str(tmp_path / "a")).restore()
    plain = Learner(cfg, net, restored)
    assert _state_equal(gather_state(meshed.state), plain.state)

    plain.state, _, _ = plain._step_fn(plain.state, batch)
    Checkpointer(str(tmp_path / "b")).save(2, plain.state, meta={})
    restored, _ = Checkpointer(str(tmp_path / "b")).restore()
    again = Learner(cfg, net, restored, mesh=mesh)
    assert all(isinstance(v, torch.distributed.tensor.DTensor)
               for v in again.state.params.values())
    assert _state_equal(gather_state(again.state), plain.state)


def test_world_of_one_meshed_step_is_the_meshless_step(world_of_one):
    """At world size 1 every placement is whole: the meshed step runs the
    meshless step's kernels on the same values, bit for bit."""
    cfg = port_test_config()
    net = create_network(cfg, A, device="cpu",
                         generator=torch.Generator().manual_seed(5))
    batch = {k: torch.from_numpy(v) for k, v in make_batch(
        cfg, np.random.default_rng(5)).items()}
    a = create_train_state(cfg, net.state_dict())
    b = create_train_state(cfg, net.state_dict())
    table = ShardingTable(world_of_one, cfg)
    step = mesh_train_step(cfg, net, table, state_template=b)
    b = table.place_state(b)
    a, la, pa = make_train_step(cfg, net)(a, batch)
    b, lb, pb = step(b, batch)
    assert not isinstance(lb, torch.distributed.tensor.DTensor)
    assert torch.equal(la, lb) and torch.equal(pa, pb)
    assert _state_equal(a, gather_state(b))
