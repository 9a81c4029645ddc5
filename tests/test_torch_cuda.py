"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions on the same device.  Every test is marked ``cuda`` and
skips without a CUDA device.  This file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Both routes are held to the plain version: the tensor-core kernel (bf16
``wh``) and the CUDA-core kernel (f32 ``wh``, and bf16 through the private
``_lstm_unroll_cudacore``, the first design kept for comparison), at
B = 65 (two 64-row tiles) and at ragged hidden sizes (H = 100, whose gate
strips start off 16-byte boundaries).  Tolerances (as in chip_smoke.py):
1e-5 max-abs in float32 with TF32 off, 1e-4 in bfloat16 — both sides round
the operands at the same points, only the order of the f32 sums differs.
"""
import numpy as np
import pytest
import torch

from r2d2_tpu_torch.ops import lstm as lstm_ops
from r2d2_tpu_torch.ops.lstm import (
    CUDACORE_COUNTER,
    KERNEL,
    _lstm_unroll_cudacore,
    launch_plan,
    lstm_unroll_cuda,
    lstm_unroll_reference,
)
from r2d2_tpu_torch.utils.trace import KERNEL_LAUNCHES

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(T, B, H, seed, device):
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(T, B, 4 * H)) * 0.5,
              rng.normal(size=(H, 4 * H)) / np.sqrt(H),
              rng.normal(size=(B, H)) * 0.5, rng.normal(size=(B, H)) * 0.5)
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H", [(1, 3, 16), (9, 3, 16), (1, 256, 512),
                                   (5, 7, 100), (1, 65, 512), (3, 65, 100),
                                   (2, 9, 36)])
def test_kernel_matches_reference(cuda, T, B, H, dtype):
    xp, wh, h0, c0 = _inputs(T, B, H, seed=T * B + H, device=cuda)
    counter = KERNEL if dtype == torch.bfloat16 else CUDACORE_COUNTER
    before = KERNEL_LAUNCHES.get(counter)
    got = lstm_unroll_cuda(xp, wh.to(dtype), h0, c0)
    want = lstm_unroll_reference(xp, wh, h0, c0, dtype)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES.get(counter) == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g - w).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(1, 7, 512), (4, 65, 512), (3, 5, 100)])
def test_cudacore_bf16_keeps_the_first_designs_numerics(cuda, T, B, H):
    """The CUDA-core kernel in bf16 is the first design unchanged: h rounded
    to bf16, exact products, f32 sums, each step within 1e-4 of the plain
    step; deterministic; counted under its own name, never the tensor-core
    kernel's."""
    xp, wh, h0, c0 = _inputs(T, B, H, seed=7 * T + B, device=cuda)
    whb = wh.to(torch.bfloat16)
    before = {k: KERNEL_LAUNCHES.get(k) for k in (KERNEL, CUDACORE_COUNTER)}
    got = _lstm_unroll_cudacore(xp, whb, h0, c0)
    again = _lstm_unroll_cudacore(xp, whb, h0, c0)
    assert KERNEL_LAUNCHES.get(CUDACORE_COUNTER) == before[CUDACORE_COUNTER] + 2
    assert KERNEL_LAUNCHES.get(KERNEL) == before[KERNEL]
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    h, c = h0, c0
    for t in range(T):
        _, h1, c1 = _lstm_unroll_cudacore(xp[t:t + 1], whb, h, c)
        _, h2, c2 = lstm_unroll_reference(xp[t:t + 1], wh, h, c,
                                          torch.bfloat16)
        assert torch.equal(h1, got[0][t])
        assert (h1 - h2).abs().max().item() <= TOL[torch.bfloat16]
        assert (c1 - c2).abs().max().item() <= TOL[torch.bfloat16]
        h, c = h1, c1


@pytest.mark.cuda
def test_launch_plan_matches_the_kernels_smem_count(cuda):
    lib = lstm_ops._library()
    for H in (16, 32, 36, 64, 100, 256, 512):
        for B in (1, 2, 4, 8, 16, 32, 64, 128, 256):
            plan = launch_plan(B, H)
            assert lib.lstm_infer_wgmma_smem(plan.n, H) == plan.smem_bytes


@pytest.mark.cuda
def test_kernel_refuses_a_grid_that_is_not_launch_plans(cuda):
    """The C entry point launches the plan's grid and refuses one that
    would leave a (row, unit) uncovered or add an empty block."""
    B, H = 65, 512
    xp, wh, h0, c0 = _inputs(1, B, H, seed=3, device=cuda)
    whb = wh.to(torch.bfloat16)
    plan = launch_plan(B, H)
    for grid in ((plan.grid[0] - 1, plan.grid[1]),
                 (plan.grid[0], plan.grid[1] + 1)):
        with pytest.raises(RuntimeError, match="invalid argument"):
            lstm_ops._launch_wgmma(xp, whb, h0, c0, plan._replace(grid=grid))


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda):
    xp, wh, h0, c0 = _inputs(2, 3, 16, seed=0, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_unroll_cuda(xp, wh.t().contiguous().t(), h0, c0)
    with pytest.raises(ValueError, match="CUDA device"):
        lstm_unroll_cuda(xp, wh, h0.cpu(), c0)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flat = torch.zeros(16 * 64 + 1, dtype=torch.bfloat16, device=cuda)
        lstm_unroll_cuda(xp, flat[1:].view(16, 64), h0, c0)
    big = _inputs(1, 1, 1600, seed=0, device=cuda)
    with pytest.raises(ValueError, match="shared-memory"):
        lstm_unroll_cuda(*big)


@pytest.mark.cuda
def test_network_kernel_path_matches_plain_path(cuda):
    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.models import create_network

    cfg = Config(obs_shape=(44, 44, 1), hidden_dim=64)
    gen = torch.Generator().manual_seed(0)
    net = create_network(cfg, 6, device=cuda, generator=gen)
    assert net.lstm_layers[0].impl == "pallas"
    plain = create_network(cfg, 6, device=cuda, lstm_impl="reference")
    plain.load_state_dict(net.state_dict())
    rng = np.random.default_rng(1)
    B = 5
    obs = torch.from_numpy(rng.integers(0, 256, (B, *cfg.stored_obs_shape),
                                        np.uint8)).to(cuda)
    la = torch.zeros(B, 6, device=cuda)
    lr = torch.zeros(B, device=cuda)
    hid = torch.zeros(B, 2, 1, 64, device=cuda)
    with torch.inference_mode():
        q1, h1 = net.act(obs, la, lr, hid)
        q2, h2 = plain.act(obs, la, lr, hid)
    assert (h1 - h2).abs().max().item() <= 1e-4
    assert (q1 - q2).abs().max().item() <= 2e-3


@pytest.mark.cuda
def test_training_path_acts_through_the_kernel_and_learns_without_it(cuda):
    """The actors' acts launch the tensor-core kernel once per layer per
    lockstep iteration (B = 8); the learner's update launches none (its
    loss runs the scan recurrence)."""
    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.envs import create_env
    from r2d2_tpu_torch.train import _build
    from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS

    cfg = Config(game_name="Fake", torso="mlp", hidden_dim=64, num_actors=8,
                 burn_in_steps=4, learning_steps=4, forward_steps=2,
                 block_length=8, buffer_capacity=160, learning_starts=16,
                 batch_size=8)
    sys = _build(cfg, lambda c, seed: create_env(c, seed=seed), None, False,
                 device=cuda)
    assert sys["net"].lstm_layers[0].impl == "pallas"
    KERNEL_LAUNCHES.reset()
    before = HOST_TRANSFERS.get("actor.act_fetch")
    sys["actor"].run(12)
    acts = HOST_TRANSFERS.get("actor.act_fetch") - before
    assert acts == 12
    assert KERNEL_LAUNCHES.get(KERNEL) == acts * cfg.lstm_layers
    assert KERNEL_LAUNCHES.get(CUDACORE_COUNTER) == 0
    learner = sys["learner"]
    dev, host = learner._stage(sys["buffer"].sample_batch())
    KERNEL_LAUNCHES.reset()
    state, loss, prios = learner._step_fn(learner.state, dev)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES.get(KERNEL) == 0
    assert torch.isfinite(loss) and prios.shape == (8,)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8])
def test_impala_two_layer_act_through_the_kernel_matches_plain(cuda, B):
    """The IMPALA-deep net (impala torso on raw 84×84 frames, two LSTM
    layers of H = 512, bf16): an act launches the tensor-core kernel once
    per layer and agrees with the plain LSTM's act, q within 2e-3 and the
    new hidden of both layers within 2e-3 (layer 1's bf16 input carries
    layer 0's last-bit differences)."""
    from r2d2_tpu_torch.config import impala_deep_config
    from r2d2_tpu_torch.models import create_network

    cfg = impala_deep_config(game_name="Fake")
    gen = torch.Generator().manual_seed(0)
    net = create_network(cfg, 4, device=cuda, generator=gen)
    assert [layer.impl for layer in net.lstm_layers] == ["pallas"] * 2
    plain = create_network(cfg, 4, device=cuda, lstm_impl="reference")
    plain.load_state_dict(net.state_dict())
    rng = np.random.default_rng(B)
    obs = torch.from_numpy(rng.integers(0, 256, (B, 84, 84, 1),
                                        np.uint8)).to(cuda)
    la = torch.zeros(B, 4, device=cuda)
    la[:, 1] = 1.0
    lr = torch.from_numpy(rng.normal(size=B).astype(np.float32)).to(cuda)
    hid = torch.from_numpy((rng.normal(size=(B, 2, 2, 512)) * 0.5).astype(
        np.float32)).to(cuda)
    KERNEL_LAUNCHES.reset()
    with torch.inference_mode():
        q1, h1 = net.act(obs, la, lr, hid)
        assert KERNEL_LAUNCHES.get(KERNEL) == 2
        q2, h2 = plain.act(obs, la, lr, hid)
    assert KERNEL_LAUNCHES.get(KERNEL) == 2
    assert KERNEL_LAUNCHES.get(CUDACORE_COUNTER) == 0
    assert torch.isfinite(q1).all() and q1.shape == (B, 4)
    assert (h1 - h2).abs().max().item() <= 2e-3
    assert (q1 - q2).abs().max().item() <= 2e-3


def _filled_ring_pair(cfg, device, n_blocks=6, seed=0):
    """A host-ring buffer and a device-ring buffer on ``device`` fed the
    same blocks (cut by the port's LocalBuffer), same sampler seeds."""
    from r2d2_tpu_torch.replay.block import LocalBuffer
    from r2d2_tpu_torch.replay.device_ring import DeviceRing
    from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer

    host = ReplayBuffer(cfg.replace(device_replay=False, in_graph_per=False),
                        4, rng=np.random.default_rng(9))
    ring = DeviceRing(cfg, 4, device=device)
    dev = ReplayBuffer(cfg, 4, rng=np.random.default_rng(9),
                       device_ring=ring)
    rng = np.random.default_rng(seed)
    local = LocalBuffer(cfg, 4)
    local.reset(rng.integers(0, 256, cfg.stored_obs_shape, np.uint8))
    for _ in range(n_blocks):
        for _ in range(cfg.block_length):
            local.add(int(rng.integers(4)), float(rng.normal()),
                      rng.integers(0, 256, cfg.stored_obs_shape, np.uint8),
                      rng.normal(size=4).astype(np.float32),
                      rng.normal(size=(2, cfg.lstm_layers, cfg.hidden_dim)
                                 ).astype(np.float32))
        blk, prios, _ = local.finish(rng.normal(size=4).astype(np.float32))
        host.add(blk, prios, None)
        dev.add(blk, prios, None)
    return host, dev, ring


@pytest.mark.cuda
def test_device_gather_on_the_card_matches_the_host_gather(cuda):
    """Blocks staged through pinned memory into a ring on the card, a
    ``sample_meta`` bundle gathered there: every field equals the host
    ring's ``_gather_rows`` of the same indices, bit for bit."""
    from r2d2_tpu_torch.config import test_config
    from r2d2_tpu_torch.replay.device_ring import gather_batch, to_device

    cfg = test_config(device_replay=True)
    host, dev, ring = _filled_ring_pair(cfg, cuda, n_blocks=24)
    assert ring.arrays["obs"].device.type == cuda.type
    meta = dev.sample_meta(k=2)
    for j in range(2):
        got = gather_batch(cfg, ring.snapshot(),
                           to_device(meta["ints"][j], cuda),
                           to_device(meta["is_weights"][j], cuda))
        want = host._gather_rows(meta["idxes"][j])
        for key, v in want.items():
            np.testing.assert_array_equal(got[key].cpu().numpy(), v,
                                          err_msg=key)


@pytest.mark.cuda
def test_in_graph_sampler_on_the_card_matches_the_cpu(cuda):
    """The stratified sampler over the same leaves and uniforms on the card
    and on the CPU: indices and ints bundles equal, weights within 1e-6."""
    from r2d2_tpu_torch.config import test_config
    from r2d2_tpu_torch.learner.step import _in_graph_sample

    cfg = test_config(device_replay=True, in_graph_per=True)
    _, _, ring = _filled_ring_pair(cfg, cuda)
    meta = ring.per_meta()
    leaves = (ring.take_prios(), meta["seq_meta"], meta["first"])
    u = torch.rand(cfg.batch_size, generator=torch.Generator().manual_seed(1))
    got = _in_graph_sample(cfg, u.to(cuda), *leaves)
    want = _in_graph_sample(cfg, u, *(t.cpu() for t in leaves))
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[2].cpu(), want[2])
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_inference_service_on_the_card_answers_a_spawned_cpu_fleet(cuda):
    """The serve-mode service builds its network on the card, warms the
    kernel with one full-batch act in ``start``, and answers the act RPCs
    of a spawned fleet that acts nowhere itself and holds no CUDA context:
    one kernel launch per layer per served batch."""
    import threading
    import time

    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.models.network import create_network
    from r2d2_tpu_torch.parallel.actor_procs import ProcessFleetPlane
    from r2d2_tpu_torch.train import _default_env_factory
    from r2d2_tpu_torch.utils.store import ParamStore

    cfg = Config(game_name="Fake", torso="mlp", hidden_dim=64, num_actors=8,
                 burn_in_steps=4, learning_steps=4, forward_steps=2,
                 block_length=8, buffer_capacity=160, learning_starts=16,
                 batch_size=8, actor_transport="process",
                 actor_inference="serve")
    A = 4   # the fake env's actions
    net = create_network(cfg, A, device=cuda,
                         generator=torch.Generator().manual_seed(0))
    store = ParamStore({k: v.detach().clone()
                        for k, v in net.state_dict().items()})
    plane = ProcessFleetPlane(cfg, A, _default_env_factory,
                              [0.4] * cfg.num_actors)
    svc = plane.service
    KERNEL_LAUNCHES.reset()
    try:
        plane.start(store)
        assert svc.net.lstm_layers[0].impl == "pallas"
        assert svc.warmups == 1
        assert KERNEL_LAUNCHES.get(KERNEL) == cfg.lstm_layers
        reports = []
        t = threading.Thread(
            target=lambda: reports.extend(plane.probe_fleets(120)))
        t.start()
        deadline = time.time() + 120
        while (t.is_alive() or svc.batches < 3) and time.time() < deadline:
            svc.serve_once(idle_sleep=0.0)
            plane.ingest_once(lambda *item: None, timeout=0.0)
        t.join(10)
        assert svc.batches >= 3 and svc.requests_corrupt == 0
        assert reports and reports[0] is not None
        assert not reports[0]["cuda_initialized"]
        assert not reports[0]["jax_loaded"]
        assert KERNEL_LAUNCHES.get(KERNEL) == cfg.lstm_layers * (
            svc.batches + svc.warmups)
        assert KERNEL_LAUNCHES.get(CUDACORE_COUNTER) == 0
        assert svc.lanes_served == svc.batches * cfg.num_actors
        stats = plane.poll_fleet_stats()["per_fleet"][0]
        assert stats["circuit_state"] == 0 and stats["local_acts"] == 0
    finally:
        plane.shutdown()


@pytest.mark.cuda
def test_sharded_plane_batch_reaches_the_learner_in_one_copy(cuda):
    """A K = 2 shm plane's batch, assembled into one pinned host buffer,
    crosses to the card in ONE copy (``learner.batch_h2d``), and the
    learner's step on it equals the step on the same batch staged field
    by field; the shard children hold no CUDA context."""
    import time

    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.learner.learner import PACKED_KEY, Learner
    from r2d2_tpu_torch.learner.step import create_train_state
    from r2d2_tpu_torch.models.network import create_network
    from r2d2_tpu_torch.parallel.replay_shards import ShardedReplayPlane
    from r2d2_tpu_torch.replay.block import LocalBuffer
    from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS

    A = 4
    cfg = Config(game_name="Fake", torso="mlp", hidden_dim=64, num_actors=8,
                 burn_in_steps=4, learning_steps=4, forward_steps=2,
                 block_length=8, buffer_capacity=160, learning_starts=16,
                 batch_size=8, replay_shards=2, prefetch_batches=0,
                 superstep_pipeline=0, compute_dtype="float32")
    plane = ShardedReplayPlane(cfg, A, rng=np.random.default_rng(0))
    plane.pin_batches = True
    try:
        plane.start()
        for b in range(6):
            local = LocalBuffer(cfg, A)
            local.reset(np.full(cfg.stored_obs_shape, b, np.uint8))
            for s in range(cfg.block_length):
                local.add(s % A, float(s),
                          np.full(cfg.stored_obs_shape, b + s + 1, np.uint8),
                          np.arange(A, dtype=np.float32) + s,
                          np.full((2, 1, 64), s / 10, np.float32))
            block, _, ep = local.finish(None)
            plane.add(block, np.full(cfg.seqs_per_block, 1.0 + b,
                                     np.float32), ep)
        deadline = time.time() + 30
        while not plane.ready and time.time() < deadline:
            time.sleep(0.05)
        batch = plane.sample_batch()
    finally:
        plane.shutdown()
    assert batch[PACKED_KEY][0].is_pinned()
    plain = {k: (np.array(v) if isinstance(v, np.ndarray) else v)
             for k, v in batch.items() if k != PACKED_KEY}

    batches = dict(packed=batch, plain=plain)

    def one_step(which: str):
        # the batch by name: a failure's traceback then shows no arrays
        net = create_network(cfg, A, device=cuda,
                             generator=torch.Generator().manual_seed(0))
        learner = Learner(cfg, net, create_train_state(cfg, net.state_dict()))
        before = HOST_TRANSFERS.get("learner.batch_h2d")
        got = []
        learner.run(lambda: batches[which],
                    lambda i, p, o, loss: got.append((p, loss)),
                    max_steps=1)
        return HOST_TRANSFERS.get("learner.batch_h2d") - before, got[0]

    n_packed, (p_packed, l_packed) = one_step("packed")
    n_plain, (p_plain, l_plain) = one_step("plain")
    assert (n_packed, n_plain) == (1, 11)
    assert np.isfinite(l_packed) and l_packed == l_plain, (l_packed, l_plain)
    assert np.array_equal(p_packed, p_plain), float(
        np.abs(p_packed - p_plain).max())


MESH_A = 4


def _mesh_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    B, T, L = cfg.batch_size, cfg.seq_len, cfg.learning_steps
    return dict(
        obs=rng.integers(0, 255, (B, T, *cfg.stored_obs_shape), np.uint8),
        last_action=rng.random((B, T, MESH_A)).astype(np.float32),
        last_reward=rng.random((B, T)).astype(np.float32),
        hidden=rng.normal(size=(B, 2, cfg.lstm_layers, cfg.hidden_dim)
                          ).astype(np.float32),
        action=rng.integers(0, MESH_A, (B, L)).astype(np.int32),
        n_step_reward=rng.random((B, L)).astype(np.float32),
        n_step_gamma=np.full((B, L), 0.99, np.float32),
        burn_in=np.full(B, cfg.burn_in_steps, np.int32),
        learning=rng.integers(1, L + 1, B).astype(np.int32),
        forward=np.full(B, cfg.forward_steps, np.int32),
        is_weights=rng.uniform(0.3, 1.0, B).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_meshed_step_on_the_card_is_the_meshless_step(cuda, dtype):
    """An NCCL world of one: the meshed train step on a DTensor state
    equals the meshless step bit for bit (cuDNN deterministic)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from r2d2_tpu_torch.config import test_config
    from r2d2_tpu_torch.learner.step import (
        create_train_state,
        make_train_step,
    )
    from r2d2_tpu_torch.models.network import create_network
    from r2d2_tpu_torch.parallel.distributed import init_distributed
    from r2d2_tpu_torch.parallel.mesh import make_mesh
    from r2d2_tpu_torch.parallel.sharding import (
        ShardingTable,
        gather_state,
        mesh_train_step,
    )

    cfg = test_config(compute_dtype=dtype)
    init_distributed(store=dist.HashStore(), world_size=1, rank=0,
                     device=cuda)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        assert dist.get_backend() == "nccl"
        net = create_network(cfg, MESH_A, device=cuda,
                             generator=torch.Generator().manual_seed(0))
        a = create_train_state(cfg, net.state_dict())
        b = create_train_state(cfg, net.state_dict())
        table = ShardingTable(make_mesh(cfg, "cuda"), cfg)
        meshed = mesh_train_step(cfg, net, table, state_template=b)
        b = table.place_state(b)
        assert all(isinstance(v, DTensor) and v.device.type == "cuda"
                   for v in b.params.values())
        plain = make_train_step(cfg, net)
        for seed in range(2):
            batch = {k: torch.from_numpy(v).to(cuda)
                     for k, v in _mesh_batch(cfg, seed).items()}
            a, la, pa = plain(a, batch)
            b, lb, pb = meshed(b, batch)
            assert torch.equal(la, lb) and torch.equal(pa, pb)
        full = gather_state(b)
        assert all(torch.equal(a.params[k], full.params[k])
                   for k in a.params)
    finally:
        torch.backends.cudnn.deterministic = det
        dist.destroy_process_group()


@pytest.mark.cuda
def test_meshed_train_sync_on_the_card(cuda):
    """``train_sync(cfg, use_mesh=True)`` with no group up makes an NCCL
    world of one, trains through it and tears it down."""
    import torch.distributed as dist

    from r2d2_tpu_torch import train as ttrain
    from r2d2_tpu_torch.config import test_config

    m = ttrain.train_sync(test_config(game_name="Fake", training_steps=6),
                          device="cuda", use_mesh=True)
    assert m["num_updates"] == 6 and np.isfinite(m["losses"]).all()
    assert all(v.device.type == "cuda" for v in m["final_params"].values())
    assert not dist.is_initialized()


@pytest.mark.cuda
def test_cross_rank_draw_over_nccl_matches_the_cpu_draw(cuda):
    """The cross-rank draw at world size 1 over NCCL on the card — the
    global leaves and metadata gathered, the draw, the row exchange, the
    feedback — against the in-graph sampler, ``gather_batch`` and
    ``scatter_last`` on the CPU from the same ring: indices, ints, rows
    and the written slab bitwise; IS weights within 1e-6 relative (an
    f32 ``pow``)."""
    import torch.distributed as dist

    from r2d2_tpu_torch.config import test_config
    from r2d2_tpu_torch.learner import step as tstep
    from r2d2_tpu_torch.parallel.cross_rank import CrossRank
    from r2d2_tpu_torch.parallel.distributed import init_distributed
    from r2d2_tpu_torch.parallel.mesh import make_mesh
    from r2d2_tpu_torch.replay.device_ring import DeviceRing, gather_batch

    cfg = test_config(device_replay=True, in_graph_per=True)
    NB, K, B = cfg.num_blocks, cfg.seqs_per_block, cfg.batch_size
    rng = np.random.default_rng(0)
    arrays = {}
    for k, v in DeviceRing(cfg, 4, device="cpu").arrays.items():
        if v.dtype == torch.uint8:
            arrays[k] = torch.from_numpy(rng.integers(0, 256, v.shape,
                                                      dtype=np.uint8))
        elif v.dtype == torch.bool:
            arrays[k] = torch.from_numpy(rng.random(v.shape) < 0.5)
        else:
            arrays[k] = torch.from_numpy(
                rng.normal(size=v.shape).astype(np.float32))
    prios = torch.from_numpy(rng.uniform(0.0, 2.0, NB * K)
                             .astype(np.float32))
    prios[::5] = 0.0
    seq_meta = torch.from_numpy(np.stack([
        rng.integers(0, cfg.burn_in_steps + 1, (NB, K)),
        rng.integers(1, cfg.learning_steps + 1, (NB, K)),
        rng.integers(0, cfg.forward_steps + 1, (NB, K))], -1)
        .astype(np.int32))
    first = torch.from_numpy(rng.integers(
        cfg.burn_in_steps, cfg.burn_in_steps + 3, NB).astype(np.int32))
    u = torch.from_numpy(rng.random(B).astype(np.float32))
    vals = torch.from_numpy(rng.uniform(0.1, 2.0, B).astype(np.float32))

    idx, w, ints = tstep._in_graph_sample(cfg, u, prios, seq_meta, first)
    whole = gather_batch(cfg, arrays, ints, w)
    want = prios.clone()
    tstep.scatter_last(want, idx, vals)

    dev = torch.device("cuda", 0)
    init_distributed(store=dist.HashStore(), world_size=1, rank=0,
                     device="cuda")
    try:
        cross = CrossRank(cfg, make_mesh(cfg, "cuda"), NB)
        on = {k: v.to(dev) for k, v in arrays.items()}
        p = prios.to(dev)
        d, rows = cross.sample_batch(
            u.to(dev), p, cross.global_meta(seq_meta.to(dev),
                                            first.to(dev)), on)
        cross.scatter_feedback(p, d.idx, vals.to(dev))
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert torch.equal(d.idx.cpu(), idx) and torch.equal(d.ints.cpu(), ints)
    np.testing.assert_allclose(d.w.cpu().numpy(), w.numpy(), rtol=1e-6)
    for k in ("obs", "last_action", "last_reward", "hidden", "action",
              "n_step_reward", "n_step_gamma", "burn_in", "learning",
              "forward"):
        assert torch.equal(rows[k].cpu(), whole[k]), k
    assert torch.equal(p.cpu(), want)


@pytest.mark.cuda
def test_population_trains_on_the_card_while_the_cpu_sidecar_scores(
        cuda, tmp_path):
    """A 2-member population (the base and the low_resource preset) in two
    serve-mode fleets trains a few updates through ``train(device=
    "cuda")``: both members' blocks in replay, the service acting through
    the tensor-core kernel (layers x (batches + warm-up) launches), and
    the eval sidecar scoring on the CPU, its process holding no NVIDIA
    device file (no CUDA context; the driver library itself comes with
    ``import torch``)."""
    import json
    import threading

    from r2d2_tpu_torch import train
    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.league import eval_service

    spec = json.dumps([{"name": "base"},
                       {"name": "low", "preset": "low_resource"}])
    cfg = Config(game_name="Fake", torso="mlp", hidden_dim=64, num_actors=8,
                 burn_in_steps=4, learning_steps=4, forward_steps=2,
                 block_length=8, buffer_capacity=1600, learning_starts=64,
                 batch_size=8, actor_transport="process", actor_fleets=2,
                 actor_inference="serve", population_spec=spec,
                 league_eval=True, league_eval_episodes=2,
                 league_eval_interval=0.2, save_interval=2,
                 training_steps=10 ** 9, log_interval=0.3)
    seen, done, real_start = {}, threading.Event(), (
        eval_service.EvalSidecar.start)

    def start(self):
        real_start(self)
        seen["sidecar"] = self

    def log_sink(entry):
        lg = entry.get("league") or {}
        if (lg.get("sweeps", 0) >= 1 and entry["training_steps"] >= 4
                and "handles" not in seen):
            seen["handles"] = eval_service.card_handles(
                str(seen["sidecar"].proc.pid))
            done.set()

    KERNEL_LAUNCHES.reset()
    eval_service.EvalSidecar.start = start
    try:
        m = train.train(cfg, checkpoint_dir=str(tmp_path), verbose=False,
                        device="cuda", max_wall_seconds=240,
                        log_sink=log_sink, stop_fn=done.is_set)
    finally:
        eval_service.EvalSidecar.start = real_start
    assert done.is_set() and not m["fabric_failed"]
    assert np.isfinite(m["mean_loss"]) and m["num_updates"] >= 4
    assert set(m["blocks_per_member"]) == {0, 1}
    assert m["league"]["sweeps"] >= 1 and not m["league"]["health"]["failed"]
    assert seen["handles"] == []
    svc = m["fleet_health"]["service"]
    assert KERNEL_LAUNCHES.get(KERNEL) == cfg.lstm_layers * (
        svc["batches"] + svc["warmups"])
    assert KERNEL_LAUNCHES.get(CUDACORE_COUNTER) == 0


# ------------------------------------------------- telemetry and guards

@pytest.mark.cuda
def test_transfer_guard_trips_an_undeclared_sync_and_passes_declared(cuda):
    """Armed, a window turns an undeclared ``.item()`` into
    TransferGuardTripped naming it; a declared crossing, a non-blocking
    copy from pinned memory and a copy into pinned memory pass; the mode
    found before the window comes back after it."""
    from r2d2_tpu_torch.utils.trace import (
        HOST_TRANSFERS,
        TRANSFER_GUARD,
        TransferGuardTripped,
    )

    g = TRANSFER_GUARD
    g.reset()
    x = torch.arange(8.0, device=cuda)
    pinned = torch.zeros(8, pin_memory=True)
    x.sum().item()                      # the context and handles exist
    before = torch.cuda.get_sync_debug_mode()
    with g.arm():
        with pytest.raises(TransferGuardTripped, match="'test.window'"):
            with g.disallow("test.window"):
                x.sum().item()
        with g.disallow("test.window"):
            y = pinned.to(cuda, non_blocking=True)
            pinned.copy_(y * 2, non_blocking=True)
            with HOST_TRANSFERS.allowed("test.fetch"):
                torch.cuda.synchronize()
                assert float(x.sum().cpu()) == 28.0
    assert torch.cuda.get_sync_debug_mode() == before
    assert g.snapshot() == {"window.test.window": 2,
                            "trip.test.window": 1}


@pytest.mark.cuda
def test_transfer_guard_lets_another_threads_declared_sync_pass(cuda):
    """A window open in one thread: a declared fetch in another thread
    (an inference service's, an actor's) does not trip."""
    import threading

    from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS, TRANSFER_GUARD

    x = torch.ones(4, device=cuda)
    x.sum().item()
    got, inside, done = [], threading.Event(), threading.Event()

    def fetcher():
        inside.wait(10)
        with HOST_TRANSFERS.allowed("serve.act_fetch"):
            got.append(float(x.sum().cpu()))
        done.set()

    th = threading.Thread(target=fetcher)
    th.start()
    with TRANSFER_GUARD.arm():
        with TRANSFER_GUARD.disallow("anakin.dispatch"):
            inside.set()
            assert done.wait(10)
    th.join(10)
    assert got == [4.0]


@pytest.mark.cuda
def test_armed_diag_on_the_card_matches_the_cpu(cuda):
    """One armed train step (f32, TF32 off) on the card against the CPU:
    the scalars within 1e-4 relative, the bucket counts equal."""
    from r2d2_tpu_torch.config import test_config
    from r2d2_tpu_torch.learner.step import create_train_state, make_train_step
    from r2d2_tpu_torch.models import create_network
    from r2d2_tpu_torch.telemetry.learnhealth import DIAG_SCALARS

    cfg = test_config(learnhealth_interval=1, act_device="cpu")
    rng = np.random.default_rng(2)
    B, T, L = cfg.batch_size, cfg.seq_len, cfg.learning_steps
    batch = dict(
        obs=rng.integers(0, 255, (B, T, *cfg.obs_shape), dtype=np.uint8),
        last_action=rng.random((B, T, 4)).astype(np.float32),
        last_reward=rng.random((B, T)).astype(np.float32),
        hidden=rng.normal(size=(B, 2, 1, cfg.hidden_dim)).astype(np.float32),
        action=rng.integers(0, 4, (B, L)).astype(np.int32),
        n_step_reward=rng.normal(size=(B, L)).astype(np.float32),
        n_step_gamma=np.full((B, L), 0.97, np.float32),
        burn_in=np.full(B, cfg.burn_in_steps, np.int32),
        learning=np.full(B, L, np.int32),
        forward=np.full(B, cfg.forward_steps, np.int32),
        is_weights=rng.uniform(0.2, 1.0, B).astype(np.float32))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        net = create_network(cfg, 4, device=dev,
                             generator=torch.Generator().manual_seed(0))
        state = create_train_state(cfg, net.state_dict())
        *_, diag = make_train_step(cfg, net, learnhealth=True)(
            state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        out[dev.type] = diag.cpu().numpy()
    n = len(DIAG_SCALARS)
    np.testing.assert_allclose(out["cuda"][:n], out["cpu"][:n], rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_array_equal(out["cuda"][n:], out["cpu"][n:])
