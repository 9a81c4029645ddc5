"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions on the same device.  Every test is marked ``cuda`` and
skips without a CUDA device.  This file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Both routes are held to the plain version: the tensor-core kernel (bf16
``wh``) and the f32 kernel (f32 ``wh``, ``lstm_step_f32``: TMA, h multicast
across a cluster, f32 FMAs), at B = 65 (two 64-row tiles) and at ragged
hidden sizes (H = 100, whose gate strips start off 16-byte boundaries);
the f32 kernel also step by step at every B of {1, 7, 8, 16, 64, 65, 256},
H of {128, 512, 100} and T of {1, 85}.  The first CUDA-core design
(``_lstm_unroll_pr1``, f32 or bf16) is kept for comparison and held to
its numerics.  Tolerances (as in chip_smoke.py):
1e-5 max-abs in float32 with TF32 off, 1e-4 in bfloat16 — both sides round
the operands at the same points, only the order of the f32 sums differs.
The session load generator's float32 cell and the soak are held to take the
f32 route.  The acts' CUDA graphs (``actor.py:GraphedAct``): each of the 9
serving buckets' graphs bit for bit the eager act on both routes at 1 and
2 LSTM layers, a publish between replays taking effect with no new
capture, launches = layers × replays, and replays beside profiler windows;
the serving batcher's bf16 parity gate failing on the card for a head
whose quantization flips an action.  The meshless anakin entries' CUDA
graphs (``learner/graphs.py:graphed_rollout``, ``graphed_super_step``):
bit for bit the eager entries run from copies of the same state at the
rollouts and dispatches after each capture, one capture per entry and
eval branch, and a restored plane's replays the uninterrupted plane's.
"""
import numpy as np
import pytest
import torch

from r2d2_tpu_torch.ops import lstm as lstm_ops
from r2d2_tpu_torch.ops.lstm import (
    CUDACORE_COUNTER,
    KERNEL,
    PR1_COUNTER,
    _lstm_unroll_pr1,
    f32_plan,
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
    """The first CUDA-core design in bf16 is unchanged: h rounded to bf16,
    exact products, f32 sums, each step within 1e-4 of the plain step;
    deterministic; counted under its own name, never a route's kernel's."""
    xp, wh, h0, c0 = _inputs(T, B, H, seed=7 * T + B, device=cuda)
    whb = wh.to(torch.bfloat16)
    names = (KERNEL, CUDACORE_COUNTER, PR1_COUNTER)
    before = {k: KERNEL_LAUNCHES.get(k) for k in names}
    got = _lstm_unroll_pr1(xp, whb, h0, c0)
    again = _lstm_unroll_pr1(xp, whb, h0, c0)
    assert KERNEL_LAUNCHES.get(PR1_COUNTER) == before[PR1_COUNTER] + 2
    assert KERNEL_LAUNCHES.get(KERNEL) == before[KERNEL]
    assert KERNEL_LAUNCHES.get(CUDACORE_COUNTER) == before[CUDACORE_COUNTER]
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    h, c = h0, c0
    for t in range(T):
        _, h1, c1 = _lstm_unroll_pr1(xp[t:t + 1], whb, h, c)
        _, h2, c2 = lstm_unroll_reference(xp[t:t + 1], wh, h, c,
                                          torch.bfloat16)
        assert torch.equal(h1, got[0][t])
        assert (h1 - h2).abs().max().item() <= TOL[torch.bfloat16]
        assert (c1 - c2).abs().max().item() <= TOL[torch.bfloat16]
        h, c = h1, c1


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 85])
@pytest.mark.parametrize("H", [128, 512, 100])
@pytest.mark.parametrize("B", [1, 7, 8, 16, 64, 65, 256])
def test_f32_kernel_matches_plain_step_by_step(cuda, T, B, H):
    """The f32 route's kernel (``lstm_step_f32`` at ``f32_plan``'s tiles)
    against the plain version in f32 with TF32 off: every step within 1e-5
    of the plain step from the same (h, c), the whole unroll within the
    whole-unroll limit (1e-5); a T-step launch equals T one-step launches
    bit for bit (the hs tensor map's step index), and each call counts one
    launch of the route, none of the first design."""
    xp, wh, h0, c0 = _inputs(T, B, H, seed=T * B + H, device=cuda)
    before = {k: KERNEL_LAUNCHES.get(k) for k in (CUDACORE_COUNTER,
                                                  PR1_COUNTER)}
    hs, hT, cT = lstm_unroll_cuda(xp, wh, h0, c0)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES.get(CUDACORE_COUNTER) == (
        before[CUDACORE_COUNTER] + 1)
    want = lstm_unroll_reference(xp, wh, h0, c0, torch.float32)
    for g, w in zip((hs, hT, cT), want):
        assert g.shape == w.shape
        assert (g - w).abs().max().item() <= TOL[torch.float32]
    h, c = h0, c0
    for t in range(T):
        _, h1, c1 = lstm_unroll_cuda(xp[t:t + 1], wh, h, c)
        _, h2, c2 = lstm_unroll_reference(xp[t:t + 1], wh, h, c,
                                          torch.float32)
        assert torch.equal(h1, hs[t])
        assert (h1 - h2).abs().max().item() <= TOL[torch.float32]
        assert (c1 - c2).abs().max().item() <= TOL[torch.float32]
        h, c = h1, c1
    assert torch.equal(c, cT)
    assert KERNEL_LAUNCHES.get(CUDACORE_COUNTER) == (
        before[CUDACORE_COUNTER] + 1 + T)
    assert KERNEL_LAUNCHES.get(PR1_COUNTER) == before[PR1_COUNTER]


@pytest.mark.cuda
def test_f32_plan_matches_the_kernels_smem_count(cuda):
    lib = lstm_ops._library()
    for H in (16, 32, 36, 64, 100, 128, 256, 512, 1024):
        for B in (1, 2, 7, 8, 16, 32, 64, 65, 128, 256):
            plan = f32_plan(B, H)
            assert lib.lstm_infer_f32_smem(plan.n, plan.rows, H) == (
                plan.smem_bytes)


@pytest.mark.cuda
def test_f32_kernel_refuses_a_plan_that_is_not_f32_plans(cuda):
    """The C entry point refuses a grid that would leave a (row, unit)
    uncovered or add an empty block, and a cluster that does not divide
    the grid's hidden tiles."""
    B, H = 65, 512
    xp, wh, h0, c0 = _inputs(1, B, H, seed=3, device=cuda)
    plan = f32_plan(B, H)
    bad = [plan._replace(grid=(plan.grid[0] - 1, plan.grid[1])),
           plan._replace(grid=(plan.grid[0], plan.grid[1] + 1)),
           plan._replace(cluster=3)]
    for p in bad:
        with pytest.raises(RuntimeError, match="invalid argument"):
            lstm_ops._lstm_unroll_cudacore(xp, wh, h0, c0, p)


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
    # all of K sits in shared memory: H = 2600 fits no f32 tile
    big = _inputs(1, 1, 2600, seed=0, device=cuda)
    with pytest.raises(ValueError, match="shared-memory"):
        lstm_unroll_cuda(*big)
    with pytest.raises(ValueError, match="H % 4 == 0"):
        lstm_unroll_cuda(*_inputs(1, 2, 18, seed=0, device=cuda))


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


@pytest.mark.cuda
def test_f32_load_gen_cell_takes_the_cudacore_route(cuda):
    """The session load generator's float32 cell at the flagship width
    for a few seconds: its LSTM runs the f32 route, ``lstm_step_f32``,
    once per layer for every served batch and warm-up bucket, and the
    tensor-core kernel never."""
    from r2d2_tpu_torch.models.network import create_network
    from r2d2_tpu_torch.serving.server import SessionServer
    from r2d2_tpu_torch.tools import session_load_gen as slg

    A = 9
    cfg = slg.cell_config("float32", 64, 192)
    net = create_network(cfg, A, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    before = KERNEL_LAUNCHES.snapshot()
    srv = SessionServer(cfg, A, device=cuda)
    srv.publish_params(net.state_dict())
    srv.warmup()
    srv.start()
    try:
        out = slg.run_load(cfg, A, srv.host, srv.port, sessions=96,
                           workers=4, steps_mean=8, think_s=0.002,
                           run_seconds=3.0, call_timeout=20.0, seed=0)
        stats = srv.stats()
    finally:
        srv.stop()
        srv.close()
    after = KERNEL_LAUNCHES.snapshot()
    assert out["acts"] > 0 and stats["act_failures"] == 0
    assert (after.get(CUDACORE_COUNTER, 0) - before.get(CUDACORE_COUNTER, 0)
            == cfg.lstm_layers * (stats["batches"]
                                  + len(srv.batcher.buckets)))
    assert after.get(KERNEL, 0) == before.get(KERNEL, 0)


@pytest.mark.cuda
def test_soak_on_the_card_takes_the_cudacore_route(cuda, tmp_path,
                                                   capsys):
    """``tools/soak.py`` for 0.3 minutes on the card, host-sampled: SOAK
    PASS, and its float32 LSTM runs the f32 route, ``lstm_step_f32``,
    once per layer for every actor act, the tensor-core kernel never."""
    import json

    from r2d2_tpu_torch.actor import ACTOR_ACT
    from r2d2_tpu_torch.evaluate import EVAL_ACT
    from r2d2_tpu_torch.tools import soak
    from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS

    cfg = soak.soak_config()
    assert cfg.compute_dtype == "float32"
    before = KERNEL_LAUNCHES.snapshot()
    acts0 = HOST_TRANSFERS.get(ACTOR_ACT) + HOST_TRANSFERS.get(EVAL_ACT)
    out = str(tmp_path / "soak.json")
    assert soak.main(0.3, out=out) == 0
    assert capsys.readouterr().out.rstrip().endswith("SOAK PASS")
    after = KERNEL_LAUNCHES.snapshot()
    acts = HOST_TRANSFERS.get(ACTOR_ACT) + HOST_TRANSFERS.get(EVAL_ACT) - acts0
    with open(out) as f:
        summary = json.load(f)
    assert summary["num_updates"] > 0 and summary["priority_accounting_exact"]
    assert acts > 0
    assert (after.get(CUDACORE_COUNTER, 0) - before.get(CUDACORE_COUNTER, 0)
            == cfg.lstm_layers * acts)
    assert after.get(KERNEL, 0) == before.get(KERNEL, 0)


# a dp group over two cards, in every drivetrain (tests/test_torch_mesh_
# span.py's slow runs, here over NCCL)
SPAN_TP = (("dp", 2), ("tp", 2))
SPAN_RUNS = [
    dict(sync=True, mesh_shape=SPAN_TP, training_steps=8),
    dict(mesh_shape=SPAN_TP, training_steps=8, log_interval=0.2),
    dict(mesh_shape=SPAN_TP, device_replay=True, superstep_k=2,
         device_ring_layout="dp", training_steps=8, log_interval=0.2),
    dict(mesh_shape=SPAN_TP, device_replay=True, in_graph_per=True,
         superstep_k=2, device_ring_layout="dp", training_steps=8,
         log_interval=0.2),
    dict(mesh_shape=SPAN_TP, actor_transport="anakin", device_replay=True,
         in_graph_per=True, num_actors=4, superstep_k=2,
         anakin_episode_len=12, learning_starts=16, device_ring_layout="dp",
         training_steps=8, log_interval=0.2),
]


@pytest.mark.cuda
def test_dp_groups_over_two_cards_train_over_nccl(cuda, tmp_path):
    """dp = 2 x tp = 2 over four cards and NCCL, one rank a card: train()
    (and ``train_sync``) in the host ring, the device-ring super-step,
    in-graph PER and anakin.  Every rank takes every update and ends with
    the same params, the same collectives; the ranks 1 and 3 are peers
    with no buffer, the leaders' buffers count one feedback an update
    (anakin: every rank steps its group's lanes); and ``train_sync``'s
    params at dp = 2 x tp = 2 equal dp = 2's on two of the cards to the
    learner tolerance (1e-4 of the largest).  Needs four cards."""
    from r2d2_tpu_torch.tools.rank_worker import run_ranks

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    four = run_ranks("span_train", 4, str(tmp_path / "four"),
                     dict(runs=SPAN_RUNS, device="cuda"), timeout=900,
                     device="cuda")
    for i, run in enumerate(SPAN_RUNS):
        ranks = [r[i] for r in four]
        anakin = run.get("actor_transport") == "anakin"
        for rank, r in enumerate(ranks):
            peer = rank % 2 == 1 and not anakin
            assert r["num_updates"] >= run["training_steps"], (run, r)
            assert not r["fabric_failed"] and bool(r["peer"]) == peer
            assert r["collectives"] == ranks[0]["collectives"]
            for k, v in r["params"].items():
                np.testing.assert_array_equal(v, ranks[0]["params"][k])
            if not run.get("sync"):
                assert r["buffer_training_steps"] == (
                    0 if peer else r["num_updates"])
    two = run_ranks("span_train", 2, str(tmp_path / "two"),
                    dict(runs=[dict(SPAN_RUNS[0], mesh_shape=(("dp", 2),))],
                         device="cuda"), timeout=600, device="cuda")
    for k, v in two[0][0]["params"].items():
        np.testing.assert_allclose(four[0][0]["params"][k], v, rtol=0,
                                   atol=1e-4 * np.abs(v).max(), err_msg=k)


# --------------------------------------------------------------------------
# the learner's CUDA-graph captures (learner/graphs.py)
# --------------------------------------------------------------------------

def _states_equal(a, b) -> bool:
    return (a.step == b.step and a.opt_state.count == b.opt_state.count
            and torch.equal(a.step_t, b.step_t)
            and torch.equal(a.opt_state.count_t, b.opt_state.count_t)
            and all(torch.equal(x[k], y[k])
                    for x, y in ((a.params, b.params),
                                 (a.target_params, b.target_params),
                                 (a.opt_state.mu, b.opt_state.mu),
                                 (a.opt_state.nu, b.opt_state.nu))
                    for k in x))


def _graph_setup(cuda, **kw):
    """A small learner on the card and two copies of its fresh state; cuDNN
    deterministic (restored by the caller), so that a graph and the eager
    step may be held bit for bit."""
    from r2d2_tpu_torch.config import test_config
    from r2d2_tpu_torch.learner.step import create_train_state
    from r2d2_tpu_torch.models.network import create_network

    cfg = test_config(target_net_update_interval=2, **kw)
    net = create_network(cfg, MESH_A, device=cuda,
                         generator=torch.Generator().manual_seed(0))
    return (cfg, net, create_train_state(cfg, net.state_dict()),
            create_train_state(cfg, net.state_dict()))


def _random_ring(cfg, device, seed=0):
    """Ring arrays, PER leaves, metadata and first burn-ins at the
    config's slot shapes, random, on ``device``."""
    from r2d2_tpu_torch.replay.device_ring import DeviceRing

    NB, K = cfg.num_blocks, cfg.seqs_per_block
    rng = np.random.default_rng(seed)
    arrays = {}
    for k, v in DeviceRing(cfg, MESH_A, device="cpu").arrays.items():
        if v.dtype == torch.uint8:
            a = torch.from_numpy(rng.integers(0, 256, v.shape,
                                              dtype=np.uint8))
        elif v.dtype == torch.bool:
            a = torch.from_numpy(rng.random(v.shape) < 0.5)
        else:
            a = torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
        if k == "action":
            a = a % MESH_A
        arrays[k] = a.to(device)
    prios = torch.from_numpy(rng.uniform(0.0, 2.0, NB * K).astype(np.float32))
    prios[::5] = 0.0
    seq_meta = torch.from_numpy(np.stack([
        rng.integers(0, cfg.burn_in_steps + 1, (NB, K)),
        rng.integers(1, cfg.learning_steps + 1, (NB, K)),
        rng.integers(1, cfg.forward_steps + 1, (NB, K))], -1)
        .astype(np.int32))
    first = torch.from_numpy(rng.integers(
        cfg.burn_in_steps, cfg.burn_in_steps + 3, NB).astype(np.int32))
    return arrays, prios.to(device), seq_meta.to(device), first.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("lh", [0, 2])
def test_graphed_train_step_is_the_eager_step(cuda, lh):
    """``learner.train_step`` as a CUDA graph against the plain step from
    the same state on the same batches, across two target syncs: loss,
    priorities, the diag rows and the whole state bit for bit; one
    capture, two with the armed and disarmed learnhealth steps."""
    from r2d2_tpu_torch.learner.graphs import make_learner_step
    from r2d2_tpu_torch.learner.step import make_train_step
    from r2d2_tpu_torch.utils.trace import RetraceGuard

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cfg, net, a, b = _graph_setup(cuda, learnhealth_interval=lh)
        guard = RetraceGuard()
        graphed = make_learner_step(cfg, net, learnhealth=lh > 0,
                                    guard=guard)
        plain = make_train_step(cfg, net, learnhealth=lh > 0)
        for seed in range(5):
            batch = {k: torch.from_numpy(v).to(cuda)
                     for k, v in _mesh_batch(cfg, seed).items()}
            ga, gb = graphed(a, batch), plain(b, batch)
            a, b = ga[0], gb[0]
            for x, y in zip(ga[1:], gb[1:]):
                assert torch.equal(x, y)
            assert _states_equal(a, b)
        torch.cuda.synchronize()
        assert guard.counts() == {"learner.train_step": 2 if lh else 1}
        assert graphed.graphs.captures == (2 if lh else 1)
        guard.assert_within_budgets()
    finally:
        torch.backends.cudnn.deterministic = det


@pytest.mark.cuda
def test_a_new_batch_shape_captures_again_and_counts_two(cuda):
    """Shape drift in the hot loop: a batch of another size is a second
    capture of the step, the second trace its guard counts."""
    from r2d2_tpu_torch.learner.graphs import make_learner_step
    from r2d2_tpu_torch.utils.trace import RetraceGuard

    cfg, net, a, _ = _graph_setup(cuda)
    guard = RetraceGuard(default_budget=1)
    step = make_learner_step(cfg, net, guard=guard)
    for B in (cfg.batch_size, cfg.batch_size, cfg.batch_size // 2,
              cfg.batch_size // 2):
        batch = {k: torch.from_numpy(v[:B]).to(cuda)
                 for k, v in _mesh_batch(cfg, B).items()}
        a, loss, prios = step(a, batch)
        assert prios.shape == (B,) and torch.isfinite(loss)
    assert guard.counts() == {"learner.train_step": 2}
    assert guard.over_budget() == [("learner.train_step", 2, 1)]


@pytest.mark.cuda
def test_graphed_super_step_is_k_eager_steps(cuda):
    """``learner.super_step`` on the card (each inner step a graph that
    gathers from the ring and steps) against the gathers and plain steps
    issued one by one: losses, priorities and the state bit for bit."""
    from r2d2_tpu_torch.learner import step as tstep
    from r2d2_tpu_torch.replay.device_ring import gather_batch
    from r2d2_tpu_torch.utils.trace import RetraceGuard

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cfg, net, a, b = _graph_setup(cuda, device_replay=True,
                                      superstep_k=3)
        k, B = cfg.superstep_k, cfg.batch_size
        arrays, prios, seq_meta, first = _random_ring(cfg, cuda)
        guard = RetraceGuard()
        fused = tstep.make_super_step_fn(cfg, net, k, guard=guard)
        plain = tstep.make_train_step(cfg, net)
        u = torch.rand((2, k, B), generator=torch.Generator(
            device=cuda).manual_seed(3), device=cuda)
        for d in range(2):
            draws = [tstep._in_graph_sample(cfg, u[d, j], prios, seq_meta,
                                            first) for j in range(k)]
            ints = torch.stack([x[2] for x in draws])
            w = torch.stack([x[1] for x in draws])
            a, losses, fprios = fused(a, arrays, ints, w)
            for j in range(k):
                b, loss, p = plain(b, gather_batch(cfg, arrays, ints[j],
                                                   w[j]))
                assert torch.equal(losses[j], loss)
                assert torch.equal(fprios[j], p)
            assert _states_equal(a, b)
        assert guard.counts() == {"learner.super_step": 1}
    finally:
        torch.backends.cudnn.deterministic = det


@pytest.mark.cuda
def test_graphed_in_graph_super_step_is_the_eager_one(cuda):
    """``learner.in_graph_per_super_step`` on the card (sample, gather,
    step and scatter in one graph an inner step) against the same super-
    step run eagerly, from the same ring, state and generator seed:
    sampled indices, losses, the priority slab and the state bit for
    bit."""
    from r2d2_tpu_torch.learner import step as tstep
    from r2d2_tpu_torch.utils.trace import RetraceGuard

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cfg, net, a, b = _graph_setup(cuda, device_replay=True,
                                      in_graph_per=True, superstep_k=3)
        k = cfg.superstep_k
        arrays, prios, seq_meta, first = _random_ring(cfg, cuda)
        pa, pb = prios.clone(), prios.clone()
        guard = RetraceGuard()
        graphed = tstep.make_in_graph_per_super_step_fn(cfg, net, k,
                                                        guard=guard)
        eager = tstep.make_in_graph_per_super_step_fn(
            cfg, net, k, train_step=tstep.make_train_step(cfg, net),
            guard=RetraceGuard())
        ga = torch.Generator(device=cuda).manual_seed(7)
        gb = torch.Generator(device=cuda).manual_seed(7)
        for _ in range(2):
            ra, rb = [], []
            a, pa, la = graphed(a, arrays, pa, seq_meta, first,
                                generator=ga, record=ra)
            b, pb, lb = eager(b, arrays, pb, seq_meta, first, generator=gb,
                              record=rb)
            assert torch.equal(la, lb) and torch.equal(pa, pb)
            assert all(torch.equal(x, y) for x, y in zip(ra, rb))
            assert len(ra) == k
            assert _states_equal(a, b)
        assert graphed.graphs.captures == 1
        assert guard.counts() == {"learner.in_graph_per_super_step": 1}
    finally:
        torch.backends.cudnn.deterministic = det


@pytest.mark.cuda
def test_profiler_windows_beside_graph_replays_finish(cuda, tmp_path):
    """``device_profile`` windows opened and closed on one thread while
    another replays the learner's graph (the ``/profilez`` case): every
    window writes its trace and both threads finish.  Without
    ``PROFILER_LOCK`` a profiler stopped beside a graph launch hung both
    on the card."""
    import os
    import threading

    from r2d2_tpu_torch.learner.graphs import make_learner_step
    from r2d2_tpu_torch.utils.trace import RetraceGuard, device_profile

    cfg, net, state, _ = _graph_setup(cuda)
    step = make_learner_step(cfg, net, guard=RetraceGuard())
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in _mesh_batch(cfg, 0).items()}
    stop, replays = threading.Event(), [0]

    def learner():
        while not stop.is_set():
            _, loss, _ = step(state, batch)
            loss.item()
            replays[0] += 1

    t = threading.Thread(target=learner, daemon=True)
    t.start()
    try:
        for i in range(4):
            with device_profile(str(tmp_path / str(i)), require_cuda=True):
                threading.Event().wait(0.2)
            assert os.path.exists(tmp_path / str(i) / "trace.json")
    finally:
        stop.set()
        t.join(60)
    assert not t.is_alive() and replays[0] > 0
    assert step.graphs.captures == 1


# --------------------------------------------------------------------------
# the acts' CUDA graphs (actor.py:GraphedAct)
# --------------------------------------------------------------------------

def _act_setup(cuda, compute_dtype, layers):
    """The flagship serving net (nature torso over 84×84 frames folded to
    21×21×16, H = 512, 9 actions, 9 buckets up to 256) at the given
    compute dtype and LSTM depth, with seeded params, and a graphed act
    over it counting in a guard of its own."""
    from r2d2_tpu_torch.actor import make_act_fn
    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.models.network import create_network
    from r2d2_tpu_torch.serving.batcher import bucket_sizes
    from r2d2_tpu_torch.utils.trace import RetraceGuard

    cfg = Config(serve_max_batch=256, compute_dtype=compute_dtype,
                 lstm_layers=layers)
    net = create_network(cfg, 9, device=cuda,
                         generator=torch.Generator().manual_seed(0))
    buckets = bucket_sizes(cfg.serve_max_batch)
    act = make_act_fn(net, retrace_name="serving.act",
                      retrace_budget=len(buckets) + 1, guard=RetraceGuard())
    return cfg, net, buckets, act


def _act_params(net, seed, device):
    g = torch.Generator().manual_seed(seed)
    return {k: (v.detach().cpu() + 0.01 * torch.randn(v.shape, generator=g)
                ).to(device) for k, v in net.state_dict().items()}


def _act_rows(cfg, n, seed, device):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(
                0, 256, (n, *cfg.stored_obs_shape), dtype=np.uint8)).to(device),
            torch.from_numpy(np.eye(9, dtype=np.float32)[
                rng.integers(9, size=n)]).to(device),
            torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(device),
            torch.from_numpy((rng.normal(size=(
                n, 2, cfg.lstm_layers, cfg.hidden_dim)) * 0.3)
                .astype(np.float32)).to(device))


def _eager_act(net, params, x):
    from torch.func import functional_call

    with torch.inference_mode():
        return functional_call(net, params, x)


@pytest.mark.cuda
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("compute_dtype,counter", [
    ("bfloat16", KERNEL), ("float32", CUDACORE_COUNTER)])
def test_graphed_act_is_the_eager_act_in_every_bucket(cuda, compute_dtype,
                                                      counter, layers):
    """The flagship serving act, one CUDA graph a bucket, against the
    eager act on the same params and rows: q and the new hidden bit for
    bit in all 9 buckets (cuDNN deterministic), on the tensor-core route
    (bf16, ``lstm_step_wgmma``) and the f32 route (``lstm_step_f32``, a
    cluster launch) at 1 and 2 LSTM layers; 9 captures; the kernel's
    launches = layers × replays; a publish between replays takes effect
    bit for bit and captures nothing."""
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cfg, net, buckets, act = _act_setup(cuda, compute_dtype, layers)
        p1, p2 = _act_params(net, 1, cuda), _act_params(net, 2, cuda)
        rows = {n: _act_rows(cfg, n, n, cuda) for n in buckets}
        before = KERNEL_LAUNCHES.get(counter)
        graphed = {n: tuple(t.clone() for t in act(p1, *rows[n]))
                   for n in buckets}
        torch.cuda.synchronize()
        assert KERNEL_LAUNCHES.get(counter) - before == layers * len(buckets)
        assert act.graphs.captures == len(buckets) == 9
        assert act.entry.traces == 9 and act.adoptions == 1
        for n in buckets:
            eager = _eager_act(net, p1, rows[n])
            assert all(torch.equal(g, e) for g, e in zip(graphed[n], eager)), n
        # a publish between two replays of one bucket
        for n in (1, 64, 256):
            before = KERNEL_LAUNCHES.get(counter)
            got = tuple(t.clone() for t in act(p2, *rows[n]))
            assert KERNEL_LAUNCHES.get(counter) - before == layers
            assert all(torch.equal(g, e) for g, e in zip(
                got, _eager_act(net, p2, rows[n])))
            got = tuple(t.clone() for t in act(p1, *rows[n]))
            assert all(torch.equal(g, e) for g, e in zip(got, graphed[n]))
        assert act.graphs.captures == 9 and act.adoptions == 7
        # the published dicts were read, never written
        assert all(torch.equal(v, _act_params(net, 2, cuda)[k])
                   for k, v in p2.items())
    finally:
        torch.backends.cudnn.deterministic = det


@pytest.mark.cuda
@pytest.mark.parametrize("w0,parity", [(1 + 2 ** -9, False), (1.5, True)])
def test_greedy_parity_gate_on_the_card_sees_a_flipped_action(cuda, w0,
                                                              parity):
    """The batcher's bf16 parity gate on the card, where its probe act
    returns its graph's outputs, which the probe's second act overwrites:
    a head whose bf16 quantization flips action 0 to action 1 (action 0's
    weight 1 + 2^-9 rounds to 1.0, action 1's 1.0 + 2^-10 stays) fails
    the gate; the same head with a wide margin (1.5) passes.  f32
    compute, so the quantization is all that differs."""
    from r2d2_tpu_torch.config import test_config
    from r2d2_tpu_torch.models.network import create_network
    from r2d2_tpu_torch.serving.batcher import ContinuousBatcher

    cfg = test_config(serve_dtype="bfloat16", serve_max_sessions=8,
                      serve_max_batch=8)
    net = create_network(cfg, 4, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    p = {k: v.detach().clone() for k, v in net.state_dict().items()}
    for k in ("adv_hidden", "adv_out", "val_hidden", "val_out"):
        p[f"head.{k}.weight"].zero_()
        p[f"head.{k}.bias"].zero_()
    p["head.adv_hidden.bias"][0] = 1.0          # the head's input: e0
    p["head.adv_out.weight"][0, 0] = w0
    p["head.adv_out.weight"][1, 0] = 1.0
    p["head.adv_out.bias"][:] = torch.tensor([0.0, 2.0 ** -10, -1.0, -1.0])
    b = ContinuousBatcher(cfg, 4, device=cuda)
    assert b.greedy_parity_ok(p) is parity
    assert b._probe_act.graphs.captures == 1


@pytest.mark.cuda
def test_act_replays_beside_profiler_windows_finish(cuda, tmp_path):
    """``device_profile`` windows opened and closed on one thread while
    another replays the act's graph (a ``/profilez`` window over served
    traffic): every window writes a trace holding the act's kernel, and
    both threads finish."""
    import json
    import os
    import threading

    from r2d2_tpu_torch.utils.trace import device_profile

    cfg, net, _, act = _act_setup(cuda, "bfloat16", 1)
    params, rows = _act_params(net, 1, cuda), _act_rows(cfg, 32, 0, cuda)
    stop, replays = threading.Event(), [0]

    def actor():
        while not stop.is_set():
            q, _ = act(params, *rows)
            q.cpu()
            replays[0] += 1

    t = threading.Thread(target=actor, daemon=True)
    t.start()
    try:
        for i in range(4):
            with device_profile(str(tmp_path / str(i)), require_cuda=True):
                threading.Event().wait(0.2)
            path = tmp_path / str(i) / "trace.json"
            assert os.path.exists(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
            assert any("lstm_step_wgmma" in str(e.get("name", ""))
                       for e in events)
    finally:
        stop.set()
        t.join(60)
    assert not t.is_alive() and replays[0] > 0
    assert act.graphs.captures == 1


def _anakin_plane(cuda, seed=0, **kw):
    """A small meshless anakin plane on the card (the mlp torso, the eval
    lane every 2nd dispatch) and its learner."""
    from r2d2_tpu_torch.config import test_config
    from r2d2_tpu_torch.learner.anakin import AnakinPlane
    from r2d2_tpu_torch.learner.learner import Learner
    from r2d2_tpu_torch.learner.step import create_train_state
    from r2d2_tpu_torch.models.network import create_network
    from r2d2_tpu_torch.replay.device_ring import DeviceRing

    cfg = test_config(**{**dict(
        game_name="Fake", actor_transport="anakin", device_replay=True,
        in_graph_per=True, num_actors=2, superstep_k=2,
        anakin_episode_len=12, training_steps=10 ** 9, learning_starts=48,
        anakin_eval_interval=2), **kw})
    net = create_network(cfg, MESH_A, device=cuda,
                         generator=torch.Generator().manual_seed(seed))
    plane = AnakinPlane(cfg, net, MESH_A,
                        DeviceRing(cfg, MESH_A, device=cuda))
    learner = Learner(cfg, net, create_train_state(cfg, net.state_dict()))
    return cfg, net, plane, learner


def _anakin_copies(plane):
    """Copies of the plane's carry, ring arrays, leaves, ``seq_meta`` and
    ``first``, in the entries' argument order."""
    arrays, prios, seq_meta, first = plane._handles()
    return ({k: v.clone() for k, v in plane.state.items()},
            {k: v.clone() for k, v in arrays.items()}, prios.clone(),
            seq_meta.clone(), first.clone())


def _anakin_same(plane, copies) -> bool:
    ast, arrays, prios, seq_meta, first = copies
    mine = _anakin_copies(plane)
    return (all(torch.equal(plane.state[k], ast[k]) for k in ast)
            and all(torch.equal(mine[1][k], arrays[k]) for k in arrays)
            and torch.equal(mine[2], prios) and torch.equal(mine[3], seq_meta)
            and torch.equal(mine[4], first))


@pytest.mark.cuda
@pytest.mark.parametrize("lh", [0, 2])
def test_anakin_graphs_are_the_eager_dispatch_at_other_indices(cuda, lh):
    """The meshless anakin entries as CUDA graphs, held to the eager
    functions run from copies of the same carry, ring, leaves, train state
    and index at the rollouts and dispatches after each capture (the
    eval lane on at dispatches 2 and 4): the result vector, the carry,
    the ring, the PER state and the train state bit for bit; one capture
    of the rollout, one of each eval branch of the super-step."""
    from r2d2_tpu_torch.learner import anakin
    from r2d2_tpu_torch.learner.graphs import _clone_state

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cfg, net, plane, learner = _anakin_plane(cuda,
                                                 learnhealth_interval=lh)
        eager_roll = anakin.make_anakin_rollout(
            cfg, net, plane.env, MESH_A, plane.roll_steps)
        eager_step = anakin.make_anakin_super_step(cfg, net, plane.env,
                                                   MESH_A)
        rollouts = 0
        while not plane.ready:
            copies = _anakin_copies(plane)
            if rollouts:
                want = eager_roll(learner.state.params, *copies)
            out = plane.rollout(learner.state.params, plane.state,
                                *plane._handles())
            plane._absorb(out[-1].cpu().numpy())
            if rollouts:
                assert torch.equal(out[-1], want[-1])
                assert _anakin_same(plane, want[:5])
            rollouts += 1
        assert rollouts >= 3
        for d in range(5):
            copies = _anakin_copies(plane)
            twin = _clone_state(learner.state)
            learner.state, *rest = plane.super_step(
                learner.state, plane.state, *plane._handles(), d)
            if d >= 2:
                want = eager_step(twin, *copies, d)
                assert torch.equal(rest[-1], want[-1])
                assert _anakin_same(plane, want[1:6])
                assert _states_equal(learner.state, want[0])
        torch.cuda.synchronize()
        assert plane.rollout.graphs.captures == 1
        assert plane.super_step.graphs.captures == 2
        assert plane.super_step.graphs.entry.traces == 2
    finally:
        torch.backends.cudnn.deterministic = det


@pytest.mark.cuda
def test_restored_anakin_plane_replays_as_the_uninterrupted_one(cuda,
                                                                tmp_path):
    """Snapshot after dispatch 1, restore into a plane built from other
    params, dispatch twice: its graphs (captured afresh, reading the
    restored tensors) give the uninterrupted plane's payload and train
    state bit for bit."""
    from r2d2_tpu_torch.learner.graphs import _clone_state

    def drive(plane, learner, n):
        while not plane.ready:
            plane.rollout_step(learner.state.params)
        for _ in range(n):
            learner.state, result = plane.dispatch(learner.state)
            plane.harvest(result)

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _, _, a, la = _anakin_plane(cuda)
        drive(a, la, 4)
        _, _, b, lb = _anakin_plane(cuda)
        drive(b, lb, 2)
        path = str(tmp_path / "anakin.bin")
        meta = b.write_state(path)
        _, _, c, lc = _anakin_plane(cuda, seed=1)
        c.read_state(path, meta)
        lc.state = _clone_state(lb.state)
        drive(c, lc, 2)
        torch.cuda.synchronize()
        assert _states_equal(la.state, lc.state)
        pa, pc = a._payload(), c._payload()
        assert sorted(pa) == sorted(pc)
        assert all(np.array_equal(pa[k], pc[k]) for k in pa)
        assert c.super_step.graphs.captures == 2
    finally:
        torch.backends.cudnn.deterministic = det
