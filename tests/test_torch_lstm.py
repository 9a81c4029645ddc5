"""The port's fused LSTM inference unroll (r2d2_tpu_torch/ops/lstm.py)
against the JAX package's Pallas kernel run in interpret mode on the CPU.

Same inputs, made with numpy from a seed, go through
``r2d2_tpu.ops.lstm.lstm_unroll_pallas(..., interpret=True)`` and the
port's ``lstm_unroll_reference`` / ``lstm_unroll_infer`` (which on CPU
tensors is the reference).  Tolerances: float32 1e-6 (same arithmetic,
another summation order); bfloat16 1e-3 (operands rounded identically —
both sides round h to bf16 and multiply exactly in f32 — so only the
summation order differs, amplified by nothing larger than the gates).

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
and ``chip_smoke.py`` hold them against the plain version there.  What
surrounds them is tested here: the tensor-core route's tile plan
(``launch_plan``), the f32 route's (``f32_plan``), the choice of route by
dtype, and the checks the wrapper makes before anything is built.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.ops.lstm import lstm_unroll_pallas
from r2d2_tpu_torch.ops import lstm as lstm_ops
from r2d2_tpu_torch.ops.lstm import (
    MAX_SMEM,
    ROW_TILE,
    UNITS_PER_GATE,
    f32_plan,
    f32_plan_for,
    launch_plan,
    lstm_unroll_cuda,
    lstm_unroll_infer,
    lstm_unroll_reference,
    plan_for,
)

B, H = 3, 16


def _inputs(T, seed=0):
    rng = np.random.default_rng(seed)
    xp = (rng.normal(size=(T, B, 4 * H)) * 0.5).astype(np.float32)
    wh = (rng.normal(size=(H, 4 * H)) * 0.3).astype(np.float32)
    h0 = rng.normal(size=(B, H)).astype(np.float32)
    c0 = rng.normal(size=(B, H)).astype(np.float32)
    return xp, wh, h0, c0


_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-6),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-3)}


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("T", [1, 9])
def test_reference_matches_pallas_interpret(T, dtype):
    jdt, tdt, atol = _DTYPES[dtype]
    xp, wh, h0, c0 = _inputs(T)
    hs_j, hT_j, cT_j = lstm_unroll_pallas(
        jnp.asarray(xp), jnp.asarray(wh), jnp.asarray(h0), jnp.asarray(c0),
        compute_dtype=jdt, interpret=True)
    args = [torch.from_numpy(a) for a in (xp, wh, h0, c0)]
    for fn in (lstm_unroll_reference, lstm_unroll_infer):
        hs, hT, cT = fn(*args, compute_dtype=tdt)
        assert hs.shape == (T, B, H) and hs.dtype == torch.float32
        np.testing.assert_allclose(hs.numpy(), np.asarray(hs_j), atol=atol,
                                   rtol=0)
        np.testing.assert_allclose(hT.numpy(), np.asarray(hT_j), atol=atol,
                                   rtol=0)
        np.testing.assert_allclose(cT.numpy(), np.asarray(cT_j), atol=atol,
                                   rtol=0)


def test_bf16_rounds_h_before_the_product_and_not_after():
    """The kernel's numerics are the Pallas kernel's, not the scan's: with
    h rounded to bf16 and the product left in f32, bf16 and f32 results
    differ (the rounding is real) but the reference agrees with the
    interpreted Pallas kernel far more closely than the bf16 product
    rounding would allow."""
    xp, wh, h0, c0 = _inputs(9, seed=1)
    args = [torch.from_numpy(a) for a in (xp, wh, h0, c0)]
    hs16, _, _ = lstm_unroll_reference(*args, compute_dtype=torch.bfloat16)
    hs32, _, _ = lstm_unroll_reference(*args, compute_dtype=torch.float32)
    assert (hs16 - hs32).abs().max() > 1e-4
    hs_j, _, _ = lstm_unroll_pallas(
        *(jnp.asarray(a) for a in (xp, wh, h0, c0)),
        compute_dtype=jnp.bfloat16, interpret=True)
    assert np.abs(hs16.numpy() - np.asarray(hs_j)).max() < 1e-5


def test_infer_is_not_differentiable():
    """Mirrors tests/test_lstm_pallas.py::test_pallas_unroll_is_not_
    differentiable: the primal is valid, backward raises."""
    xp, wh, h0, c0 = _inputs(4)
    w = torch.from_numpy(wh).requires_grad_(True)
    hs, _, _ = lstm_unroll_infer(torch.from_numpy(xp), w,
                                 torch.from_numpy(h0), torch.from_numpy(c0),
                                 compute_dtype=torch.float32)
    assert torch.isfinite(hs).all()
    with pytest.raises(RuntimeError, match="not differentiable"):
        hs.sum().backward()


@pytest.mark.parametrize("bad", ["xp_dtype", "wh_shape", "h0_shape",
                                 "wh_dtype"])
def test_wrapper_rejects_what_the_kernel_cannot_take(bad):
    xp, wh, h0, c0 = (torch.from_numpy(a) for a in _inputs(2))
    if bad == "xp_dtype":
        xp = xp.double()
    elif bad == "wh_shape":
        wh = wh[:, :-4]
    elif bad == "h0_shape":
        h0 = h0[:, :-1]
    else:
        wh = wh.half()
    with pytest.raises((TypeError, ValueError)):
        lstm_unroll_reference(xp, wh, h0, c0, compute_dtype=torch.float32)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never runs the plain version: CPU inputs raise
    before any build is attempted."""
    xp, wh, h0, c0 = (torch.from_numpy(a) for a in _inputs(1))
    with pytest.raises(ValueError, match="CUDA device"):
        lstm_unroll_cuda(xp, wh, h0, c0)



# the serving buckets of the flagship config (serve_max_batch=256) and
# every hidden size the repo's configs and the port's tests use
BUCKETS = [1, 2, 4, 8, 16, 32, 64, 128, 256]
HIDDEN = [16, 32, 64, 100, 256, 512]


@pytest.mark.parametrize("H", HIDDEN)
@pytest.mark.parametrize("B", BUCKETS)
def test_launch_plan_covers_every_row_and_unit_once(B, H):
    """Block (x, y) owns units [x*n, x*n+n) of all four gates (masked at
    H) and rows [64y, 64y+64) (masked at B): the grid, which the C entry
    point launches as given, covers each (row, unit) exactly once, with
    no block that owns nothing."""
    plan = launch_plan(B, H)
    cover = np.zeros((B, H), np.int64)
    for x in range(plan.grid[0]):
        for y in range(plan.grid[1]):
            owned = cover[y * ROW_TILE:(y + 1) * ROW_TILE,
                          x * plan.n:(x + 1) * plan.n]
            assert owned.size
            owned += 1
    assert (cover == 1).all()
    assert plan == plan_for(plan.n, B, H)


@pytest.mark.parametrize("H", HIDDEN)
@pytest.mark.parametrize("B", BUCKETS)
def test_launch_plan_fits_shared_memory(B, H):
    plan = launch_plan(B, H)
    assert plan.n in UNITS_PER_GATE
    assert plan.smem_bytes <= MAX_SMEM == 232_448
    # the wh strips, the A tile and one barrier per stage at least
    kp = -(-H // lstm_ops.STAGE_K) * lstm_ops.STAGE_K
    assert plan.smem_bytes >= 8 * plan.n * kp + 2 * ROW_TILE * kp
    if H % 8:   # strips copied into place: only at n = 8
        assert plan.n == 8


def test_launch_plan_spreads_small_buckets_over_many_blocks():
    """Up to two row tiles the flagship width runs 64 blocks per tile;
    B = 256 takes wider tiles (n = 16), and wh is read once per tile."""
    assert launch_plan(1, 512).grid == (64, 1)
    assert launch_plan(65, 512).grid == (64, 2)
    assert launch_plan(256, 512).grid == (32, 4)
    with pytest.raises(ValueError, match="shared-memory"):
        launch_plan(1, 1600)


# the f32 route's main-path shapes: the reference soak's H = 128, B = 16,
# and the load generator's float32 cell at H = 512 over its buckets
F32_MAIN = [(16, 128), (1, 512), (8, 512), (16, 512), (32, 512),
            (64, 512), (256, 512)]


@pytest.mark.parametrize("B,H", F32_MAIN + [(7, 100), (65, 512), (3, 16),
                                            (9, 36), (2, 1536)])
def test_f32_plan_covers_every_row_and_unit_once(B, H):
    """Block (x, y) owns units [x*n, x*n+n) of all four gates and rows
    [y*rows, (y+1)*rows): the grid covers each (row, unit) exactly once
    with no empty block; the cluster divides the hidden tiles; the threads
    are n * rows / rr with rr dividing the row tile; the shared memory (all
    of K: per 32-row stage the swizzled h box, four wh boxes at least 16
    bytes wide, one mbarrier) fits a block."""
    p = f32_plan(B, H)
    cover = np.zeros((B, H), np.int64)
    for x in range(p.grid[0]):
        for y in range(p.grid[1]):
            owned = cover[y * p.rows:(y + 1) * p.rows,
                          x * p.n:(x + 1) * p.n]
            assert owned.size
            owned += 1
    assert (cover == 1).all()
    assert p.grid[0] % p.cluster == 0 and p.cluster in (1, 2)
    assert p.rows % p.rr == 0
    assert p.threads == p.ks * p.n * p.rows // p.rr
    assert p.threads <= lstm_ops.F32_MAX_THREADS
    assert 1 <= p.ks <= min(16, -(-H // 32))
    stages = -(-H // 32)
    assert p.smem_bytes == 1024 + stages * (p.rows * 128
                                            + 4 * max(p.n, 4) * 128 + 8)
    assert p.smem_bytes <= MAX_SMEM
    assert p == f32_plan_for(p.n, p.rows, B, H)


def test_f32_plan_at_the_main_path_shapes():
    """The soak's (16, 128) runs 64 blocks of 4 units x 8 rows in
    clusters of 2 that share each h box by multicast; H = 512 takes the
    most units that keep 64 blocks (8, then 16 from B = 16) over 8-row
    tiles up to B = 32, 16 and 32 rows beyond; K groups fill the blocks
    to 512 threads, one stage a group where they can; a shape whose K
    does not fit a block, and an H that is not a multiple of 4, raise."""
    want = {(16, 128): (4, 8, (32, 2)), (1, 512): (8, 8, (64, 1)),
            (8, 512): (8, 8, (64, 1)), (16, 512): (16, 8, (32, 2)),
            (32, 512): (16, 8, (32, 4)), (64, 512): (16, 16, (32, 4)),
            (256, 512): (16, 32, (32, 8))}
    for (B, H), (n, rows, grid) in want.items():
        p = f32_plan(B, H)
        assert (p.n, p.rows, p.grid, p.cluster) == (n, rows, grid, 2)
    # the soak's four stages, one a group: a step waits on one stage
    assert f32_plan(16, 128).ks == 4
    # H = 512: 512 threads a block, K split over up to 16 groups
    assert [f32_plan(B, 512).ks for B in (1, 32, 64, 256)] == [16, 16, 8, 4]
    # 13 hidden tiles of 8 at H = 100: no cluster divides them
    assert f32_plan(7, 100).cluster == 2
    assert f32_plan_for(8, 8, 7, 100).cluster == 1
    with pytest.raises(ValueError, match="shared-memory"):
        f32_plan(1, 2600)
    with pytest.raises(ValueError, match="H % 4 == 0"):
        f32_plan(4, 18)
    with pytest.raises(ValueError, match="no f32 tile"):
        f32_plan_for(3, 8, 4, 16)


# the training path's batches at the flagship width: the actor fleet's
# lockstep batch (num_actors = 8) and evaluator batches of one episode per
# env (eval_episodes = 5 by default, 4 in chip_smoke.py), which need not be
# serving buckets
@pytest.mark.parametrize("B", [3, 4, 5, 8, 10])
def test_training_path_batches_pass_the_checks_and_plan(monkeypatch, B):
    calls = []
    monkeypatch.setattr(lstm_ops, "_launch_wgmma",
                        lambda *a: calls.append(a[4]))
    H = 512
    rng = np.random.default_rng(B)
    xp = torch.from_numpy(rng.normal(size=(1, B, 4 * H)).astype(np.float32))
    # the layer's wh as the network passes it: the f32 param cast per act
    wh = torch.from_numpy(rng.normal(size=(H, 4 * H)).astype(np.float32)
                          ).to(torch.bfloat16).contiguous()
    h0 = torch.zeros(B, H)
    lstm_unroll_cuda(xp, wh, h0, h0.clone())
    assert calls == [launch_plan(B, H)]
    assert calls[0].grid == (64, 1) and calls[0].n == 8
    lstm_ops._check_tma(wh)


@pytest.mark.parametrize("dtype,route,launcher", [
    (torch.bfloat16, "tensor_core", "_launch_wgmma"),
    (torch.float32, "cuda_core", "_lstm_unroll_cudacore"),
])
def test_dtype_picks_the_route(monkeypatch, dtype, route, launcher):
    """bf16 wh goes to the tensor-core kernel with launch_plan's tiles,
    f32 to the CUDA-core kernel; the launchers are replaced by recorders
    so the dispatch runs without a card."""
    calls = []
    monkeypatch.setattr(lstm_ops, "_launch_wgmma",
                        lambda *a: calls.append(("_launch_wgmma", a[4])))
    monkeypatch.setattr(lstm_ops, "_lstm_unroll_cudacore",
                        lambda *a: calls.append(("_lstm_unroll_cudacore",
                                                 None)))
    xp, wh, h0, c0 = (torch.from_numpy(a) for a in _inputs(1))
    lstm_unroll_cuda(xp, wh.to(dtype), h0, c0)
    want_plan = launch_plan(B, H) if route == "tensor_core" else None
    assert calls == [(launcher, want_plan)]


def _bf16_wh(bad):
    H = 15 if bad == "odd_hidden" else 16
    if bad == "misaligned":   # one bf16 past a 16-byte boundary
        return torch.zeros(H * 4 * H + 1, dtype=torch.bfloat16)[1:].view(
            H, 4 * H)
    if bad == "non_contiguous":
        return torch.zeros(4 * H, H, dtype=torch.bfloat16).t()
    return torch.zeros(H, 4 * H, dtype=torch.bfloat16)



@pytest.mark.parametrize("bad,match", [
    ("misaligned", "16-byte aligned"),
    ("non_contiguous", "contiguous"),
    ("odd_hidden", "multiple of 16"),
])
def test_wrapper_rejects_bad_wh_before_any_build(monkeypatch, bad, match):
    """What TMA cannot read is refused before the library is built or a
    device is asked for."""
    def no_build():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(lstm_ops, "_library", no_build)
    wh = _bf16_wh(bad)
    H = wh.shape[0]
    rng = np.random.default_rng(0)
    xp = torch.from_numpy(rng.normal(size=(1, 2, 4 * H)).astype(np.float32))
    h0 = torch.zeros(2, H)
    with pytest.raises(ValueError, match=match):
        lstm_unroll_cuda(xp, wh, h0, h0.clone())
