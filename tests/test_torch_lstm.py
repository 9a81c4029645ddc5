"""The port's fused LSTM inference unroll (r2d2_tpu_torch/ops/lstm.py)
against the JAX package's Pallas kernel run in interpret mode on the CPU.

Same inputs, made with numpy from a seed, go through
``r2d2_tpu.ops.lstm.lstm_unroll_pallas(..., interpret=True)`` and the
port's ``lstm_unroll_reference`` / ``lstm_unroll_infer`` (which on CPU
tensors is the reference).  Tolerances: float32 1e-6 (same arithmetic,
another summation order); bfloat16 1e-3 (operands rounded identically —
both sides round h to bf16 and multiply exactly in f32 — so only the
summation order differs, amplified by nothing larger than the gates).

The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py
and ``chip_smoke.py`` hold it against the plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.ops.lstm import lstm_unroll_pallas
from r2d2_tpu_torch.ops.lstm import (
    lstm_unroll_cuda,
    lstm_unroll_infer,
    lstm_unroll_reference,
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

