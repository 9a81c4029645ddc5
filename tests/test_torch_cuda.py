"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions on the same device.  Every test is marked ``cuda`` and
skips without a CUDA device.  This file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerances (as in chip_smoke.py): 1e-5 max-abs in float32 with TF32 off,
1e-4 in bfloat16 — both sides round the operands at the same points, only
the order of the f32 sums differs.
"""
import numpy as np
import pytest
import torch

from r2d2_tpu_torch.ops.lstm import lstm_unroll_cuda, lstm_unroll_reference
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
                                   (5, 7, 100)])
def test_kernel_matches_reference(cuda, T, B, H, dtype):
    xp, wh, h0, c0 = _inputs(T, B, H, seed=T * B + H, device=cuda)
    before = KERNEL_LAUNCHES.get("lstm_infer")
    got = lstm_unroll_cuda(xp, wh.to(dtype), h0, c0)
    want = lstm_unroll_reference(xp, wh, h0, c0, dtype)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES.get("lstm_infer") == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g - w).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda):
    xp, wh, h0, c0 = _inputs(2, 3, 16, seed=0, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_unroll_cuda(xp, wh.t().contiguous().t(), h0, c0)
    with pytest.raises(ValueError, match="CUDA device"):
        lstm_unroll_cuda(xp, wh, h0.cpu(), c0)
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
