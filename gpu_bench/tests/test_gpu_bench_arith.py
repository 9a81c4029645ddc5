"""The benchmark's own operation counts (``arith/r2d2.py``) against
``torch.utils.flop_counter``'s count of the matrix products and
convolutions the reference runs, at small sizes on the CPU."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import tiny  # noqa: F401
from gpu_bench.arith import r2d2
from gpu_bench.reference import network
from gpu_bench.reference.precision import Ops
from gpu_bench.weights import make_weights

ARCHS = {
    "nature_s2d": dict(torso="nature", obs=(21, 21, 16), s2d=True),
    "nature_raw": dict(torso="nature", obs=(84, 84, 1), s2d=False),
    "impala": dict(torso="impala", obs=(84, 84, 1), s2d=False),
    "impala_odd": dict(torso="impala", obs=(13, 11, 1), s2d=False),
    "mlp": dict(torso="mlp", obs=(12, 12, 1), s2d=False),
}


def _arch(kind, layers=1, hidden=24):
    return dict(ARCHS[kind], hidden=hidden, layers=layers, actions=4)


def _count(fn) -> int:
    with FlopCounterMode(display=False) as m:
        fn()
    return m.get_total_flops()


@pytest.mark.parametrize("kind", sorted(ARCHS))
@pytest.mark.parametrize("layers", [1, 2])
def test_forward_count_matches_the_flop_counter(kind, layers):
    arch = _arch(kind, layers)
    w = make_weights(arch, 7, "cpu")
    B, T = 2, 3
    obs = torch.randint(0, 256, (B, T, *arch["obs"]), dtype=torch.uint8)
    la = torch.zeros(B, T, 4)
    lr = torch.zeros(B, T)
    hidden = torch.zeros(B, 2, layers, arch["hidden"])
    with torch.no_grad():
        got = _count(lambda: network.unroll(w, arch, obs, la, lr, hidden,
                                            Ops("f32")))
    assert got == B * T * r2d2.frame_flops(arch)


def test_update_counts_forward_twice_and_backward_over_learning():
    arch = _arch("nature_s2d", hidden=512)
    f = r2d2.frame_flops(arch)
    assert r2d2.update_flops(arch, 64, 85, 40) == 2 * 64 * 85 * f \
        + 2 * 64 * 40 * f
    # the Nature-DQN/LSTM-512 update is about 0.3 TFLOP
    assert 0.25e12 < r2d2.update_flops(arch, 64, 85, 40) < 0.35e12


def test_lstm_kernel_is_bound_by_its_recurrent_kernel_bytes():
    arch = _arch("nature_s2d", hidden=512)
    ops, nbytes = r2d2.lstm_step_kernel(arch, lanes=8)
    assert ops == 2 * 8 * 512 * 2048
    # the bf16 (512, 2048) kernel is 2 MiB of the launch's bytes
    assert 2 * 512 * 2048 < nbytes < 2 * 512 * 2048 + 300_000
