"""The benchmark's weights: drawn on the device from the run's seed, in one
call to a ``torch.Generator`` on the card, then cut into the parameters
of ``reference.network.param_spec``.  Both sides get them: the port's
network is loaded with a copy, and the reference starts from these.

Kernels are normal with variance 1/fan_in (LeCun), biases zero but the
LSTM forget gate's, which is 1 (the port's own initialisation draws the
same laws; the numbers are the benchmark's)."""
from __future__ import annotations

from typing import Dict

import torch

from gpu_bench.reference.network import param_spec

# a seed may be any whole number: the generator takes 64 bits
_SEED_MASK = (1 << 63) - 1


def make_weights(arch: dict, seed: int, device, dtype=torch.float32
                 ) -> Dict[str, torch.Tensor]:
    spec = param_spec(arch)
    n = sum(_numel(shape) for _, shape, _, kind in spec if kind == "kernel")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & _SEED_MASK)
    flat = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, fan_in, kind in spec:
        if kind == "kernel":
            k = _numel(shape)
            out[name] = (flat[off:off + k].reshape(shape)
                         * fan_in ** -0.5).to(dtype)
            off += k
        else:
            b = torch.zeros(shape, device=device, dtype=dtype)
            if kind == "lstm_bias":
                H = shape[0] // 4
                b[H:2 * H] = 1.0
            out[name] = b
    return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n
