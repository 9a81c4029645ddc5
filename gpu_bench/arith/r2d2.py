"""Operations and bytes of the R2D2 network, from its sizes alone (the
reference's ``arch`` dict, ``reference/network.py``).  An operation is a
multiply or an add of a matrix product or a convolution: 2 per
multiply-accumulate.  Elementwise work (activations, gates, the loss) is
not counted, so every count here is a floor of what any implementation
does."""
from __future__ import annotations

from gpu_bench.reference.network import (
    IMPALA_BLOCKS,
    IMPALA_CHANNELS,
    _nature_convs,
)


def _conv(h, w, c_in, c_out, k, s, same: bool):
    if same:
        ho, wo = -(-h // s), -(-w // s)
    else:
        ho, wo = (h - k) // s + 1, (w - k) // s + 1
    return 2 * ho * wo * c_out * c_in * k * k, ho, wo


def torso_flops(arch: dict) -> int:
    """One frame through the torso, its dense layer included."""
    h, w, c = arch["obs"]
    H = arch["hidden"]
    total = 0
    if arch["torso"] == "nature":
        for co, k, s in _nature_convs(arch):
            f, h, w = _conv(h, w, c, co, k, s, same=False)
            total, c = total + f, co
    elif arch["torso"] == "impala":
        for ch in IMPALA_CHANNELS:
            f, _, _ = _conv(h, w, c, ch, 3, 1, same=True)
            total, c = total + f, ch
            h, w = -(-h // 2), -(-w // 2)
            f, _, _ = _conv(h, w, ch, ch, 3, 1, same=True)
            total += 2 * IMPALA_BLOCKS * f
    return total + 2 * h * w * c * H


def lstm_flops(arch: dict) -> int:
    """One step of every LSTM layer: input and recurrent products."""
    H, A = arch["hidden"], arch["actions"]
    total = 0
    for i in range(arch["layers"]):
        n_in = H + A + 1 if i == 0 else H
        total += 2 * (n_in + H) * 4 * H
    return total


def head_flops(arch: dict) -> int:
    H, A = arch["hidden"], arch["actions"]
    return 2 * (2 * H * H + H * A + H)


def frame_flops(arch: dict) -> int:
    """One frame's forward pass through the whole network."""
    return torso_flops(arch) + lstm_flops(arch) + head_flops(arch)


def update_flops(arch: dict, batch: int, seq_len: int, learning: int
                 ) -> int:
    """One learner update's model operations: the online and the target
    forward over every step of the sequence, and the backward (twice the
    forward) over the learning steps.  Recomputation (remat) is not
    counted."""
    f = frame_flops(arch)
    return 2 * batch * seq_len * f + 2 * batch * learning * f


def act_flops(arch: dict, lanes: int) -> int:
    """One act: a forward step for each lane."""
    return lanes * frame_flops(arch)


def lstm_step_kernel(arch: dict, lanes: int, steps: int = 1):
    """(operations, bytes) of one launch of the fused LSTM inference kernel
    over ``steps`` steps of one layer for ``lanes`` lanes: it reads the
    input projection (steps, lanes, 4H) float32, the recurrent kernel
    (H, 4H) bfloat16 and the state (lanes, H) float32 twice (h and c),
    and writes every step's h and the last c (float32); each once."""
    H = arch["hidden"]
    ops = 2 * steps * lanes * H * 4 * H
    read = 4 * steps * lanes * 4 * H + 2 * H * 4 * H + 2 * 4 * lanes * H
    written = 4 * steps * lanes * H + 4 * lanes * H
    return ops, read + written
