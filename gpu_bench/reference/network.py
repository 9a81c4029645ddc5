"""The R2D2 Q-network, written out plainly: a conv torso over each frame,
LSTM layers over [latent, one-hot last action, last reward], and a dueling
head (Kapturowski et al., ICLR 2019; the IMPALA deep torso of Espeholt et
al., 2018, Fig. 3).

``arch`` is a plain dict of sizes: ``torso`` ("nature", "impala" or
"mlp"), ``obs`` (the stored frame, (H, W, C) uint8), ``s2d`` (the nature
torso's first layer is the 2x2/1 conv over frames folded 4x4 into
channels, the same linear map as 8x8/4 over raw pixels), ``hidden``,
``layers`` and ``actions``.  Parameters are a dict by the names of the
port's ``state_dict`` (its public layout): dense kernels (out, in), conv
kernels (out, in, kh, kw), LSTM ``wi`` (in, 4H), ``wh`` (H, 4H) and one
bias ``b`` (4H,) in gate order (i, f, g, o).

Departures from the published networks, all shared with the port: the
IMPALA torso's 3x3 stride-2 max-pool pads as TensorFlow's SAME does (the
odd pad on the high side).  Everything runs in the precision of ``ops``
(``precision.py``)."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from gpu_bench.reference.precision import Ops

Params = Dict[str, torch.Tensor]
IMPALA_CHANNELS = (16, 32, 32)
IMPALA_BLOCKS = 2


def _nature_convs(arch: dict) -> List[Tuple[int, int, int]]:
    """(channels out, kernel, stride) of the three nature convs."""
    first = (32, 2, 1) if arch["s2d"] else (32, 8, 4)
    return [first, (64, 4, 2), (64, 3, 1)]


def param_spec(arch: dict) -> List[Tuple[str, tuple, int, str]]:
    """(name, shape, fan_in, kind) of every parameter, in the port's
    order; ``kind`` is "kernel", "bias" or "lstm_bias"."""
    h, w, c = arch["obs"]
    H, A = arch["hidden"], arch["actions"]
    spec = []

    def dense(name, n_in, n_out):
        spec.append((f"{name}.weight", (n_out, n_in), n_in, "kernel"))
        spec.append((f"{name}.bias", (n_out,), n_in, "bias"))

    def conv(name, c_in, c_out, k):
        spec.append((f"{name}.weight", (c_out, c_in, k, k), c_in * k * k,
                     "kernel"))
        spec.append((f"{name}.bias", (c_out,), c_in * k * k, "bias"))

    if arch["torso"] == "nature":
        for i, (co, k, s) in enumerate(_nature_convs(arch)):
            conv(f"torso.conv{i + 1}", c, co, k)
            h, w, c = (h - k) // s + 1, (w - k) // s + 1, co
        dense("torso.dense", h * w * c, H)
    elif arch["torso"] == "impala":
        i = 0
        for ch in IMPALA_CHANNELS:
            for j in range(1 + 2 * IMPALA_BLOCKS):
                conv(f"torso.convs.{i}", c if j == 0 else ch, ch, 3)
                i += 1
            h, w, c = -(-h // 2), -(-w // 2), ch
        dense("torso.dense", h * w * c, H)
    elif arch["torso"] == "mlp":
        dense("torso.dense", h * w * c, H)
    else:
        raise ValueError(f"unknown torso {arch['torso']!r}")
    for i in range(arch["layers"]):
        n_in = H + A + 1 if i == 0 else H
        spec.append((f"lstm_layers.{i}.wi", (n_in, 4 * H), n_in, "kernel"))
        spec.append((f"lstm_layers.{i}.wh", (H, 4 * H), H, "kernel"))
        spec.append((f"lstm_layers.{i}.b", (4 * H,), H, "lstm_bias"))
    dense("head.adv_hidden", H, H)
    dense("head.adv_out", H, A)
    dense("head.val_hidden", H, H)
    dense("head.val_out", H, 1)
    return spec


def _pool_pads(n: int, k: int = 3, s: int = 2) -> Tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _max_pool_same(x: torch.Tensor) -> torch.Tensor:
    top, bottom = _pool_pads(x.shape[2])
    left, right = _pool_pads(x.shape[3])
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, 3, stride=2)


def torso(p: Params, arch: dict, frames: torch.Tensor, ops: Ops
          ) -> torch.Tensor:
    """(N, H, W, C) uint8 frames -> (N, hidden) latents."""
    x = frames.float() / 255.0
    if arch["torso"] == "mlp":
        x = x.reshape(x.shape[0], -1)
        return F.relu(ops.linear(x, p["torso.dense.weight"],
                                 p["torso.dense.bias"]))
    x = x.permute(0, 3, 1, 2)
    if arch["torso"] == "nature":
        for i, (_, _, s) in enumerate(_nature_convs(arch)):
            name = f"torso.conv{i + 1}"
            x = F.relu(ops.conv2d(x, p[f"{name}.weight"], p[f"{name}.bias"],
                                  s, 0))
    else:
        i = 0

        def conv(x):
            nonlocal i
            y = ops.conv2d(x, p[f"torso.convs.{i}.weight"],
                           p[f"torso.convs.{i}.bias"], 1, 1)
            i += 1
            return y

        for _ in IMPALA_CHANNELS:
            x = _max_pool_same(conv(x))
            for _ in range(IMPALA_BLOCKS):
                x = x + conv(F.relu(conv(F.relu(x))))
        x = F.relu(x)
    # the dense layer reads the feature map in (H, W, C) order
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return F.relu(ops.linear(x, p["torso.dense.weight"],
                             p["torso.dense.bias"]))


def lstm(p: Params, i: int, xs: torch.Tensor, h: torch.Tensor,
         c: torch.Tensor, ops: Ops):
    """Layer ``i`` over (B, T, F): (hs (B, T, H), h_T, c_T)."""
    B, T = xs.shape[:2]
    H = h.shape[-1]
    xp = ops.matmul(xs.reshape(B * T, -1), p[f"lstm_layers.{i}.wi"]
                    ).reshape(B, T, 4 * H) + p[f"lstm_layers.{i}.b"]
    wh = p[f"lstm_layers.{i}.wh"]
    hs = []
    for t in range(T):
        gates = xp[:, t] + ops.matmul(h, wh)
        gi, gf, gg, go = gates.split(H, dim=-1)
        c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        h = torch.sigmoid(go) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, 1), h, c


def head(p: Params, x: torch.Tensor, ops: Ops) -> torch.Tensor:
    """Dueling: q = V + A - mean(A)."""
    def mlp(a, b):
        y = F.relu(ops.linear(x, p[f"head.{a}.weight"], p[f"head.{a}.bias"]))
        return ops.linear(y, p[f"head.{b}.weight"], p[f"head.{b}.bias"])

    adv = mlp("adv_hidden", "adv_out")
    val = mlp("val_hidden", "val_out")
    return val + adv - adv.mean(dim=-1, keepdim=True)


def unroll(p: Params, arch: dict, obs: torch.Tensor,
           last_action: torch.Tensor, last_reward: torch.Tensor,
           hidden: torch.Tensor, ops: Ops):
    """obs (B, T, H, W, C) uint8, last_action (B, T, A), last_reward (B, T),
    hidden (B, 2, layers, H) -> q (B, T, A), new hidden (B, 2, layers, H)."""
    B, T = obs.shape[:2]
    latent = torso(p, arch, obs.reshape(B * T, *obs.shape[2:]), ops)
    xs = torch.cat([latent.reshape(B, T, -1), last_action.float(),
                    last_reward.float()[..., None]], dim=-1)
    hn, cn = [], []
    for i in range(arch["layers"]):
        xs, h, c = lstm(p, i, xs, hidden[:, 0, i].float(),
                        hidden[:, 1, i].float(), ops)
        hn.append(h)
        cn.append(c)
    q = head(p, xs.reshape(B * T, -1), ops).reshape(B, T, -1)
    return q, torch.stack([torch.stack(hn, 1), torch.stack(cn, 1)], 1)


def act(p: Params, arch: dict, obs, last_action, last_reward, hidden,
        ops: Ops):
    """One step for a batch of lanes: obs (B, H, W, C) -> q (B, A), new
    hidden."""
    q, new_hidden = unroll(p, arch, obs[:, None], last_action[:, None],
                           last_reward[:, None], hidden, ops)
    return q[:, 0], new_hidden
