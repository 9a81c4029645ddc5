"""Dueling CNN+LSTM Q-network in PyTorch.

Port of ``r2d2_tpu/models/network.py``: conv torso → LSTM over
[latent ⊕ one-hot last action ⊕ last reward] → dueling head, with a
single-step ``act`` and a sequence ``unroll``.  The public layouts are the
JAX package's, so tests compare like with like:

- observations arrive NHWC uint8 ``(B, T, H, W, C)`` (space-to-depth
  folded when ``cfg.obs_space_to_depth``); the torso permutes to NCHW for
  the convolutions and back to NHWC before the flatten, so the torso
  Dense sees the reference's feature order;
- the recurrent state is ``(B, 2, layers, H)`` float32, axis 1 = (h, c);
- parameters are float32 (``cfg.param_dtype``) and every layer casts
  them and its input to ``cfg.compute_dtype`` at use, with the reference's
  rounding points: a Dense/Conv output is rounded to the compute dtype
  and its bias added in it (flax's ``dtype=`` semantics), the latent is
  widened to float32 before the concat, the LSTM input projection is
  rounded to the compute dtype before ``+ b`` in float32, and the head
  runs in the compute dtype with ``q`` cast to float32.

``ImpalaTorso`` waits for a later slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.ops.lstm import lstm_unroll_infer, lstm_unroll_reference

LSTM_IMPLS = ("scan", "pallas", "reference")


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator]) -> None:
    """flax's default kernel init: truncated normal at ±2σ, rescaled so the
    variance is 1/fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


def _dense_layer(n_in: int, n_out: int,
                 generator: Optional[torch.Generator]) -> nn.Linear:
    layer = nn.Linear(n_in, n_out)
    with torch.no_grad():
        _lecun_normal_(layer.weight, n_in, generator)
        layer.bias.zero_()
    return layer


def _conv_layer(c_in: int, c_out: int, k: int, stride: int,
                generator: Optional[torch.Generator]) -> nn.Conv2d:
    layer = nn.Conv2d(c_in, c_out, k, stride=stride)
    with torch.no_grad():
        _lecun_normal_(layer.weight, c_in * k * k, generator)
        layer.bias.zero_()
    return layer


def dense(x: torch.Tensor, layer: nn.Linear, cd: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=cd)``: the product rounded to ``cd``, then the
    bias added in ``cd``."""
    return F.linear(x.to(cd), layer.weight.to(cd)) + layer.bias.to(cd)


def conv(x: torch.Tensor, layer: nn.Conv2d, cd: torch.dtype) -> torch.Tensor:
    """flax ``Conv(dtype=cd, padding="VALID")`` on NCHW."""
    y = F.conv2d(x.to(cd), layer.weight.to(cd), stride=layer.stride)
    return y + layer.bias.to(cd)[:, None, None]


class NatureTorso(nn.Module):
    """Nature-DQN conv stack.  With ``s2d_input`` conv1 is the 2×2 stride-1
    conv over the (21, 21, 16) space-to-depth input (the same linear map as
    8×8 stride-4 on raw pixels); otherwise it is the raw 8×8/4 conv."""

    def __init__(self, obs_shape: Tuple[int, int, int], out_dim: int,
                 compute_dtype: torch.dtype, s2d_input: bool,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h, w, c = obs_shape
        k1, s1 = (2, 1) if s2d_input else (8, 4)
        self.compute_dtype = compute_dtype
        self.conv1 = _conv_layer(c, 32, k1, s1, generator)
        self.conv2 = _conv_layer(32, 64, 4, 2, generator)
        self.conv3 = _conv_layer(64, 64, 3, 1, generator)
        for k, s in ((k1, s1), (4, 2), (3, 1)):
            h, w = (h - k) // s + 1, (w - k) // s + 1
        if h < 1 or w < 1:
            raise ValueError(f"obs shape {obs_shape} is too small for the "
                             "nature torso")
        self.dense = _dense_layer(h * w * 64, out_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (N, H, W, C) in [0, 1], compute dtype
        cd = self.compute_dtype
        x = x.permute(0, 3, 1, 2)
        x = F.relu(conv(x, self.conv1, cd))
        x = F.relu(conv(x, self.conv2, cd))
        x = F.relu(conv(x, self.conv3, cd))
        # flatten in NHWC order, as the reference's Dense rows expect
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return F.relu(dense(x, self.dense, cd))


class MlpTorso(nn.Module):
    """Small flatten+dense torso for tests and non-image observations."""

    def __init__(self, obs_shape: Tuple[int, ...], out_dim: int,
                 compute_dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n_in = 1
        for d in obs_shape:
            n_in *= d
        self.compute_dtype = compute_dtype
        self.dense = _dense_layer(n_in, out_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        return F.relu(dense(x, self.dense, self.compute_dtype))


class LSTMLayer(nn.Module):
    """One LSTM layer unrolled over time: ``wi`` (F, 4H), ``wh`` (H, 4H) and
    ONE bias ``b`` (4H,), gate order (i, f, g, o), forget bias 1.  The
    input projection for all T steps is one matmul; only the recurrent
    product is sequential.

    ``impl`` picks the recurrence:

    - ``"scan"``: a differentiable loop that rounds the recurrent product
      to the compute dtype (the reference's ``jax.lax.scan``);
    - ``"pallas"``: the fused inference unroll (``ops/lstm.py``) — the CUDA
      kernel on a CUDA device, its plain version on the CPU; no gradient;
    - ``"reference"``: that plain version on any device, used to hold the
      kernel's path against the plain one on the card.
    """

    def __init__(self, in_dim: int, hidden_dim: int,
                 compute_dtype: torch.dtype, impl: str,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if impl not in LSTM_IMPLS:
            raise ValueError(f"unknown LSTM impl {impl!r}")
        H = hidden_dim
        self.hidden_dim = H
        self.compute_dtype = compute_dtype
        self.impl = impl
        self.wi = nn.Parameter(torch.empty(in_dim, 4 * H))
        self.wh = nn.Parameter(torch.empty(H, 4 * H))
        self.b = nn.Parameter(torch.zeros(4 * H))
        with torch.no_grad():
            nn.init.xavier_uniform_(self.wi, generator=generator)
            nn.init.orthogonal_(self.wh, generator=generator)
            self.b[H:2 * H] = 1.0   # forget-gate bias

    def _scan(self, xp: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        cd = self.compute_dtype
        H = self.hidden_dim
        wh = self.wh.to(cd)
        hs = []
        for t in range(xp.shape[0]):
            gates = xp[t] + (h.to(cd) @ wh).float()
            i, f, g, o = gates.split(H, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        return torch.stack(hs), h, c

    def forward(self, xs: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor):
        # xs: (B, T, F); h0, c0: (B, H) → hs (B, T, H), (h_T, c_T)
        cd = self.compute_dtype
        x_proj = (xs.to(cd) @ self.wi.to(cd)).float() + self.b
        xp = x_proj.transpose(0, 1).contiguous()
        h0, c0 = h0.float(), c0.float()
        if self.impl == "pallas":
            hs, h, c = lstm_unroll_infer(xp, self.wh, h0, c0, cd)
        elif self.impl == "reference":
            hs, h, c = lstm_unroll_reference(xp, self.wh, h0, c0, cd)
        else:
            hs, h, c = self._scan(xp, h0, c0)
        return hs.transpose(0, 1), (h, c)


class DuelingHead(nn.Module):
    """q = V + A - mean(A), computed in the compute dtype, cast to f32."""

    def __init__(self, hidden_dim: int, action_dim: int,
                 compute_dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.adv_hidden = _dense_layer(hidden_dim, hidden_dim, generator)
        self.adv_out = _dense_layer(hidden_dim, action_dim, generator)
        self.val_hidden = _dense_layer(hidden_dim, hidden_dim, generator)
        self.val_out = _dense_layer(hidden_dim, 1, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        adv = dense(F.relu(dense(x, self.adv_hidden, cd)), self.adv_out, cd)
        val = dense(F.relu(dense(x, self.val_hidden, cd)), self.val_out, cd)
        q = val + adv - adv.mean(dim=-1, keepdim=True)
        return q.float()


def resolve_lstm_impl(cfg: Config, device: torch.device) -> str:
    """``auto`` → the fused inference kernel on a CUDA device, the scan
    elsewhere.  Like the reference, the resolved impl governs no-grad
    unrolls only; every impl declares the same parameters."""
    if cfg.lstm_impl != "auto":
        return cfg.lstm_impl
    return "pallas" if torch.device(device).type == "cuda" else "scan"


class R2D2Network(nn.Module):
    """The full Q-network.  ``forward`` is :meth:`act` (or :meth:`unroll`
    with ``method="unroll"``), so ``torch.func.functional_call`` can run it
    over published params.

    - ``unroll``: (obs (B,T,*obs) uint8, last_action (B,T,A), last_reward
      (B,T), hidden (B,2,layers,H)) → (q (B,T,A) f32, new hidden).
    - ``act``: the T=1 unroll for batched single-step inference.

    ``lstm_impl`` overrides the impl resolved from ``cfg`` (``"reference"``
    is only reachable this way).  Parameters are drawn from ``generator``
    on the CPU, then moved to ``device``.
    """

    def __init__(self, cfg: Config, action_dim: int,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 lstm_impl: Optional[str] = None):
        super().__init__()
        if cfg.torso not in ("nature", "mlp"):
            raise ValueError(f"torso {cfg.torso!r} is not ported yet "
                             "(nature and mlp are)")
        self.cfg = cfg
        self.action_dim = action_dim
        cd = _dtype(cfg.compute_dtype)
        if _dtype(cfg.param_dtype) != torch.float32:
            raise ValueError("the port keeps params in float32")
        self.compute_dtype = cd
        obs_shape = tuple(cfg.stored_obs_shape)
        H = cfg.hidden_dim
        if cfg.torso == "nature":
            self.torso = NatureTorso(obs_shape, H, cd, cfg.obs_space_to_depth,
                                     generator)
        else:
            self.torso = MlpTorso(obs_shape, H, cd, generator)
        impl = lstm_impl or resolve_lstm_impl(cfg, device)
        self.lstm_layers = nn.ModuleList(
            [LSTMLayer(H + action_dim + 1 if i == 0 else H, H, cd, impl,
                       generator) for i in range(cfg.lstm_layers)])
        self.head = DuelingHead(H, action_dim, cd, generator)
        self.to(device)

    def _features(self, obs, last_action, last_reward):
        B, T = obs.shape[:2]
        cd = self.compute_dtype
        x = obs.reshape(B * T, *obs.shape[2:]).to(cd) / 255.0
        latent = self.torso(x).reshape(B, T, -1)
        return torch.cat([latent.float(), last_action.float(),
                          last_reward[..., None].float()], dim=-1)

    def _lstm_stack(self, xs, hidden):
        new_h, new_c = [], []
        for i, layer in enumerate(self.lstm_layers):
            xs, (h, c) = layer(xs, hidden[:, 0, i], hidden[:, 1, i])
            new_h.append(h)
            new_c.append(c)
        new_hidden = torch.stack([torch.stack(new_h, 1),
                                  torch.stack(new_c, 1)], 1)
        return xs, new_hidden

    def unroll(self, obs, last_action, last_reward, hidden):
        feats = self._features(obs, last_action, last_reward)
        outs, new_hidden = self._lstm_stack(feats, hidden)
        B, T = outs.shape[:2]
        q = self.head(outs.reshape(B * T, -1)).reshape(B, T, -1)
        return q, new_hidden

    def act(self, obs, last_action, last_reward, hidden):
        q, new_hidden = self.unroll(obs[:, None], last_action[:, None],
                                    last_reward[:, None], hidden)
        return q[:, 0], new_hidden

    def forward(self, obs, last_action, last_reward, hidden,
                method: str = "act"):
        """``method`` picks :meth:`act` or :meth:`unroll` (flax's
        ``apply(..., method=)``), so ``functional_call`` reaches both."""
        if method == "unroll":
            return self.unroll(obs, last_action, last_reward, hidden)
        if method != "act":
            raise ValueError(f"unknown method {method!r}")
        return self.act(obs, last_action, last_reward, hidden)


def create_network(cfg: Config, action_dim: int, device="cuda",
                   generator: Optional[torch.Generator] = None,
                   lstm_impl: Optional[str] = None) -> R2D2Network:
    return R2D2Network(cfg, action_dim, device=device, generator=generator,
                       lstm_impl=lstm_impl)


def zero_hidden(cfg: Config, batch: int, device="cuda") -> torch.Tensor:
    return torch.zeros((batch, 2, cfg.lstm_layers, cfg.hidden_dim),
                       dtype=torch.float32, device=device)
