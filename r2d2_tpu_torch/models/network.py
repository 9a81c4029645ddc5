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
- parameters are kept in ``cfg.param_dtype`` (float32 by default, or
  bfloat16) and every layer casts them and its input to
  ``cfg.compute_dtype`` at use, with the reference's rounding points: a
  Dense/Conv output is rounded to the compute dtype and its bias added in
  it (flax's ``dtype=`` semantics), the latent is widened to float32
  before the concat, the LSTM input projection is rounded to the compute
  dtype before ``+ b`` in float32, and the head runs in the compute dtype
  with ``q`` cast to float32.

Three torsos: ``nature`` (raw or space-to-depth folded), ``impala`` (the
deep residual CNN of ``impala_deep_config``) and ``mlp``.  ``cfg.remat``
checkpoints each step of the training scan, as the reference's
``jax.checkpoint`` does: the same numbers for less saved activation.
"""
from __future__ import annotations

import sys
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

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
                generator: Optional[torch.Generator],
                padding: int = 0) -> nn.Conv2d:
    layer = nn.Conv2d(c_in, c_out, k, stride=stride, padding=padding)
    with torch.no_grad():
        _lecun_normal_(layer.weight, c_in * k * k, generator)
        layer.bias.zero_()
    return layer


def _dtensor_module(t: torch.Tensor):
    """``torch.distributed.tensor`` when ``t`` is a DTensor (the meshed
    learner, parallel/sharding.py), else None.  Without a mesh nothing is
    a DTensor and that module is never imported here."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod if mod is not None and isinstance(t, mod.DTensor) else None


def unshard(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` with tensor dim ``dim`` whole on every rank: a DTensor sharded
    along ``dim`` is gathered over the axes that split it, keeping its
    other placements; any other tensor comes back as it is."""
    mod = _dtensor_module(t)
    if mod is None:
        return t
    dim %= t.ndim
    pl = [mod.Replicate() if isinstance(p, mod.Shard) and p.dim == dim
          else p for p in t.placements]
    return t if pl == list(t.placements) else t.redistribute(placements=pl)


def dense(x: torch.Tensor, layer: nn.Linear, cd: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=cd)``: the product rounded to ``cd``, then the
    bias added in ``cd``."""
    return F.linear(x.to(cd), layer.weight.to(cd)) + layer.bias.to(cd)


def conv(x: torch.Tensor, layer: nn.Conv2d, cd: torch.dtype,
         weight: Optional[torch.Tensor] = None,
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """flax ``Conv(dtype=cd)`` on NCHW: ``padding="VALID"`` for a layer
    built without padding, ``"SAME"`` for a stride-1 3×3 layer built with
    padding 1 (flax pads that one symmetrically).  ``weight``/``bias``
    replace the layer's own (a :func:`conv_rows` region's)."""
    weight = layer.weight if weight is None else weight
    bias = layer.bias if bias is None else bias
    y = F.conv2d(x.to(cd), weight.to(cd), stride=layer.stride,
                 padding=layer.padding)
    return y + bias.to(cd)[:, None, None]


def conv_rows(x: torch.Tensor, layers):
    """``(x, [(weight, bias)], wrap)`` for a conv stack over ``x``.

    On the learner mesh (``x`` a DTensor whose rows are sharded over dp)
    the stack runs on plain tensors: DTensor's convolution handler is a
    spatial tensor-parallel conv (a halo exchange over width-sharded
    images), not a batch-sharded one.  So each rank takes its rows, each
    weight whole (gathered over fsdp; its gradient a sum over dp), and
    ``wrap`` makes the stack's output a dp-sharded DTensor again.
    Anything else passes through with the layers' own params."""
    mod = _dtensor_module(x)
    if mod is None:
        return x, [(layer.weight, layer.bias) for layer in layers], (
            lambda y: y)
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    rows = [mod.Shard(0) if n == "dp" else mod.Replicate() for n in names]
    whole = [mod.Replicate()] * len(names)
    summed = [mod.Partial() if n == "dp" else mod.Replicate()
              for n in names]

    def local(p):
        return p.redistribute(placements=whole).to_local(
            grad_placements=summed)

    params = [(local(layer.weight), local(layer.bias)) for layer in layers]
    return (x.redistribute(placements=rows).to_local(), params,
            lambda y: mod.DTensor.from_local(y, mesh, rows))


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
        layers = (self.conv1, self.conv2, self.conv3)
        x, params, wrap = conv_rows(x, layers)
        x = x.permute(0, 3, 1, 2)
        for layer, (w, b) in zip(layers, params):
            x = F.relu(conv(x, layer, cd, w, b))
        # flatten in NHWC order, as the reference's Dense rows expect
        x = wrap(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))
        return F.relu(dense(x, self.dense, cd))


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """(low, high) padding of a SAME window of ``k`` at stride ``s`` over
    ``n`` positions, by ``lax.padtype_to_pads``'s rule: the output has
    ceil(n / s) positions and the odd pad goes to the high side."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """flax ``max_pool(x, (k, k), strides=(s, s), padding="SAME")`` on
    NCHW: padded with -inf, asymmetrically where the reference pads so
    (84 → 42 pads (0, 1), 21 → 11 pads (1, 1))."""
    top, bottom = _same_pads(x.shape[2], k, s)
    left, right = _same_pads(x.shape[3], k, s)
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, k, stride=s)


class ImpalaTorso(nn.Module):
    """IMPALA deep residual CNN: per stage of ``channels``, a 3×3 SAME
    conv, a 3×3/2 SAME max-pool, then ``blocks_per_stage`` residual blocks
    of relu → conv → relu → conv plus the skip (added in the compute
    dtype); then relu, the NHWC flatten and a relu Dense.  ``convs`` holds
    the convolutions in the order flax creates them (``Conv_0`` …), so the
    converter maps them by index."""

    def __init__(self, obs_shape: Tuple[int, int, int], out_dim: int,
                 compute_dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None,
                 channels: Tuple[int, ...] = (16, 32, 32),
                 blocks_per_stage: int = 2):
        super().__init__()
        h, w, c = obs_shape
        self.compute_dtype = compute_dtype
        self.blocks_per_stage = blocks_per_stage
        convs = []
        for ch in channels:
            convs.append(_conv_layer(c, ch, 3, 1, generator, padding=1))
            convs += [_conv_layer(ch, ch, 3, 1, generator, padding=1)
                      for _ in range(2 * blocks_per_stage)]
            h, w, c = -(-h // 2), -(-w // 2), ch
        self.convs = nn.ModuleList(convs)
        self.dense = _dense_layer(h * w * c, out_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (N, H, W, C) in [0, 1], compute dtype
        cd = self.compute_dtype
        x, params, wrap = conv_rows(x, self.convs)
        x = x.permute(0, 3, 1, 2)
        convs = iter(zip(self.convs, params))

        def step(x):
            layer, (w, b) = next(convs)
            return conv(x, layer, cd, w, b)

        for _ in range(len(self.convs) // (1 + 2 * self.blocks_per_stage)):
            x = max_pool_same(step(x))
            for _ in range(self.blocks_per_stage):
                skip = x
                x = step(F.relu(x))
                x = step(F.relu(x))
                x = x + skip
        x = F.relu(x)
        x = wrap(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))
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

    ``remat`` runs each step of the scan under activation checkpointing
    when autograd records it: its intermediates are recomputed in the
    backward pass instead of kept (the reference's ``jax.checkpoint`` of
    the scan step).
    """

    def __init__(self, in_dim: int, hidden_dim: int,
                 compute_dtype: torch.dtype, impl: str,
                 generator: Optional[torch.Generator] = None,
                 remat: bool = False):
        super().__init__()
        if impl not in LSTM_IMPLS:
            raise ValueError(f"unknown LSTM impl {impl!r}")
        H = hidden_dim
        self.hidden_dim = H
        self.compute_dtype = compute_dtype
        self.impl = impl
        self.remat = remat
        self.wi = nn.Parameter(torch.empty(in_dim, 4 * H))
        self.wh = nn.Parameter(torch.empty(H, 4 * H))
        self.b = nn.Parameter(torch.zeros(4 * H))
        with torch.no_grad():
            nn.init.xavier_uniform_(self.wi, generator=generator)
            nn.init.orthogonal_(self.wh, generator=generator)
            self.b[H:2 * H] = 1.0   # forget-gate bias

    def _step(self, x_t: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              wh: torch.Tensor):
        gates = x_t + (h.to(self.compute_dtype) @ wh).float()
        # under tp each rank holds whole gates of the 4H columns; the cell
        # mixes all four, so gather the columns before the split
        i, f, g, o = unshard(gates, -1).split(self.hidden_dim, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    def _scan(self, xp: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        wh = self.wh.to(self.compute_dtype)
        remat = self.remat and torch.is_grad_enabled()
        hs = []
        for t in range(xp.shape[0]):
            if remat:
                h, c = checkpoint(self._step, xp[t], h, c, wh,
                                  use_reentrant=False)
            else:
                h, c = self._step(xp[t], h, c, wh)
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
    on the CPU in float32, then moved to ``device`` in ``cfg.param_dtype``.
    """

    def __init__(self, cfg: Config, action_dim: int,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 lstm_impl: Optional[str] = None):
        super().__init__()
        self.cfg = cfg
        self.action_dim = action_dim
        cd, pd = _dtype(cfg.compute_dtype), _dtype(cfg.param_dtype)
        self.compute_dtype = cd
        obs_shape = tuple(cfg.stored_obs_shape)
        H = cfg.hidden_dim
        if cfg.torso == "nature":
            self.torso = NatureTorso(obs_shape, H, cd, cfg.obs_space_to_depth,
                                     generator)
        elif cfg.torso == "impala":
            self.torso = ImpalaTorso(obs_shape, H, cd, generator)
        else:
            self.torso = MlpTorso(obs_shape, H, cd, generator)
        impl = lstm_impl or resolve_lstm_impl(cfg, device)
        self.lstm_layers = nn.ModuleList(
            [LSTMLayer(H + action_dim + 1 if i == 0 else H, H, cd, impl,
                       generator, remat=cfg.remat)
             for i in range(cfg.lstm_layers)])
        self.head = DuelingHead(H, action_dim, cd, generator)
        # drawn in float32, then kept in cfg.param_dtype (the reference
        # initialises in that dtype; every layer casts to the compute
        # dtype at use either way)
        self.to(device=device, dtype=pd)

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
