"""Fused LSTM **inference** unroll: the hand-written CUDA kernel and its
plain PyTorch version.

Port of ``r2d2_tpu/ops/lstm.py`` (the Pallas ``_fwd_infer_kernel``).  The
kernel source is ``r2d2_tpu_torch/csrc/lstm_infer.cu``; its header says
what bounds it on the H100 and how it is laid out.

Shapes (time-major, as the Pallas call takes them):

- ``xp``: (T, B, 4H) float32 — hoisted input projection ``x @ wi + b``,
- ``wh``: (H, 4H) in ``compute_dtype`` (bfloat16 or float32),
- ``h0``/``c0``: (B, H) float32,
- returns ``hs`` (T, B, H) float32 and the finals ``h_T``, ``c_T``.

Numerics are the Pallas kernel's: ``h`` is rounded to ``compute_dtype``
before the recurrent product, the product accumulates in float32 and is
NOT rounded to ``compute_dtype`` (the scan in ``models/network.py`` does
round it), gate order i, f, g, o, and h/c stay float32.

Dispatch: :func:`lstm_unroll_infer` launches the CUDA kernel for tensors
on a CUDA device and runs :func:`lstm_unroll_reference` for tensors on the
CPU.  A CUDA input that the kernel cannot take raises; nothing falls back
to the plain version.  The unroll is not differentiable (the reference
retired its backward kernel): ``backward`` raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from r2d2_tpu_torch.utils.trace import KERNEL_LAUNCHES

Unroll = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

KERNEL = "lstm_infer"


def _check(xp: torch.Tensor, wh: torch.Tensor, h0: torch.Tensor,
           c0: torch.Tensor) -> None:
    if xp.dim() != 3 or xp.shape[0] < 1 or xp.shape[1] < 1:
        raise ValueError(f"xp must be (T>=1, B>=1, 4H), got {tuple(xp.shape)}")
    T, B, H4 = xp.shape
    if H4 % 4:
        raise ValueError(f"xp's last dim {H4} is not 4H")
    H = H4 // 4
    if tuple(wh.shape) != (H, H4):
        raise ValueError(f"wh must be {(H, H4)}, got {tuple(wh.shape)}")
    for name, t in (("h0", h0), ("c0", c0)):
        if tuple(t.shape) != (B, H):
            raise ValueError(f"{name} must be {(B, H)}, got {tuple(t.shape)}")
    if xp.dtype != torch.float32:
        raise TypeError(f"xp must be float32, got {xp.dtype}")
    if wh.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"wh must be float32 or bfloat16, got {wh.dtype}")


def lstm_unroll_reference(xp: torch.Tensor, wh: torch.Tensor,
                          h0: torch.Tensor, c0: torch.Tensor,
                          compute_dtype: torch.dtype = torch.bfloat16
                          ) -> Unroll:
    """Plain PyTorch loop with the kernel's semantics.  The recurrent
    product is an f32 matmul of operands already rounded to
    ``compute_dtype`` — exact products, f32 sums, no output rounding.  On a
    CUDA device the caller turns TF32 off for it to mean f32."""
    _check(xp, wh, h0, c0)
    H = h0.shape[1]
    w = wh.to(compute_dtype).float()
    h, c = h0.float(), c0.float()
    hs = []
    for t in range(xp.shape[0]):
        gates = xp[t] + h.to(compute_dtype).float() @ w
        i, f, g, o = gates.split(H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs), h, c


_lib = None


def _library() -> ctypes.CDLL:
    """The kernel's library, built on first use and bound once."""
    global _lib
    if _lib is None:
        from r2d2_tpu_torch.ops._build import library

        _lib = _bind(library(KERNEL))
    return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p = ctypes.c_void_p
    lib.lstm_infer_forward.argtypes = [p, p, ctypes.c_int, p, p, p,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, p]
    lib.lstm_infer_forward.restype = ctypes.c_int
    lib.lstm_infer_max_hidden.argtypes = []
    lib.lstm_infer_max_hidden.restype = ctypes.c_int
    lib.lstm_infer_error_string.argtypes = [ctypes.c_int]
    lib.lstm_infer_error_string.restype = ctypes.c_char_p
    lib.max_hidden = lib.lstm_infer_max_hidden()
    return lib


def lstm_unroll_cuda(xp: torch.Tensor, wh: torch.Tensor, h0: torch.Tensor,
                     c0: torch.Tensor) -> Unroll:
    """Launch the CUDA kernel (``wh``'s dtype is the compute dtype).  All
    inputs must be contiguous on one CUDA device; anything else raises.
    Ticks ``KERNEL_LAUNCHES["lstm_infer"]`` once per call (one call runs
    T step launches)."""
    _check(xp, wh, h0, c0)
    dev = xp.device
    for name, t in (("xp", xp), ("wh", wh), ("h0", h0), ("c0", c0)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel needs "
                             f"every input on one CUDA device ({dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if h0.dtype != torch.float32 or c0.dtype != torch.float32:
        raise TypeError("h0 and c0 must be float32")
    T, B, H4 = xp.shape
    H = H4 // 4
    lib = _library()
    if H > lib.max_hidden:
        raise ValueError(f"hidden size {H} exceeds the kernel's shared-"
                         f"memory tile ({lib.max_hidden})")
    hs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    c = torch.empty((B, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        c.copy_(c0)   # c_T is updated in place from c0
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lstm_infer_forward(
            xp.data_ptr(), wh.data_ptr(), int(wh.dtype == torch.bfloat16),
            h0.data_ptr(), c.data_ptr(), hs.data_ptr(), T, B, H, stream)
    if err:
        raise RuntimeError("lstm_infer launch failed: "
                           + lib.lstm_infer_error_string(err).decode())
    KERNEL_LAUNCHES.count(KERNEL)
    return hs, hs[-1], c


class _FusedInfer(torch.autograd.Function):
    """The inference unroll as an autograd node whose backward raises: a
    grad path must use the scan recurrence (``LSTMLayer`` impl "scan")."""

    @staticmethod
    def forward(ctx, xp, wh, h0, c0, compute_dtype):
        if xp.device.type == "cuda":
            hs, _, c = lstm_unroll_cuda(xp, wh, h0, c0)
        elif xp.device.type == "cpu":
            hs, _, c = lstm_unroll_reference(xp, wh, h0, c0, compute_dtype)
        else:
            raise ValueError(f"no lstm_infer path for device {xp.device}")
        return hs, c

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            "the fused LSTM inference unroll is not differentiable; build "
            "the network with lstm_impl='scan' for any gradient path")


def lstm_unroll_infer(xp: torch.Tensor, wh: torch.Tensor, h0: torch.Tensor,
                      c0: torch.Tensor,
                      compute_dtype: torch.dtype = torch.bfloat16) -> Unroll:
    """Fused inference unroll: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (module docstring)."""
    hs, c = _FusedInfer.apply(xp.float().contiguous(),
                              wh.to(compute_dtype).contiguous(),
                              h0.float().contiguous(),
                              c0.float().contiguous(), compute_dtype)
    return hs, hs[-1], c
