"""The arithmetic of every matrix product and convolution in the reference.

``"f32"``: float32 throughout, with TF32 switched off (:func:`strict_f32`)
so that a card's float32 product is not silently rounded to 10 bits.

``"fp8"``: the control.  Both operands of every product are rounded to
float8 e4m3 under a per-tensor scale (the tensor's largest magnitude maps
to e4m3's largest finite value, 448), then multiplied in float32.  The
rounding is a straight-through estimate: the backward pass sees the
rounded operands and passes the gradient through the rounding unchanged.
Everything between the products (biases, gates, the loss) stays float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

PRECISIONS = ("f32", "fp8")
_E4M3_MAX = 448.0


def strict_f32() -> None:
    """Float32 products in float32, not TF32, on a card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, as float32;
    the gradient passes through."""
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / _E4M3_MAX, torch.ones_like(amax))
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


class Ops:
    """``matmul``, ``linear`` and ``conv2d`` in one precision."""

    def __init__(self, precision: str = "f32"):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def _r(self, x: torch.Tensor) -> torch.Tensor:
        return round_fp8(x) if self.precision == "fp8" else x

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._r(a) @ self._r(b)

    def linear(self, x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
        """``x @ w.T + b`` (``w`` laid out (out, in))."""
        return self._r(x) @ self._r(w).t() + b

    def conv2d(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               stride: int, padding: int) -> torch.Tensor:
        return F.conv2d(self._r(x), self._r(w), b, stride=stride,
                        padding=padding)
