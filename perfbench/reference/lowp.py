"""The control's matrix product: both operands rounded to float8 e4m3
forward and the product's gradient to e5m2 backward, each tensor scaled by
its largest entry into the format's range first (the usual float8 recipe);
the product itself runs in float32."""
from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, fmt, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (x / scale).to(fmt).to(torch.float32) * scale


class _Fp8Mm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = _round(a, torch.float8_e4m3fn, E4M3_MAX), _round(b, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(a8, b8)
        return torch.matmul(a8, b8)

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = _round(g, torch.float8_e5m2, E5M2_MAX)
        ga = torch.matmul(g8, b8.transpose(-1, -2))
        gb = torch.matmul(a8.transpose(-1, -2), g8)
        return _sum_to(ga, a8.shape), _sum_to(gb, b8.shape)


def _sum_to(g: torch.Tensor, shape) -> torch.Tensor:
    """A broadcast operand's gradient summed back to its shape."""
    while g.ndim > len(shape):
        g = g.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if b.ndim == 2:  # a weight: one product over every row
        return _Fp8Mm.apply(a.reshape(-1, a.shape[-1]), b).reshape(*a.shape[:-1], b.shape[-1])
    return _Fp8Mm.apply(a, b)
