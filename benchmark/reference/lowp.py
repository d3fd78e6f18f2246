"""The lower-precision control of the training cell: the reference with
every convolution's operands rounded to 8-bit floats, the step below the
bfloat16 the configuration computes in.  Inputs and weights take float8
e4m3 in the forward pass and the gradients float8 e5m2 in the backward
pass, each tensor scaled by its own maximum."""

from __future__ import annotations

import torch


def _round(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = torch.clamp(t.detach().abs().amax(), min=1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def fp8(t: torch.Tensor, role: str) -> torch.Tensor:
    return _Fp8.apply(t)
