"""The fused epilogue of a convolution that an activation and an eval-mode
BatchNorm follow, and its plain version.

``conv_epilogue(z, bias, bn, act)`` takes the convolution's output without
its bias, ``z`` (N, C, H, W) channels-last, and writes in place

    act(z + bias) * a + b,  a = bn.weight * rsqrt(bn.running_var + bn.eps),
                            b = bn.bias - bn.running_mean * a,

which is ``bn(act(conv(x)))`` in eval mode.  Everything is float32, each
product and sum rounded on its own, and the result is rounded once to z's
type (bfloat16 or float32), where the module chain rounds after each of its
three passes.  ``act`` is one of ``ACTIVATIONS``: 'identity' (the upsampling
chain), or the four of ``models.blocks.make_act`` with its parameters
(leaky slope 0.01, ELU alpha 1, ``mish`` below).

A CUDA tensor goes through the kernel (``csrc/epilogue.cu``), one launch
counted as ``conv_epilogue``; a CPU tensor through the plain version.
``refusal`` names what the kernel does not take, and ``conv_epilogue``
raises on it; ``conv_epilogue_unchecked`` leaves the check to its caller.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from microbeseg_torch.kernels import _build

ACTIVATIONS = ("identity", "relu", "leakyrelu", "elu", "mish")
_MAX_WORDS = 256   # 16-byte words of a pixel: one block's threads hold them


def mish(x: torch.Tensor) -> torch.Tensor:
    """mish(x) = x * tanh(softplus(x)) with one exp, the JAX package's form:
    tanh(log(1 + u)) = u(u + 2) / (u(u + 2) + 2) with u = e^x, evaluated at
    min(x, 12) and replaced by 1 above 12, where mish(x) = x to machine
    precision.  Same arithmetic as the reference model, so f32 forwards
    agree to the convolutions' summation order."""
    u = torch.exp(torch.clamp(x, max=12.0))
    v = u * (u + 2.0)
    t = torch.where(x > 12.0, torch.ones_like(x), v / (v + 2.0))
    return x * t


_ACT_FNS = {"identity": lambda t: t, "relu": F.relu,
            "leakyrelu": lambda t: F.leaky_relu(t, 0.01), "elu": F.elu,
            "mish": mish}


def refusal(z: torch.Tensor, bias: Optional[torch.Tensor], bn: nn.Module,
            act: str) -> Optional[str]:
    """Why ``conv_epilogue`` does not take these arguments, or None."""
    if act not in ACTIVATIONS:
        return f"unknown activation {act!r}"
    if z.ndim != 4 or z.dtype not in (torch.bfloat16, torch.float32):
        return f"z must be (N, C, H, W) bfloat16 or float32, got " \
               f"{tuple(z.shape)} {z.dtype}"
    if not z.is_contiguous(memory_format=torch.channels_last):
        return "z must be channels-last and contiguous"
    C = z.shape[1]
    if C % 8 or C // (16 // z.element_size()) > _MAX_WORDS:
        return f"{C} channels: a multiple of 8 up to {_MAX_WORDS} words of " \
               "16 bytes"
    rows = z.numel() // C
    if not 0 < rows < 1 << 31 or z.data_ptr() % 16:
        return f"{rows} pixels at address {z.data_ptr()}: 1 to 2^31 - 1, " \
               "16-byte aligned"
    if not isinstance(bn, nn.BatchNorm2d) or bn.num_features != C \
            or bn.weight is None or bn.running_mean is None:
        return "bn must be an affine BatchNorm2d over z's channels with " \
               "running statistics"
    for t in (bias, bn.weight, bn.bias, bn.running_mean, bn.running_var):
        if t is None or t.shape != (C,) or t.dtype != torch.float32 \
                or t.device != z.device or not t.is_contiguous():
            return "bias and bn's parameters must be (C,) float32, " \
                   "contiguous, on z's device"
    return None


def conv_epilogue_plain(z: torch.Tensor, bias: torch.Tensor, bn: nn.Module,
                        act: str) -> torch.Tensor:
    """``conv_epilogue``'s arithmetic in plain PyTorch, into a new tensor."""
    a = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    b = bn.bias - bn.running_mean * a
    t = _ACT_FNS[act](z.float() + bias.view(1, -1, 1, 1))
    return (t * a.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)).to(z.dtype)


def conv_epilogue(z: torch.Tensor, bias: torch.Tensor, bn: nn.Module,
                  act: str) -> torch.Tensor:
    """``bn(act(z + bias))`` of an eval-mode BatchNorm, written into ``z``,
    which is returned.  CUDA tensors go through the kernel, CPU tensors
    through the plain version."""
    why = refusal(z, bias, bn, act)
    if why is not None:
        raise ValueError(f"conv_epilogue: {why}")
    return conv_epilogue_unchecked(z, bias, bn, act)


def conv_epilogue_unchecked(z: torch.Tensor, bias: torch.Tensor,
                            bn: nn.Module, act: str) -> torch.Tensor:
    """``conv_epilogue`` for a caller that has found no ``refusal`` of its
    arguments (the blocks' route, which checks each chain once)."""
    if z.device.type == "cpu":
        with torch.no_grad():
            return z.copy_(conv_epilogue_plain(z, bias, bn, act))
    if z.device.type != "cuda":
        raise RuntimeError(f"conv_epilogue: unsupported device {z.device}")
    fn = _build.entry("epilogue", "conv_epilogue_launch", 6, 4, n_floats=1)
    with torch.cuda.device(z.device):
        err = fn(_build.ptr(z), _build.ptr(bias), _build.ptr(bn.weight),
                 _build.ptr(bn.bias), _build.ptr(bn.running_mean),
                 _build.ptr(bn.running_var), z.numel() // z.shape[1],
                 z.shape[1], ACTIVATIONS.index(act),
                 int(z.dtype == torch.bfloat16), float(bn.eps),
                 _build.stream_ptr(z))
    _build.check(err, "conv_epilogue")
    _build.count_launch("conv_epilogue")
    return z
