"""Building blocks of the (D)U-Net, NCHW inside.

Module and attribute names follow the reference's ``src/utils/unets.py``
(``ConvBlock.conv`` = Sequential[conv, act, norm, conv, act, norm],
``ConvPool.conv_pool``, ``TranspConvBlock.up`` / ``.norm``), so a
``state_dict`` of these modules has the reference's keys.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


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


class Mish(nn.Module):
    def forward(self, x):
        return mish(x)


def make_act(name: str) -> nn.Module:
    if name == "relu":
        return nn.ReLU()
    if name == "leakyrelu":
        return nn.LeakyReLU(0.01)
    if name == "elu":
        return nn.ELU()
    if name == "mish":
        return Mish()
    raise ValueError(f"Unsupported activation function: {name}")


def make_norm(kind: str, ch: int) -> nn.Module:
    """'bn' (eps 1e-5, momentum 0.1 = flax's 0.9) | 'gn' (8 groups, eps
    1e-5) | 'in' (instance statistics, no affine parameters)."""
    if kind == "bn":
        return nn.BatchNorm2d(ch, eps=1e-5, momentum=0.1)
    if kind == "gn":
        return nn.GroupNorm(8, ch, eps=1e-5)
    if kind == "in":
        return nn.InstanceNorm2d(ch, eps=1e-5, affine=False)
    raise ValueError(f"Unsupported normalization: {kind}")


class ConvBlock(nn.Module):
    """[conv3x3 -> act -> norm] x 2."""

    def __init__(self, ch_in: int, ch_out: int, act_fun: str = "relu",
                 normalization: str = "bn"):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(ch_in, ch_out, 3, padding=1),
            make_act(act_fun), make_norm(normalization, ch_out),
            nn.Conv2d(ch_out, ch_out, 3, padding=1),
            make_act(act_fun), make_norm(normalization, ch_out))

    def forward(self, x):
        return self.conv(x)


class ConvPool(nn.Module):
    """Strided-conv downsample: conv3x3 stride 2 -> act -> norm."""

    def __init__(self, ch: int, act_fun: str = "relu",
                 normalization: str = "bn"):
        super().__init__()
        self.conv_pool = nn.Sequential(
            nn.Conv2d(ch, ch, 3, stride=2, padding=1),
            make_act(act_fun), make_norm(normalization, ch))

    def forward(self, x):
        return self.conv_pool(x)


class TranspConvBlock(nn.Module):
    """Upsample: transposed conv 2x2 stride 2 -> norm."""

    def __init__(self, ch_in: int, ch_out: int, normalization: str = "bn"):
        super().__init__()
        self.up = nn.Sequential(nn.ConvTranspose2d(ch_in, ch_out, 2, stride=2))
        self.norm = make_norm(normalization, ch_out)

    def forward(self, x):
        return self.norm(self.up(x))


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)
