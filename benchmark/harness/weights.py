"""Weights made on the device from the seed, in a few large draws, for the
entries of the reference's state dict.

``averaging``: the inference cells' weights.  Random weights have no
trained scale, so every convolution kernel is non-negative and sums to 1
over its inputs (a weighted average): the fields then follow the frames'
cells instead of turning into speckle, at the same scale under every seed.
Norms are the identity (scale 1, shift 0, running mean 0, variance 1),
biases 0.  The border head's output convolution is scaled by
``BORDER_SCALE``, so that its field stays below the cell field and both
heads move the seeds.

``lecun``: the training cell's weights, a standard start: kernels normal
with variance 1 / fan-in, biases 0, norm scales 1 and shifts 0.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.harness.gen import generator
from benchmark.reference.unet import state_shapes


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _constant(kind, shape, device):
    if kind in ("scale", "var"):
        return torch.ones(shape, device=device)
    if kind == "count":
        return torch.zeros(shape, dtype=torch.int64, device=device)
    return torch.zeros(shape, device=device)


BORDER_SCALE = 0.5


def make(cfg: dict, seed: int, device, kind: str) -> Dict[str, torch.Tensor]:
    shapes = state_shapes(cfg)
    kernels = {n: s for n, (k, s) in shapes.items() if k in ("conv", "convT")}
    g = generator(seed, 2, device)
    total = sum(_numel(s) for s in kernels.values())
    if kind == "averaging":
        flat = torch.rand(total, generator=g, device=device)
    elif kind == "lecun":
        flat = torch.randn(total, generator=g, device=device)
    else:
        raise ValueError(f"unknown weight kind {kind!r}")
    out, at = {}, 0
    for name, (k, shape) in shapes.items():
        if name not in kernels:
            out[name] = _constant(k, shape, device)
            continue
        w = flat[at:at + _numel(shape)].view(shape)
        at += _numel(shape)
        if kind == "averaging":
            # a transposed 2x2 stride-2 kernel gives each output pixel one
            # tap: it sums to 1 over the inputs per output channel and tap
            axes = (0,) if k == "convT" else (1, 2, 3)
            w = w / w.sum(dim=axes, keepdim=True)
            if name.startswith("decoder1Conv.") and shape[2] == 1:
                w = w * BORDER_SCALE
        else:
            fan_in = (shape[0] if k == "convT" else shape[1]) * shape[2] * \
                shape[3]
            w = w / fan_in ** 0.5
        out[name] = w.contiguous()
    return out
