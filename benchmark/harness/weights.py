"""Weights made on the device from the seed, in a few large draws, for the
entries of the state dict that the configuration's family lists
(``state_shapes``, ``benchmark/families``).  Kinds: ``conv`` a kernel
(out, in, ...) whose fan-in is every axis but the first (a linear layer's
too), ``convT`` a transposed kernel (in, out, kh, kw), and the constants
``bias``, ``scale``, ``shift``, ``mean``, ``var``, ``count``.

``averaging``: the inference cells' weights.  Random weights have no
trained scale, so every kernel is non-negative and sums to 1 over its
inputs (a weighted average): the fields then follow the frames' cells
instead of turning into speckle, at the same scale under every seed.
Norms are the identity (scale 1, shift 0, running mean 0, variance 1),
biases 0.  A family may scale single kernels (``averaging_scale``).

``lecun``: the training cell's weights, a standard start: kernels normal
with variance 1 / fan-in, biases 0, norm scales 1 and shifts 0.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark import families
from benchmark.harness.gen import generator


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


def make(cfg: dict, seed: int, device, kind: str,
         family=None) -> Dict[str, torch.Tensor]:
    """The weights of ``cfg``, a family's ``model_config``; ``family`` its
    module (the default family where None)."""
    family = family or families.load(families.DEFAULT)
    shapes = family.state_shapes(cfg)
    scale = getattr(family, "averaging_scale", None)
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
            axes = (0,) if k == "convT" else tuple(range(1, len(shape)))
            w = w / w.sum(dim=axes, keepdim=True)
            f = scale(name, shape) if scale else 1.0
            if f != 1.0:
                w = w * f
        else:
            fan_in = (shape[0] * _numel(shape[2:]) if k == "convT"
                      else _numel(shape[1:]))
            w = w / fan_in ** 0.5
        out[name] = w.contiguous()
    return out
