"""Spatial resize with the weights of ``jax.image.resize``.

The JAX engine scales frames down with method "cubic" and predictions back
up with "linear" (``microbeseg_tpu/inference/engine.py``).  That resize is
separable: along each resized axis the output is the input times an
(in, out) weight matrix.  "cubic" is the Keys kernel with a = -0.5; when an
axis shrinks, the kernel is widened by 1 / scale (antialiasing), every
output sample's weights are renormalised to sum 1, and samples that fall
outside the input are zeroed.  ``torch.nn.functional.interpolate`` computes
another function (a = -0.75, no widening), so the matrices are built here
from the formula, in float32 as JAX builds them, and applied as two small
matrix products.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

_F32 = np.float32


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((_F32(1.5) * x - _F32(2.5)) * x) * x + _F32(1.0)
    out = np.where(x >= 1.0,
                   ((_F32(-0.5) * x + _F32(2.5)) * x - _F32(4.0)) * x
                   + _F32(2.0), out)
    return np.where(x >= 2.0, _F32(0.0), out).astype(_F32)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(_F32(0.0), _F32(1.0) - np.abs(x)).astype(_F32)


_KERNELS = {"cubic": _keys_cubic, "linear": _triangle}


def weight_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """(in_size, out_size) float32 resize weights along one axis."""
    kernel = _KERNELS[method]
    inv_scale = _F32(1.0 / (out_size / in_size))
    kernel_scale = np.maximum(inv_scale, _F32(1.0))
    sample_f = ((np.arange(out_size, dtype=_F32) + _F32(0.5)) * inv_scale
                - _F32(0.5))
    x = (np.abs(sample_f[None, :] - np.arange(in_size, dtype=_F32)[:, None])
         / kernel_scale)
    weights = kernel(x)
    total = weights.sum(axis=0, keepdims=True, dtype=_F32)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(_F32).eps,
                       weights / np.where(total != 0, total, _F32(1.0)),
                       _F32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, _F32(0.0)).astype(_F32)


@lru_cache(maxsize=32)
def _weights_on(in_size: int, out_size: int, method: str,
                device: torch.device) -> torch.Tensor:
    return torch.from_numpy(weight_matrix(in_size, out_size, method)
                            ).to(device)


def resize(x: torch.Tensor, out_hw: Tuple[int, int],
           method: str) -> torch.Tensor:
    """Resize axes 1 and 2 of a (B, H, W) or (B, H, W, C) float tensor to
    ``out_hw`` with method "cubic" or "linear".  An axis that keeps its
    size is left alone, as in ``jax.image.resize``."""
    if method not in _KERNELS:
        raise ValueError(f"unknown resize method {method!r}")
    x = x.to(torch.float32)
    for axis, out in ((1, out_hw[0]), (2, out_hw[1])):
        if x.shape[axis] == out:
            continue
        w = _weights_on(x.shape[axis], out, method, x.device)
        x = torch.tensordot(x.movedim(axis, -1), w, dims=1).movedim(-1, axis)
    return x
