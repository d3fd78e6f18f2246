"""Separable gaussian filtering (scipy ``gaussian_filter`` defaults:
truncate 4, mode 'reflect' = symmetric padding), and the training blur with
one sigma per sample (``gaussian_blur_dynamic``).

Written as the JAX package's sum of shifted slices, in the same tap order
and in float32: a ``conv2d`` would sum in another order, and a seed
threshold could then flip on a tie.  The output is not bit-identical to the
JAX package's: XLA's CPU backend fuses the taps into multiply-adds in an
order of its own, and about 0.1% of pixels differ by one ulp (see
``_correlate1d``).
"""

from __future__ import annotations

import torch


def _gaussian_kernel1d(sigma: float, radius: int,
                       device: torch.device) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    phi = torch.exp(-0.5 / (sigma * sigma) * x * x)
    return phi / torch.sum(phi)


def _symmetric_pad(x: torch.Tensor, radius: int, dim: int) -> torch.Tensor:
    """np.pad(mode='symmetric') along ``dim`` (edge sample repeated)."""
    n = x.shape[dim]
    idx = torch.arange(-radius, n + radius, device=x.device)
    # reflect about -0.5 and n-0.5; the period 2n covers any radius
    idx = torch.remainder(idx, 2 * n)
    idx = torch.where(idx >= n, 2 * n - 1 - idx, idx)
    return torch.index_select(x, dim, idx)


def _correlate1d(x: torch.Tensor, k: torch.Tensor, dim: int,
                 radius: int) -> torch.Tensor:
    """Taps summed in order.  From the third tap on each step is a fused
    multiply-add (``addcmul``): XLA's CPU backend contracts those adds into
    FMAs, and the first two taps stay a plain product sum.  This matches
    the JAX package's output on all but ~0.1% of pixels, which differ by
    one ulp where XLA recomputes a fused intermediate in another order."""
    xp = _symmetric_pad(x, radius, dim)
    n = x.shape[dim]
    out = torch.zeros_like(x)
    for i in range(2 * radius + 1):
        tap = xp.narrow(dim, i, n)
        out = (out + k[i] * tap if i < 2
               else torch.addcmul(out, k[i].expand_as(tap), tap))
    return out


def gaussian_filter(img: torch.Tensor, sigma: float = 0.5,
                    truncate: float = 4.0) -> torch.Tensor:
    """2D gaussian blur of the trailing two axes (any number of lead axes)."""
    radius = int(truncate * float(sigma) + 0.5)
    if radius == 0:
        return img
    k = _gaussian_kernel1d(float(sigma), radius, img.device)
    x = img.to(torch.float32)
    x = _correlate1d(x, k, x.ndim - 2, radius)
    x = _correlate1d(x, k, x.ndim - 1, radius)
    return x.to(img.dtype)


def gaussian_blur_dynamic(img: torch.Tensor, sigma: torch.Tensor,
                          radius: int = 9) -> torch.Tensor:
    """Gaussian blur of the trailing two axes of a batch with one sigma per
    sample (the Blur augmentation): a fixed ``2 * radius + 1`` support,
    weights from each sigma.

    Like ``microbeseg_tpu/ops/filters.py::gaussian_blur_dynamic`` this
    blurs the *trailing two* axes: on (B, H, W, 1), as the training
    pipeline gives it, that is the width and the size-1 channel axis, so
    the blur is horizontal only (the channel pass multiplies by the taps'
    sum)."""
    x = img.to(torch.float32)
    ones = [1] * (x.ndim - 1)
    s = sigma.to(torch.float32).reshape(-1, *ones)               # (B, 1..)
    t = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=x.device).view(-1, 1, *ones)          # (K, 1..)
    phi = torch.exp(-0.5 / (s * s) * t * t)                       # (K, B, 1..)
    k = phi / torch.sum(phi, dim=0, keepdim=True)
    x = _correlate1d(x, k, x.ndim - 2, radius)
    x = _correlate1d(x, k, x.ndim - 1, radius)
    return x.to(img.dtype)
