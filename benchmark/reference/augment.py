"""The training augmentation of microbeSEG, applied with drawn parameters.

A frozen copy of the apply step the port implements for the reference's
train Compose (``src/training/train_data_generator.py``): D4 flip -> one
contrast branch (CLAHE | percentile stretch | contrast + gamma) -> scaling
and rotation as one two-pass resample (bfloat16-rounded weights and
intermediates, zero outside the frame) -> horizontal gaussian blur -> noise
-> [-1, 1].  Distance labels take the flip and the resample with the image.
Each stage runs on the samples that drew it.  Parameters come from
``benchmark/harness/augdraw.py``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

UINT16_MAX = 65535.0

_D4 = torch.tensor([[0, 0, 0], [0, 1, 0], [1, 0, 0], [0, 1, 1],
                    [1, 1, 0], [1, 0, 1], [0, 0, 1], [1, 1, 1]],
                   dtype=torch.bool)


def _d4(x, h):
    t = _D4[h.cpu()].to(x.device).view(-1, 3, 1, 1, 1)
    x = torch.where(t[:, 0], x.flip(1), x)
    x = torch.where(t[:, 1], x.flip(2), x)
    return torch.where(t[:, 2], x.transpose(1, 2), x)


def _sym_index(size, padded):
    return np.pad(np.arange(size), (0, padded - size), mode="symmetric")


def clahe(img01, clip_limit=0.01, grid=8, nbins=256):
    img = img01.to(torch.float32)
    dev = img.device
    B, H, W = img.shape
    unit = 2 * grid
    Hp, Wp = -(-H // unit) * unit, -(-W // unit) * unit
    if Hp != H:
        img = img[:, torch.from_numpy(_sym_index(H, Hp)).to(dev)]
    if Wp != W:
        img = img[:, :, torch.from_numpy(_sym_index(W, Wp)).to(dev)]
    th, tw = Hp // grid, Wp // grid
    hh, hw = th // 2, tw // 2
    b = torch.clamp((img * nbins).to(torch.int32), 0, nbins - 1
                    ).to(torch.int64)
    ty = torch.arange(Hp, device=dev) // th
    tx = torch.arange(Wp, device=dev) // tw
    tile_id = ty[:, None] * grid + tx[None, :]
    img_id = torch.arange(B, device=dev).view(B, 1, 1) * (grid * grid)
    flat = ((img_id + tile_id) * nbins + b).view(-1)
    hist = torch.zeros(B * grid * grid * nbins, dtype=torch.int64,
                       device=dev).index_add_(0, flat, torch.ones_like(flat))
    hist = hist.view(B, grid, grid, nbins).to(torch.float32)
    limit = max(clip_limit * th * tw, 1.0)
    excess = torch.clamp(hist - limit, min=0.0).sum(dim=-1, keepdim=True)
    hist = torch.clamp(hist, max=limit) + excess / nbins
    cdf = torch.cumsum(hist, dim=-1)
    cdf = cdf / cdf[..., -1:]
    cdf = cdf.to(torch.bfloat16).to(torch.float32).view(B, -1)
    bi = np.arange(unit) // 2
    half = np.arange(unit) % 2
    n0 = torch.from_numpy(np.where(half == 0, np.maximum(bi - 1, 0),
                                   bi)).to(dev)
    n1 = torch.from_numpy(np.where(half == 0, bi,
                                   np.minimum(bi + 1, grid - 1))).to(dev)
    by = torch.arange(Hp, device=dev) // hh
    bx = torch.arange(Wp, device=dev) // hw
    y0, y1, x0, x1 = n0[by], n1[by], n0[bx], n1[bx]

    def lookup(ny, nx):
        idx = (ny[:, None] * grid + nx[None, :]) * nbins + b
        return torch.gather(cdf, 1, idx.view(B, -1)).view(B, Hp, Wp)

    yy = (torch.arange(Hp, dtype=torch.float32, device=dev) + 0.5) / th - 0.5
    xx = (torch.arange(Wp, dtype=torch.float32, device=dev) + 0.5) / tw - 0.5
    wy = (yy - torch.floor(yy))[:, None]
    wx = (xx - torch.floor(xx))[None, :]
    out = ((1 - wy) * ((1 - wx) * lookup(y0, x0) + wx * lookup(y0, x1))
           + wy * ((1 - wx) * lookup(y1, x0) + wx * lookup(y1, x1)))
    return torch.clamp(out[:, :H, :W], 0.0, 1.0)


def _quantiles(img, qs, iters=22):
    flat = img.reshape(img.shape[0], -1)
    k = qs.shape[1]
    lo = flat.amin(dim=1, keepdim=True).expand(-1, k)
    hi = flat.amax(dim=1, keepdim=True).expand(-1, k)
    n = flat.shape[1]
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        count = (flat[:, :, None] <= mid[:, None, :]).sum(dim=1)
        reached = count.to(torch.float32) / n >= qs
        lo, hi = torch.where(reached, lo, mid), torch.where(reached, mid, hi)
    return hi


def _stretch(img, lo_hi):
    first = lo_hi == 0
    p_lo = torch.where(first, 0.2, 0.1) / 100.0
    p_hi = torch.where(first, 99.8, 99.9) / 100.0
    p = _quantiles(img, torch.stack([p_lo, p_hi], dim=1)).view(-1, 2, 1, 1, 1)
    p0, p1 = p[:, 0], p[:, 1]
    out = torch.clamp((img - p0) / torch.clamp(p1 - p0, min=1e-7), 0.0, 1.0)
    return out * UINT16_MAX


def _gamma(img, factor, gamma):
    dims = (1, 2, 3)
    x = img / UINT16_MAX
    mean = x.mean(dim=dims, keepdim=True)
    x = (x - mean) * factor.view(-1, 1, 1, 1) + mean
    lo = x.amin(dim=dims, keepdim=True)
    rnge = x.amax(dim=dims, keepdim=True) - lo
    x = torch.pow(torch.clamp((x - lo) / (rnge + 1e-7), 0.0, 1.0),
                  gamma.view(-1, 1, 1, 1)) * rnge + lo
    return torch.clamp(x, 0.0, 1.0) * UINT16_MAX


def _resample_axis(x, pos, dim):
    C = x.shape[-1]
    size = x.shape[dim]
    k0 = torch.floor(pos)
    out = None
    for k in (k0, k0 + 1.0):
        inside = (k >= 0) & (k <= size - 1)
        w = torch.clamp(1.0 - torch.abs(pos - k), min=0.0)
        w = torch.where(inside, w, 0.0).to(torch.bfloat16).to(torch.float32)
        idx = torch.clamp(k, 0, size - 1).to(torch.int64)
        term = torch.gather(x, dim, idx.unsqueeze(-1).expand(-1, -1, -1, C))
        term = term * w.unsqueeze(-1)
        out = term if out is None else out + term
    return out


def _affine(x, ca, sa, sy, sx):
    B, H, W, C = x.shape
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0

    def col(v):
        return v.view(-1, 1, 1)

    m00, m01 = col(ca / sy), col(-sa / sy)
    m10, m11 = col(sa / sx), col(ca / sx)
    c0 = cy - m00 * cy - m01 * cx
    c1 = cx - m10 * cy - m11 * cx
    beta = m01 / m11
    alpha = m00 - beta * m10
    gamma = c0 - beta * c1
    yy = torch.arange(H, dtype=torch.float32, device=x.device)[:, None]
    xx = torch.arange(W, dtype=torch.float32, device=x.device)[None, :]
    p1 = alpha * yy + beta * xx + gamma
    t1 = _resample_axis(x.to(torch.bfloat16).to(torch.float32), p1, 1)
    p2 = m10 * yy + m11 * xx + c1
    out = _resample_axis(t1.to(torch.bfloat16).to(torch.float32), p2, 2)
    src_y = m00 * yy + m01 * xx + c0
    valid = ((src_y >= 0.0) & (src_y <= H - 1.0)
             & (p2 >= 0.0) & (p2 <= W - 1.0))
    return out * valid[..., None]


def _blur(img, sigma, radius=9):
    """Gaussian of the trailing two axes of (B, H, W, 1) with one sigma a
    sample: the width, and the size-1 channel axis (a product with the
    taps' sum), as the port blurs."""
    x = img.to(torch.float32)
    ones = [1] * (x.ndim - 1)
    s = sigma.to(torch.float32).reshape(-1, *ones)
    t = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=x.device).view(-1, 1, *ones)
    phi = torch.exp(-0.5 / (s * s) * t * t)
    k = phi / torch.sum(phi, dim=0, keepdim=True)
    for dim in (x.ndim - 2, x.ndim - 1):
        n = x.shape[dim]
        idx = torch.arange(-radius, n + radius, device=x.device)
        idx = torch.remainder(idx, 2 * n)
        idx = torch.where(idx >= n, 2 * n - 1 - idx, idx)
        xp = torch.index_select(x, dim, idx)
        out = torch.zeros_like(x)
        for i in range(2 * radius + 1):
            out = out + k[i] * xp.narrow(dim, i, n)
        x = out
    return x


def apply(images: torch.Tensor, labels: Dict[str, torch.Tensor],
          p: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor,
                                               Dict[str, torch.Tensor]]:
    """(B, H, W, 1) raw images and distance labels -> augmented images in
    [-1, 1] and labels."""
    dev = images.device
    image = _d4(images.to(torch.float32), p["h"])
    labels = {k: _d4(v, p["h"]) for k, v in labels.items()}
    for b in range(3):
        r = torch.nonzero(p["do_contrast"] & (p["branch"] == b)).flatten()
        if not len(r):
            continue
        rows = r.to(dev)
        image = image.clone()
        if b == 0:
            image[rows] = (clahe(image[rows][..., 0] / UINT16_MAX)
                           * UINT16_MAX)[..., None]
        elif b == 1:
            image[rows] = _stretch(image[rows], p["lo_hi"][r].to(dev))
        else:
            image[rows] = _gamma(image[rows], p["factor"][r].to(dev),
                                 p["gamma"][r].to(dev))
    r = torch.nonzero(p["geo"]).flatten()
    if len(r):
        rows = r.to(dev)
        keys = list(labels)
        stacked = torch.cat([image[rows]] + [labels[k][rows].to(
            torch.float32) for k in keys], dim=-1)
        out = _affine(stacked, *(p[k][r].to(dev)
                                 for k in ("cos", "sin", "sy", "sx")))
        image = image.index_copy(0, rows, out[..., :1])
        labels = {k: labels[k].index_copy(0, rows, out[..., 1 + i:2 + i])
                  for i, k in enumerate(keys)}
    r = torch.nonzero(p["do_blur"]).flatten()
    if len(r):
        rows = r.to(dev)
        image = image.index_copy(0, rows, _blur(image[rows],
                                                p["sigma"][r].to(dev)))
    r = torch.nonzero(p["do_noise"]).flatten()
    if len(r):
        rows = r.to(dev)
        sub = image[rows]
        sigma = (p["pct"][r].to(dev).view(-1, 1, 1, 1)
                 * sub.amax(dim=(1, 2, 3), keepdim=True))
        image = image.index_copy(0, rows, sub + sigma * p["noise"].to(dev))
    image = torch.clamp(image, 0.0, UINT16_MAX)
    return 2.0 * image / UINT16_MAX - 1.0, labels
