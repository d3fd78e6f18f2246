"""Contrast-limited adaptive histogram equalisation (CLAHE).

Port of ``microbeseg_tpu/ops/augment.py::clahe``, the one augmentation
inference uses (``InferConfig.apply_clahe``).  The JAX function takes one
image and the engine vmaps it; here the batch axis is explicit.  Tile
histograms are one ``bincount`` and the lookups of the four neighbouring
tile mappings one ``gather`` each, where the JAX package multiplies a
one-hot of the bin image on the matrix unit.  That product selects table
entries held in bfloat16, so the tables are rounded to bfloat16 here too.
"""

from __future__ import annotations

import numpy as np
import torch


def _symmetric_index(size: int, padded: int) -> np.ndarray:
    """Source index of each position of an axis padded at its end in
    numpy's 'symmetric' mode."""
    return np.pad(np.arange(size), (0, padded - size), mode="symmetric")


def clahe(img01: torch.Tensor, clip_limit: float = 0.01, grid: int = 8,
          nbins: int = 256) -> torch.Tensor:
    """CLAHE of [0, 1] images, (B, H, W) or (H, W) float32, any size (padded
    symmetrically at the bottom and right to a multiple of 2 * grid).  Per
    tile: clipped histogram, the clipped excess spread evenly over the bins,
    cdf; per pixel: bilinear blend of the mappings of the 4 nearest tiles."""
    squeeze = img01.ndim == 2
    img = img01[None] if squeeze else img01
    img = img.to(torch.float32)
    dev = img.device
    B, H, W = img.shape
    unit = 2 * grid
    Hp = -(-H // unit) * unit
    Wp = -(-W // unit) * unit
    if Hp != H:
        img = img[:, torch.from_numpy(_symmetric_index(H, Hp)).to(dev)]
    if Wp != W:
        img = img[:, :, torch.from_numpy(_symmetric_index(W, Wp)).to(dev)]
    th, tw = Hp // grid, Wp // grid
    hh, hw = th // 2, tw // 2
    b = torch.clamp((img * nbins).to(torch.int32), 0, nbins - 1
                    ).to(torch.int64)

    # per-tile histograms: one bincount over (image, tile row, tile col, bin)
    ty = torch.arange(Hp, device=dev) // th
    tx = torch.arange(Wp, device=dev) // tw
    tile_id = ty[:, None] * grid + tx[None, :]
    img_id = torch.arange(B, device=dev).view(B, 1, 1) * (grid * grid)
    flat = ((img_id + tile_id) * nbins + b).view(-1)
    hist = torch.bincount(flat, minlength=B * grid * grid * nbins)
    hist = hist.view(B, grid, grid, nbins).to(torch.float32)

    limit = max(clip_limit * th * tw, 1.0)
    excess = torch.clamp(hist - limit, min=0.0).sum(dim=-1, keepdim=True)
    hist = torch.clamp(hist, max=limit) + excess / nbins
    cdf = torch.cumsum(hist, dim=-1)
    cdf = cdf / cdf[..., -1:]
    # the JAX package looks the mappings up in bfloat16 tables
    cdf = cdf.to(torch.bfloat16).to(torch.float32).view(B, -1)

    # half-tile block I covers the (I % 2)-th half of tile I // 2; its two
    # neighbouring tiles along the axis are (i - 1, i) or (i, i + 1),
    # clipped at the edges
    bi = np.arange(unit) // 2
    half = np.arange(unit) % 2
    n0 = np.where(half == 0, np.maximum(bi - 1, 0), bi)
    n1 = np.where(half == 0, bi, np.minimum(bi + 1, grid - 1))
    by = torch.arange(Hp, device=dev) // hh
    bx = torch.arange(Wp, device=dev) // hw
    n0, n1 = torch.from_numpy(n0).to(dev), torch.from_numpy(n1).to(dev)
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
    out = torch.clamp(out[:, :H, :W], 0.0, 1.0)
    return out[0] if squeeze else out
