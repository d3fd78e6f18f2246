"""The distance method of microbeSEG as plain operations.

hip-satomi/microbeSEG ``src/inference/postprocessing.py`` (distance
method): the cell field smoothed by a gaussian (sigma 0.5, scipy's
defaults), the mask ``cell > th_cell``, seeds ``cell - borders > th_seed``
with ``borders = tan(border^2)`` (below 0.05 set to 0, clipped to 1),
seed components (8-connected) smaller than max(10% of the mean area, 4)
removed, then a marker watershed of ``-cell`` inside the mask.

The watershed is the quantised marker flood the port implements: the
in-mask value takes ``n_levels`` levels from the frame's own minimum and
maximum; at each level two synchronous steps let every unlabelled pixel at
or below the level take the label of its 4-neighbour with the least key
``(level << bits) | label``; steps over the whole mask then run to a fixed
point.  (On the CPU the port floods by value within a level, and so
does ``value_flood``.)  Seed components are numbered in raster order of their last pixel,
at most ``max_seeds`` of them.  Components are labelled with SciPy on the
host; everything else runs in plain PyTorch on the tensors' device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

BIG_KEY = 0x7FFFFFFF
_EIGHT = np.ones((3, 3), bool)


def gaussian(x: torch.Tensor, sigma: float = 0.5,
             truncate: float = 4.0) -> torch.Tensor:
    """scipy.ndimage.gaussian_filter of the last two axes (mode 'reflect',
    which repeats the edge sample), the taps summed in order, the third on
    as multiply-adds: the port's arithmetic, so that a seed threshold
    falls on the same side."""
    radius = int(truncate * sigma + 0.5)
    t = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=x.device)
    k = torch.exp(-0.5 / (sigma * sigma) * t * t)
    k = k / torch.sum(k)
    for dim in (x.ndim - 2, x.ndim - 1):
        n = x.shape[dim]
        idx = torch.remainder(torch.arange(-radius, n + radius,
                                           device=x.device), 2 * n)
        idx = torch.where(idx >= n, 2 * n - 1 - idx, idx)
        xp = torch.index_select(x, dim, idx)
        out = torch.zeros_like(x)
        for i in range(2 * radius + 1):
            tap = xp.narrow(dim, i, n)
            out = (out + k[i] * tap if i < 2
                   else torch.addcmul(out, k[i].expand_as(tap), tap))
        x = out
    return x


def seeds_pruned(seeds_bin: np.ndarray, max_seeds: int,
                 min_area_floor: float = 4.0,
                 rel_mean: float = 0.10) -> np.ndarray:
    """(H, W) bool -> int32 seed labels 1..n: 8-connected components in
    raster order of their last pixel (the first ``raw_cap`` of them
    counted), those of area <= max(rel_mean * mean area, floor) dropped,
    the rest numbered again, ids past ``max_seeds`` dropped.  The mean
    and the limit in float32."""
    raw_cap = max(4 * max_seeds, 1024)
    # SciPy numbers by first pixel; on the image turned by 180 degrees the
    # first pixel is the original's last
    lab, n = ndimage.label(seeds_bin[::-1, ::-1], structure=_EIGHT)
    rank = np.where(lab > 0, n + 1 - lab, 0)[::-1, ::-1]
    rank = np.where(rank > raw_cap, 0, rank)
    areas = np.bincount(rank.ravel(), minlength=raw_cap + 1)[:raw_cap + 1]
    areas = areas.astype(np.float32)
    areas[0] = 0
    n_comp = int((areas > 0).sum())
    mean = np.float32(areas.sum(dtype=np.float32)
                      / np.float32(max(n_comp, 1)))
    min_area = (np.float32(rel_mean) * mean if n_comp > 0
                else np.float32(0.0))
    min_area = max(np.float32(min_area), np.float32(min_area_floor))
    kept = areas > min_area
    table = np.cumsum(kept).astype(np.int32)
    table = np.where(kept & (table <= max_seeds), table, 0)
    return table[rank].astype(np.int32)


def _levels(value: torch.Tensor, mask: torch.Tensor,
            n_levels: int) -> torch.Tensor:
    big = torch.tensor(3.0e38, dtype=torch.float32, device=value.device)
    vmin = torch.where(mask, value, big).amin(dim=(1, 2), keepdim=True)
    vmax = torch.where(mask, value, -big).amax(dim=(1, 2), keepdim=True)
    span = torch.clamp(vmax - vmin, min=1e-20)
    t = (value - vmin) / span * (n_levels - 1)
    t = torch.where(mask, t, torch.zeros_like(t))
    return torch.clamp(t.to(torch.int32), 0, n_levels - 1)


def _step(key, qshift, active, low_bits):
    H, W = key.shape[-2:]
    p = F.pad(torch.where(active, key, BIG_KEY), (1, 1, 1, 1),
              value=BIG_KEY)
    best = torch.minimum(
        torch.minimum(p[:, :H, 1:W + 1], p[:, 2:, 1:W + 1]),
        torch.minimum(p[:, 1:H + 1, :W], p[:, 1:H + 1, 2:]))
    grow = active & (key == BIG_KEY) & (best < BIG_KEY)
    return torch.where(grow, qshift | (best & low_bits), key)


def marker_flood(value: torch.Tensor, markers: torch.Tensor,
                 mask: torch.Tensor, n_levels: int,
                 label_bits: int) -> torch.Tensor:
    """(B, H, W) value (lower floods first), int32 markers, bool mask ->
    int32 labels."""
    low_bits = (1 << label_bits) - 1
    q = _levels(value, mask, n_levels)
    qshift = q << label_bits
    key = torch.where(mask & (markers > 0), qshift | markers,
                      torch.full_like(q, BIG_KEY))
    for lvl in range(n_levels):
        active = mask & (q <= lvl)
        for _ in range(2):
            key = _step(key, qshift, active, low_bits)
    while True:
        new = _step(key, qshift, mask, low_bits)
        if torch.equal(new, key):
            break
        key = new
    return torch.where(key < BIG_KEY, key & low_bits, 0)


_SHIFTS = ((-1, 0), (1, 0), (0, -1), (0, 1))


def _value_step(labels, value, active):
    """Unlabelled active pixels take the label of the lowest-valued
    labelled active 4-neighbour (the first in ``_SHIFTS`` on ties)."""
    H, W = labels.shape[-2:]
    big = 3.0e38
    pl = F.pad(labels, (1, 1, 1, 1), value=0)
    pv = F.pad(value, (1, 1, 1, 1), value=big)
    pa = F.pad(active.to(torch.uint8), (1, 1, 1, 1), value=0).bool()
    best_v = torch.full_like(value, big)
    best_l = torch.zeros_like(labels)
    for dy, dx in _SHIFTS:
        sl = (slice(None), slice(1 + dy, 1 + dy + H), slice(1 + dx, 1 + dx + W))
        cand = torch.where((pl[sl] > 0) & pa[sl], pv[sl],
                           torch.full_like(value, big))
        take = cand < best_v
        best_v = torch.where(take, cand, best_v)
        best_l = torch.where(take, pl[sl], best_l)
    grow = (labels == 0) & active & (best_v < big)
    return torch.where(grow, best_l, labels)


def value_flood(value, markers, mask, n_levels: int) -> torch.Tensor:
    """The flood the port runs on the CPU: the same levels, but within a
    level the lower-valued neighbour wins, not the lower label."""
    q = _levels(value, mask, n_levels)
    labels = torch.where(mask, markers, 0)
    for lvl in range(n_levels):
        active = mask & (q <= lvl)
        for _ in range(2):
            labels = _value_step(labels, value, active)
    while True:
        new = _value_step(labels, value, mask)
        if torch.equal(new, labels):
            break
        labels = new
    return labels


def label_bits(side: int, max_seeds: int) -> int:
    """12 label bits on frames up to 768 px with fewer than 4096 seeds,
    else 24, as the port packs its keys (ties within a level go to the
    lower label either way)."""
    return 12 if side <= 768 and max_seeds < 4096 else 24


def distance_masks(border: torch.Tensor, cell: torch.Tensor, th_cell: float,
                   th_seed: float, max_seeds: int,
                   n_levels: int = 128) -> np.ndarray:
    """(B, H, W) float32 border and cell fields -> (B, H, W) uint16
    masks."""
    th_cell = torch.as_tensor(th_cell, dtype=torch.float32,
                              device=cell.device)
    th_seed = torch.as_tensor(th_seed, dtype=torch.float32,
                              device=cell.device)
    cell = gaussian(cell.to(torch.float32))
    border = torch.clamp(border.to(torch.float32), 0.0, 1.0)
    mask = cell > th_cell
    borders = torch.tan(border * border)
    borders = torch.clamp(torch.where(borders < 0.05,
                                      torch.zeros_like(borders), borders),
                          0.0, 1.0)
    seeds_bin = ((cell - borders) > th_seed).cpu().numpy()
    seeds = np.stack([seeds_pruned(s, max_seeds) for s in seeds_bin])
    seeds = torch.from_numpy(seeds).to(cell.device)
    side = max(cell.shape[-2:])
    if cell.device.type == "cpu":
        labels = value_flood(-cell, seeds, mask, n_levels)
    else:
        labels = marker_flood(-cell, seeds, mask, n_levels,
                              label_bits(side, max_seeds))
    return labels.cpu().numpy().astype(np.uint16)
