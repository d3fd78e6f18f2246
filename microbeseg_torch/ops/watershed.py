"""Marker-based watershed as bounded-iteration flooding ('flood' method),
and its drainage approximation ('fast' method).

``watershed``: the image is quantised into ``n_levels`` flood levels and
labels propagate level by level: within a level, unlabeled pixels take the
label of their lowest-valued labeled neighbour (4-connected, or 8-connected
with ``connectivity=2``).  A final fixed-point sweep labels plateau
leftovers.  ``watershed_fast``: every pixel drains to
its lowest neighbour, pointer doubling finds each basin's root, markers
label their basins, and the same fixed-point sweep fills the rest.  Same
steps as ``microbeseg_tpu/ops/watershed.py::watershed`` and
``watershed_fast``, batched over a leading axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from microbeseg_torch.ops.kernels.flood import quantize_levels

_BIG = 3.0e38

_SHIFTS_4 = ((-1, 0), (1, 0), (0, -1), (0, 1))
_SHIFTS_8 = _SHIFTS_4 + ((-1, -1), (-1, 1), (1, -1), (1, 1))


def _shift(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """Value of the neighbour at offset (dy, dx), ``fill`` outside."""
    H, W = x.shape[-2], x.shape[-1]
    if x.dtype == torch.bool:
        return _shift(x.to(torch.uint8), dy, dx, int(fill)).to(torch.bool)
    xp = F.pad(x, (1, 1, 1, 1), value=fill)
    return xp[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]


def _flood_step(labels, value, active, shifts):
    """Unlabeled active pixels take the label of the lowest-valued labeled
    active neighbour (first in ``shifts`` order on ties)."""
    big = torch.tensor(_BIG, dtype=torch.float32, device=value.device)
    best_v = torch.full_like(value, _BIG)
    best_l = torch.zeros_like(labels)
    for dy, dx in shifts:
        nl = _shift(labels, dy, dx, 0)
        nv = _shift(value, dy, dx, _BIG)
        na = _shift(active, dy, dx, False)
        cand_v = torch.where((nl > 0) & na, nv, big)
        take = cand_v < best_v
        best_v = torch.where(take, cand_v, best_v)
        best_l = torch.where(take, nl, best_l)
    grow = (labels == 0) & active & (best_v < _BIG)
    return torch.where(grow, best_l, labels)


def _cleanup(labels, image, mask, shifts):
    """Flood steps over the whole mask until one changes nothing; H * W
    steps bound the geodesic distance."""
    for _ in range(image.shape[-2] * image.shape[-1]):
        new = _flood_step(labels, image, mask, shifts)
        if torch.equal(new, labels):
            break
        labels = new
    return labels


def watershed(image: torch.Tensor, markers: torch.Tensor, mask: torch.Tensor,
              n_levels: int = 128, inner_steps: int = 2, *,
              connectivity: int = 1) -> torch.Tensor:
    """Flood ``image`` (lower = flooded first) from ``markers`` within
    ``mask``.  (B, H, W) or (H, W) inputs; returns int32 labels.  Each image
    is quantised with its own min and max.  ``connectivity``: 1 for 4- and
    2 for 8-connected steps (keyword only: the JAX function's next
    positional argument bounds its cleanup loop, which here stops at its
    fixed point)."""
    squeeze = image.ndim == 2
    if squeeze:
        image, markers, mask = image[None], markers[None], mask[None]
    shifts = _SHIFTS_4 if connectivity == 1 else _SHIFTS_8
    mask = mask.to(torch.bool)
    image = image.to(torch.float32)
    labels = torch.where(mask, markers.to(torch.int32), 0)
    q = quantize_levels(image, mask, n_levels)

    for lvl in range(n_levels):
        active = mask & (q <= lvl)
        for _ in range(inner_steps):
            labels = _flood_step(labels, image, active, shifts)
    labels = _cleanup(labels, image, mask, shifts)
    return labels[0] if squeeze else labels


def watershed_fast(image: torch.Tensor, markers: torch.Tensor,
                   mask: torch.Tensor, connectivity: int = 1) -> torch.Tensor:
    """Drainage approximation of the marker watershed.  (B, H, W) or
    (H, W) inputs; returns int32 labels.

    Each masked pixel points to its lowest neighbour by (value, raster
    index), or to itself where it is lowest; markers point to themselves.
    ceil(log2(H * W)) rounds of pointer doubling take every pixel to its
    root, and a root's marker labels its whole basin.  Pixels that drain to
    a root without a marker are filled by fixed-point steps of the flood
    over the mask."""
    squeeze = image.ndim == 2
    if squeeze:
        image, markers, mask = image[None], markers[None], mask[None]
    shifts = _SHIFTS_4 if connectivity == 1 else _SHIFTS_8
    mask = mask.to(torch.bool)
    image = image.to(torch.float32)
    B, H, W = image.shape
    dev = image.device
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    idx = torch.arange(H * W, dtype=torch.int32, device=dev).view(1, H, W)
    idx = idx.expand(B, H, W)
    val = torch.where(mask, image, big)

    # lowest neighbour by (value, index); the pixel itself where it is lowest
    best_v, best_i = val, idx
    for dy, dx in shifts:
        nv = _shift(val, dy, dx, _BIG)
        ni = _shift(idx, dy, dx, -1)
        na = _shift(mask, dy, dx, False)
        nv = torch.where(na, nv, big)
        take = (nv < best_v) | ((nv == best_v) & (ni < best_i) & (nv < big))
        best_v = torch.where(take, nv, best_v)
        best_i = torch.where(take, ni, best_i)
    parent = torch.where(mask, best_i, idx).reshape(B, -1)

    # markers are roots
    labels0 = torch.where(mask, markers.to(torch.int32), 0).reshape(B, -1)
    parent = torch.where(labels0 > 0, idx.reshape(B, -1), parent).long()

    # pointer doubling to the root
    for _ in range(max(1, (H * W - 1).bit_length())):
        parent = torch.gather(parent, 1, parent)
    labels = torch.gather(labels0, 1, parent).view(B, H, W)
    labels = torch.where(mask, labels, 0)

    # cleanup: pixels that drain to unlabelled minima, by the ordered flood
    labels = _cleanup(labels, image, mask, shifts)
    return labels[0] if squeeze else labels
