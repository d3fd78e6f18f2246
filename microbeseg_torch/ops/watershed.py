"""Marker-based watershed as bounded-iteration flooding ('flood' method).

The image is quantised into ``n_levels`` flood levels and labels propagate
level by level: within a level, unlabeled pixels take the label of their
lowest-valued labeled 4-neighbour.  A final
fixed-point sweep labels plateau leftovers.  Same steps as
``microbeseg_tpu/ops/watershed.py::watershed``, batched over a leading axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from microbeseg_torch.ops.kernels.flood import quantize_levels

_BIG = 3.0e38

_SHIFTS_4 = ((-1, 0), (1, 0), (0, -1), (0, 1))


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


def watershed(image: torch.Tensor, markers: torch.Tensor, mask: torch.Tensor,
              n_levels: int = 128, inner_steps: int = 2) -> torch.Tensor:
    """Flood ``image`` (lower = flooded first) from ``markers`` within
    ``mask``.  (B, H, W) or (H, W) inputs; returns int32 labels.  Each image
    is quantised with its own min and max."""
    squeeze = image.ndim == 2
    if squeeze:
        image, markers, mask = image[None], markers[None], mask[None]
    mask = mask.to(torch.bool)
    image = image.to(torch.float32)
    labels = torch.where(mask, markers.to(torch.int32), 0)
    q = quantize_levels(image, mask, n_levels)

    for lvl in range(n_levels):
        active = mask & (q <= lvl)
        for _ in range(inner_steps):
            labels = _flood_step(labels, image, active, _SHIFTS_4)

    # H * W steps bound the geodesic distance; stops at the fixed point
    for _ in range(image.shape[-2] * image.shape[-1]):
        new = _flood_step(labels, image, mask, _SHIFTS_4)
        if torch.equal(new, labels):
            break
        labels = new
    return labels[0] if squeeze else labels
