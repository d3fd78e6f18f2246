"""Region properties by segment sums over a label image.

Port of ``microbeseg_tpu/ops/regionprops.py``, the replacement for the
``skimage.measure.regionprops`` calls of label generation: areas,
centroids, equivalent diameters and major/minor axis lengths of every
instance at once, with ``index_add_`` over the label image instead of a
per-instance loop.  The JAX package switches to ``ops/radix.py`` on large
frames; that module works around slow sorts and scatters on the TPU, and
the port does not need it.

Sums whose terms are integers (areas, Σy, Σx) are taken in int64 and cast
to float32, so they equal the JAX float32 sums exactly wherever those are
exact (below 2^24).  The central moments are float32 products summed in
float64: the same on the CPU and on the card, whatever the order of the
card's atomic adds, and within an ulp or so of the JAX float32 sums.

Labels must be consecutive 1..n (``cc.relabel_sequential``); ids above
``max_labels`` are ignored.  Index i of each output is label i + 1.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class RegionProps(NamedTuple):
    area: torch.Tensor                 # (N,) float32; 0 for absent labels
    centroid: torch.Tensor             # (N, 2) float32 (row, col)
    equivalent_diameter: torch.Tensor  # (N,) float32
    major_axis_length: torch.Tensor    # (N,) float32
    minor_axis_length: torch.Tensor    # (N,) float32


def _segment_sum(values: torch.Tensor, seg: torch.Tensor, n: int,
                 dtype: torch.dtype) -> torch.Tensor:
    return torch.zeros(n, dtype=dtype, device=seg.device).index_add_(
        0, seg, values.to(dtype))


def regionprops(labels: torch.Tensor, max_labels: int = 256) -> RegionProps:
    """Properties of labels 1..max_labels of an (H, W) integer image, or of
    each image of a (B, H, W) stack in one pass (JAX's ``vmap``); each
    output then gains the leading B axis.  Each image's sums are those of
    the image alone."""
    batched = labels.ndim == 3
    if not batched:
        labels = labels[None]
    B, H, W = labels.shape
    dev = labels.device
    n_seg = max_labels + 1
    seg = labels.reshape(B, -1).to(torch.int64) - 1
    seg = torch.where(seg < 0, max_labels, seg)   # background -> slot N
    keep = (seg <= max_labels).reshape(-1)
    # image b's slots are b * n_seg .. b * n_seg + N
    seg = (seg + torch.arange(B, device=dev)[:, None] * n_seg).reshape(-1)
    seg = seg[keep]
    yy = torch.arange(H, device=dev).repeat_interleave(W).repeat(B)[keep]
    xx = torch.arange(W, device=dev).repeat(B * H)[keep]

    def per_image(v, dtype):
        return _segment_sum(v, seg, B * n_seg, dtype).view(
            B, n_seg)[:, :max_labels]

    def sum_int(v):
        return per_image(v, torch.int64).to(torch.float32)

    area = sum_int(torch.ones_like(seg))
    sy, sx = sum_int(yy), sum_int(xx)
    safe_area = torch.clamp(area, min=1.0)
    cy, cx = sy / safe_area, sx / safe_area
    centroid = torch.stack([cy, cx], dim=-1)

    # central second moments normalised by area (skimage's inertia-tensor
    # convention), two-pass: deviations from each region's centroid, not
    # E[y^2] - E[y]^2, which cancels catastrophically at full-frame
    # coordinates
    zero = torch.zeros((B, 1), dtype=torch.float32, device=dev)
    dy = yy.to(torch.float32) - torch.cat([cy, zero], 1).reshape(-1)[seg]
    dx = xx.to(torch.float32) - torch.cat([cx, zero], 1).reshape(-1)[seg]

    def moment(v):
        return per_image(v, torch.float64).to(torch.float32) / safe_area

    mu20, mu02, mu11 = moment(dy * dy), moment(dx * dx), moment(dx * dy)
    common = torch.sqrt(torch.clamp((mu20 - mu02) ** 2 + 4.0 * mu11 ** 2,
                                    min=0.0))
    l1 = (mu20 + mu02 + common) / 2.0
    l2 = (mu20 + mu02 - common) / 2.0
    major = 4.0 * torch.sqrt(torch.clamp(l1, min=0.0))
    minor = 4.0 * torch.sqrt(torch.clamp(l2, min=0.0))
    eq_diam = torch.sqrt(4.0 * area / math.pi)

    present = area > 0
    props = RegionProps(
        area=torch.where(present, area, 0.0),
        centroid=torch.where(present[..., None], centroid, 0.0),
        equivalent_diameter=torch.where(present, eq_diam, 0.0),
        major_axis_length=torch.where(present, major, 0.0),
        minor_axis_length=torch.where(present, minor, 0.0),
    )
    return props if batched else RegionProps(*(p[0] for p in props))
