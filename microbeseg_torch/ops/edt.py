"""Exact Euclidean distance transform on tensors.

Port of ``microbeseg_tpu/ops/edt.py``, the replacement for
``scipy.ndimage.distance_transform_edt`` in label generation (reference:
src/training/train_data_representations.py:244, 289, 317).  Separable
two-pass squared EDT:

  pass 1: per column, the distance to the nearest zero-candidate row, from
          the running index of the last candidate above and below (cummax);
  pass 2: per row, D2[i, j] = min_k g2[i, k] + (j - k)^2 as a broadcast min,
          chunked over rows to bound memory.

Squared distances are integers, so both passes run in int32 and one float32
``sqrt`` ends the transform: the result is exactly the JAX function's,
whatever the order of the min.  A ``valid`` mask restricts the domain, so
windowed per-instance transforms reproduce the reference's *cropped* EDT:
pixels outside ``valid`` are neither features nor zero candidates.
"""

from __future__ import annotations

from typing import Optional

import torch

_BIG = 1 << 30          # squared distance where a row has no candidate
_MAX_SIDE = 1 << 14     # _BIG + (W - 1)^2 must fit int32
_CHUNK_ELEMS = 1 << 24  # int32 elements of one (rows, W, W) broadcast


def _col_dist_sq(zero_cand: torch.Tensor) -> torch.Tensor:
    """(..., H, W) bool -> int32 squared vertical distance to the nearest
    zero candidate of the column, _BIG where the column has none."""
    H = zero_cand.shape[-2]
    none = 2 * H + 2
    rows = torch.arange(H, dtype=torch.int32,
                        device=zero_cand.device).view(H, 1)
    # sentinel rows far enough above and below that either distance to
    # them is >= none
    above = torch.where(zero_cand, rows, -none).cummax(dim=-2).values
    below = torch.where(zero_cand, rows, none + H).flip(-2).cummin(
        dim=-2).values.flip(-2)
    d1 = torch.minimum(rows - above, below - rows)
    return torch.where(d1 >= none, _BIG, d1 * d1)


def _parabola_min(g2: torch.Tensor) -> torch.Tensor:
    """D2[..., i, j] = min_k g2[..., i, k] + (j - k)^2 (int32)."""
    W = g2.shape[-1]
    k = torch.arange(W, dtype=torch.int32, device=g2.device)
    sq = (k.view(W, 1) - k.view(1, W)) ** 2            # [j, k]
    rows = g2.reshape(-1, W)
    step = max(1, _CHUNK_ELEMS // (W * W))
    out = torch.cat([(rows[s:s + step, None, :] + sq).amin(dim=-1)
                     for s in range(0, rows.shape[0], step)])
    return out.view(g2.shape)


def edt(feature: torch.Tensor,
        valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Euclidean distance from each feature pixel to the nearest
    non-feature pixel of the domain.

    feature: bool (..., H, W), the nonzero pixels (scipy: distance at
    nonzero pixels to the nearest zero).  valid: optional bool of the same
    shape, the domain; pixels outside are ignored entirely.  Returns float32:
    0 outside the features, and 0 where the domain holds no zero (callers
    normalise by the max, so the all-feature case is handled upstream)."""
    H, W = feature.shape[-2:]
    if max(H, W) > _MAX_SIDE:
        raise ValueError(f"edt: side {max(H, W)} exceeds {_MAX_SIDE}")
    feature = feature.to(torch.bool)
    if valid is None:
        zero_cand, inside = ~feature, feature
    else:
        valid = valid.to(torch.bool)
        zero_cand, inside = ~feature & valid, feature & valid
    d2 = _parabola_min(_col_dist_sq(zero_cand))
    d = torch.sqrt(d2.to(torch.float32))
    return torch.where(inside & (d2 < _BIG), d, 0.0)
