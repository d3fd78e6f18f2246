"""Host-side image utilities: instance ids, min/max normalization, bucket
padding, the border correction of masks before scoring, and numbered file
names."""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from microbeseg_torch.config import PAD_BUCKETS


def get_nucleus_ids(img: np.ndarray) -> np.ndarray:
    """Instance ids (> 0) present in an intensity-coded label image."""
    values = np.unique(img)
    return values[values > 0]


def min_max_normalization(img: np.ndarray,
                          min_value: Optional[float] = None,
                          max_value: Optional[float] = None) -> np.ndarray:
    """Clip to [min, max] then scale to [-1, 1] (float32)."""
    if max_value is None:
        max_value = img.max()
    if min_value is None:
        min_value = img.min()
    img = np.clip(img, min_value, max_value)
    denom = float(max_value) - float(min_value)
    if denom == 0:
        return np.zeros_like(img, dtype=np.float32)
    img = 2.0 * (img.astype(np.float32) - min_value) / denom - 1.0
    return img.astype(np.float32)


def pad_bucket_shape(h: int, w: int) -> Tuple[int, int]:
    """Smallest tested bucket shape covering (h, w).

    Raises ValueError if either side exceeds the largest bucket."""
    out = []
    for s in (h, w):
        for b in PAD_BUCKETS:
            if s <= b:
                out.append(b)
                break
        else:
            raise ValueError(
                f"side {s} exceeds the largest pad bucket {PAD_BUCKETS[-1]}; "
                "use tiled inference (InferConfig.use_tiling=True)")
    return out[0], out[1]


def zero_pad_model_input(img: np.ndarray, pad_val: float = 0
                         ) -> Tuple[np.ndarray, List[int]]:
    """Pad up and left to the next bucket shape; returns (padded, [pad_y,
    pad_x]).  The image sits at the bottom right of the padded frame and
    comes back as ``padded[..., pad_y:, pad_x:]``.  A (T, H, W) stack pads
    H and W and returns the pads in the same order."""
    th, tw = pad_bucket_shape(img.shape[-2], img.shape[-1])
    pads = [th - img.shape[-2], tw - img.shape[-1]]
    widths = [(0, 0)] * (img.ndim - 2) + [(pads[0], 0), (pads[1], 0)]
    padded = np.pad(img, widths, mode="constant", constant_values=pad_val)
    return padded, pads


def border_correction(mask: np.ndarray, border_width: int = 10) -> np.ndarray:
    """Drop instances absent from the inset field of interest before scoring."""
    mask = np.asarray(mask)
    foi = mask[border_width:mask.shape[0] - border_width,
               border_width:mask.shape[1] - border_width]
    keep = np.unique(foi)
    out = np.where(np.isin(mask, keep), mask, 0)
    return out.astype(mask.dtype)


def unique_path(directory: Path, name_pattern: str) -> Path:
    """First non-existing ``directory / name_pattern.format(counter)``,
    counting from 1."""
    counter = 0
    while True:
        counter += 1
        path = Path(directory) / name_pattern.format(counter)
        if not path.exists():
            return path
