"""Host-side image utilities: min/max normalization, bucket padding, the
border correction of masks before scoring, and numbered file names."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from microbeseg_torch.config import PAD_BUCKETS


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
