"""Binary and grayscale morphology on tensors.

Port of ``microbeseg_tpu/ops/morphology.py``, the ``scipy.ndimage``
morphology of label generation (reference:
src/training/train_data_representations.py:54-68, 94, 120, 149-152, 340,
359).  Border semantics are scipy's defaults: binary operations treat the
outside of the image as 0 (``border_value=0``); the grayscale closing pads
symmetrically ('reflect' in scipy's terms).

A binary dilation or erosion is one window count: a convolution of the 0/1
image with the structuring element, zero-padded, gives how many of the
footprint's pixels are set, and the dilation is ``count > 0``, the erosion
``count == footprint size``.  The counts are compared with half a pixel of
margin, so a convolution algorithm that rounds (Winograd, FFT) cannot flip
them.
The grayscale closing is a 3x3 max pool then a min pool.  Every function
takes (H, W) or (..., H, W) tensors; the structuring element applies to the
last two axes.  Structuring elements are boolean numpy arrays; ``disk(r)``
matches ``skimage.morphology.disk``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def disk(radius: int) -> np.ndarray:
    """Boolean disk structuring element (skimage.morphology.disk parity)."""
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    return (x * x + y * y) <= radius * radius


def generate_binary_structure(rank: int = 2,
                              connectivity: int = 1) -> np.ndarray:
    """scipy.ndimage.generate_binary_structure for rank 2."""
    if rank != 2:
        raise ValueError(f"only rank 2 is supported, got {rank}")
    if connectivity == 1:
        return np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=bool)
    return np.ones((3, 3), dtype=bool)


def _as_images(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (N, 1, H, W) float32."""
    return x.reshape(-1, 1, *x.shape[-2:]).to(torch.float32)


def _window_count(x: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    """Number of set pixels of ``x`` under the footprint ``se`` centred on
    each pixel, the outside counting as 0: (..., H, W) -> float32."""
    se = np.asarray(se, dtype=bool)
    kh, kw = se.shape
    weight = torch.from_numpy(se.astype(np.float32)).to(x.device)
    count = F.conv2d(_as_images(x.to(torch.bool)), weight.view(1, 1, kh, kw),
                     padding=(kh // 2, kw // 2))
    return count.view(x.shape)


def binary_dilation(x: torch.Tensor,
                    se: Optional[np.ndarray] = None) -> torch.Tensor:
    if se is None:
        se = generate_binary_structure(2, 1)
    return _window_count(x, se) > 0.5


def binary_erosion(x: torch.Tensor,
                   se: Optional[np.ndarray] = None) -> torch.Tensor:
    if se is None:
        se = generate_binary_structure(2, 1)
    return _window_count(x, se) > float(np.count_nonzero(se)) - 0.5


def binary_closing(x: torch.Tensor,
                   se: Optional[np.ndarray] = None) -> torch.Tensor:
    """Dilation then erosion, scipy border semantics (outside = 0)."""
    return binary_erosion(binary_dilation(x, se), se)


def binary_opening(x: torch.Tensor,
                   se: Optional[np.ndarray] = None) -> torch.Tensor:
    return binary_dilation(binary_erosion(x, se), se)


def grey_closing(x: torch.Tensor,
                 size: Tuple[int, int] = (3, 3)) -> torch.Tensor:
    """Grayscale closing (max filter then min filter), symmetric boundary:
    scipy.ndimage.grey_closing(x, size=(3, 3)) as used on the
    neighbour-distance label (reference: train_data_representations.py:359).
    A symmetric pad of one pixel repeats the edge, so 3x3 windows pad with
    'replicate'."""
    if tuple(size) != (3, 3):
        raise ValueError(f"only size (3, 3) is supported, got {size}")
    img = _as_images(x)
    dil = F.max_pool2d(F.pad(img, (1, 1, 1, 1), mode="replicate"), 3, 1)
    out = -F.max_pool2d(F.pad(-dil, (1, 1, 1, 1), mode="replicate"), 3, 1)
    return out.view(x.shape).to(x.dtype)
