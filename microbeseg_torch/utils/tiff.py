"""TIFF I/O on Pillow (single- and multi-frame grayscale or RGB).

Pillow is imported inside the functions: the package imports on machines
without it, and only TIFF reading and writing need it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np

_MODE_FOR_DTYPE = {
    np.dtype(np.uint8): "L",
    np.dtype(np.uint16): "I;16",
    np.dtype(np.int32): "I",
    np.dtype(np.float32): "F",
}


def _pil():
    from PIL import Image
    # microscopy stacks can be large
    Image.MAX_IMAGE_PIXELS = None
    return Image


def imread(path: Union[str, Path]) -> np.ndarray:
    """Read a (multi-frame) grayscale or RGB TIFF into a numpy array.

    Returns HxW for single-frame grayscale, TxHxW for stacks, HxWx3 for RGB.
    """
    with _pil().open(str(path)) as im:
        n = getattr(im, "n_frames", 1)
        frames = []
        for i in range(n):
            im.seek(i)
            frames.append(np.asarray(_promote(im)))
    if len(frames) == 1:
        return frames[0]
    return np.stack(frames, axis=0)


def imread_page(path: Union[str, Path], page: int) -> np.ndarray:
    """Read ONE page of a (multi-frame) TIFF without decoding the rest."""
    with _pil().open(str(path)) as im:
        n = getattr(im, "n_frames", 1)
        if not 0 <= page < n:
            raise IndexError(f"page {page} out of range (n_frames={n})")
        im.seek(page)
        return np.asarray(_promote(im))


def _promote(im):
    """Normalize PIL modes so np.asarray yields the expected dtype."""
    if im.mode in ("L", "I;16", "I", "F", "RGB"):
        return im
    if im.mode in ("I;16B", "I;16L", "I;16N"):
        return im.convert("I")
    if im.mode in ("P", "RGBA"):
        return im.convert("RGB")
    if im.mode == "1":
        return im.convert("L")
    return im


def imwrite(path: Union[str, Path], arr: np.ndarray) -> None:
    """Write a numpy array as a TIFF. 2D -> single frame; 3D (T,H,W) -> stack."""
    arr = np.asarray(arr)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    if arr.dtype == np.int64:
        arr = arr.astype(np.int32)
    if arr.dtype == bool:
        arr = arr.astype(np.uint8)
    path = str(path)

    rgb = arr.shape[-1] == 3 and arr.ndim in (3, 4)
    if rgb and arr.dtype != np.uint8:
        raise ValueError(
            f"RGB TIFF write requires uint8, got {arr.dtype} {arr.shape}")
    if arr.ndim == 2 or (arr.ndim == 3 and rgb):
        _frame_to_pil(arr).save(path, format="TIFF")
        return
    if arr.ndim == 3 or (arr.ndim == 4 and rgb):
        frames = [_frame_to_pil(f) for f in arr]
        frames[0].save(path, format="TIFF", save_all=True,
                       append_images=frames[1:])
        return
    raise ValueError(f"unsupported array shape for TIFF write: {arr.shape}")


def _frame_to_pil(frame: np.ndarray):
    Image = _pil()
    if frame.ndim == 3 and frame.shape[-1] == 3:
        return Image.fromarray(frame, mode="RGB")
    mode = _MODE_FOR_DTYPE.get(frame.dtype)
    if mode is None:
        raise ValueError(f"unsupported dtype for TIFF write: {frame.dtype}")
    if mode == "I;16":
        im = Image.new("I;16", (frame.shape[1], frame.shape[0]))
        im.frombytes(frame.astype("<u2").tobytes())
        return im
    return Image.fromarray(frame, mode=mode)
