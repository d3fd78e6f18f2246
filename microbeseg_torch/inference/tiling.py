"""Sliding-window tiled inference with halo overlap and feathered stitching.

Port of ``microbeseg_tpu/inference/tiling.py``: the frame is cut into
overlapping tiles, the tiles are batched through the network, and the
continuous predictions are blended back with linear-ramp weights in the
overlaps; instance extraction then runs once on the stitched maps, so no
instance ids have to be reconciled across tiles.  Tiles are cut and stitched
on the tensors' device by slicing, with no host round trip.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def tile_positions(size: int, tile: int, overlap: int) -> List[int]:
    """Start offsets covering [0, size) with ``tile``-sized windows that
    overlap by at least ``overlap`` (the last tile is right-aligned)."""
    if tile >= size:
        return [0]
    stride = tile - overlap
    starts = list(range(0, size - tile, stride))
    starts.append(size - tile)
    return starts


def extract_tiles(img: np.ndarray, tile: int, overlap: int
                  ) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """img (H, W) -> (n_tiles, tile, tile) plus (y, x) start positions.
    The image must be at least ``tile`` in both dimensions."""
    H, W = img.shape[:2]
    pos = [(y, x) for y in tile_positions(H, tile, overlap)
           for x in tile_positions(W, tile, overlap)]
    return np.stack([img[y:y + tile, x:x + tile] for y, x in pos]), pos


def extract_tiles_device(frames: torch.Tensor, tile: int,
                         pos: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """(B, H, W) frames -> (B, n_tiles, tile, tile), cut on the device."""
    return torch.stack([frames[:, y:y + tile, x:x + tile] for y, x in pos],
                       dim=1)


def _feather_weight(tile: int) -> np.ndarray:
    """2D feathering weight: linear ramp from the tile border inward."""
    ramp = np.minimum(np.arange(tile) + 1, np.arange(tile)[::-1] + 1)
    ramp = ramp.astype(np.float32)
    w = np.minimum.outer(ramp, ramp)
    return w / w.max()


def stitch_predictions(tiles: np.ndarray, pos: Sequence[Tuple[int, int]],
                       out_shape: Tuple[int, int]) -> np.ndarray:
    """Blend (n, tile, tile) prediction tiles into (H, W) with feathered
    weights (normalised weighted average in overlaps).  Host-side numpy
    reference that ``stitch_tiles_device`` is tested against."""
    H, W = out_shape
    tile = tiles.shape[1]
    acc = np.zeros((H, W), np.float64)
    wacc = np.zeros((H, W), np.float64)
    w = _feather_weight(tile)
    for t, (y, x) in zip(tiles, pos):
        acc[y:y + tile, x:x + tile] += t.astype(np.float64) * w
        wacc[y:y + tile, x:x + tile] += w
    return (acc / np.maximum(wacc, 1e-12)).astype(np.float32)


def stitch_tiles_device(tiles: torch.Tensor,
                        pos: Sequence[Tuple[int, int]],
                        out_shape: Tuple[int, int]) -> torch.Tensor:
    """Stitch a (B, n_tiles, tile, tile) batch into (B, H, W) float32 on
    the tiles' device: each tile is weighted and added into its rectangle
    of the output, tile by tile in order, and the sum is divided by the
    accumulated weights (the same field for every image of the batch)."""
    H, W = out_shape
    B, _, tile, _ = tiles.shape
    weight = torch.from_numpy(_feather_weight(tile)).to(tiles.device)
    acc = torch.zeros((B, H, W), dtype=torch.float32, device=tiles.device)
    wacc = torch.zeros((H, W), dtype=torch.float32, device=tiles.device)
    for i, (y, x) in enumerate(pos):
        acc[:, y:y + tile, x:x + tile] += tiles[:, i].to(torch.float32) * weight
        wacc[y:y + tile, x:x + tile] += weight
    return acc / torch.clamp(wacc, min=1e-12)


def stitch_predictions_batch(tiles: np.ndarray,
                             pos: Sequence[Tuple[int, int]],
                             out_shape: Tuple[int, int],
                             device=None) -> np.ndarray:
    """Host-array wrapper around ``stitch_tiles_device``; runs on the CUDA
    card unless ``device`` says otherwise."""
    from microbeseg_torch.utils.device import resolve_device
    dev = resolve_device(device)
    return stitch_tiles_device(torch.as_tensor(tiles, device=dev), pos,
                               out_shape).cpu().numpy()
