"""muSAM's automatic instance segmentation of uint16 frames in plain
PyTorch, NumPy and SciPy: what ``InferenceEngine.segment`` computes with
``label_type="ais"``.

Normalisation (micro-sam ``_to_image`` through torch_em's ``normalize``):
each frame (x - min) / (max - min + 1e-7), times 255, cut to an integer
as a cast to uint8 cuts it; the channel replicated to three and
standardised with SAM's pixel mean (123.675, 116.28, 103.53) and std
(58.395, 57.12, 57.375).  Tiling: tiles of the network's input size that
overlap by at least ``tile_overlap`` (the last tile right-aligned; a frame
smaller than a tile padded with 0 after the standardisation, as SAM pads),
the three fields of the tiles blended with the feathered weights of
``reference/infer.py`` (micro-sam crops halos instead: a departure the
configuration file lists).

Post-processing (torch_em ``watershed_from_center_and_boundary_distances``
as micro-sam's ``InstanceSegmentationWithDecoder.generate`` calls it):
the foreground smoothed with a Gaussian of std ``foreground_smoothing``,
both distances with std ``distance_smoothing`` (``reference/
postprocess.gaussian``: scipy's filter, radius int(4 sigma + 0.5), where
vigra's window differs); the mask foreground > ``foreground_threshold``;
the seeds the 8-connected components (SciPy) of both distances below
their thresholds inside the mask, numbered in raster order of their last
pixel, at most 65,535; the seeds flood the smoothed boundary distance
inside the mask with the quantised marker flood of
``reference/postprocess.py`` (128 levels, 24-bit labels; the plain flood
by value on the CPU, where the port floods by value), where torch_em calls
skimage's exact watershed; segments under ``min_size`` pixels removed and
the rest numbered 1..n in order.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

from benchmark.reference.infer import feather, tile_starts
from benchmark.reference.micro_sam import Net, Params
from benchmark.reference.postprocess import (gaussian, label_bits,
                                             marker_flood, value_flood)

# the inference settings the reference follows; ``batch_size`` (tiles a
# forward) changes no result
INFER_KEYS = ("batch_size", "use_tiling", "tile_size", "tile_overlap",
              "center_distance_threshold", "boundary_distance_threshold",
              "foreground_threshold", "foreground_smoothing",
              "distance_smoothing", "min_size")
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)
MAX_SEEDS = 65535
N_LEVELS = 128
_EIGHT = np.ones((3, 3), bool)


def to_image(x: torch.Tensor) -> torch.Tensor:
    """(T, H, W) -> float32 whole numbers 0..255 per frame."""
    x = x.to(torch.float32)
    mn = x.amin(dim=(1, 2), keepdim=True)
    mx = x.amax(dim=(1, 2), keepdim=True)
    return torch.floor((x - mn) / (mx - mn + 1e-7) * 255.0)


def standardise(img: torch.Tensor) -> torch.Tensor:
    """(n, H, W) on 0..255 -> (n, 3, H, W) SAM inputs."""
    mean = torch.tensor(PIXEL_MEAN, device=img.device).view(1, 3, 1, 1)
    std = torch.tensor(PIXEL_STD, device=img.device).view(1, 3, 1, 1)
    return (img[:, None] - mean) / std


def seed_labels(seeds_bin: np.ndarray) -> np.ndarray:
    """(H, W) bool -> int32 8-connected components numbered in raster
    order of their last pixel (SciPy numbers by the first pixel: on the
    image turned by 180 degrees that is the last), those past MAX_SEEDS
    dropped."""
    lab, n = ndimage.label(seeds_bin[::-1, ::-1], structure=_EIGHT)
    rank = np.where(lab > 0, n + 1 - lab, 0)[::-1, ::-1]
    return np.where(rank > MAX_SEEDS, 0, rank).astype(np.int32)


def size_filter(labels: np.ndarray, min_size: int) -> np.ndarray:
    """Segments under ``min_size`` pixels set to 0, the rest numbered 1..n
    in the order of their labels."""
    if min_size <= 0:
        return labels
    sizes = np.bincount(labels.ravel())
    keep = sizes >= min_size
    keep[0] = False
    table = np.where(keep, np.cumsum(keep), 0)
    return table[labels]


def ais_masks(fields: torch.Tensor, infer: dict) -> np.ndarray:
    """(T, 3, H, W) fields (foreground, centre, boundary distance) -> (T,
    H, W) uint16 masks."""
    f = fields.to(torch.float32)
    fg = f[:, 0]
    if infer["foreground_smoothing"] > 0:
        fg = gaussian(fg, infer["foreground_smoothing"])
    center = gaussian(f[:, 1], infer["distance_smoothing"])
    boundary = gaussian(f[:, 2], infer["distance_smoothing"])
    mask = fg > infer["foreground_threshold"]
    seeds_bin = ((center < infer["center_distance_threshold"])
                 & (boundary < infer["boundary_distance_threshold"])
                 & mask).cpu().numpy()
    seeds = torch.from_numpy(np.stack([seed_labels(s) for s in seeds_bin])
                             ).to(f.device)
    if f.device.type == "cpu":
        labels = value_flood(boundary, seeds, mask, N_LEVELS)
    else:
        labels = marker_flood(boundary, seeds, mask, N_LEVELS,
                              label_bits(max(f.shape[-2:]), MAX_SEEDS))
    labels = labels.cpu().numpy().astype(np.int64)
    return np.stack([size_filter(m, infer["min_size"])
                     for m in labels]).astype(np.uint16)


class Segmenter:
    """``segment(frames)`` with muSAM for one configuration (the family's
    ``model_config``) and one set of inference settings."""

    def __init__(self, cfg: dict, params: Params, infer: dict,
                 batch: int = 2, quant=None):
        self.net = Net(cfg, quant)
        self.cfg, self.p, self.infer, self.batch = cfg, params, infer, batch
        self.tile = cfg["img_size"]

    def _positions(self, H: int, W: int):
        t, o = self.tile, self.infer["tile_overlap"]
        ph, pw = max(t - H, 0), max(t - W, 0)
        pos = [(y, x) for y in tile_starts(H + ph, t, o)
               for x in tile_starts(W + pw, t, o)]
        return pos, ph, pw

    @torch.no_grad()
    def net_fields(self, tiles: torch.Tensor) -> torch.Tensor:
        """(n, 3, t, t) SAM inputs -> (n, 3, t, t) fields, in batches."""
        return torch.cat([self.net(self.p, tiles[i:i + self.batch])
                          for i in range(0, tiles.shape[0], self.batch)])

    def stitch(self, fields: torch.Tensor, B: int, H: int, W: int
               ) -> torch.Tensor:
        """(B * n, 3, t, t) tile fields, frame by frame in tile order ->
        (B, 3, H, W)."""
        t = self.tile
        pos, ph, pw = self._positions(H, W)
        w = feather(t, fields.device)
        f = fields.float().reshape(B, len(pos), 3, t, t)
        acc = torch.zeros((B, 3, H + ph, W + pw), device=fields.device)
        wacc = torch.zeros((H + ph, W + pw), device=fields.device)
        for i, (y, x) in enumerate(pos):
            acc[:, :, y:y + t, x:x + t] += f[:, i] * w
            wacc[y:y + t, x:x + t] += w
        return (acc / torch.clamp(wacc, min=1e-12))[:, :, :H, :W]

    def fields_of(self, frames: np.ndarray, device) -> torch.Tensor:
        """(T, H, W) raw frames -> (T, 3, H, W) stitched fields."""
        frames = np.asarray(frames)
        T, H, W = frames.shape
        t = self.tile
        pos, ph, pw = self._positions(H, W)
        x = standardise(to_image(torch.from_numpy(
            frames.astype(np.float32)).to(device)))
        x = F.pad(x, (0, pw, 0, ph), value=0.0)
        tiles = torch.stack([x[:, :, y:y + t, xx:xx + t] for y, xx in pos],
                            1).reshape(-1, 3, t, t)
        return self.stitch(self.net_fields(tiles), T, H, W)

    def from_outputs(self, outs, T: int, H: int, W: int) -> torch.Tensor:
        """The stitched (T, 3, H, W) fields of a stack from the network's
        own outputs ((b, 3, t, t) each, in order)."""
        f = torch.cat([o.float() for o in outs])
        n = len(self._positions(H, W)[0])
        return self.stitch(f[:T * n], T, H, W)

    def masks(self, fields: torch.Tensor) -> List[np.ndarray]:
        """(T, 3, H, W) fields -> T (H, W) uint16 masks, two frames a
        post-processing batch."""
        return [m for i in range(0, fields.shape[0], 2)
                for m in ais_masks(fields[i:i + 2], self.infer)]
