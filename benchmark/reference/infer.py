"""Segmentation of uint16 frames with the plain network and the plain
distance method: what ``InferenceEngine.segment`` computes.

Each frame is normalised to [-1, 1] with its own minimum and maximum (a
constant frame gives 0).  Frames up to 8192 px take the bucket path: padded
up-left with -1 to the smallest tested shape (the reference's pad
buckets), one forward, the padding cropped off.  With tiling, frames with a
side above the tile are cut into tiles that overlap by at least
``overlap`` (the last tile right-aligned), and the tile predictions are
blended with a linear ramp from each tile's border (the normalised
weighted average in the overlaps).  The fields are then post-processed
with at most one seed per 256 px (256 at least, 32768 at most).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.postprocess import distance_masks
from benchmark.reference.unet import Net, Params

# the inference settings the reference follows; ``batch_size`` (frames a
# forward) changes no result
INFER_KEYS = ("batch_size", "use_tiling", "tile_size", "tile_overlap",
              "th_cell", "th_seed")

PAD_BUCKETS = (64, 128, 256, 320, 512, 768, 1024, 1280, 1408, 1600, 1920,
               2048, 2240, 2560, 3200, 4096, 4480, 6080, 8192)


def bucket(n: int) -> int:
    for b in PAD_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"side {n} beyond the pad buckets")


def normalise(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> float32 in [-1, 1] per frame."""
    x = x.to(torch.float32)
    mn = x.amin(dim=(1, 2), keepdim=True)
    mx = x.amax(dim=(1, 2), keepdim=True)
    d = mx - mn
    return torch.where(d > 0, 2.0 * (x - mn) / torch.where(d > 0, d, 1.0)
                       - 1.0, torch.zeros_like(x))


def tile_starts(size: int, tile: int, overlap: int) -> List[int]:
    if tile >= size:
        return [0]
    starts = list(range(0, size - tile, tile - overlap))
    return starts + [size - tile]


def feather(tile: int, device) -> torch.Tensor:
    r = torch.arange(tile, device=device)
    ramp = torch.minimum(r + 1, tile - r).to(torch.float32)
    w = torch.minimum(ramp[:, None], ramp[None, :])
    return w / w.max()


def max_seeds(h: int, w: int) -> int:
    return int(min(32768, max(256, (h * w) // 256)))


class Segmenter:
    """``segment(frames)`` for one configuration and one set of
    inference settings (``th_cell``, ``th_seed``, ``use_tiling``,
    ``tile_size``, ``tile_overlap``), on ``params``' device."""

    def __init__(self, cfg: dict, params: Params, infer: dict,
                 batch: int = 8):
        self.net = Net(cfg)
        self.p = params
        self.infer = infer
        self.batch = batch

    @torch.no_grad()
    def fields(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Normalised (B, h, w) inputs -> (border, cell), in batches."""
        outs = [self.net(self.p, x[i:i + self.batch, None])
                for i in range(0, x.shape[0], self.batch)]
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))

    def _bucket_fields(self, x):
        H, W = x.shape[1:]
        th, tw = bucket(H), bucket(W)
        xp = F.pad(x, (tw - W, 0, th - H, 0), value=-1.0)
        b, c = self.fields(xp)
        return b[:, th - H:, tw - W:], c[:, th - H:, tw - W:]

    def _positions(self, H: int, W: int):
        tile, overlap = self.infer["tile_size"], self.infer["tile_overlap"]
        ph, pw = max(tile - H, 0), max(tile - W, 0)
        pos = [(y, xx) for y in tile_starts(H + ph, tile, overlap)
               for xx in tile_starts(W + pw, tile, overlap)]
        return pos, ph, pw

    def stitch(self, fields, B: int, H: int, W: int):
        """Tile predictions (B * n_tiles, tile, tile), frame by frame in
        tile order, of each head -> stitched (B, H, W) fields."""
        tile = self.infer["tile_size"]
        pos, ph, pw = self._positions(H, W)
        w = feather(tile, fields[0].device)
        out = []
        for f in fields:
            f = f.reshape(B, len(pos), tile, tile)
            acc = torch.zeros((B, H + ph, W + pw), device=f.device)
            wacc = torch.zeros((H + ph, W + pw), device=f.device)
            for i, (y, xx) in enumerate(pos):
                acc[:, y:y + tile, xx:xx + tile] += f[:, i] * w
                wacc[y:y + tile, xx:xx + tile] += w
            out.append((acc / torch.clamp(wacc, min=1e-12))[:, :H, :W])
        return tuple(out)

    def _tiled_fields(self, x):
        tile = self.infer["tile_size"]
        B, H, W = x.shape
        pos, ph, pw = self._positions(H, W)
        x = F.pad(x, (0, pw, 0, ph), value=-1.0)
        tiles = torch.stack([x[:, y:y + tile, xx:xx + tile]
                             for y, xx in pos], 1).reshape(-1, tile, tile)
        return self.stitch(self.fields(tiles), B, H, W)

    def tiled(self, H: int, W: int) -> bool:
        return bool(self.infer.get("use_tiling")) and max(H, W) > \
            self.infer.get("tile_size", 512)

    def from_outputs(self, outs, T: int, H: int, W: int):
        """The fields of a stack from the network's own outputs, as the
        forward calls gave them ((border, cell), each (b, h, w, 1), in
        order): the bucket padding cropped off, or the tiles stitched."""
        b = torch.cat([o[0][..., 0] for o in outs]).float()
        c = torch.cat([o[1][..., 0] for o in outs]).float()
        if self.tiled(H, W):
            n = len(self._positions(H, W)[0])
            return self.stitch((b[:T * n], c[:T * n]), T, H, W)
        return b[:T, -H:, -W:], c[:T, -H:, -W:]

    def fields_of(self, frames: np.ndarray, device) -> Tuple[torch.Tensor,
                                                              torch.Tensor]:
        x = normalise(torch.from_numpy(
            np.asarray(frames).astype(np.float32)).to(device))
        if self.tiled(*x.shape[1:]):
            return self._tiled_fields(x)
        return self._bucket_fields(x)

    def masks(self, border: torch.Tensor, cell: torch.Tensor) -> np.ndarray:
        """(T, H, W) fields -> (T, H, W) uint16 masks."""
        H, W = border.shape[1:]
        post = max(1, (16 * 256 * 256) // (H * W))
        return np.concatenate([
            distance_masks(border[i:i + post], cell[i:i + post],
                           self.infer["th_cell"], self.infer["th_seed"],
                           max_seeds(H, W))
            for i in range(0, border.shape[0], post)])

