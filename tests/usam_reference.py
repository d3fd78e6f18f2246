"""The plain reference of muSAM's automatic instance segmentation for the
tests: SAM's windowed ViT encoder and torch_em's UNETR decoder in plain
float32 PyTorch, the normalisation, tiling and stitching, and torch_em's
seeded watershed with the plain flood the port runs on the CPU.  Nothing
of either package is imported; the benchmark keeps its own copy
(``benchmark/reference/micro_sam.py``, ``benchmark/reference/ais.py``,
with ``reference/postprocess.py``'s filter and floods), whose docstrings
give the sources (facebookresearch/segment-anything
``modeling/image_encoder.py``; constantpape/torch-em ``model/unetr.py``,
``util/segmentation.py``; computational-cell-analytics/micro-sam
``instance_segmentation.py``) and the departures.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

Params = Dict[str, torch.Tensor]
LN_EPS = 1e-6
NORM_EPS = 1e-5
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)
MAX_SEEDS = 65535
N_LEVELS = 128
_EIGHT = np.ones((3, 3), bool)


class Net:
    """The forward of one configuration (the family's ``model_config``)."""

    def __init__(self, cfg: dict, quant: Optional[Callable] = None):
        self.cfg = cfg
        self.q = quant

    def _ops(self, x, w):
        if self.q is None:
            return x, w
        return self.q(x, "input"), self.q(w, "weight")

    def linear(self, p: Params, name: str, x):
        x, w = self._ops(x, p[name + ".weight"])
        return x @ w.t() + p[name + ".bias"]

    def conv(self, p: Params, name: str, x, stride=1, padding=0):
        x, w = self._ops(x, p[name + ".weight"])
        return F.conv2d(x, w, p.get(name + ".bias"), stride=stride,
                        padding=padding)

    def conv_t(self, p: Params, name: str, x):
        x, w = self._ops(x, p[name + ".weight"])
        return F.conv_transpose2d(x, w, p[name + ".bias"], stride=2)

    @staticmethod
    def ln(p: Params, name: str, x):
        return F.layer_norm(x, x.shape[-1:], p[name + ".weight"],
                            p[name + ".bias"], LN_EPS)

    @staticmethod
    def ln2d(p: Params, name: str, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + LN_EPS)
        return p[name + ".weight"][:, None, None] * x \
            + p[name + ".bias"][:, None, None]

    @staticmethod
    def instance_norm(x):
        u = x.mean((2, 3), keepdim=True)
        s = (x - u).pow(2).mean((2, 3), keepdim=True)
        return (x - u) / torch.sqrt(s + NORM_EPS)

    @staticmethod
    def batch_norm(p: Params, name: str, x):
        a = p[name + ".weight"] / torch.sqrt(p[name + ".running_var"]
                                             + NORM_EPS)
        b = p[name + ".bias"] - p[name + ".running_mean"] * a
        return x * a[:, None, None] + b[:, None, None]

    # --- encoder ----------------------------------------------------------

    def attention(self, p: Params, pre: str, x):
        """x (B, g, g, D): the attention over its g x g tokens."""
        B, g, _, d = x.shape
        heads = self.cfg["num_heads"]
        hd = d // heads
        qkv = self.linear(p, pre + "qkv", x).reshape(B, g * g, 3, heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).reshape(
            3, B * heads, g * g, hd).unbind(0)
        attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
        r = torch.arange(g, device=x.device)
        idx = r[:, None] - r[None, :] + (g - 1)
        rh = p[pre + "rel_pos_h"][idx]
        rw = p[pre + "rel_pos_w"][idx]
        r_q = q.reshape(B * heads, g, g, hd)
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
        attn = (attn.view(B * heads, g, g, g, g) + rel_h[:, :, :, :, None]
                + rel_w[:, :, :, None, :]).view(B * heads, g * g, g * g)
        x = (attn.softmax(dim=-1) @ v).view(B, heads, g, g, hd)
        x = x.permute(0, 2, 3, 1, 4).reshape(B, g, g, d)
        return self.linear(p, pre + "proj", x)

    def windowed(self, p: Params, pre: str, x, ws: int):
        """SAM's window_partition, the attention, window_unpartition."""
        B, g, _, d = x.shape
        n = -(-g // ws)
        x = F.pad(x, (0, 0, 0, n * ws - g, 0, n * ws - g))
        x = x.view(B, n, ws, n, ws, d).permute(0, 1, 3, 2, 4, 5).reshape(
            B * n * n, ws, ws, d)
        x = self.attention(p, pre, x)
        x = x.view(B, n, n, ws, ws, d).permute(0, 1, 3, 2, 4, 5).reshape(
            B, n * ws, n * ws, d)
        return x[:, :g, :g]

    def encoder(self, p: Params, x):
        cfg = self.cfg
        e = "image_encoder."
        x = self.conv(p, e + "patch_embed.proj", x, stride=cfg["patch_size"])
        x = x.permute(0, 2, 3, 1) + p[e + "pos_embed"]
        for i in range(cfg["depth"]):
            pre = f"{e}blocks.{i}."
            h = self.ln(p, pre + "norm1", x)
            ws = cfg["window_size"]
            if ws and i not in cfg["global_attn_indexes"]:
                x = x + self.windowed(p, pre + "attn.", h, ws)
            else:
                x = x + self.attention(p, pre + "attn.", h)
            h = self.ln(p, pre + "norm2", x)
            x = x + self.linear(p, pre + "mlp.lin2", F.gelu(
                self.linear(p, pre + "mlp.lin1", h)))
        x = x.permute(0, 3, 1, 2)
        x = self.ln2d(p, e + "neck.1", self.conv(p, e + "neck.0", x))
        return self.ln2d(p, e + "neck.3",
                         self.conv(p, e + "neck.2", x, padding=1))

    # --- decoder ----------------------------------------------------------

    def deconv_block(self, p: Params, name: str, x):
        x = self.conv_t(p, name + "block.0.block", x)
        x = self.conv(p, name + "block.1.block", x, padding=1)
        return torch.relu(self.batch_norm(p, name + "block.2", x))

    def conv_block(self, p: Params, name: str, x):
        x = torch.relu(self.conv(p, name + "block.1", self.instance_norm(x),
                                 padding=1))
        return torch.relu(self.conv(p, name + "block.4",
                                    self.instance_norm(x), padding=1))

    @torch.no_grad()
    def __call__(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        z = self.encoder(p, x)
        z9 = self.deconv_block(p, "deconv1.", z)
        z6 = self.deconv_block(p, "deconv2.", z9)
        z3 = self.deconv_block(p, "deconv3.", z6)
        z0 = self.deconv_block(p, "deconv4.", z3)
        y = self.conv_block(p, "base.", z)
        for lvl, skip in enumerate((z9, z6, z3)):
            y = self.conv_t(p, f"decoder.samplers.{lvl}.block", y)
            y = self.conv_block(p, f"decoder.blocks.{lvl}.",
                                torch.cat([y, skip], dim=1))
        y = self.conv_t(p, "deconv_out.block", y)
        y = self.conv_block(p, "decoder_head.", torch.cat([y, z0], dim=1))
        return torch.sigmoid(self.conv(p, "out_conv", y))


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


def gaussian(x: torch.Tensor, sigma: float = 0.5,
             truncate: float = 4.0) -> torch.Tensor:
    """scipy.ndimage.gaussian_filter of the last two axes (mode 'reflect',
    which repeats the edge sample), the taps summed in order, the third on
    as multiply-adds: the port's arithmetic, so that a seed threshold
    falls on the same side."""
    radius = int(truncate * sigma + 0.5)
    t = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=x.device)
    k = torch.exp(-0.5 / (sigma * sigma) * t * t)
    k = k / torch.sum(k)
    for dim in (x.ndim - 2, x.ndim - 1):
        n = x.shape[dim]
        idx = torch.remainder(torch.arange(-radius, n + radius,
                                           device=x.device), 2 * n)
        idx = torch.where(idx >= n, 2 * n - 1 - idx, idx)
        xp = torch.index_select(x, dim, idx)
        out = torch.zeros_like(x)
        for i in range(2 * radius + 1):
            tap = xp.narrow(dim, i, n)
            out = (out + k[i] * tap if i < 2
                   else torch.addcmul(out, k[i].expand_as(tap), tap))
        x = out
    return x


def _levels(value: torch.Tensor, mask: torch.Tensor,
            n_levels: int) -> torch.Tensor:
    big = torch.tensor(3.0e38, dtype=torch.float32, device=value.device)
    vmin = torch.where(mask, value, big).amin(dim=(1, 2), keepdim=True)
    vmax = torch.where(mask, value, -big).amax(dim=(1, 2), keepdim=True)
    span = torch.clamp(vmax - vmin, min=1e-20)
    t = (value - vmin) / span * (n_levels - 1)
    t = torch.where(mask, t, torch.zeros_like(t))
    return torch.clamp(t.to(torch.int32), 0, n_levels - 1)


_SHIFTS = ((-1, 0), (1, 0), (0, -1), (0, 1))


def _value_step(labels, value, active):
    """Unlabelled active pixels take the label of the lowest-valued
    labelled active 4-neighbour (the first in ``_SHIFTS`` on ties)."""
    H, W = labels.shape[-2:]
    big = 3.0e38
    pl = F.pad(labels, (1, 1, 1, 1), value=0)
    pv = F.pad(value, (1, 1, 1, 1), value=big)
    pa = F.pad(active.to(torch.uint8), (1, 1, 1, 1), value=0).bool()
    best_v = torch.full_like(value, big)
    best_l = torch.zeros_like(labels)
    for dy, dx in _SHIFTS:
        sl = (slice(None), slice(1 + dy, 1 + dy + H), slice(1 + dx, 1 + dx + W))
        cand = torch.where((pl[sl] > 0) & pa[sl], pv[sl],
                           torch.full_like(value, big))
        take = cand < best_v
        best_v = torch.where(take, cand, best_v)
        best_l = torch.where(take, pl[sl], best_l)
    grow = (labels == 0) & active & (best_v < big)
    return torch.where(grow, best_l, labels)


def value_flood(value, markers, mask, n_levels: int) -> torch.Tensor:
    """The flood the port runs on the CPU: the same levels, but within a
    level the lower-valued neighbour wins, not the lower label."""
    q = _levels(value, mask, n_levels)
    labels = torch.where(mask, markers, 0)
    for lvl in range(n_levels):
        active = mask & (q <= lvl)
        for _ in range(2):
            labels = _value_step(labels, value, active)
    while True:
        new = _value_step(labels, value, mask)
        if torch.equal(new, labels):
            break
        labels = new
    return labels


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
    labels = value_flood(boundary, seeds, mask, N_LEVELS)
    labels = labels.numpy().astype(np.int64)
    return np.stack([size_filter(m, infer["min_size"])
                     for m in labels]).astype(np.uint16)


class Segmenter:
    """``segment(frames)`` with muSAM for one configuration (the family's
    ``model_config``) and one set of inference settings."""

    def __init__(self, cfg: dict, params: Params, infer: dict,
                 batch: int = 4, quant=None):
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
