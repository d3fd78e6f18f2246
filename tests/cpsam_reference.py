"""The plain reference of Cellpose-SAM for the tests: its forward and
Cellpose's flow dynamics in plain float32 PyTorch, NumPy and SciPy, and the
segmentation of frames with both.  Nothing of either package is imported;
the benchmark keeps its own copy (``benchmark/reference/cellpose_sam.py``
and ``benchmark/reference/flows.py``), whose docstrings give the sources
(MouseLand/cellpose release 4: ``cellpose/vit_sam.py``,
``cellpose/dynamics.py``; facebookresearch/segment-anything
``segment_anything/modeling/image_encoder.py``) and the departures.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

Params = Dict[str, torch.Tensor]
EPS = 1e-6


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

    @staticmethod
    def ln(p: Params, name: str, x):
        return F.layer_norm(x, x.shape[-1:], p[name + ".weight"],
                            p[name + ".bias"], EPS)

    @staticmethod
    def ln2d(p: Params, name: str, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + EPS)
        return p[name + ".weight"][:, None, None] * x \
            + p[name + ".bias"][:, None, None]

    def attention(self, p: Params, pre: str, x):
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

    @torch.no_grad()
    def __call__(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        ps = cfg["patch_size"]
        x = self.conv(p, "encoder.patch_embed.proj", x, stride=ps)
        x = x.permute(0, 2, 3, 1) + p["encoder.pos_embed"]
        for i in range(cfg["depth"]):
            pre = f"encoder.blocks.{i}."
            x = x + self.attention(p, pre + "attn.",
                                   self.ln(p, pre + "norm1", x))
            h = self.ln(p, pre + "norm2", x)
            x = x + self.linear(p, pre + "mlp.lin2", F.gelu(
                self.linear(p, pre + "mlp.lin1", h)))
        x = x.permute(0, 3, 1, 2)
        x = self.ln2d(p, "encoder.neck.1", self.conv(p, "encoder.neck.0", x))
        x = self.ln2d(p, "encoder.neck.3",
                      self.conv(p, "encoder.neck.2", x, padding=1))
        x = self.conv(p, "out", x)
        n = cfg["nout"]
        w2 = torch.eye(n * ps * ps, device=x.device).reshape(
            n * ps * ps, n, ps, ps)
        return F.conv_transpose2d(x, w2, stride=ps)

def tile_starts(size: int, tile: int, overlap: int) -> List[int]:
    if tile >= size:
        return [0]
    return list(range(0, size - tile, tile - overlap)) + [size - tile]


def feather(tile: int, device) -> torch.Tensor:
    r = torch.arange(tile, device=device)
    ramp = torch.minimum(r + 1, tile - r).to(torch.float32)
    w = torch.minimum(ramp[:, None], ramp[None, :])
    return w / w.max()


RPAD = 20
def steps_interp(dP: torch.Tensor, inds, niter: int) -> np.ndarray:
    """Cellpose's Euler steps: (2, H, W) masked flows (already dP * fg / 5)
    and the (ys, xs) of the points -> (2, n) int end points (y, x)."""
    shape = dP.shape[1:]
    dev = dP.device
    pt = torch.zeros((1, 1, len(inds[0]), 2), dtype=torch.float32,
                     device=dev)
    im = torch.zeros((1, 2, *shape), dtype=torch.float32, device=dev)
    for n in range(2):
        pt[0, 0, :, 1 - n] = torch.from_numpy(inds[n]).to(dev, torch.float32)
        im[0, 1 - n] = dP[n]
    size = np.array(shape)[::-1].astype("float") - 1
    for k in range(2):
        im[:, k] *= 2. / size[k]
        pt[..., k] /= size[k]
    pt *= 2
    pt -= 1
    for _ in range(niter):
        d = F.grid_sample(im, pt, align_corners=False)
        for k in range(2):
            pt[..., k] = torch.clamp(pt[..., k] + d[:, k], -1., 1.)
    pt += 1
    pt *= 0.5
    for k in range(2):
        pt[..., k] *= size[k]
    return pt[0, 0][:, [1, 0]].T.int().cpu().numpy()


def renumber(m: np.ndarray) -> np.ndarray:
    """Labels 1..n in order of first appearance in raster order, 0 kept."""
    uniq, first = np.unique(m.ravel(), return_index=True)
    keep = uniq != 0
    uniq, first = uniq[keep], first[keep]
    lut = np.zeros(int(m.max()) + 1 if m.size else 1, np.int64)
    lut[uniq[np.argsort(first)]] = np.arange(1, len(uniq) + 1)
    return lut[m]


def get_masks(pt: np.ndarray, inds, shape0, max_size_fraction: float,
              device="cpu") -> np.ndarray:
    """``get_masks_torch``: the histogram and its seeds' growth in torch on
    ``device``, all seeds' 11 x 11 windows at once; the regions written
    seed after seed."""
    H, W = shape0
    pt = pt.astype(np.int64) + RPAD
    pt = np.clip(pt, 0, None)
    pt[0] = np.minimum(pt[0], H + RPAD - 1)
    pt[1] = np.minimum(pt[1], W + RPAD - 1)
    shape = (H + 2 * RPAD, W + 2 * RPAD)
    h1 = torch.zeros(shape, dtype=torch.float32, device=device)
    h1.index_put_(tuple(torch.from_numpy(pt).to(device)),
                  torch.ones(pt.shape[1], device=device), accumulate=True)
    hmax1 = F.max_pool2d(h1[None], 5, stride=1, padding=2)[0]
    seeds = torch.nonzero((h1 - hmax1 > -1e-6) & (h1 > 10))
    if len(seeds) == 0:
        return np.zeros(shape0, np.int64)
    seeds = seeds[torch.argsort(h1[tuple(seeds.T)], stable=True)]
    off = torch.arange(-5, 6, device=device)
    h_slc = h1[seeds[:, 0, None, None] + off[None, :, None],
               seeds[:, 1, None, None] + off[None, None, :]]
    seed_masks = torch.zeros_like(h_slc)
    seed_masks[:, 5, 5] = 1
    for _ in range(5):
        seed_masks = F.max_pool2d(seed_masks, 3, stride=1, padding=1)
        seed_masks *= h_slc > 2
    sm = seed_masks.cpu().numpy()
    sd = seeds.cpu().numpy()
    m1 = np.zeros(shape, np.int64)
    for k in range(len(sd)):
        yy, xx = np.nonzero(sm[k])
        m1[yy + sd[k, 0] - 5, xx + sd[k, 1] - 5] = k + 1
    m0 = np.zeros(shape0, np.int64)
    m0[inds] = m1[pt[0], pt[1]]
    uniq, counts = np.unique(m0, return_counts=True)
    big = uniq[(counts > H * W * max_size_fraction) & (uniq != 0)]
    m0[np.isin(m0, big)] = 0
    return renumber(m0)


def get_centers(masks: np.ndarray, slices):
    centers = np.zeros((len(slices), 2), np.int64)
    exts = np.zeros(len(slices), np.int64)
    for i, (sr, sc) in enumerate(slices):
        yi, xi = np.nonzero(masks[sr, sc] == i + 1)
        ymed, xmed = yi.mean(), xi.mean()
        imin = ((xi - xmed) ** 2 + (yi - ymed) ** 2).argmin()
        centers[i] = (yi[imin] + sr.start, xi[imin] + sc.start)
        exts[i] = (sr.stop - sr.start) + (sc.stop - sc.start) + 2
    return centers, exts


def masks_to_flows(masks: np.ndarray, device) -> np.ndarray:
    """(2, H, W) float64 unit flows of consecutive masks (heat diffusion
    from each mask's centre, ``masks_to_flows_gpu``)."""
    H, W = masks.shape
    mp = F.pad(torch.from_numpy(masks.astype(np.int64)).to(device),
               (1, 1, 1, 1))
    y, x = torch.nonzero(mp, as_tuple=True)
    yxi = [[0, -1, 1, 0, 0, -1, -1, 1, 1], [0, 0, 0, -1, 1, -1, 1, -1, 1]]
    nb = torch.stack([torch.stack([y + yxi[0][i] for i in range(9)]),
                      torch.stack([x + yxi[1][i] for i in range(9)])])
    m0 = mp[nb[0, 0], nb[1, 0]]
    isn = torch.stack([mp[nb[0, i], nb[1, i]] == m0 for i in range(9)])
    centers, ext = get_centers(masks, ndimage.find_objects(masks))
    meds = torch.from_numpy(centers).to(device) + 1
    T = torch.zeros(mp.shape, dtype=torch.double, device=device)
    for _ in range(2 * int(ext.max())):
        T[meds[:, 0], meds[:, 1]] += 1
        Tn = T[nb[0], nb[1]] * isn
        T[nb[0, 0], nb[1, 0]] = Tn.mean(dim=0)
    g = T[nb[0, [2, 1, 4, 3]], nb[1, [2, 1, 4, 3]]]
    mu = torch.stack((g[0] - g[1], g[2] - g[3])).cpu().numpy()
    mu /= (1e-60 + (mu ** 2).sum(axis=0) ** 0.5)
    out = np.zeros((2, H, W))
    out[:, y.cpu().numpy() - 1, x.cpu().numpy() - 1] = mu
    return out


def remove_bad_flow_masks(masks: np.ndarray, dP: np.ndarray,
                          threshold: float, device) -> np.ndarray:
    flows = masks_to_flows(masks, device)
    idx = np.arange(1, masks.max() + 1)
    err = sum(ndimage.mean((flows[i] - dP[i] / 5.) ** 2, masks, index=idx)
              for i in range(2))
    bad = 1 + np.nonzero(np.asarray(err) > threshold)[0]
    masks = masks.copy()
    masks[np.isin(masks, bad)] = 0
    return masks


def fill_holes_and_remove_small_masks(masks: np.ndarray,
                                      min_size: int) -> np.ndarray:
    def remove_small(m):
        counts = np.bincount(m.ravel())
        small = np.nonzero(counts < min_size)[0]
        m = m.copy()
        m[np.isin(m, small[small > 0])] = 0
        return renumber(m)

    if min_size > 0:
        masks = remove_small(masks)
    masks = masks.copy()
    for i, slc in enumerate(ndimage.find_objects(masks)):
        if slc is not None:
            msk = ndimage.binary_fill_holes(masks[slc] == i + 1)
            masks[slc][msk] = i + 1
    return remove_small(masks) if min_size > 0 else renumber(masks)


def compute_masks(dP: torch.Tensor, cellprob: torch.Tensor,
                  infer: dict) -> np.ndarray:
    """One frame's (2, H, W) flows and (H, W) cell probability -> (H, W)
    int64 masks (``compute_masks``)."""
    H, W = cellprob.shape
    fg = cellprob > infer["cellprob_threshold"]
    if not bool(fg.any()):
        return np.zeros((H, W), np.int64)
    inds = tuple(i.cpu().numpy() for i in torch.nonzero(fg, as_tuple=True))
    pt = steps_interp(dP * fg / 5., inds, infer["niter"])
    masks = get_masks(pt, inds, (H, W), infer["max_size_fraction"],
                      dP.device)
    if masks.max() > 0 and infer["flow_threshold"] > 0:
        masks = remove_bad_flow_masks(masks, dP.cpu().numpy(),
                                      infer["flow_threshold"], dP.device)
    return fill_holes_and_remove_small_masks(masks, infer["min_size"])


def normalise99(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32)
    lo, hi = np.percentile(x, 1), np.percentile(x, 99)
    if hi - lo > 1e-3:
        return ((x - lo) / (hi - lo)).astype(np.float32)
    return np.zeros_like(x)


class Segmenter:
    """``segment(frames)`` with Cellpose-SAM for one configuration (the
    family's ``model_config``) and one set of inference settings."""

    def __init__(self, cfg: dict, params: Params, infer: dict,
                 batch: int = 8, quant=None):
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
        """(n, t, t) normalised tiles -> (n, 3, t, t), in batches."""
        outs = []
        for i in range(0, tiles.shape[0], self.batch):
            x = F.pad(tiles[i:i + self.batch, None],
                      (0, 0, 0, 0, 0, self.cfg["ch_in"] - 1))
            outs.append(self.net(self.p, x))
        return torch.cat(outs)

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
        x = torch.from_numpy(np.stack([normalise99(f) for f in frames])
                             ).to(device)
        x = F.pad(x, (0, pw, 0, ph), value=0.0)
        tiles = torch.stack([x[:, y:y + t, xx:xx + t] for y, xx in pos],
                            1).reshape(-1, t, t)
        return self.stitch(self.net_fields(tiles), T, H, W)

    def from_outputs(self, outs, T: int, H: int, W: int) -> torch.Tensor:
        """The stitched (T, 3, H, W) fields of a stack from the network's
        own outputs ((b, 3, t, t) each, in order)."""
        f = torch.cat([o.float() for o in outs])
        n = len(self._positions(H, W)[0])
        return self.stitch(f[:T * n], T, H, W)

    def masks(self, fields: torch.Tensor) -> List[np.ndarray]:
        """(T, 3, H, W) fields -> T (H, W) int64 masks."""
        return [compute_masks(f[:2], f[2], self.infer) for f in fields]
