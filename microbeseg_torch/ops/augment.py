"""Training augmentation and contrast-limited adaptive histogram
equalisation (CLAHE).

Port of ``microbeseg_tpu/ops/augment.py``.  The pipeline is the reference's
train Compose: D4 flip (p=1) -> contrast (p=0.45: CLAHE | percentile
stretch | contrast + gamma) -> scaling (p=0.25) and rotation (p=0.25) as one
resample -> blur (p=0.3, sigma U(1, 2)) -> noise (p=0.3, sigma 1-5% of the
maximum) -> [-1, 1].

Drawing is split from applying.  ``draw_params`` draws every random choice
of a batch from an explicit ``torch.Generator`` on the host;
``apply_params`` applies them to the whole batch on the images' device.
Each stage runs only on the samples that drew it (index, apply, scatter
back), where the JAX package's ``vmap`` runs every ``lax.switch`` branch on
every sample and selects; the result is the same.  The parameters live on
the host, so which samples take a stage is known without a device sync.
JAX's threefry and torch's Philox streams never agree, so the draw matches
the JAX package only in distribution; given the same parameters the apply
step computes what ``augment_train`` computes (the resample and the D4 flip
bit for bit).  The rotation enters ``apply_params`` as the cosine and sine
of its angle, which the draw computes: torch's and XLA's float32 ``cos``
and ``sin`` differ by an ulp on about 5% of angles.

CLAHE is also the one augmentation inference uses
(``InferConfig.apply_clahe``).  Its tile histograms are one ``index_add_``
and the lookups of the four neighbouring tile mappings one ``gather`` each,
where the JAX package multiplies a one-hot of the bin image on the matrix
unit.  That product selects table entries held in bfloat16, so the tables
are rounded to bfloat16 here too.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from microbeseg_torch.ops.filters import gaussian_blur_dynamic
from microbeseg_torch.utils.device import upload

UINT16_MAX = 65535.0

# h -> (flip_ud, flip_lr, transpose); y = T(F(x))
_D4 = torch.tensor([[0, 0, 0], [0, 1, 0], [1, 0, 0], [0, 1, 1],
                    [1, 1, 0], [1, 0, 1], [0, 0, 1], [1, 1, 1]],
                   dtype=torch.bool)


def _d4(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Apply D4 element ``h[b]`` to each square (H, W, C) sample ``x[b]``."""
    t = upload(_D4[h.cpu()], x.device).view(-1, 3, 1, 1, 1)
    x = torch.where(t[:, 0], x.flip(1), x)
    x = torch.where(t[:, 1], x.flip(2), x)
    return torch.where(t[:, 2], x.transpose(1, 2), x)


def _symmetric_index(size: int, padded: int) -> np.ndarray:
    """Source index of each position of an axis padded at its end in
    numpy's 'symmetric' mode."""
    return np.pad(np.arange(size), (0, padded - size), mode="symmetric")


def clahe(img01: torch.Tensor, clip_limit: float = 0.01, grid: int = 8,
          nbins: int = 256) -> torch.Tensor:
    """CLAHE of [0, 1] images, (B, H, W) or (H, W) float32, any size (padded
    symmetrically at the bottom and right to a multiple of 2 * grid).  Per
    tile: clipped histogram, the clipped excess spread evenly over the bins,
    cdf; per pixel: bilinear blend of the mappings of the 4 nearest tiles."""
    squeeze = img01.ndim == 2
    img = img01[None] if squeeze else img01
    img = img.to(torch.float32)
    dev = img.device
    B, H, W = img.shape
    unit = 2 * grid
    Hp = -(-H // unit) * unit
    Wp = -(-W // unit) * unit
    if Hp != H:
        img = img[:, upload(torch.from_numpy(_symmetric_index(H, Hp)), dev)]
    if Wp != W:
        img = img[:, :, upload(torch.from_numpy(_symmetric_index(W, Wp)),
                               dev)]
    th, tw = Hp // grid, Wp // grid
    hh, hw = th // 2, tw // 2
    b = torch.clamp((img * nbins).to(torch.int32), 0, nbins - 1
                    ).to(torch.int64)

    # per-tile histograms: one count over (image, tile row, tile col, bin);
    # index_add_ where bincount would read its maximum back to the host
    ty = torch.arange(Hp, device=dev) // th
    tx = torch.arange(Wp, device=dev) // tw
    tile_id = ty[:, None] * grid + tx[None, :]
    img_id = torch.arange(B, device=dev).view(B, 1, 1) * (grid * grid)
    flat = ((img_id + tile_id) * nbins + b).view(-1)
    hist = torch.zeros(B * grid * grid * nbins, dtype=torch.int64,
                       device=dev).index_add_(
        0, flat, torch.ones_like(flat))
    hist = hist.view(B, grid, grid, nbins).to(torch.float32)

    limit = max(clip_limit * th * tw, 1.0)
    excess = torch.clamp(hist - limit, min=0.0).sum(dim=-1, keepdim=True)
    hist = torch.clamp(hist, max=limit) + excess / nbins
    cdf = torch.cumsum(hist, dim=-1)
    cdf = cdf / cdf[..., -1:]
    # the JAX package looks the mappings up in bfloat16 tables
    cdf = cdf.to(torch.bfloat16).to(torch.float32).view(B, -1)

    # half-tile block I covers the (I % 2)-th half of tile I // 2; its two
    # neighbouring tiles along the axis are (i - 1, i) or (i, i + 1),
    # clipped at the edges
    bi = np.arange(unit) // 2
    half = np.arange(unit) % 2
    n0 = np.where(half == 0, np.maximum(bi - 1, 0), bi)
    n1 = np.where(half == 0, bi, np.minimum(bi + 1, grid - 1))
    by = torch.arange(Hp, device=dev) // hh
    bx = torch.arange(Wp, device=dev) // hw
    n0 = upload(torch.from_numpy(n0), dev)
    n1 = upload(torch.from_numpy(n1), dev)
    y0, y1, x0, x1 = n0[by], n1[by], n0[bx], n1[bx]

    def lookup(ny, nx):
        idx = (ny[:, None] * grid + nx[None, :]) * nbins + b
        return torch.gather(cdf, 1, idx.view(B, -1)).view(B, Hp, Wp)

    yy = (torch.arange(Hp, dtype=torch.float32, device=dev) + 0.5) / th - 0.5
    xx = (torch.arange(Wp, dtype=torch.float32, device=dev) + 0.5) / tw - 0.5
    wy = (yy - torch.floor(yy))[:, None]
    wx = (xx - torch.floor(xx))[None, :]
    out = ((1 - wy) * ((1 - wx) * lookup(y0, x0) + wx * lookup(y0, x1))
           + wy * ((1 - wx) * lookup(y1, x0) + wx * lookup(y1, x1)))
    out = torch.clamp(out[:, :H, :W], 0.0, 1.0)
    return out[0] if squeeze else out


# ---------------------------------------------------------------------------
# contrast family
# ---------------------------------------------------------------------------

def _quantiles(img: torch.Tensor, qs: torch.Tensor,
               iters: int = 22) -> torch.Tensor:
    """Per-sample value-space bisection quantiles, the JAX package's: 22
    compare-and-count passes, each keeping the half whose lower end has not
    reached q.  ``img`` (B, ...), ``qs`` (B, K) in [0, 1] -> (B, K) values
    t ~= inf{t : P(img <= t) >= q}."""
    flat = img.reshape(img.shape[0], -1)
    k = qs.shape[1]
    lo = flat.amin(dim=1, keepdim=True).expand(-1, k)
    hi = flat.amax(dim=1, keepdim=True).expand(-1, k)
    n = flat.shape[1]
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        count = (flat[:, :, None] <= mid[:, None, :]).sum(dim=1)
        reached = count.to(torch.float32) / n >= qs
        lo, hi = torch.where(reached, lo, mid), torch.where(reached, mid, hi)
    return hi


def _clahe_branch(img: torch.Tensor) -> torch.Tensor:
    return (clahe(img[..., 0] / UINT16_MAX, clip_limit=0.01)
            * UINT16_MAX)[..., None]


def _stretch_branch(img: torch.Tensor, lo_hi: torch.Tensor) -> torch.Tensor:
    """Percentile stretch to [0.2, 99.8] or [0.1, 99.9] per sample."""
    first = lo_hi == 0
    p_lo = torch.where(first, 0.2, 0.1) / 100.0
    p_hi = torch.where(first, 99.8, 99.9) / 100.0
    p = _quantiles(img, torch.stack([p_lo, p_hi], dim=1)).view(-1, 2, 1, 1, 1)
    p0, p1 = p[:, 0], p[:, 1]
    out = torch.clamp((img - p0) / torch.clamp(p1 - p0, min=1e-7), 0.0, 1.0)
    return out * UINT16_MAX


def _gamma_branch(img: torch.Tensor, factor: torch.Tensor,
                  gamma: torch.Tensor) -> torch.Tensor:
    """Contrast about the mean by ``factor``, then a gamma curve over the
    sample's range."""
    dims = (1, 2, 3)
    x = img / UINT16_MAX
    mean = x.mean(dim=dims, keepdim=True)
    x = (x - mean) * factor.view(-1, 1, 1, 1) + mean
    lo = x.amin(dim=dims, keepdim=True)
    rnge = x.amax(dim=dims, keepdim=True) - lo
    x = torch.pow(torch.clamp((x - lo) / (rnge + 1e-7), 0.0, 1.0),
                  gamma.view(-1, 1, 1, 1)) * rnge + lo
    return torch.clamp(x, 0.0, 1.0) * UINT16_MAX


# ---------------------------------------------------------------------------
# geometry: scale + rotate as one two-pass resample
# ---------------------------------------------------------------------------

def _interp_weights(pos: torch.Tensor, size: int, order: int
                    ) -> Tuple[torch.Tensor, ...]:
    """The nonzero entries of the JAX package's (K, *pos.shape) weight
    tensor, as source indices and bfloat16-rounded weights: order 1, a
    linear tent, has at most two (``floor(pos)`` and the next sample),
    weight ``max(1 - |pos - k|, 0)``; order 0, nearest, one, ``round(pos)``
    (half to even) with weight 1.  Sources outside [0, size) weigh 0.
    Returns (indices clamped into range, weights), one pair per tap."""
    if order == 1:
        k0 = torch.floor(pos)
        taps = (k0, k0 + 1.0)
    else:
        taps = (torch.round(pos),)
    out = []
    for k in taps:
        inside = (k >= 0) & (k <= size - 1)
        if order == 1:
            w = torch.clamp(1.0 - torch.abs(pos - k), min=0.0)
        else:
            w = torch.ones_like(pos)
        w = torch.where(inside, w, 0.0).to(torch.bfloat16).to(torch.float32)
        out.append((torch.clamp(k, 0, size - 1).to(torch.int64), w))
    return tuple(out)


def _resample_axis(x: torch.Tensor, pos: torch.Tensor, dim: int,
                   order: int) -> torch.Tensor:
    """One pass: out[b, y, x, c] = sum_k W[k, y, x] * x[b, .., k, .., c]
    with the source index k along ``dim`` (1: rows, 2: columns).  At most
    two products, each of two bfloat16 values and so exact in float32; the
    one float32 sum of two is the same in any order."""
    C = x.shape[-1]
    out = None
    for k, w in _interp_weights(pos, x.shape[dim], order):
        term = torch.gather(x, dim, k.unsqueeze(-1).expand(-1, -1, -1, C))
        term = term * w.unsqueeze(-1)
        out = term if out is None else out + term
    return out


def _affine_resample(x: torch.Tensor, ca: torch.Tensor, sa: torch.Tensor,
                     sy: torch.Tensor, sx: torch.Tensor,
                     order: int) -> torch.Tensor:
    """out = Rotate(Scale(x)) per sample: out(p) = x(c + diag(1/sy, 1/sx)
    R(-angle)(p - c)), with ``ca``, ``sa`` = cos(-angle), sin(-angle).

    The JAX package's two-pass separable decomposition: pass 1 resamples
    along y, pass 2 along x; the image and the first pass's output are
    rounded to bfloat16 as it rounds them, and positions whose composite
    source falls outside the frame read 0 (scipy's mode='constant').
    ``x`` (B, H, W, C) float32; the parameters (B,) float32."""
    B, H, W, C = x.shape
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0

    def col(v):
        return v.view(-1, 1, 1)

    m00, m01 = col(ca / sy), col(-sa / sy)
    m10, m11 = col(sa / sx), col(ca / sx)
    c0 = cy - m00 * cy - m01 * cx
    c1 = cx - m10 * cy - m11 * cx
    beta = m01 / m11
    alpha = m00 - beta * m10
    gamma = c0 - beta * c1

    yy = torch.arange(H, dtype=torch.float32, device=x.device)[:, None]
    xx = torch.arange(W, dtype=torch.float32, device=x.device)[None, :]
    p1 = alpha * yy + beta * xx + gamma
    xb = x.to(torch.bfloat16).to(torch.float32)
    t1 = _resample_axis(xb, p1, 1, order)
    p2 = m10 * yy + m11 * xx + c1
    t1b = t1.to(torch.bfloat16).to(torch.float32)
    out = _resample_axis(t1b, p2, 2, order)

    src_y = m00 * yy + m01 * xx + c0
    valid = ((src_y >= 0.0) & (src_y <= H - 1.0)
             & (p2 >= 0.0) & (p2 <= W - 1.0))
    return out * valid[..., None]


# ---------------------------------------------------------------------------
# the pipeline: draw, then apply
# ---------------------------------------------------------------------------

def draw_params(gen: torch.Generator, n: int, size: int
                ) -> Dict[str, torch.Tensor]:
    """Every random choice of ``n`` samples of ``size``^2, drawn on the host
    from ``gen``.  Gates and branches are bool / int64; values float32;
    ``noise`` holds one standard normal image per sample that drew noise."""
    def u():
        return torch.rand(n, generator=gen)

    def uniform(lo, hi):
        return u() * (hi - lo) + lo

    p = {"h": torch.randint(0, 8, (n,), generator=gen)}
    p["do_contrast"] = u() < 0.45
    p["branch"] = torch.randint(0, 3, (n,), generator=gen)
    p["lo_hi"] = torch.randint(0, 2, (n,), generator=gen)
    p["factor"] = uniform(0.75, 1.25)
    p["gamma"] = uniform(0.7, 1.3)
    do_scale, do_rot = u() < 0.25, u() < 0.25
    p["geo"] = do_scale | do_rot
    p["sx"] = torch.where(do_scale, uniform(0.85, 1.15), 1.0)
    p["sy"] = torch.where(do_scale, uniform(0.85, 1.15), 1.0)
    angle = torch.where(do_rot, torch.deg2rad(uniform(-45.0, 45.0)), 0.0)
    p["cos"], p["sin"] = torch.cos(-angle), torch.sin(-angle)
    p["do_blur"] = u() < 0.3
    p["sigma"] = torch.where(p["do_blur"], uniform(1.0, 2.0), 1e-3)
    p["do_noise"] = u() < 0.3
    p["pct"] = torch.randint(1, 6, (n,), generator=gen).to(torch.float32) / 100.0
    p["noise"] = torch.randn((int(p["do_noise"].sum()), size, size, 1),
                             generator=gen)
    return p


def _subset(gate: torch.Tensor, dev: torch.device):
    """(host, device) indices of the samples whose host-side ``gate`` is
    set."""
    rows = torch.nonzero(gate).flatten()
    return rows, upload(rows, dev)


def apply_params(images: torch.Tensor, labels: Dict[str, torch.Tensor],
                 p: Dict[str, torch.Tensor], label_type: str = "distance"
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Augment a batch with drawn parameters.  ``images`` (B, H, W, 1)
    float32 raw intensities [0, 65535]; ``labels`` {'border_label',
    'cell_label'} float32 (distance) or {'label'} int (boundary), each
    (B, H, W, 1).  Returns the images normalised to [-1, 1] and the
    labels, both transformed as ``augment_train`` transforms them."""
    dev = images.device
    image = _d4(images.to(torch.float32), p["h"])
    labels = {k: _d4(v, p["h"]) for k, v in labels.items()}

    # contrast, image only: each branch on the samples that drew it
    if p["do_contrast"].any():
        image = image.clone()
        for b in range(3):
            r, rows = _subset(p["do_contrast"] & (p["branch"] == b), dev)
            if not len(r):
                continue
            if b == 0:
                image[rows] = _clahe_branch(image[rows])
            elif b == 1:
                image[rows] = _stretch_branch(image[rows],
                                              upload(p["lo_hi"][r], dev))
            else:
                image[rows] = _gamma_branch(image[rows],
                                            upload(p["factor"][r], dev),
                                            upload(p["gamma"][r], dev))

    # scaling + rotation as one resample, on the samples that drew either
    if p["geo"].any():
        r, rows = _subset(p["geo"], dev)
        geo = [upload(p[k][r], dev) for k in ("cos", "sin", "sy", "sx")]
        if label_type != "distance":
            image = image.index_copy(0, rows, _affine_resample(
                image[rows], *geo, order=1))
            labels = {k: v.index_copy(0, rows, _affine_resample(
                v[rows].to(torch.float32), *geo, order=0).to(v.dtype))
                for k, v in labels.items()}
        else:
            # image and float labels share the transform and the order
            keys = list(labels)
            stacked = torch.cat([image[rows]] + [labels[k][rows].to(
                torch.float32) for k in keys], dim=-1)
            geo_out = _affine_resample(stacked, *geo, order=1)
            image = image.index_copy(0, rows, geo_out[..., :1])
            labels = {k: labels[k].index_copy(
                0, rows, geo_out[..., 1 + i:2 + i].to(labels[k].dtype))
                for i, k in enumerate(keys)}

    # blur (a sigma of 1e-3 elsewhere is the identity in the JAX package)
    if p["do_blur"].any():
        r, rows = _subset(p["do_blur"], dev)
        image = image.index_copy(0, rows, gaussian_blur_dynamic(
            image[rows], upload(p["sigma"][r], dev), radius=9))

    # additive gaussian noise, sigma = pct * the sample's maximum
    if p["do_noise"].any():
        r, rows = _subset(p["do_noise"], dev)
        sub = image[rows]
        nsigma = (upload(p["pct"][r], dev).view(-1, 1, 1, 1)
                  * sub.amax(dim=(1, 2, 3), keepdim=True))
        image = image.index_copy(0, rows,
                                 sub + nsigma * upload(p["noise"], dev))
    image = torch.clamp(image, 0.0, UINT16_MAX)
    return 2.0 * image / UINT16_MAX - 1.0, labels


def normalize_val(images: torch.Tensor) -> torch.Tensor:
    """Validation path: normalisation only (reference val transform)."""
    return 2.0 * images.to(torch.float32) / UINT16_MAX - 1.0
