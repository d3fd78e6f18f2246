"""Cellpose's flow dynamics on the device: flow fields and a cell
probability -> instance masks (MouseLand/cellpose, release 4,
``cellpose/dynamics.py::compute_masks``).

``flows_postprocessing(dP, cellprob, cfg)`` takes one frame's (2, H, W)
flows (dY, dX) and (H, W) cell probability and an ``InferConfig``
(``niter``, ``cellprob_threshold``, ``flow_threshold``, ``min_size``,
``max_size_fraction``) and returns (H, W) int64 labels, in four stages,
each a span under ``mseg.segment.flows``:

1. ``follow``: every foreground pixel (``cellprob > cellprob_threshold``)
   starts at its own coordinates and takes ``niter`` float32 Euler steps
   through the masked field ``dP * fg / 5``, sampled bilinearly
   (``grid_sample``, ``align_corners=False``, zeros outside) and clamped to
   the frame, in grid_sample's normalised coordinates as ``steps_interp``
   keeps them.  CUDA tensors take one launch of ``csrc/follow.cu``
   (counted as ``follow_flows``), CPU tensors the plain ``grid_sample``
   loop ``follow_plain`` (counted as ``follow_flows_fallback`` where it is
   handed CUDA tensors).  The end points
   are cast to integers as Cellpose's ``.int()`` casts them (toward zero;
   they are never negative).
2. ``masks`` (``get_masks_torch``): the histogram of the end points, padded
   by 20; its seeds are the local maxima of a 5 x 5 window with a count
   above 10, in increasing order of count; each seed grows 5 times over 3 x
   3 neighbourhoods within its 11 x 11 window where the count is above 2,
   and a later seed's region takes what it shares with an earlier one.  A
   pixel takes the label of the region its end point lands in; masks of
   more than ``max_size_fraction`` of the frame are removed, and the labels
   renumbered in order of first appearance in raster order.
3. ``qc`` (``remove_bad_flow_masks``): each mask's flows are recomputed by
   heat diffusion from its centre pixel (``masks_to_flows_gpu``: the mask
   pixel nearest its mean coordinates; 2 x the largest mask's height +
   width + 2 diffusion steps of the 3 x 3 mean over the mask's own pixels,
   float64; the gradient normalised), and masks whose mean squared error
   against ``dP / 5`` exceeds ``flow_threshold`` are removed.
4. ``fill``: masks under ``min_size`` pixels are removed, holes filled, and
   the labels renumbered in order of first appearance.

Departures from Cellpose, which its reference in the benchmark states
too: seeds of equal count are ordered by their raster position (Cellpose's
CUDA argsort is not stable); a hole is a 4-connected component of
background that touches no frame border and whose 4-neighbours all belong
to one mask (Cellpose fills each mask's holes in its bounding box, which
also swallows a mask that lies wholly inside another); the labels after
the fill keep the order of their first pixels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from microbeseg_torch.kernels import _build
from microbeseg_torch.ops.cc import connected_components
from microbeseg_torch.utils.profiling import count, span

RPAD = 20         # the end-point histogram's pad (get_masks_torch)
SEED_POOL = 5     # a seed is the maximum of its SEED_POOL^2 window
SEED_MIN = 10     # ... with more end points than this
GROW_MIN = 2      # a seed's region grows where the count is above this
GROW_STEPS = 5
WINDOW = 2 * GROW_STEPS + 1
# the 3 x 3 neighbours of masks_to_flows_gpu, in its order (self first)
_NY = (0, -1, 1, 0, 0, -1, -1, 1, 1)
_NX = (0, 0, 0, -1, 1, -1, 1, -1, 1)


def _field(dP: torch.Tensor, fg: torch.Tensor) -> torch.Tensor:
    """(H, W, 2) pairs (x, y) of the masked field dP * fg / 5, each scaled
    by 2 / (size - 1) of its axis (steps_interp's ``im``)."""
    H, W = fg.shape
    m = dP * fg / 5.0
    return torch.stack([m[1] * (2.0 / (W - 1)), m[0] * (2.0 / (H - 1))],
                       dim=-1).contiguous()


def follow_plain(field: torch.Tensor, pts: torch.Tensor,
                 niter: int) -> torch.Tensor:
    """``niter`` steps of (n, 2) normalised points (x, y) through the (H, W,
    2) field, one ``grid_sample`` and two clamps a step, as
    ``steps_interp``; returns new points.  Counted as
    ``follow_flows_fallback`` where the field is on the card."""
    if field.device.type == "cuda":
        _build.count_launch("follow_flows_fallback")
    im = field.permute(2, 0, 1)[None]
    pt = pts.reshape(1, 1, -1, 2).clone()
    for _ in range(niter):
        d = F.grid_sample(im, pt, align_corners=False)
        for k in range(2):
            pt[..., k] = torch.clamp(pt[..., k] + d[:, k], -1.0, 1.0)
    return pt.reshape(-1, 2)


def _follow_kernel(field: torch.Tensor, pts: torch.Tensor,
                   niter: int) -> torch.Tensor:
    H, W = field.shape[:2]
    if (field.dtype != torch.float32 or pts.dtype != torch.float32
            or field.shape[2:] != (2,) or pts.ndim != 2 or pts.shape[1] != 2
            or not field.is_contiguous() or pts.device != field.device
            or pts.shape[0] >= 1 << 31):
        raise ValueError(f"follow_flows: field {tuple(field.shape)} "
                         f"{field.dtype} and points {tuple(pts.shape)} "
                         f"{pts.dtype}: (H, W, 2) contiguous and (n, 2), "
                         "float32 on one device, n < 2^31")
    pts = pts.contiguous().clone()
    fn = _build.entry("follow", "follow_flows_launch", 2, 4)
    with torch.cuda.device(pts.device):
        err = fn(_build.ptr(field), _build.ptr(pts), pts.shape[0], H, W,
                 niter, _build.stream_ptr(pts))
    _build.check(err, "follow_flows")
    _build.count_launch("follow_flows")
    return pts


def start_points(idx: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(n, 2) normalised points (x, y) of the flat pixel indices ``idx``
    into (H, W), as ``steps_interp`` starts them."""
    pts = torch.stack([idx % W, idx // W], dim=1).to(torch.float32)
    pts[:, 0] /= W - 1
    pts[:, 1] /= H - 1
    return pts * 2 - 1


def end_pixels(pts: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(n, 2) normalised points (x, y) -> (n, 2) int64 pixels (y, x), cast
    toward zero as Cellpose's ``.int()``."""
    pts = (pts + 1) * 0.5
    pts[:, 0] *= W - 1
    pts[:, 1] *= H - 1
    return pts.flip(1).to(torch.int32).to(torch.int64)


def follow_flows(dP: torch.Tensor, fg: torch.Tensor, idx: torch.Tensor,
                 niter: int) -> torch.Tensor:
    """The end points of the foreground pixels ``idx`` (flat indices into
    (H, W)) after ``niter`` steps through ``dP * fg / 5``: (n, 2) int64
    (y, x).  The kernel on the card, the ``grid_sample`` loop elsewhere."""
    H, W = fg.shape
    if H < 2 or W < 2:
        raise ValueError(f"follow_flows needs at least 2 x 2 pixels, got "
                         f"{H} x {W}")
    field = _field(dP, fg)
    pts = start_points(idx, H, W)
    count("flow_points", pts.shape[0])
    if field.device.type == "cuda":
        pts = _follow_kernel(field, pts, niter)
    else:
        pts = follow_plain(field, pts, niter)
    return end_pixels(pts, H, W)


def renumber(labels: torch.Tensor) -> torch.Tensor:
    """Positive labels -> 1..n in order of their first pixel in raster
    order, 0 stays 0 (fastremap.renumber)."""
    flat = labels.reshape(-1)
    n = int(flat.max()) + 1 if flat.numel() else 1
    pos = torch.arange(flat.numel(), device=flat.device)
    first = torch.full((n,), flat.numel(), dtype=torch.int64,
                       device=flat.device)
    first.scatter_reduce_(0, flat, pos, "amin")
    first[0] = flat.numel()
    order = torch.argsort(first)
    k = int((first < flat.numel()).sum())
    new = torch.zeros(n, dtype=torch.int64, device=flat.device)
    new[order[:k]] = torch.arange(1, k + 1, device=flat.device)
    return new[flat].view(labels.shape)


def _remove(labels: torch.Tensor, drop: torch.Tensor) -> torch.Tensor:
    """Set the labels where ``drop`` (indexed by label) holds to 0."""
    drop = drop.clone()
    drop[0] = False
    return torch.where(drop[labels], 0, labels)


def get_masks(ends: torch.Tensor, idx: torch.Tensor, H: int, W: int,
              max_size_fraction: float) -> torch.Tensor:
    """(H, W) int64 labels from the end points ``ends`` (n, 2) of the
    pixels ``idx``."""
    dev = ends.device
    hp, wp = H + 2 * RPAD, W + 2 * RPAD
    ey = torch.clamp(ends[:, 0] + RPAD, 0, H + RPAD - 1)
    ex = torch.clamp(ends[:, 1] + RPAD, 0, W + RPAD - 1)
    at = ey * wp + ex
    h = torch.bincount(at, minlength=hp * wp).to(torch.float32).view(hp, wp)
    hmax = F.max_pool2d(h[None, None], SEED_POOL, stride=1,
                        padding=SEED_POOL // 2)[0, 0]
    seeds = torch.nonzero((h - hmax > -1e-6) & (h > SEED_MIN))
    out = torch.zeros(H * W, dtype=torch.int64, device=dev)
    if seeds.shape[0] == 0:
        return out.view(H, W)
    seeds = seeds[torch.argsort(h[seeds[:, 0], seeds[:, 1]], stable=True)]
    off = torch.arange(WINDOW, device=dev) - GROW_STEPS
    wy = seeds[:, 0, None, None] + off[None, :, None]
    wx = seeds[:, 1, None, None] + off[None, None, :]
    keep = h[wy, wx] > GROW_MIN
    grown = torch.zeros(keep.shape, dtype=torch.float32, device=dev)
    grown[:, GROW_STEPS, GROW_STEPS] = 1
    for _ in range(GROW_STEPS):
        grown = F.max_pool2d(grown, 3, stride=1, padding=1) * keep
    ids = torch.arange(1, seeds.shape[0] + 1, device=dev)[:, None, None]
    inside = grown > 0
    m1 = torch.zeros(hp * wp, dtype=torch.int64, device=dev)
    m1.scatter_reduce_(0, (wy * wp + wx).expand_as(inside)[inside],
                       ids.expand_as(inside)[inside], "amax")
    out[idx] = m1[at]
    big = torch.bincount(out, minlength=seeds.shape[0] + 1) \
        > H * W * max_size_fraction
    return renumber(_remove(out, big)).view(H, W)


def mask_flows(labels: torch.Tensor):
    """Cellpose's flows of consecutive (H, W) labels (masks_to_flows_gpu):
    (flat indices of the mask pixels, their labels, (2, n) float64 unit
    flows (dY, dX), diffusion steps)."""
    H, W = labels.shape
    dev = labels.device
    wp = W + 2
    lp = F.pad(labels, (1, 1, 1, 1)).reshape(-1)
    at = torch.nonzero(lp).squeeze(1)
    y, x = at // wp, at % wp
    nbr = torch.stack([(y + a) * wp + (x + b) for a, b in zip(_NY, _NX)])
    lab = lp[at]
    same = (lp[nbr] == lab).to(torch.float64)
    n = int(lab.max())
    cnt = torch.bincount(lab, minlength=n + 1)

    def extreme(v, how):
        fill = v.max() + 1 if how == "amin" else -1
        e = torch.full((n + 1,), int(fill), dtype=torch.int64, device=dev)
        return e.scatter_reduce_(0, lab, v, how)

    y0, x0 = extreme(y, "amin"), extreme(x, "amin")
    ext = (extreme(y, "amax") - y0 + 1) + (extreme(x, "amax") - x0 + 1) + 2
    # the centre: the pixel nearest the mean of its mask's coordinates
    # (taken inside the bounding box, as get_centers takes them), the
    # first in raster order among equals
    ly, lx = y - y0[lab], x - x0[lab]
    denom = torch.clamp(cnt, min=1).to(torch.float64)
    my = torch.zeros(n + 1, dtype=torch.int64, device=dev).index_add_(
        0, lab, ly).to(torch.float64) / denom
    mx = torch.zeros(n + 1, dtype=torch.int64, device=dev).index_add_(
        0, lab, lx).to(torch.float64) / denom
    d = (lx - mx[lab]) ** 2 + (ly - my[lab]) ** 2
    dmin = torch.full((n + 1,), float("inf"), dtype=torch.float64,
                      device=dev).scatter_reduce_(0, lab, d, "amin")
    big = lp.numel()
    centre = torch.full((n + 1,), big, dtype=torch.int64,
                        device=dev).scatter_reduce_(
        0, lab, torch.where(d == dmin[lab], at, big), "amin")[1:]
    steps = 2 * int(ext[1:].max())
    T = torch.zeros(lp.numel(), dtype=torch.float64, device=dev)
    for _ in range(steps):
        T[centre] += 1
        T[nbr[0]] = (T[nbr] * same).mean(dim=0)
    mu = torch.stack([T[nbr[2]] - T[nbr[1]], T[nbr[4]] - T[nbr[3]]])
    mu = mu / (1e-60 + (mu ** 2).sum(dim=0) ** 0.5)
    pix = (y - 1) * W + (x - 1)
    return pix, lab, mu, steps


def remove_bad_flow_masks(labels: torch.Tensor, dP: torch.Tensor,
                          threshold: float) -> torch.Tensor:
    """Remove the masks of consecutive (H, W) labels whose mean squared
    error between their recomputed flows and ``dP / 5`` exceeds
    ``threshold``."""
    pix, lab, mu, steps = mask_flows(labels)
    count("qc_iterations", steps)
    n = int(lab.max())
    err = torch.zeros(n + 1, dtype=torch.float64, device=labels.device)
    for c in range(2):
        e = (mu[c] - (dP[c].reshape(-1)[pix] / 5.0).to(torch.float64)) ** 2
        err += torch.zeros_like(err).index_add_(0, lab, e)
    err = err / torch.clamp(torch.bincount(lab, minlength=n + 1), min=1)
    return _remove(labels, err > threshold)


def fill_holes_and_remove_small_masks(labels: torch.Tensor,
                                      min_size: int) -> torch.Tensor:
    """Masks under ``min_size`` pixels removed, each hole (a 4-connected
    component of background off the border whose 4-neighbours all belong
    to one mask) filled with that mask, labels renumbered."""
    H, W = labels.shape
    if min_size > 0:
        labels = _remove(labels, torch.bincount(labels.reshape(-1))
                         < min_size)
    bg = labels == 0
    comp = connected_components(bg, connectivity=1).to(torch.int64)
    n = H * W + 1
    lp = F.pad(labels, (1, 1, 1, 1))
    lo = torch.full((n,), n, dtype=torch.int64, device=labels.device)
    hi = torch.zeros(n, dtype=torch.int64, device=labels.device)
    for a, b in ((0, 1), (2, 1), (1, 0), (1, 2)):
        nb = lp[a:a + H, b:b + W]
        sel = bg & (nb > 0)
        lo.scatter_reduce_(0, comp[sel], nb[sel], "amin")
        hi.scatter_reduce_(0, comp[sel], nb[sel], "amax")
    edge = torch.zeros(n, dtype=torch.bool, device=labels.device)
    for border in (comp[0], comp[-1], comp[:, 0], comp[:, -1]):
        edge[border] = True
    hole = (lo == hi) & ~edge
    hole[0] = False
    labels = torch.where(bg & hole[comp], lo[comp], labels)
    return renumber(labels)


def flows_postprocessing(dP: torch.Tensor, cellprob: torch.Tensor,
                         cfg) -> torch.Tensor:
    """One frame's (2, H, W) flows (dY, dX) and (H, W) cell probability ->
    (H, W) int64 labels, with ``cfg``'s (an ``InferConfig``) settings."""
    H, W = cellprob.shape
    dP, cellprob = dP.float(), cellprob.float()
    with span("mseg.segment.flows.follow"):
        fg = cellprob > cfg.cellprob_threshold
        idx = torch.nonzero(fg.reshape(-1)).squeeze(1)
        if idx.numel() == 0:
            return torch.zeros((H, W), dtype=torch.int64,
                               device=cellprob.device)
        ends = follow_flows(dP, fg, idx, cfg.niter)
    with span("mseg.segment.flows.masks"):
        labels = get_masks(ends, idx, H, W, cfg.max_size_fraction)
    with span("mseg.segment.flows.qc"):
        if cfg.flow_threshold > 0 and int(labels.max()) > 0:
            labels = remove_bad_flow_masks(labels, dP, cfg.flow_threshold)
    with span("mseg.segment.flows.fill"):
        return fill_holes_and_remove_small_masks(labels, cfg.min_size)
