"""Training-label generation on tensors.

Port of ``microbeseg_tpu/ops/labelgen.py`` (itself a re-design of reference
src/training/train_data_representations.py), all seven label types of
``get_label``.

- ``boundary``, ``border``, ``j4``: a pixel is on a boundary iff a
  neighbour carries a different positive label, so one window min and max
  of the label image (max pools in float64, exact for int32 ids) replace
  the reference's per-instance dilations.
- ``adapted_border``: the Canny edges of the instance partition and of the
  foreground (``_canny_edges``, cv2.Canny(img, 1, 1) on piecewise-constant
  labels), then dilation, closing and erosion.
- ``distance``, ``cell_dist``, ``cell_dist_clipped``: per-instance windows.
  Each instance gets an (S, S) window around its centroid with a validity
  mask that reproduces the reference's clipped crop; the windows of a chunk
  of instances are gathered as one (n, S, S) tensor, transformed by one
  batched ``edt`` and added back into the canvas with one ``index_put_``.
  Each canvas pixel takes a nonzero value from its own instance's window
  only, so the sums are exact in any order.  The gap step of ``distance``
  labels runs ``cc.connected_components`` (kernel K3 on the card) and
  ``cc.relabel_sequential`` on the bottom hat of the closed instances.

``get_label(..., device=None)`` runs on the CUDA card; CPU runs pass
``device="cpu"``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from microbeseg_torch.ops import cc
from microbeseg_torch.ops.edt import edt
from microbeseg_torch.ops.morphology import (
    binary_closing,
    binary_dilation,
    binary_erosion,
    disk,
    generate_binary_structure,
    grey_closing,
)
from microbeseg_torch.ops.regionprops import regionprops
from microbeseg_torch.utils.device import resolve_device

_BIG_I = 2 ** 30


# ---------------------------------------------------------------------------
# Boundary, border and touching labels (all instances at once)
# ---------------------------------------------------------------------------

def _neighbor_minmax_pos(label: torch.Tensor, k: int):
    """(min, max) positive label over the k x k footprint at each pixel
    (min _BIG_I and max 0 where the footprint holds none; the outside of the
    image counts as background)."""
    x = label.to(torch.float64)[None, None]
    mx = torch.clamp(F.max_pool2d(x, k, 1, k // 2), min=0.0)
    pos = torch.where(x > 0, x, float(_BIG_I))
    mn = -F.max_pool2d(-pos, k, 1, k // 2)
    return mn[0, 0].to(torch.int32), mx[0, 0].to(torch.int32)


def boundary_mask(label: torch.Tensor) -> torch.Tensor:
    """Union over instances of (dilate(inst, 3x3) ^ inst): pixels with an
    8-neighbour carrying a different positive label."""
    label = label.to(torch.int32)
    mn, mx = _neighbor_minmax_pos(label, 3)
    differs = (mx != label) | ((mn != label) & (mn < _BIG_I))
    return (mx > 0) & differs


def _classes(cell: torch.Tensor, edge: torch.Tensor) -> torch.Tensor:
    """uint8 label: 0 background, 1 cell, 2 edge (edge wins)."""
    return torch.maximum(cell.to(torch.uint8), 2 * edge.to(torch.uint8))


def boundary_label(label: torch.Tensor) -> torch.Tensor:
    """3-class label: 0 bg, 1 cell, 2 boundary (reference :75-99)."""
    label = label.to(torch.int32)
    return _classes(label > 0, boundary_mask(label))


def border_mask(label: torch.Tensor) -> torch.Tensor:
    """Touching borders only: boundary pixels *inside* instances
    (reference border_label :102-126)."""
    label = label.to(torch.int32)
    return boundary_mask(label) & (label > 0)


def border_label(label: torch.Tensor) -> torch.Tensor:
    label = label.to(torch.int32)
    return _classes(label > 0, border_mask(label))


def j4_label(label: torch.Tensor, k_neighbors: int = 2,
             se_radius: int = 4) -> torch.Tensor:
    """Pena J4 4-class label: 0 bg, 1 cell, 2 touching, 3 gap (reference
    :158-190).  Touching = more than one instance in the (2k+1)^2
    neighbourhood, i.e. min positive label != max positive label."""
    label = label.to(torch.int32)
    label_bin = label > 0
    bottom_hat = binary_closing(label_bin, disk(se_radius)) ^ label_bin
    mn, mx = _neighbor_minmax_pos(label, 2 * k_neighbors + 1)
    multi = (mx > 0) & (mn < _BIG_I) & (mn != mx)
    bg = ~label_bin & ~bottom_hat
    gap = ~label_bin & bottom_hat
    touching = label_bin & multi
    # cell = everything else; encoded 0..3 as in the reference (max stack - 1)
    out = torch.maximum(bg.to(torch.int32), 2 * (~(bg | gap | touching)))
    out = torch.maximum(out, 3 * touching)
    out = torch.maximum(out, 4 * gap)
    return (out - 1).to(torch.uint8)


def _canny_edges(img: torch.Tensor) -> torch.Tensor:
    """cv2.Canny(img, 1, 1): 3x3 Sobel with replicated borders, L1 gradient
    magnitude, sector-quantised non-maximum suppression (tan 22.5 / 67.5
    split like cv2's fixed-point comparison), threshold >= 1.  With low ==
    high == 1 the hysteresis is the identity, so this is the whole pipeline
    for piecewise-constant label inputs (reference :144-146)."""
    H, W = img.shape
    xp = F.pad(img.to(torch.float32)[None, None], (1, 1, 1, 1),
               mode="replicate")[0, 0]

    def sh(dy, dx):
        return xp[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    gx = ((sh(-1, 1) + 2 * sh(0, 1) + sh(1, 1))
          - (sh(-1, -1) + 2 * sh(0, -1) + sh(1, -1)))
    gy = ((sh(1, -1) + 2 * sh(1, 0) + sh(1, 1))
          - (sh(-1, -1) + 2 * sh(-1, 0) + sh(-1, 1)))
    mag = torch.abs(gx) + torch.abs(gy)
    magp = F.pad(mag, (1, 1, 1, 1))

    def nb(dy, dx):
        return magp[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    ax, ay = torch.abs(gx), torch.abs(gy)
    tg22, tg67 = 0.41421356, 2.41421356
    horiz = ay <= tg22 * ax
    vert = ay > tg67 * ax
    same_sign = (gx * gy) >= 0
    keep = torch.where(
        horiz, (mag > nb(0, -1)) & (mag >= nb(0, 1)),
        torch.where(
            vert, (mag > nb(-1, 0)) & (mag >= nb(1, 0)),
            torch.where(same_sign,
                        (mag > nb(-1, -1)) & (mag >= nb(1, 1)),
                        (mag > nb(-1, 1)) & (mag >= nb(1, -1)))))
    return (mag >= 1.0) & keep


def adapted_border_label(label: torch.Tensor) -> torch.Tensor:
    """Adapted-border label (reference :129-155): Canny edges of the
    instance partition XOR Canny edges of the binary foreground leave the
    touching borders; dilate and close those, erode the cells, combine."""
    label = label.to(torch.int32)
    label_bin = label > 0
    se = np.ones((3, 3), dtype=bool)
    border = _canny_edges(label) ^ _canny_edges(label_bin.to(torch.int32))
    border_adapted = binary_closing(binary_dilation(border, se), se)
    return _classes(binary_erosion(label_bin, se), border_adapted)


# ---------------------------------------------------------------------------
# Distance labels: per-instance windows, batched
# ---------------------------------------------------------------------------

def _window_bounds(cy, cx, radius: int, H: int, W: int, S: int):
    """Window rows and columns (n, S), the start clamped so the whole (S, S)
    window stays in bounds, and the reference crop's valid rows and columns
    in window coordinates."""
    cy = torch.round(cy).to(torch.int32)
    cx = torch.round(cx).to(torch.int32)
    s = torch.arange(S, dtype=torch.int32, device=cy.device)

    def axis(c, n):
        start = torch.clamp(c - radius, 0, max(n - S, 0))
        g = start[:, None] + s
        v = ((g >= torch.clamp(c - radius, min=0)[:, None])
             & (g < torch.clamp(c + radius, max=n)[:, None]))
        return g.to(torch.int64), v

    gy, vy = axis(cy, H)
    gx, vx = axis(cx, W)
    return gy, gx, vy, vx


def _instances(label: torch.Tensor, max_instances: int):
    """(ids, centroid rows, centroid cols) of the capacity's slots; absent
    slots carry id 0 and a window at (0, 0), which contributes nothing."""
    props = regionprops(label, max_labels=max_instances)
    present = props.area > 0
    ids = torch.arange(1, max_instances + 1, dtype=torch.int32,
                       device=label.device)
    return (torch.where(present, ids, 0),
            torch.where(present, props.centroid[:, 0], 0.0),
            torch.where(present, props.centroid[:, 1], 0.0))


def _slot_chunk(n_slots: int, window: int) -> int:
    """Instances per batch of windows: ~8M window pixels at most."""
    return max(1, min(n_slots, (8 << 20) // (window * window)))


def _windowed(label, ids, cys, cxs, radius, S, window_fn, n_canvases):
    """Run ``window_fn(win, valid, inst) -> tuple of (n, S, S) float32`` on
    chunks of instance windows and add each output into its own (H, W)
    canvas."""
    H, W = label.shape
    canvases = [torch.zeros((H, W), dtype=torch.float32, device=label.device)
                for _ in range(n_canvases)]
    step = _slot_chunk(ids.shape[0], S)
    for s in range(0, ids.shape[0], step):
        gy, gx, vy, vx = _window_bounds(cys[s:s + step], cxs[s:s + step],
                                        radius, H, W, S)
        rows, cols = gy[:, :, None], gx[:, None, :]
        win = label[rows, cols]
        valid = vy[:, :, None] & vx[:, None, :]
        outs = window_fn(win, valid, ids[s:s + step].view(-1, 1, 1))
        idx = (rows.expand_as(win), cols.expand_as(win))
        for canvas, out in zip(canvases, outs):
            canvas.index_put_(idx, out, accumulate=True)
    return canvases


def _max_norm(d: torch.Tensor):
    """(d / its per-window max, that max), 0 where the max is 0."""
    m = d.amax(dim=(-2, -1), keepdim=True)
    return torch.where(m > 0, d / torch.clamp(m, min=1e-12), 0.0), m


def _distance_windows(win, valid, inst):
    """Cell- and neighbour-distance window contributions."""
    nucleus = (win == inst) & valid & (inst > 0)
    # cell distance (reference :289-298)
    cell, max_dist = _max_norm(edt(nucleus, valid))
    # neighbour distance (reference :300-330): distance from this nucleus to
    # the nearest *other* instance within the crop
    other = (win > 0) & (win != inst) & valid
    has_neighbor = other.any(dim=-1, keepdim=True).any(dim=-2, keepdim=True)
    feat = ((win == 0) | (win == inst)) & valid
    d_nb = edt(feat, valid) * nucleus
    max_nb = d_nb.amax(dim=(-2, -1), keepdim=True)
    denom = torch.minimum(max_dist + 3.0, max_nb)
    nb_scaled = torch.clamp(d_nb / torch.clamp(denom, min=1e-12), 0.0, 1.0)
    neighbor = (1.0 - nb_scaled) * nucleus
    neighbor = torch.where(has_neighbor & (max_nb > 0) & (max_dist > 0),
                           neighbor, 0.0)
    return cell, neighbor


def _closing_canvas(label, ids, cys, cxs, radius, S, se):
    """OR of per-instance binary closings over each whole window (reference
    bottom_hat_closing :48-55 closes each nucleus with disk(3))."""
    def closed(win, valid, inst):
        return (binary_closing((win == inst) & (inst > 0), se).to(
            torch.float32),)

    (canvas,) = _windowed(label, ids, cys, cxs, radius, S, closed, 1)
    return canvas > 0


def _gap_ring_sums(gaps: torch.Tensor, label_nb: torch.Tensor,
                   max_gaps: int) -> torch.Tensor:
    """Per-gap boundary sum: sum of label_nb over each gap's 8-connected
    ring (pixels next to the gap, not in it), slots 1..max_gaps, float64.
    Each pixel finds the distinct gap ids among its 8 neighbours and adds
    its label_nb to each (the JAX function's path for more than 256 gaps,
    the same sums as its per-gap rings)."""
    H, W = gaps.shape
    padded = F.pad(gaps, (1, 1, 1, 1))
    shifted = [padded[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
               for dy in (-1, 0, 1) for dx in (-1, 0, 1)
               if (dy, dx) != (0, 0)]
    total = torch.zeros(max_gaps + 1, dtype=torch.float64,
                        device=gaps.device)
    values = label_nb.to(torch.float64)
    for k, s in enumerate(shifted):
        contrib = (s > 0) & (s <= max_gaps) & (s != gaps)
        for j in range(k):   # count each (pixel, gap) pair once
            contrib &= shifted[j] != s
        total.index_add_(0, s[contrib].to(torch.int64), values[contrib])
    return total[1:]


def distance_label_device(label: torch.Tensor, radius: int,
                          max_instances: int = 128, window: int = 64,
                          max_gaps: int = 64):
    """Cell-distance and neighbour-distance labels (reference
    distance_label :261-361).  ``label`` int (H, W) with ids 1..n,
    ``radius`` the search radius, ``window`` the (S, S) window size >=
    2 * radius.  Returns two float32 (H, W) tensors."""
    label = label.to(torch.int32)
    ids, cys, cxs = _instances(label, max_instances)
    label_dist, label_nb = _windowed(label, ids, cys, cxs, radius, window,
                                     _distance_windows, 2)

    # gaps via the bottom-hat closing (reference :332-354)
    se3 = disk(3)
    label_bin = _closing_canvas(label, ids, cys, cxs, radius, window, se3)
    bottom_hat = binary_closing(label_bin, se3) ^ label_bin
    gaps = cc.relabel_sequential(cc.connected_components(bottom_hat))
    gprops = regionprops(gaps, max_labels=max_gaps)
    ring_sums = _gap_ring_sums(gaps, label_nb, max_gaps)

    areas = gprops.area
    th = torch.where(areas <= 20, 5.0,
                     torch.where(areas <= 30, 8.0,
                                 torch.where(areas <= 50, 10.0, 20.0)))
    keep = (areas > 0) & (ring_sums >= th)          # artifact filter :337-350
    thick = gprops.minor_axis_length >= 3.0         # gap integration :66-70

    # ids beyond max_gaps have no keep/thick slot: treated as artifacts
    in_range = (gaps > 0) & (gaps <= max_gaps)
    slot = torch.clamp(gaps - 1, 0, max_gaps - 1).to(torch.int64)
    gap_keep = keep[slot] & in_range
    gap_thick = thick[slot] & in_range
    corr = gap_keep.to(torch.float32)
    # thick gaps: interior 1.0, 1-px inner border 0.8 (reference :65-70)
    interior = binary_erosion(gaps > 0, generate_binary_structure(2, 1))
    gap_border = (gaps > 0) & ~interior
    corr = torch.where(gap_thick & gap_keep,
                       torch.where(gap_border, 0.8, 1.0), corr)

    label_nb = torch.maximum(label_nb, corr)
    label_nb = torch.maximum(label_nb, border_mask(label).to(torch.float32))
    # nonlinear rescale + grey closing (reference :357-359)
    label_nb = 1.0 / torch.sqrt(
        0.65 + 0.5 * torch.exp(-11.0 * (label_nb - 0.75))) - 0.19
    label_nb = grey_closing(torch.clamp(label_nb, 0.0, 1.0))
    return label_dist, label_nb


def cell_distance_label_device(label: torch.Tensor, radius: int,
                               max_instances: int = 128, window: int = 64,
                               apply_clipping: bool = False,
                               clip_val: float = 5.0) -> torch.Tensor:
    """Cell-distance-only label (reference cell_distance_label :220-258)."""
    label = label.to(torch.int32)
    ids, cys, cxs = _instances(label, max_instances)

    def one(win, valid, inst):
        d = edt((win == inst) & valid & (inst > 0), valid)
        return (d if apply_clipping else _max_norm(d)[0],)

    (out,) = _windowed(label, ids, cys, cxs, radius, window, one, 1)
    if apply_clipping:
        out = torch.clamp(out, 0.0, clip_val) / clip_val
    return out


# ---------------------------------------------------------------------------
# Host-facing dispatch (reference get_label :11-37)
# ---------------------------------------------------------------------------

def _bucket(n: int, buckets=(16, 32, 48, 64, 96, 128, 192, 256, 384, 512,
                             768, 1024, 1536, 2048, 3072, 4096, 6144,
                             8192)) -> int:
    """Smallest bucket >= n (saturating at the top): the instance capacity
    and the window size."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _dense_relabel(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    ids = np.unique(mask)
    ids = ids[ids > 0]
    dense = np.searchsorted(ids, mask) + 1
    dense = np.where(mask > 0, dense, 0).astype(np.int32)
    return dense, len(ids)


def max_major_axis_length(mask: np.ndarray, device=None) -> int:
    """ceil(max major axis) over instances (reference train.py:74-79)."""
    dense, n = _dense_relabel(mask)
    if not n:
        return 0
    props = regionprops(torch.from_numpy(dense).to(resolve_device(device)),
                        max_labels=_bucket(n + 1))
    return int(np.ceil(props.major_axis_length.max().item()))


_LABEL_FNS = {"boundary": boundary_label, "border": border_label,
              "adapted_border": adapted_border_label, "j4": j4_label}


def get_label(mask: np.ndarray, label_type: str, max_mal: int = 0,
              device=None):
    """Label-generation dispatch, host entry point: numpy in, numpy out;
    for 'distance' a (cell_dist, neighbor_dist) tuple (reference get_label
    :11-37).  Runs on the CUDA card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    mask = np.asarray(mask)
    if label_type in _LABEL_FNS:
        return _LABEL_FNS[label_type](
            torch.from_numpy(mask.astype(np.int32)).to(dev)).cpu().numpy()

    dense, n = _dense_relabel(mask)
    if n + 1 > 8192:
        # _bucket saturates at its top entry; past it, instances would get
        # silently ZERO labels
        raise ValueError(
            f"{n} instances exceed the 8192-instance label-generation "
            f"capacity; split the frame into crops")
    radius = int(np.ceil(0.75 * max_mal))
    H, W = mask.shape
    # the (S, S) window must cover 2 * radius, or the per-instance window
    # is truncated and mis-centred: pad the canvas up to the window
    window = _bucket(max(2 * radius, 8))
    radius = min(radius, window // 2)
    Hp, Wp = max(H, window), max(W, window)
    if (Hp, Wp) != (H, W):
        dense = np.pad(dense, ((0, Hp - H), (0, Wp - W)))
    cap = max(_bucket(n + 1), 16)
    dense = torch.from_numpy(dense).to(dev)
    if label_type in ("cell_dist", "cell_dist_clipped"):
        out = cell_distance_label_device(
            dense, radius, max_instances=cap, window=window,
            apply_clipping=(label_type == "cell_dist_clipped"))
        return out[:H, :W].cpu().numpy()
    if label_type == "distance":
        cell, nb = distance_label_device(
            dense, radius, max_instances=cap, window=window,
            max_gaps=max(cap, 64))
        return cell[:H, :W].cpu().numpy(), nb[:H, :W].cpu().numpy()
    raise ValueError(f"Label type not known: {label_type!r}")
