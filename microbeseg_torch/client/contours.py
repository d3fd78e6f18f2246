"""Contour extraction and polygon rasterization (host-side).

A copy of ``microbeseg_tpu/client/contours.py`` for the port, which imports
nothing of the JAX package.  First-party replacements for the reference's
cv2.findContours + shapely contour path (reference:
src/utils/hull_polygon.py:44-89 ``cv2_countour``) and skimage.draw.polygon
rasterization (reference: src/utils/data_export.py:60-70,
result_export.py, analysis.py).  These feed the OMERO polygon-ROI contract:
per-instance outer boundary as an ordered (x, y) vertex list.

This is host code on numpy arrays: contours only serialise masks for the
store, they are not on the device path.  The C++ library of
``native/contours.cpp`` (``client/native.py``) is the fast route; the
Python loops here are its plain versions, with the same output.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np

# 'x,y x,y ...' where every whitespace-separated token carries exactly one
# comma (values may be signed floats/ints; exponent forms included)
_ROI_POINTS_RE = re.compile(r"\s*(?:[^,\s]+,[^,\s]+(?:\s+|\s*$))+")

# Moore neighborhood in clockwise order starting from W
_MOORE = [(0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1)]


def trace_boundary(mask: np.ndarray) -> np.ndarray:
    """Trace the outer boundary of a binary object (Moore neighbor tracing
    with Jacob's stopping criterion).  Returns (n, 2) array of (y, x) pixel
    coordinates, clockwise.  Uses the native C++ tracer when available
    (native/contours.cpp); this Python path is the semantics-identical
    fallback."""
    from microbeseg_torch.client.native import trace_boundary_native
    native = trace_boundary_native(np.asarray(mask).astype(np.int32), 1)
    if native is not None:
        return native
    mask = np.asarray(mask).astype(bool)
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return np.zeros((0, 2), dtype=np.int64)
    # start: topmost-leftmost pixel
    i = np.lexsort((xs, ys))[0]
    start = (int(ys[i]), int(xs[i]))
    if len(ys) == 1:
        return np.array([start])

    H, W = mask.shape

    def at(p):
        y, x = p
        return 0 <= y < H and 0 <= x < W and mask[y, x]

    contour = [start]
    # backtrack: the point we came from; start from W of the start pixel
    prev_dir = 0  # index into _MOORE pointing to the backtrack cell
    cur = start
    first_next = None
    while True:
        found = False
        for k in range(8):
            d = (prev_dir + 1 + k) % 8
            cand = (cur[0] + _MOORE[d][0], cur[1] + _MOORE[d][1])
            if at(cand):
                # new backtrack = direction pointing back toward cur
                prev_dir = (d + 4) % 8
                # rotate so the scan starts just after the backtrack
                cur = cand
                found = True
                break
        if not found:  # isolated pixel cluster
            break
        if first_next is None:
            first_next = cur
        elif cur == first_next and contour[-1] == start:
            break
        contour.append(cur)
        if len(contour) > 4 * (H * W):
            break  # safety
    # drop the duplicated closing vertex if present
    if len(contour) > 1 and contour[-1] == start:
        contour.pop()
    return np.array(contour, dtype=np.int64)


def trace_holes(mask: np.ndarray) -> List[np.ndarray]:
    """Boundaries of interior holes of a binary object.

    A hole is a 4-connected background component not touching the image
    border (the complement-connectivity dual of the 8-connected object).
    Each hole's boundary is Moore-traced like an outer contour.  Returns a
    list of (n, 2) (y, x) arrays (reference: cv2.findContours RETR_TREE
    yields these as child contours, hull_polygon.py:56-80).
    """
    from scipy import ndimage

    mask = np.asarray(mask).astype(bool)
    bg, n_bg = ndimage.label(~mask, structure=np.array(
        [[0, 1, 0], [1, 1, 1], [0, 1, 0]]))
    if n_bg == 0:
        return []
    border_ids = np.unique(np.concatenate(
        [bg[0, :], bg[-1, :], bg[:, 0], bg[:, -1]]))
    holes = []
    for b in range(1, n_bg + 1):
        if b in border_ids:
            continue
        contour = trace_boundary(bg == b)
        if len(contour):
            holes.append(contour)
    return holes


def polygon_covers(outer_xy: np.ndarray, inner_xy: np.ndarray) -> bool:
    """True if polygon ``outer`` covers polygon ``inner`` (every vertex of
    inner inside or on outer) — the shapely ``Polygon.covers`` decision the
    reference uses to pick the covering outer shape when holes are present
    (hull_polygon.py:62-80), without the shapely dependency."""
    outer = np.asarray(outer_xy, np.float64)
    inner = np.asarray(inner_xy, np.float64)
    if len(outer) < 3 or len(inner) == 0:
        return False
    x, y = outer[:, 0], outer[:, 1]
    x2, y2 = np.roll(x, -1), np.roll(y, -1)
    px = inner[:, 0][:, None]
    py = inner[:, 1][:, None]
    # on-boundary: vertex coincides with an outer vertex (integer contours)
    on = np.any((px == x[None, :]) & (py == y[None, :]), axis=1)
    cond = ((y[None, :] <= py) & (y2[None, :] > py)) | \
           ((y2[None, :] <= py) & (y[None, :] > py))
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (py - y[None, :]) / (y2[None, :] - y[None, :])
    xint = x[None, :] + t * (x2[None, :] - x[None, :])
    crossings = np.sum(cond & (px < xint), axis=1)
    inside = (crossings % 2) == 1
    return bool(np.all(inside | on))


def mask_to_polygons(labels: np.ndarray,
                     include_holes: bool = False) -> Dict[int, List[np.ndarray]]:
    """Per-instance contours: {id: [(n, 2) arrays of (x, y) vertices]}.

    One contour per connected fragment of the instance (the reference's
    cv2_countour returns a contour list per id, hull_polygon.py:44-89).
    Fragments with interior holes are handled as the reference does: the
    hole contours are traced, the covering outer contour is identified via
    the covers test, and only the outer contour represents the fragment in
    the ROI (hull_polygon.py:62-80 returns the covering shape).  Pass
    ``include_holes=True`` to ALSO get each fragment's hole contours
    appended after its outer contour.  The x-y order matches the OMERO
    polygon ROI string convention.
    """
    from scipy import ndimage

    labels = np.asarray(labels)
    if not include_holes:
        # native batch path: one C call traces every fragment of every
        # instance (same polygon order/vertices as the loop below, which is
        # ~0.4 ms/instance of interpreter overhead — tested identical)
        from microbeseg_torch.client.native import trace_all_native
        res = trace_all_native(labels)
        if res is not None:
            xy, offsets, ids = res
            batched: Dict[int, List[np.ndarray]] = {}
            for p in range(len(ids)):
                batched.setdefault(int(ids[p]), []).append(
                    xy[offsets[p]:offsets[p + 1]])
            return batched
    out: Dict[int, List[np.ndarray]] = {}
    # per-instance bounding boxes in ONE pass: a full-frame `labels == id`
    # scan per instance is O(instances * H * W) — ~10 s/frame at 2048^2 with
    # ~2K cells (the round-3 scale run's host bottleneck); all per-instance
    # work below runs on the instance's crop instead
    slices = ndimage.find_objects(labels.astype(np.int32))
    for idx, sl in enumerate(slices):
        if sl is None:
            continue
        inst_id = idx + 1
        y0, x0 = sl[0].start, sl[1].start
        inst = labels[sl] == inst_id
        frags, n_frags = ndimage.label(inst, structure=np.ones((3, 3)))
        contours = []
        for f in range(1, n_frags + 1):
            frag = frags == f
            contour_yx = trace_boundary(frag)
            if len(contour_yx) == 0:
                continue
            contour_yx = contour_yx + np.array([[y0, x0]])
            outer_xy = contour_yx[:, ::-1].copy()       # (x, y)
            contours.append(outer_xy)
            if include_holes:
                # reference semantics keep only the covering outer shape in
                # the ROI; holes are traced on request (the default path
                # skips the background labeling + covers tests entirely)
                holes = [h + np.array([[y0, x0]])
                         for h in trace_holes(frag)]
                contours.extend(h[:, ::-1].copy() for h in holes
                                if polygon_covers(outer_xy, h[:, ::-1]))
        if contours:
            out[int(inst_id)] = contours
    return out


def polygons_to_roi_strings(polygons: Dict[int, List[np.ndarray]]) -> List[str]:
    """OMERO polygon ROI point strings: 'x1,y1 x2,y2 ...' per contour."""
    return [" ".join(f"{x},{y}" for x, y in poly)
            for contours in polygons.values() for poly in contours]


def mask_to_roi_strings(labels: np.ndarray) -> List[str]:
    """OMERO points strings for every fragment of every instance, in
    mask_to_polygons order (ids ascending, fragments in raster order).
    The all-native path (trace + ASCII serialization in C) skips both the
    per-instance Python loop and the per-vertex f-string join — the two
    dominant host costs of ROI upload at scale (docs/E2E_RESULTS.md)."""
    from microbeseg_torch.client.native import roi_strings_native, \
        trace_all_native

    res = trace_all_native(np.asarray(labels))
    if res is not None:
        xy, offsets, ids = res
        strings = roi_strings_native(xy, offsets)
        if strings is not None:
            return strings
        return [" ".join(f"{x},{y}" for x, y in
                         xy[offsets[p]:offsets[p + 1]])
                for p in range(len(ids))]
    return polygons_to_roi_strings(mask_to_polygons(labels))


def roi_string_to_polygon(points: str) -> np.ndarray:
    """Parse 'x1,y1 x2,y2 ...' (allows 'x,y' with float values)."""
    # fast path: C-speed parse of the whole string (a 2048^2 frame holds
    # ~2K polygons x ~50 points; the per-token Python loop was measurable
    # across a 2D+t stack).  Only valid when every point token carries
    # exactly one comma — 'x,y,z' tokens would otherwise reshape into
    # scrambled pairs, so those fall through to the defensive parser.
    normalized = points.replace(";", " ")
    # token-count balancing alone is foolable ('1,2,3 4' has 4 subtokens
    # for 2 points); the regex fullmatch validates one-comma-per-token at
    # C speed before the vectorized parse
    if _ROI_POINTS_RE.fullmatch(normalized):
        toks = normalized.replace(",", " ").split()
        try:
            return np.asarray(toks, dtype=np.float64).reshape(-1, 2)
        except ValueError:
            pass
    pts = []
    for tok in points.replace(";", " ").split():
        x, y = tok.split(",")[:2]
        pts.append((float(x), float(y)))
    return np.array(pts, dtype=np.float64)


def polygon_to_mask(poly_xy: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Rasterize a polygon given as (n, 2) (x, y) vertices into a boolean
    mask (skimage.draw.polygon semantics: pixel centers inside the polygon,
    boundary-inclusive via a half-open crossing test + explicit boundary).
    Native C++ fast path when available."""
    from microbeseg_torch.client.native import rasterize_polygon_native
    native = rasterize_polygon_native(np.asarray(poly_xy, np.float64), shape)
    if native is not None:
        return native
    H, W = shape
    poly = np.asarray(poly_xy, dtype=np.float64)
    if len(poly) < 3:
        m = np.zeros(shape, bool)
        xs = np.clip(np.round(poly[:, 0]).astype(int), 0, W - 1)
        ys = np.clip(np.round(poly[:, 1]).astype(int), 0, H - 1)
        m[ys, xs] = True
        return m
    x = poly[:, 0]
    y = poly[:, 1]

    # bound all work to the polygon's bbox, like the native path: the
    # crossing test materializes (h, w, n_vertices) intermediates, which at
    # full-frame extent is GBs per polygon x thousands of polygons/frame —
    # a per-instance full-frame scan, the documented scale killer
    y0 = max(int(np.floor(y.min())), 0)
    y1 = min(int(np.ceil(y.max())) + 1, H)
    x0 = max(int(np.floor(x.min())), 0)
    x1 = min(int(np.ceil(x.max())) + 1, W)
    inside = np.zeros(shape, bool)
    if y1 <= y0 or x1 <= x0:
        return inside
    xl = x - x0
    yl = y - y0
    x2 = np.roll(xl, -1)
    y2 = np.roll(yl, -1)

    h, w = y1 - y0, x1 - x0
    yy = np.arange(h, dtype=np.float64)[:, None, None]   # (h, 1, 1)
    xx = np.arange(w, dtype=np.float64)[None, :, None]   # (1, w, 1)
    # crossing-number test per pixel center
    cond = ((yl[None, None, :] <= yy) & (y2[None, None, :] > yy)) | \
           ((y2[None, None, :] <= yy) & (yl[None, None, :] > yy))
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (yy - yl[None, None, :]) / (y2[None, None, :] - yl[None, None, :])
    xint = xl[None, None, :] + t * (x2[None, None, :] - xl[None, None, :])
    crossings = np.sum(cond & (xx < xint), axis=-1)
    inside[y0:y1, x0:x1] = (crossings % 2) == 1
    # include boundary vertices (skimage.draw.polygon includes the outline
    # pixels of integer-coordinate polygons in almost all cases)
    xs = np.clip(np.round(x).astype(int), 0, W - 1)
    ys = np.clip(np.round(y).astype(int), 0, H - 1)
    inside[ys, xs] = True
    return inside


def get_indices_pandas(labels: np.ndarray) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """{instance id: (ys, xs)} pixel indices (reference hull_polygon.py:8-41
    — the pandas groupby trick replaced with a single argsort pass)."""
    labels = np.asarray(labels)
    flat = labels.ravel()
    order = np.argsort(flat, kind="stable")
    sorted_vals = flat[order]
    uniq, starts = np.unique(sorted_vals, return_index=True)
    out = {}
    H, W = labels.shape
    for i, val in enumerate(uniq):
        if val == 0:
            continue
        end = starts[i + 1] if i + 1 < len(starts) else len(flat)
        idx = order[starts[i]:end]
        out[int(val)] = (idx // W, idx % W)
    return out
