"""Instance-segmentation metrics: AJI+, AJI, PQ, Dice.

A copy of ``microbeseg_tpu/evaluation/metrics.py`` (host numpy and scipy;
the port imports nothing of the JAX package).  Same semantics as the
HoVer-Net metrics the reference vendors (reference:
src/evaluation/stats_utils.py — get_fast_aji_plus :98-179, get_fast_aji
:16-94, get_fast_pq :183-284, dice :288-361, remap_label :365-394), on a
sparse contingency table: one bincount over (true_id, pred_id) pairs
replaces the per-instance boolean-mask loops.  Only AJI+ feeds model
selection (reference eval.py:261).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment


def remap_label(pred: np.ndarray, by_size: bool = False) -> np.ndarray:
    """Renumber instances to 1..n (optionally largest-first).

    One bincount + one table gather — O(HW + max_id), no per-instance
    full-frame scans (reference stats_utils.py:365-394 loops per instance).
    Ids <= 0 map to background; when max_id vastly exceeds the id count
    (sparse int32/int64 labels) the lookup falls back to searchsorted so
    the table allocation stays bounded.
    """
    pred = np.asarray(pred)
    ids = np.unique(pred)
    ids = ids[ids > 0]
    if len(ids) == 0:
        return np.zeros_like(pred)
    if by_size:
        counts = np.bincount(
            np.searchsorted(ids, pred.ravel()) + 1,
            weights=(pred.ravel() > 0).astype(np.float64),
            minlength=len(ids) + 2)[1:len(ids) + 1]
        # stable sort on -size keeps original id order among equal sizes
        order = np.argsort(-counts, kind="stable")
    else:
        order = np.arange(len(ids))
    new_ids = np.empty(len(ids), dtype=pred.dtype)
    new_ids[order] = np.arange(1, len(ids) + 1, dtype=pred.dtype)
    max_id = int(ids[-1])
    if max_id <= max(65536, 4 * pred.size):
        table = np.zeros(max_id + 1, dtype=pred.dtype)
        table[ids] = new_ids
        return np.where(pred > 0, table[np.clip(pred, 0, max_id)], 0)
    # sparse fallback: O(HW log n) lookup, no O(max_id) allocation
    idx = np.searchsorted(ids, pred)
    idx = np.clip(idx, 0, len(ids) - 1)
    hit = (pred > 0) & (ids[idx] == pred)
    return np.where(hit, new_ids[idx], 0).astype(pred.dtype)


def _contingency(true: np.ndarray, pred: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(inter[nt, np], true_areas[nt], pred_areas[np]) with dense 1..n ids."""
    true = remap_label(true)
    pred = remap_label(pred)
    nt = int(true.max())
    npred = int(pred.max())
    t = true.ravel().astype(np.int64)
    p = pred.ravel().astype(np.int64)
    true_areas = np.bincount(t, minlength=nt + 1)[1:].astype(np.float64)
    pred_areas = np.bincount(p, minlength=npred + 1)[1:].astype(np.float64)
    both = (t > 0) & (p > 0)
    pair = t[both] * (npred + 1) + p[both]
    counts = np.bincount(pair, minlength=(nt + 1) * (npred + 1))
    inter = counts.reshape(nt + 1, npred + 1)[1:, 1:].astype(np.float64)
    return inter, true_areas, pred_areas


def get_fast_aji_plus(true: np.ndarray, pred: np.ndarray) -> float:
    """AJI+ — Hungarian 1-to-1 pairing maximizing IoU; unpaired instances
    count toward the union (reference :98-179)."""
    inter, ta, pa = _contingency(true, pred)
    nt, npred = inter.shape
    if nt == 0 and npred == 0:
        return 0.0
    if nt == 0 or npred == 0:
        return 0.0
    union = ta[:, None] + pa[None, :] - inter
    iou = inter / (union + 1e-6)
    rows, cols = linear_sum_assignment(-iou)
    good = iou[rows, cols] > 0
    rows, cols = rows[good], cols[good]
    overall_inter = inter[rows, cols].sum()
    overall_union = union[rows, cols].sum()
    unpaired_true = np.setdiff1d(np.arange(nt), rows)
    unpaired_pred = np.setdiff1d(np.arange(npred), cols)
    overall_union += ta[unpaired_true].sum() + pa[unpaired_pred].sum()
    if overall_union == 0:
        return 0.0
    return float(overall_inter / overall_union)


def get_fast_aji(true: np.ndarray, pred: np.ndarray) -> float:
    """Original AJI — each GT pairs with its best-IoU overlapping prediction
    (1-to-many over-penalization; reference :16-94)."""
    inter, ta, pa = _contingency(true, pred)
    nt, npred = inter.shape
    if nt == 0 or npred == 0:
        return 0.0
    union = ta[:, None] + pa[None, :] - inter
    iou = inter / (union + 1e-6)
    best = np.argmax(iou, axis=1)
    best_iou = iou[np.arange(nt), best]
    paired_t = best_iou > 0
    overall_inter = inter[np.arange(nt)[paired_t], best[paired_t]].sum()
    overall_union = union[np.arange(nt)[paired_t], best[paired_t]].sum()
    overall_union += ta[~paired_t].sum()
    used_pred = np.unique(best[paired_t])
    unused = np.setdiff1d(np.arange(npred), used_pred)
    overall_union += pa[unused].sum()
    if overall_union == 0:
        return 0.0
    return float(overall_inter / overall_union)


def get_fast_pq(true: np.ndarray, pred: np.ndarray, match_iou: float = 0.5):
    """Panoptic quality [dq, sq, pq] + pairing (reference :183-284)."""
    inter, ta, pa = _contingency(true, pred)
    nt, npred = inter.shape
    if nt == 0 and npred == 0:
        return [0.0, 0.0, 0.0], (np.array([]), np.array([]))
    union = ta[:, None] + pa[None, :] - inter if nt and npred else np.zeros((nt, npred))
    iou = inter / (union + 1e-6) if nt and npred else np.zeros((nt, npred))
    if match_iou >= 0.5:
        rows, cols = np.nonzero(iou > match_iou)
        paired_iou = iou[rows, cols]
    else:
        rows, cols = linear_sum_assignment(-iou)
        paired_iou = iou[rows, cols]
        good = paired_iou > match_iou
        rows, cols, paired_iou = rows[good], cols[good], paired_iou[good]
    tp = len(rows)
    fp = npred - tp
    fn = nt - tp
    dq = tp / (tp + 0.5 * fp + 0.5 * fn) if (tp + fp + fn) else 0.0
    sq = paired_iou.mean() if tp else 0.0
    return [float(dq), float(sq), float(dq * sq)], (rows + 1, cols + 1)


def get_dice_1(true: np.ndarray, pred: np.ndarray) -> float:
    """Traditional binary dice (reference :288-304)."""
    t = np.asarray(true) > 0
    p = np.asarray(pred) > 0
    denom = t.sum() + p.sum()
    if denom == 0:
        return 0.0
    return float(2.0 * (t & p).sum() / denom)


def get_fast_dice_2(true: np.ndarray, pred: np.ndarray) -> float:
    """Ensemble (instance-aware) dice: each GT paired with its max-overlap
    prediction (reference :307-361)."""
    inter, ta, pa = _contingency(true, pred)
    nt, npred = inter.shape
    if nt == 0 or npred == 0:
        return 0.0
    total_markup = 0.0
    total_intersect = 0.0
    for ti in range(nt):
        overlaps = inter[ti]
        if overlaps.max() <= 0:
            continue
        pi = int(np.argmax(overlaps))
        total_intersect += inter[ti, pi]
        total_markup += ta[ti] + pa[pi]
    if total_markup == 0:
        return 0.0
    return float(2.0 * total_intersect / total_markup)


def pair_coordinates(set_a: np.ndarray, set_b: np.ndarray, radius: float
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Optimal unique point pairing under a distance budget (reference
    src/evaluation/stats_utils.py:398-434; unused by the app, kept for
    drop-in stats_utils completeness).

    Hungarian assignment on the Euclidean cost matrix between the (N, 2)
    coordinate sets, then pairs farther apart than ``radius`` are discarded.
    Returns (pairing (k, 2) of [index_in_a, index_in_b], unpaired_a indices,
    unpaired_b indices).  Host-side on purpose: eval-only, tiny matrices
    (SURVEY §2.2 Hungarian row).
    """
    set_a = np.asarray(set_a, dtype=np.float64)
    set_b = np.asarray(set_b, dtype=np.float64)
    # cdist without scipy.spatial: |a-b|^2 = |a|^2 + |b|^2 - 2 a.b
    d2 = (np.sum(set_a ** 2, axis=1)[:, None]
          + np.sum(set_b ** 2, axis=1)[None, :]
          - 2.0 * set_a @ set_b.T)
    dist = np.sqrt(np.maximum(d2, 0.0))
    idx_a, idx_b = linear_sum_assignment(dist)
    close = dist[idx_a, idx_b] <= radius
    paired_a, paired_b = idx_a[close], idx_b[close]
    pairing = np.stack([paired_a, paired_b], axis=-1)
    unpaired_a = np.delete(np.arange(set_a.shape[0]), paired_a)
    unpaired_b = np.delete(np.arange(set_b.shape[0]), paired_b)
    return pairing, unpaired_a, unpaired_b
