"""The numbers that decide ``correct``: instance masks against the
reference's, and a training step's loss, first gradient and parameter
change against the reference's."""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch


def mask_counts(pred: np.ndarray, ref: np.ndarray) -> Tuple[int, int]:
    """(foreground pixels of either mask, pixels of instance pairs that
    match: pred and ref instances of IoU above 0.5, a one-to-one pairing)."""
    p = pred.astype(np.int64).ravel()
    r = ref.astype(np.int64).ravel()
    union = int(np.count_nonzero((p > 0) | (r > 0)))
    both = (p > 0) & (r > 0)
    if not both.any():
        return union, 0
    k = int(r.max()) + 1
    pairs, inter = np.unique(p[both] * k + r[both], return_counts=True)
    pi, ri = pairs // k, pairs % k
    size_p = np.bincount(p, minlength=int(p.max()) + 1)
    size_r = np.bincount(r, minlength=k)
    iou = inter / (size_p[pi] + size_r[ri] - inter)
    return union, int(inter[iou > 0.5].sum())


def mask_mismatch(preds: Iterable[np.ndarray],
                  refs: Iterable[np.ndarray]) -> Dict[str, float]:
    """Over all frames: the share of foreground pixels outside matched
    instance pairs (``mask_mismatch``), and the largest such share of one
    frame (``worst_frame``)."""
    tot_u = tot_m = 0
    worst = 0.0
    n = 0
    for p, r in zip(preds, refs):
        if p.shape != r.shape:
            raise ValueError(f"mask shapes {p.shape} and {r.shape}")
        for pf, rf in zip(p.reshape(-1, *p.shape[-2:]),
                          r.reshape(-1, *r.shape[-2:])):
            u, m = mask_counts(pf, rf)
            tot_u, tot_m, n = tot_u + u, tot_m + m, n + 1
            worst = max(worst, 1.0 - m / u if u else 0.0)
    return {"mask_mismatch": 1.0 - tot_m / tot_u if tot_u else 1.0,
            "worst_frame": worst, "frames": float(n)}


def leaf_norm_gaps(got: Dict[str, torch.Tensor],
                   ref: Dict[str, torch.Tensor],
                   leaves: List[str]) -> Dict[str, float]:
    """Per leaf, the gap between the two norms over the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    rn = {n: float(torch.linalg.vector_norm(ref[n].double())) for n in leaves}
    gn = {n: float(torch.linalg.vector_norm(got[n].double())) for n in leaves}
    med = float(np.median(list(rn.values())))
    return {n: abs(gn[n] - rn[n]) / max(rn[n], med, 1e-30) for n in leaves}


def worst_and_median(gaps: Dict[str, float]) -> Tuple[float, str, float]:
    """(the worst leaf's gap, that leaf, the median leaf's gap)."""
    name = max(gaps, key=gaps.get)
    return gaps[name], name, float(np.median(list(gaps.values())))


def moving_leaves(ref_grads: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient norm is at least a thousandth of the
    median leaf's: the others move by round-off alone."""
    norms = {n: float(torch.linalg.vector_norm(g.double()))
             for n, g in ref_grads.items()}
    med = float(np.median(list(norms.values())))
    return [n for n, v in norms.items() if v >= 1e-3 * med]


def field_error(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst frame's RMS error of a (T, H, W) field over the RMS of the
    reference's field on that frame."""
    d = (got.float() - ref.float()).pow(2).mean(dim=(1, 2)).sqrt()
    r = ref.float().pow(2).mean(dim=(1, 2)).sqrt()
    return float((d / torch.clamp(r, min=1e-30)).max())
