"""Distance-method instance extraction, batched over frames.

Port of ``microbeseg_tpu/ops/postprocessing.py::distance_postprocessing``:
gaussian smoothing, seed thresholding, connected components, root-rank
relabel, small-seed prune, then the marker flood -> uint16 masks.  The JAX
function works on one frame and the engine vmaps it; here the batch axis is
explicit, and the quantisation and the prune statistics stay per image.
"""

from __future__ import annotations

from typing import Union

import torch

from microbeseg_torch.ops import cc
from microbeseg_torch.ops.filters import gaussian_filter
from microbeseg_torch.ops.kernels import flood
from microbeseg_torch.ops.watershed import watershed

_MAX_PACKED = (1 << 24) - 1


def _prune_small_seeds(seeds_bin: torch.Tensor, min_area_floor: float,
                       rel_mean: float, max_seeds: int = 256,
                       cc_fn=cc.connected_components,
                       rank_fn=cc.sequentialize_components) -> torch.Tensor:
    """Label seed components sequentially, drop those with area <=
    max(rel_mean * mean_area, floor), compact the survivors to 1..n and drop
    ids past ``max_seeds``.  seeds_bin (B, H, W) bool -> (B, H, W) int32.

    The area pass runs with raw_cap = max(4 * max_seeds, 1024) component
    ranks, so speckle that outnumbers the real seeds cannot push them past
    the cap; the mean area includes the speckle, as the reference's does.
    Areas are a batched ``bincount``; the table lookup a ``gather``.
    ``cc_fn`` and ``rank_fn`` label and rank the components."""
    rank = rank_fn(cc_fn(seeds_bin))
    B = rank.shape[0]
    raw_cap = min(max(4 * max_seeds, 1024), _MAX_PACKED)
    rank = torch.where(rank > raw_cap, 0, rank).view(B, -1).to(torch.int64)
    offsets = torch.arange(B, device=rank.device).view(B, 1) * (raw_cap + 1)
    areas = torch.bincount((rank + offsets).view(-1),
                           minlength=B * (raw_cap + 1))
    areas = areas.view(B, raw_cap + 1).to(torch.float32)
    areas[:, 0] = 0.0
    n = (areas > 0).sum(dim=1)
    mean_area = areas.sum(dim=1) / torch.clamp(n, min=1).to(torch.float32)
    rel = torch.tensor(rel_mean, dtype=torch.float32, device=rank.device)
    min_area = torch.where(n > 0, rel * mean_area,
                           torch.zeros_like(mean_area))
    min_area = torch.clamp(min_area, min=float(min_area_floor))
    kept = areas > min_area[:, None]
    table = torch.cumsum(kept.to(torch.int32), dim=1, dtype=torch.int32)
    table = torch.where(kept & (table <= max_seeds), table, 0)
    return torch.gather(table, 1, rank).view(seeds_bin.shape).to(torch.int32)


def distance_postprocessing(border_prediction: torch.Tensor,
                            cell_prediction: torch.Tensor,
                            th_seed: Union[float, torch.Tensor],
                            th_cell: Union[float, torch.Tensor],
                            max_seeds: int = 256, n_levels: int = 128,
                            method: str = "auto") -> torch.Tensor:
    """Distance-method post-processing of (B, H, W) or (H, W) predictions.

    Returns uint16 instance masks.  ``method``: 'auto' = the packed-key
    flood on CUDA, the 'flood' watershed on the CPU (as the JAX package
    picks the Pallas flood on accelerators and the XLA flood on the CPU);
    'flood' = the quantised priority flood of ``ops/watershed``; 'pallas' =
    the packed-key flood (kernel K1), named as in the JAX package."""
    return _distance_postprocessing(border_prediction, cell_prediction,
                                    th_seed, th_cell, max_seeds, n_levels,
                                    method)


def _distance_postprocessing(border_prediction, cell_prediction, th_seed,
                             th_cell, max_seeds=256, n_levels=128,
                             method="auto", cc_fn=cc.connected_components,
                             rank_fn=cc.sequentialize_components,
                             flood_fn=flood.flood_or_fallback):
    """``distance_postprocessing`` with its kernels as arguments, so that
    the plain versions can run on the card as the kernels' reference.
    ``flood_fn(value, markers, mask, n_levels=, max_label=)`` is the
    'pallas' method's flood."""
    squeeze = cell_prediction.ndim == 2
    if squeeze:
        border_prediction = border_prediction[None]
        cell_prediction = cell_prediction[None]
    dev = cell_prediction.device
    if method == "auto":
        if dev.type == "cpu":
            method = "flood"
        elif max_seeds < _MAX_PACKED:
            method = "pallas"
        else:
            raise NotImplementedError(
                f"max_seeds {max_seeds} does not fit the packed key; the card "
                "has no kernel for the watershed flood yet (ROADMAP Queue 1 "
                "item 13)")
    if method not in ("flood", "pallas"):
        raise ValueError(f"unknown post-processing method {method!r}")
    th_seed = torch.as_tensor(th_seed, dtype=torch.float32, device=dev)
    th_cell = torch.as_tensor(th_cell, dtype=torch.float32, device=dev)

    cell = gaussian_filter(cell_prediction.to(torch.float32), sigma=0.5)
    border = torch.clamp(border_prediction.to(torch.float32), 0.0, 1.0)
    mask = cell > th_cell
    borders = torch.tan(border * border)
    borders = torch.where(borders < 0.05, torch.zeros_like(borders), borders)
    borders = torch.clamp(borders, 0.0, 1.0)
    seeds_bin = (cell - borders) > th_seed

    seeds = _prune_small_seeds(seeds_bin, min_area_floor=4.0, rel_mean=0.10,
                               max_seeds=max_seeds, cc_fn=cc_fn,
                               rank_fn=rank_fn)
    if method == "pallas":
        if max_seeds >= _MAX_PACKED:
            raise ValueError(
                f"method='pallas' supports max_seeds < 2^24-1, got "
                f"{max_seeds} (use method='auto'/'flood')")
        labels = flood_fn(-cell, seeds, mask, n_levels=n_levels,
                          max_label=max_seeds)
    else:
        labels = watershed(-cell, seeds, mask, n_levels=n_levels)
    labels = labels.to(torch.uint16)
    return labels[0] if squeeze else labels
