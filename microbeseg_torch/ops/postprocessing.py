"""Instance extraction from CNN predictions, batched over frames.

Port of ``microbeseg_tpu/ops/postprocessing.py``: the distance method
(gaussian smoothing, seed thresholding, connected components ranked in
raster order, small-seed prune, then the marker flood -> uint16 masks), the
boundary method (argmax mask, seeds from cell and boundary probability, the
same prune and flood) and the distance method over a grid of threshold
pairs.  The JAX functions work on one frame and the engine vmaps them; here
the batch axis is explicit, and the quantisation and the prune statistics
stay per image.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from microbeseg_torch.kernels import _build
from microbeseg_torch.ops import cc
from microbeseg_torch.ops.filters import gaussian_filter
from microbeseg_torch.ops.kernels import flood
from microbeseg_torch.ops.watershed import watershed, watershed_fast

_MAX_PACKED = (1 << 24) - 1


def _prune_small_seeds(seeds_bin: torch.Tensor, min_area_floor: float,
                       rel_mean: float, max_seeds: int = 256,
                       label_fn=cc.ranked_components) -> torch.Tensor:
    """Label seed components sequentially, drop those with area <=
    max(rel_mean * mean_area, floor), compact the survivors to 1..n and drop
    ids past ``max_seeds``.  seeds_bin (B, H, W) bool -> (B, H, W) int32.

    The area pass runs with raw_cap = max(4 * max_seeds, 1024) component
    ranks, so speckle that outnumbers the real seeds cannot push them past
    the cap; the mean area includes the speckle, as the reference's does.
    Areas are a batched ``bincount``; the table lookup a ``gather``.
    ``label_fn`` numbers the components 1..n in raster order of their
    roots."""
    rank = label_fn(seeds_bin)
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
    flood on CUDA, the 'flood' watershed on the CPU and for ``max_seeds``
    the packed key cannot carry (as the JAX package picks the Pallas flood
    on accelerators and the XLA flood on the CPU or beyond the key);
    'flood' = the quantised priority flood of ``ops/watershed``; 'pallas' =
    the packed-key flood (kernel K1), named as in the JAX package; 'fast' =
    ``watershed_fast``, drainage labelling and a flood cleanup."""
    return _distance_postprocessing(border_prediction, cell_prediction,
                                    th_seed, th_cell, max_seeds, n_levels,
                                    method)


def _distance_postprocessing(border_prediction, cell_prediction, th_seed,
                             th_cell, max_seeds=256, n_levels=128,
                             method="auto", label_fn=cc.ranked_components,
                             flood_fn=flood.flood_or_fallback):
    """``distance_postprocessing`` with its kernels as arguments, so that
    the plain versions can run on the card as the kernels' reference.
    ``flood_fn(value, markers, mask, n_levels=, max_label=)`` is the
    'pallas' method's flood.  Thresholds may be (B, 1, 1) tensors, one pair
    per image (the threshold grid)."""
    squeeze = cell_prediction.ndim == 2
    if squeeze:
        border_prediction = border_prediction[None]
        cell_prediction = cell_prediction[None]
    dev = cell_prediction.device
    method = _resolve_method(method, dev, max_seeds)
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
                               max_seeds=max_seeds, label_fn=label_fn)
    cell = cell.expand(mask.shape)  # one map under a grid of thresholds
    labels = _flood(method, -cell, seeds, mask, n_levels, max_seeds, flood_fn)
    return labels[0] if squeeze else labels


def _resolve_method(method: str, dev: torch.device, max_seeds: int) -> str:
    if method == "auto":
        if dev.type == "cpu":
            return "flood"
        if max_seeds < _MAX_PACKED:
            return "pallas"
        # seeds beyond the packed key: the watershed flood, as in JAX
        _build.count_launch("watershed_route")
        return "flood"
    if method not in ("flood", "pallas", "fast"):
        raise ValueError(f"unknown post-processing method {method!r}")
    return method


def _flood(method, value, seeds, mask, n_levels, max_seeds, flood_fn):
    """The marker flood of both methods -> uint16 labels."""
    if method == "pallas":
        if max_seeds >= _MAX_PACKED:
            raise ValueError(
                f"method='pallas' supports max_seeds < 2^24-1, got "
                f"{max_seeds} (use method='auto'/'flood')")
        labels = flood_fn(value, seeds, mask, n_levels=n_levels,
                          max_label=max_seeds)
    elif method == "fast":
        labels = watershed_fast(value, seeds, mask)
    else:
        labels = watershed(value, seeds, mask, n_levels=n_levels)
    return labels.to(torch.uint16)


def boundary_postprocessing(prediction: torch.Tensor,
                            max_seeds: int = 256) -> torch.Tensor:
    """Boundary-method post-processing of (B, H, W, 3) or (H, W, 3) softmax
    probabilities (background, cell, boundary) -> uint16 instance masks.
    The mask is the argmax's cell class, seeds are
    ``p_cell * (1 - p_boundary) > 0.5`` with areas above 4, and the flood
    runs on the negated mask with 2 levels: the packed-key flood on CUDA,
    the ``watershed`` flood on the CPU."""
    return _boundary_postprocessing(prediction, max_seeds)


def _boundary_postprocessing(prediction, max_seeds=256, method="auto",
                             label_fn=cc.ranked_components,
                             flood_fn=flood.flood_or_fallback):
    """``boundary_postprocessing`` with its kernels as arguments (see
    ``_distance_postprocessing``)."""
    squeeze = prediction.ndim == 3
    if squeeze:
        prediction = prediction[None]
    method = _resolve_method(method, prediction.device, max_seeds)
    prediction = prediction.to(torch.float32)
    mask = torch.argmax(prediction, dim=-1) == 1
    seeds_bin = (prediction[..., 1] * (1.0 - prediction[..., 2])) > 0.5
    seeds = _prune_small_seeds(seeds_bin, min_area_floor=4.0, rel_mean=0.0,
                               max_seeds=max_seeds, label_fn=label_fn)
    labels = _flood(method, -mask.to(torch.float32), seeds, mask, 2,
                    max_seeds, flood_fn)
    return labels[0] if squeeze else labels


def distance_postprocessing_grid(border_prediction: torch.Tensor,
                                 cell_prediction: torch.Tensor,
                                 th_pairs: Union[torch.Tensor, Sequence],
                                 max_seeds: int = 256,
                                 n_levels: int = 128) -> torch.Tensor:
    """Threshold grid on one frame: (H, W) predictions and th_pairs (n, 2)
    of (th_cell, th_seed) -> (n, H, W) uint16 masks.  The n pairs go through
    post-processing as one batch of n images; frames with a side above 768
    take the pairs one after the other, which bounds the memory."""
    dev = cell_prediction.device
    pairs = torch.as_tensor(th_pairs, dtype=torch.float32, device=dev)
    th_cell = pairs[:, 0].view(-1, 1, 1)
    th_seed = pairs[:, 1].view(-1, 1, 1)
    border, cell = border_prediction[None], cell_prediction[None]
    if max(cell_prediction.shape[-2:]) <= flood.MAX_SIDE:
        return distance_postprocessing(border, cell, th_seed, th_cell,
                                       max_seeds=max_seeds, n_levels=n_levels)
    return torch.cat([
        distance_postprocessing(border, cell, th_seed[i], th_cell[i],
                                max_seeds=max_seeds, n_levels=n_levels)
        for i in range(pairs.shape[0])])
