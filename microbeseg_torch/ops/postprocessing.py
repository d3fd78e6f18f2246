"""Instance extraction from CNN predictions, batched over frames.

Port of ``microbeseg_tpu/ops/postprocessing.py``: the distance method
(gaussian smoothing, seed thresholding, connected components ranked in
raster order, small-seed prune, then the marker flood -> uint16 masks), the
boundary method (argmax mask, seeds from cell and boundary probability, the
same prune and flood) and the distance method over a grid of threshold
pairs.  Beside them muSAM's automatic instance segmentation
(``ais_postprocessing``, which the JAX package does not have): torch_em's
seeded watershed from centre and boundary distances on the same
components and flood.  The JAX functions work on one frame and the engine
vmaps them; here the batch axis is explicit, and the quantisation and the
prune statistics stay per image.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from microbeseg_torch.kernels import _build
from microbeseg_torch.ops import cc
from microbeseg_torch.ops.filters import gaussian_filter
from microbeseg_torch.ops.kernels import flood
from microbeseg_torch.ops.watershed import watershed, watershed_fast
from microbeseg_torch.utils.profiling import span

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
    areas = _areas(rank, raw_cap).to(torch.float32)
    areas[:, 0] = 0.0
    n = (areas > 0).sum(dim=1)
    mean_area = areas.sum(dim=1) / torch.clamp(n, min=1).to(torch.float32)
    rel = torch.tensor(rel_mean, dtype=torch.float32, device=rank.device)
    min_area = torch.where(n > 0, rel * mean_area,
                           torch.zeros_like(mean_area))
    min_area = torch.clamp(min_area, min=float(min_area_floor))
    kept = areas > min_area[:, None]
    return _renumber(rank, kept, max_seeds).view(seeds_bin.shape)


def _areas(ids: torch.Tensor, cap: int) -> torch.Tensor:
    """(B, N) int64 ids 0..cap -> (B, cap + 1) pixel counts per image: one
    batched ``bincount``."""
    B = ids.shape[0]
    offsets = torch.arange(B, device=ids.device).view(B, 1) * (cap + 1)
    return torch.bincount((ids + offsets).view(-1),
                          minlength=B * (cap + 1)).view(B, cap + 1)


def _renumber(ids: torch.Tensor, kept: torch.Tensor,
              limit: int = _MAX_PACKED) -> torch.Tensor:
    """(B, N) int64 ids and (B, cap + 1) bool ``kept`` per id -> (B, N)
    int32: the kept ids numbered 1..n per image in their order, ids not
    kept or numbered past ``limit`` 0 (a cumsum table and a ``gather``)."""
    table = torch.cumsum(kept.to(torch.int32), dim=1, dtype=torch.int32)
    table = torch.where(kept & (table <= limit), table, 0)
    return torch.gather(table, 1, ids)


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


# the most seeds muSAM's post-processing floods: every one fits the uint16
# masks
AIS_MAX_SEEDS = 65535
AIS_LEVELS = 128


def ais_postprocessing(fields: torch.Tensor, cfg) -> torch.Tensor:
    """muSAM's automatic instance segmentation of (B, H, W, 3) or (H, W,
    3) fields (foreground, centre distance, boundary distance) -> uint16
    masks: torch_em's ``watershed_from_center_and_boundary_distances`` as
    micro-sam's ``InstanceSegmentationWithDecoder.generate`` calls it.

    ``cfg`` (an ``InferConfig``) gives the thresholds, the smoothings and
    ``min_size``.  The foreground is smoothed with a Gaussian of std
    ``foreground_smoothing`` (none at 0), both distances with std
    ``distance_smoothing`` (``gaussian_filter``, radius int(4 sigma + 0.5));
    the mask is ``foreground > foreground_threshold``; the seeds are the
    8-connected components of (centre < its threshold) & (boundary < its
    threshold) & mask, numbered in raster order of their last pixel (at
    most ``AIS_MAX_SEEDS``); they flood the boundary distance inside the
    mask (lower first, 4-neighbour) with the quantised marker flood the
    distance method dispatches (``AIS_LEVELS`` levels; the packed-key
    kernels on the card, above 768 px K2); segments under ``min_size``
    pixels go and the rest are numbered 1..n in order.  Spans
    ``mseg.segment.ais.smooth``, ``.seeds`` and ``.flood``."""
    squeeze = fields.ndim == 3
    if squeeze:
        fields = fields[None]
    f = fields.to(torch.float32)
    with span("mseg.segment.ais.smooth"):
        fg = f[..., 0].contiguous()
        if cfg.foreground_smoothing > 0:
            fg = gaussian_filter(fg, sigma=cfg.foreground_smoothing)
        dist = gaussian_filter(f[..., 1:].permute(0, 3, 1, 2).contiguous(),
                               sigma=cfg.distance_smoothing)
        center, boundary = dist[:, 0], dist[:, 1]
    with span("mseg.segment.ais.seeds"):
        mask = fg > cfg.foreground_threshold
        seeds_bin = ((center < cfg.center_distance_threshold)
                     & (boundary < cfg.boundary_distance_threshold) & mask)
        seeds = cc.ranked_components(seeds_bin)
        seeds = torch.where(seeds > AIS_MAX_SEEDS, 0, seeds)
    with span("mseg.segment.ais.flood"):
        method = _resolve_method("auto", f.device, AIS_MAX_SEEDS)
        labels = _flood(method, boundary, seeds, mask, AIS_LEVELS,
                        AIS_MAX_SEEDS, flood.flood_or_fallback)
        if cfg.min_size > 0:
            B = labels.shape[0]
            ids = labels.to(torch.int64).view(B, -1)
            kept = _areas(ids, AIS_MAX_SEEDS) >= cfg.min_size
            kept[:, 0] = False
            labels = _renumber(ids, kept).view(labels.shape).to(torch.uint16)
    return labels[0] if squeeze else labels

