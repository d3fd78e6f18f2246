"""What the inference engine does for each label type: one entry each.

``InferenceEngine`` reads everything that depends on its ``label_type``
from the entry ``label_type_entry`` returns: how a frame is normalised, the
value a normalised frame is padded with, whether every frame takes the
tiled path, how one model's output becomes the engine's fields, the
settings it refuses, how fields become masks, and whether a threshold grid
exists.  A new label type is one new entry.

- ``distance`` (DUNet): min-max to [-1, 1] per frame, padded with -1; two
  fields, border and cell distance, each (B, H, W); the distance
  post-processing with its two thresholds, also over a grid of them.
- ``boundary`` (3-class U-Net), and every label type without an entry of
  its own: min-max as distance, padded with -1; one field, the softmax
  (B, H, W, 3); the boundary post-processing, which has no thresholds.
- ``flows`` (Cellpose-SAM, ``models/vit_sam.py``): each frame by its 1st
  and 99th percentiles (Cellpose's ``normalize99``), padded with 0, every
  frame tiled with tiles of the network's input size; the one-channel
  input fills channel 0 of the network's ``ch_in``; one field (dY, dX,
  cell probability) (B, H, W, 3); Cellpose's flow dynamics
  (``ops/flows.py``).  Test-time augmentation, int8 and scaling are
  refused.
- ``ais`` (muSAM's automatic instance segmentation, ``models/unetr.py``):
  each frame min-max scaled to the integers 0..255 (micro-sam's
  ``_to_image``), every frame tiled with tiles of the network's input
  size; the one channel
  replicated to three and standardised with SAM's pixel mean and std, a
  padded pixel 0 after that (the frame is padded with NaN, which the
  standardisation takes to 0, as SAM pads); one field (foreground, centre
  distance, boundary distance) (B, H, W, 3); torch_em's seeded watershed
  (``ops/postprocessing.ais_postprocessing``).  Test-time augmentation,
  int8, scaling and tiles of another size are refused.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch

from microbeseg_torch.config import InferConfig
from microbeseg_torch.ops.flows import flows_postprocessing
from microbeseg_torch.ops.postprocessing import (
    ais_postprocessing,
    boundary_postprocessing,
    distance_postprocessing,
    distance_postprocessing_grid,
)


def normalize_minmax(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W) float32 -> [-1, 1] per frame by its min and max; a
    constant frame maps to all-zero."""
    mn = x.amin(dim=(1, 2), keepdim=True)
    mx = x.amax(dim=(1, 2), keepdim=True)
    denom = mx - mn
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    return torch.where(denom > 0, 2.0 * (x - mn) / safe - 1.0,
                       torch.zeros_like(x))


def normalize99(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W) float32 -> (x - p1) / (p99 - p1) per frame with its 1st
    and 99th percentiles (linear between order statistics, as
    ``np.percentile``), or 0 where they lie within 1e-3 (Cellpose's
    ``normalize99``)."""
    s = torch.sort(x.reshape(x.shape[0], -1), dim=1).values
    n = s.shape[1]
    p = []
    for q in (0.01, 0.99):
        pos = q * (n - 1)
        i = int(pos)
        j = min(i + 1, n - 1)
        p.append(s[:, i] + (s[:, j] - s[:, i]) * (pos - i))
    lo, d = p[0][:, None, None], (p[1] - p[0])[:, None, None]
    return torch.where(d > 1e-3, (x - lo) / torch.where(d > 1e-3, d, 1.0),
                       torch.zeros_like(x))


# SAM's pixel mean and std (segment_anything/modeling/sam.py), on [0, 255]
SAM_PIXEL_MEAN = (123.675, 116.28, 103.53)
SAM_PIXEL_STD = (58.395, 57.12, 57.375)


def normalize_to_255(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W) float32 -> whole numbers 0..255 per frame: torch_em's
    ``normalize`` ((x - min) / (max - min + 1e-7)), times 255, cut to an
    integer as micro-sam's ``_to_image`` casts to uint8."""
    mn = x.amin(dim=(1, 2), keepdim=True)
    d = x.amax(dim=(1, 2), keepdim=True) - mn
    return torch.floor((x - mn) / (d + 1e-7) * 255.0)


def _accept(model: torch.nn.Module, cfg: InferConfig) -> None:
    pass


def _refuse_tiled(label_type: str, size: int, cfg: InferConfig) -> None:
    """Refuse settings a path whose tiles are the network's input does not
    run: tiles of another size, TTA, int8, scaling."""
    if cfg.tile_size != size:
        raise ValueError(f"label_type {label_type!r}: tile_size must be the "
                         f"network's input size {size}, got "
                         f"{cfg.tile_size}")
    bad = [k for k, v in (("tta", cfg.tta), ("quantize", cfg.quantize),
                          ("scale_factor", cfg.scale_factor != 1))
           if v]
    if bad:
        raise ValueError(f"label_type {label_type!r} does not run {bad}")


def _check_flows(model: torch.nn.Module, cfg: InferConfig) -> None:
    """Refuse settings the flows path does not run: its tiles are the
    network's input size, and flows neither flip with TTA nor scale."""
    size = getattr(getattr(model, "cfg", None), "img_size", None)
    if size is None:
        raise ValueError("label_type 'flows' needs a Cellpose-SAM model "
                         "(models/vit_sam.py)")
    _refuse_tiled("flows", size, cfg)


def _check_ais(model: torch.nn.Module, cfg: InferConfig) -> None:
    """Refuse settings the ais path does not run: its tiles are the
    network's input size, and it neither flips with TTA, scales nor runs
    int8."""
    mcfg = getattr(model, "cfg", None)
    if not hasattr(mcfg, "decoder_features"):
        raise ValueError("label_type 'ais' needs a muSAM model "
                         "(models/unetr.py)")
    _refuse_tiled("ais", mcfg.img_size, cfg)


def _distance_fields(model, x):
    preds = model(x)
    return [preds[0][..., 0], preds[1][..., 0]]


def _boundary_fields(model, x):
    return [torch.softmax(model(x), dim=-1)]


def _flows_fields(model, x):
    xin = torch.nn.functional.pad(x.permute(0, 3, 1, 2),
                                  (0, 0, 0, 0, 0, model.cfg.ch_in - 1))
    return [model(xin).permute(0, 2, 3, 1).contiguous()]


def _ais_fields(model, x):
    mean = x.new_tensor(SAM_PIXEL_MEAN).view(1, 3, 1, 1)
    std = x.new_tensor(SAM_PIXEL_STD).view(1, 3, 1, 1)
    xin = torch.nan_to_num((x.permute(0, 3, 1, 2) - mean) / std, nan=0.0)
    return [model(xin).permute(0, 2, 3, 1).contiguous()]


def _distance_masks(fields, th_cell, th_seed, max_seeds, cfg):
    return distance_postprocessing(fields[0], fields[1], th_seed, th_cell,
                                   max_seeds=max_seeds)


def _boundary_masks(fields, th_cell, th_seed, max_seeds, cfg):
    return boundary_postprocessing(fields[0], max_seeds=max_seeds)


def _flows_masks(fields, th_cell, th_seed, max_seeds, cfg):
    return torch.stack([
        flows_postprocessing(f[..., :2].permute(2, 0, 1), f[..., 2], cfg)
        for f in fields[0]])


def _ais_masks(fields, th_cell, th_seed, max_seeds, cfg):
    return ais_postprocessing(fields[0], cfg)


@dataclass(frozen=True)
class LabelType:
    """One label type's contract with the engine.

    ``normalize``: raw (B, H, W) float32 frames (after CLAHE) -> normalised.
    ``pad_value``: what a normalised frame is padded with.  ``fields``: the
    trailing shape of each field the engine carries, () for a (B, H, W)
    map, (3,) for (B, H, W, 3).  ``apply(model, x)``: normalised (B, H, W,
    1) input -> the model's fields.  ``check(model, cfg)`` raises
    ``ValueError`` for what the engine does not run.  ``postprocess(fields,
    th_cell, th_seed, max_seeds, cfg)``: a batch of fields -> (B, H, W)
    masks.  ``grid``: the threshold-grid post-processing, None where there
    is none.  ``always_tiled``: every frame takes the tiled path."""

    normalize: Callable[[torch.Tensor], torch.Tensor]
    pad_value: float
    fields: Tuple[Tuple[int, ...], ...]
    apply: Callable[[torch.nn.Module, torch.Tensor], List[torch.Tensor]]
    postprocess: Callable[..., torch.Tensor]
    check: Callable[[torch.nn.Module, InferConfig], None] = _accept
    grid: Optional[Callable[..., torch.Tensor]] = None
    always_tiled: bool = False


LABEL_TYPES = {
    "distance": LabelType(
        normalize=normalize_minmax, pad_value=-1.0, fields=((), ()),
        apply=_distance_fields, postprocess=_distance_masks,
        grid=distance_postprocessing_grid),
    "boundary": LabelType(
        normalize=normalize_minmax, pad_value=-1.0, fields=((3,),),
        apply=_boundary_fields, postprocess=_boundary_masks),
    "flows": LabelType(
        normalize=normalize99, pad_value=0.0, fields=((3,),),
        apply=_flows_fields, postprocess=_flows_masks, check=_check_flows,
        always_tiled=True),
    "ais": LabelType(
        normalize=normalize_to_255, pad_value=float("nan"), fields=((3,),),
        apply=_ais_fields, postprocess=_ais_masks, check=_check_ais,
        always_tiled=True),
}


def label_type_entry(label_type: str) -> LabelType:
    """The entry of ``label_type``; the boundary entry for a label type
    without one of its own."""
    return LABEL_TYPES.get(label_type, LABEL_TYPES["boundary"])
