"""Reference PyTorch checkpoints in and out of the port.

The reference ships trained models as ``torch.save(net.state_dict())``
(.pth, src/training/train.py:502-515) plus a JSON sidecar
(src/utils/utils.py:94-107).  The port's ``models/unet.py`` uses the
reference's module layout and state_dict keys (``encoderConv.{i}.conv.0.
weight``, ``decoder1Upconv.{i}.up.0.weight``, ...), so a reference
``state_dict`` loads into it as it is: the import is
``ModelConfig.from_architecture`` + ``load_state_dict(strict=True)`` + the
flax ``.ckpt`` writer, and the export is the model's ``state_dict``.  The
``.ckpt`` written loads in both packages.  Counterparts of
``microbeseg_tpu/models/torch_import.py``'s ``import_torch_checkpoint`` and
``export_torch_checkpoint``.

A ``module.`` prefix (reference DataParallel checkpoints, unets.py:60-78)
is stripped.  The ``.pth`` is read with ``torch.load(weights_only=True)``,
which unpickles tensors and containers only.

``cellpose_sam_from_state_dict`` takes a Cellpose-SAM state dict under its
published names (``encoder.patch_embed.proj.*``, ``encoder.pos_embed``,
``encoder.blocks.{i}.{norm1, attn.qkv, attn.proj, attn.rel_pos_h,
attn.rel_pos_w, norm2, mlp.lin1, mlp.lin2}.*``, ``encoder.neck.{0,1,2,3}.*``,
``out.*``, ``W2``; MouseLand/cellpose ``cellpose/vit_sam.py``), which are
the port's own names (``models/vit_sam.py``).  The published ``cpsam``
file keeps 127-row relative-position tables in SAM's 4 global blocks and
27-row ones in the others, and Cellpose interpolates them to 2G - 1 rows at
each call (SAM's ``get_rel_pos``); the import does that interpolation
once.  ``W2``, the fixed identity that Cellpose's readout multiplies by,
must be that identity, and is dropped: the port writes it as a pixel
shuffle.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

from microbeseg_torch.config import (CellposeSAMConfig, ModelConfig,
                                     TrainConfig, read_sidecar)
from microbeseg_torch.models.io import load_model, save_checkpoint, write_sidecar
from microbeseg_torch.models.unet import build_unet
from microbeseg_torch.models.vit_sam import CellposeSAM, build_cellpose_sam
from microbeseg_torch.utils.device import resolve_device


def import_torch_checkpoint(pth_path: Path, out_dir: Path,
                            json_path: Optional[Path] = None,
                            label_type: Optional[str] = None,
                            device=None) -> Path:
    """Convert a reference ``.pth`` + ``.json`` pair to a ``.ckpt`` + sidecar
    under ``out_dir`` (same stem).  The reference sidecar provides the
    architecture tuple; ``label_type`` falls back to it.  The weights load
    into the model on ``device`` (the CUDA card unless ``"cpu"``), which
    fails on any missing, extra or misshapen key.  Returns the .ckpt
    path."""
    device = resolve_device(device)
    pth_path = Path(pth_path)
    json_path = Path(json_path) if json_path else pth_path.with_suffix(".json")
    sidecar = json.loads(json_path.read_text())
    label_type = label_type or sidecar.get("label_type", "distance")
    mcfg = ModelConfig.from_architecture(sidecar["architecture"],
                                         label_type=label_type)
    state_dict = torch.load(pth_path, map_location="cpu", weights_only=True)
    state_dict = {k[len("module."):] if k.startswith("module.") else k: v
                  for k, v in state_dict.items()}
    model = build_unet(mcfg).to(device)
    model.load_state_dict(state_dict, strict=True)

    cfg = TrainConfig(model=mcfg, label_type=label_type,
                      loss=sidecar.get("loss", "smooth_l1"),
                      optimizer=sidecar.get("optimizer", "ranger"),
                      batch_size=int(sidecar.get("batch_size", 4)),
                      run_name=pth_path.stem)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ckpt = save_checkpoint(model, out_dir / cfg.run_name)
    write_sidecar(cfg, out_dir, extra={"imported_from": str(pth_path)})
    return ckpt


def export_torch_checkpoint(ckpt_path: Path, out_dir: Path,
                            device=None) -> Path:
    """Convert a ``.ckpt`` + sidecar pair into a reference ``.pth`` +
    ``.json`` pair under ``out_dir`` (same stem), so models trained here
    run in the reference GPU tool.  The model loads on ``device`` (the CUDA
    card unless ``"cpu"``).  Returns the .pth path."""
    ckpt_path = Path(ckpt_path)
    model, _ = load_model(ckpt_path, device=resolve_device(device))
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = ckpt_path.stem if ckpt_path.suffix == ".ckpt" else ckpt_path.name
    pth = out_dir / f"{stem}.pth"
    torch.save(sd, pth)
    sidecar = read_sidecar(
        ckpt_path.with_suffix("").parent / f"{stem}.json")
    (out_dir / f"{stem}.json").write_text(json.dumps(sidecar, indent=2))
    return pth


def rel_pos_resized(rel_pos: torch.Tensor, rows: int) -> torch.Tensor:
    """A (n, c) relative-position table at ``rows`` rows: SAM's
    ``get_rel_pos`` interpolation (linear, ``align_corners=False``)."""
    if rel_pos.shape[0] == rows:
        return rel_pos
    t = F.interpolate(rel_pos.float().reshape(1, rel_pos.shape[0], -1)
                      .permute(0, 2, 1), size=rows, mode="linear")
    return t.reshape(-1, rows).permute(1, 0).to(rel_pos.dtype)


def cellpose_sam_from_state_dict(state_dict: dict,
                                 cfg: CellposeSAMConfig = CellposeSAMConfig()
                                 ) -> CellposeSAM:
    """A Cellpose-SAM state dict under the published names -> the port's
    model of ``cfg`` on the CPU.  Refuses a ``pos_embed`` or patch kernel
    of another size, a ``W2`` that is not the identity readout, and any
    missing, extra or misshapen key."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in state_dict.items()}
    model = build_cellpose_sam(cfg)
    want = model.state_dict()
    for key in ("encoder.pos_embed", "encoder.patch_embed.proj.weight"):
        if key in sd and tuple(sd[key].shape) != tuple(want[key].shape):
            raise ValueError(f"{key} of shape {tuple(sd[key].shape)}: this "
                             f"configuration takes {tuple(want[key].shape)}")
    w2 = sd.pop("W2", None)
    n, p = cfg.nout, cfg.patch_size
    eye = torch.eye(n * p * p).reshape(n * p * p, n, p, p)
    if w2 is None or tuple(w2.shape) != tuple(eye.shape) \
            or not torch.equal(w2.float().cpu(), eye):
        raise ValueError("W2 must be the identity readout of shape "
                         f"{tuple(eye.shape)}")
    rows = 2 * cfg.grid - 1
    for k in list(sd):
        if k.endswith(("attn.rel_pos_h", "attn.rel_pos_w")):
            sd[k] = rel_pos_resized(sd[k], rows)
    model.load_state_dict(sd, strict=True)
    return model


def load_cellpose_sam(pth_path: Path,
                      cfg: CellposeSAMConfig = CellposeSAMConfig(),
                      device=None) -> CellposeSAM:
    """Cellpose-SAM from a ``torch.save`` of its state dict (the published
    ``cpsam`` file), on ``device`` (the CUDA card unless ``"cpu"``)."""
    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    return cellpose_sam_from_state_dict(sd, cfg).to(resolve_device(device))
