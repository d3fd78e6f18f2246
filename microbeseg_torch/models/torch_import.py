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
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import torch

from microbeseg_torch.config import ModelConfig, TrainConfig, read_sidecar
from microbeseg_torch.models.io import load_model, save_checkpoint, write_sidecar
from microbeseg_torch.models.unet import build_unet
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
