"""Headless workers: label creation.

Port of ``create_labels`` from ``microbeseg_tpu/training/workers.py`` (the
reference's CreateLabelsWorker, src/training/train.py:33-104, without Qt:
callbacks replace signals).  The training worker is not ported yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

from microbeseg_torch.ops.labelgen import get_label, max_major_axis_length
from microbeseg_torch.utils.device import resolve_device
from microbeseg_torch.utils.tiff import imread, imwrite


def _noop(*a, **k):
    pass


def create_labels(path: Path, label_type: str,
                  text_output: Callable[[str], None] = _noop,
                  progress: Callable[[int], None] = _noop,
                  should_stop: Callable[[], bool] = lambda: False,
                  device=None) -> bool:
    """Generate label TIFFs next to the mask TIFFs in {path}/{train,val}.
    Runs on the CUDA card unless ``device`` says otherwise."""
    path = Path(path)
    dev = resolve_device(device)
    mask_ids_train = sorted((path / "train").glob("mask*.tif"))
    mask_ids_val = sorted((path / "val").glob("mask*.tif"))
    if len(mask_ids_val) < 2 or len(mask_ids_train) < 2:
        text_output("The training and the validation set should each contain "
                    "at least two annotated images! Stop")
        return False
    text_output("Create labels")
    mask_ids = mask_ids_train + mask_ids_val
    for i, mask_id in enumerate(mask_ids):
        if should_stop():
            text_output("Stop label creation due to user interaction.")
            return False
        mask = imread(mask_id)
        # every radius-windowed label type needs the measured major axis
        # (reference train.py:74-84); max_mal=0 would shrink the EDT window
        # to nothing and emit all-zero labels
        max_mal = (max_major_axis_length(mask, device=dev)
                   if label_type in ("distance", "cell_dist",
                                     "cell_dist_clipped") else 0)
        label = get_label(mask=mask, label_type=label_type, max_mal=max_mal,
                          device=dev)
        fname = mask_id.name.split("mask_")[-1]
        if label_type == "distance":
            imwrite(mask_id.parent / f"cell_dist_{fname}", label[0])
            imwrite(mask_id.parent / f"neighbor_dist_{fname}", label[1])
        else:
            imwrite(mask_id.parent / f"{label_type}_{fname}", label)
        progress(int(100 * (i + 1) / len(mask_ids)))
    return True
