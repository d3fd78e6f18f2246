"""Training data: whole splits as stacked arrays, and index batching.

A copy of ``microbeseg_tpu/training/data.py`` on the port's TIFF reader.
Microbe training sets are small (hundreds of crops of 256^2 / 320^2
uint16), so each split is one stacked array; a batch is an index gather
plus augmentation on the device.

Directory layout (reference trainset export, src/utils/data_export.py:
104-106): ``{root}/{train,val}/img_*.tif`` with ``mask_*.tif`` and the
generated ``cell_dist_*.tif`` / ``neighbor_dist_*.tif`` (or
``boundary_*.tif``) label files.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

import numpy as np

from microbeseg_torch.utils.tiff import imread


@dataclass
class SplitArrays:
    images: np.ndarray            # (N, H, W, 1) float32, raw [0, 65535] scale
    labels: Dict[str, np.ndarray]  # distance: border/cell (N,H,W,1) float32;
                                   # boundary: label (N,H,W,1) int32
    ids: List[str]

    def __len__(self) -> int:
        return len(self.ids)


def _load_split(split_dir: Path, label_type: str) -> SplitArrays:
    img_paths = sorted(split_dir.glob("img*.tif"))
    images, ids = [], []
    labels: Dict[str, list] = (
        {"border_label": [], "cell_label": []} if label_type == "distance"
        else {"label": []})
    for p in img_paths:
        fname = p.name.split("img")[-1]
        img = imread(p).astype(np.float32)
        if img.ndim == 2:
            img = img[..., None]
        images.append(img)
        ids.append(p.stem)
        if label_type == "distance":
            labels["cell_label"].append(imread(
                split_dir / f"cell_dist{fname}").astype(np.float32)[..., None])
            labels["border_label"].append(imread(
                split_dir / f"neighbor_dist{fname}").astype(np.float32)[..., None])
        else:
            labels["label"].append(imread(
                split_dir / f"{label_type}{fname}").astype(np.int32)[..., None])
    if not images:
        raise FileNotFoundError(f"no img*.tif found under {split_dir}")
    return SplitArrays(images=np.stack(images),
                       labels={k: np.stack(v) for k, v in labels.items()},
                       ids=ids)


@dataclass
class TrainingData:
    train: SplitArrays
    val: SplitArrays
    crop_size: int

    @classmethod
    def from_directory(cls, root: Path,
                       label_type: str = "distance") -> "TrainingData":
        root = Path(root)
        train = _load_split(root / "train", label_type)
        val = _load_split(root / "val", label_type)
        return cls(train=train, val=val, crop_size=train.images.shape[1])

    def __len__(self) -> int:
        return len(self.train) + len(self.val)


def epoch_batches(n: int, batch_size: int, rng: np.random.Generator,
                  shuffle: bool = True, step_size: int = 0
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (indices, weights) per batch of at most ``batch_size`` REAL
    samples.  Every batch has ``step_size`` (>= batch_size) slots: ragged
    slots are wrap-around duplicates with weight 0, so the weighted loss
    matches the reference's batch size and dataset-size normalisation
    (train.py:493-495).  The same ``rng`` gives the JAX package's order."""
    step_size = max(step_size, batch_size)
    order = rng.permutation(n) if shuffle else np.arange(n)
    for start in range(0, n, batch_size):
        idx = order[start:start + batch_size]
        w = np.ones(len(idx), np.float32)
        if len(idx) < step_size:
            pad = step_size - len(idx)
            idx = np.concatenate([idx, np.resize(order, pad)])
            w = np.concatenate([w, np.zeros(pad, np.float32)])
        yield idx.astype(np.int32), w
