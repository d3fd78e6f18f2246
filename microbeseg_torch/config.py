"""Typed configuration and the JSON model sidecar.

A copy of the configuration surface of ``microbeseg_tpu/config.py``:
``ModelConfig``, ``TrainConfig``, ``InferConfig``, ``EvalConfig``, the
pad-bucket table, the epoch budget (``get_max_epochs``) and the sidecar
read/parse, so checkpoints written by either package describe their
architecture the same way.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Sequence, Tuple

# Padding bucket table: the reference's "tested shapes".  Frames are padded
# up-left to the next bucket before the forward pass.
PAD_BUCKETS: Tuple[int, ...] = (
    64, 128, 256, 320, 512, 768, 1024, 1280, 1408, 1600, 1920, 2048, 2240,
    2560, 3200, 4096, 4480, 6080, 8192,
)

LABEL_TYPES = ("distance", "boundary", "border", "adapted_border", "j4",
               "cell_dist", "cell_dist_clipped")
ACTIVATIONS = ("relu", "leakyrelu", "elu", "mish")
NORMALIZATIONS = ("bn", "gn", "in")
POOL_METHODS = ("conv", "max")
OPTIMIZERS = ("adam", "ranger")
LOSSES = ("smooth_l1", "l1", "l2", "ce_dice", "ce")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of the (D)U-Net."""

    unet_type: str = "DU"            # 'DU' = shared encoder + 2 decoders, 'U' = 1 decoder
    act_fun: str = "relu"
    pool_method: str = "conv"
    normalization: str = "bn"
    ch_in: int = 1
    ch_out: int = 1                   # 1 for distance, 3 for boundary
    filters: Tuple[int, int] = (64, 1024)

    def __post_init__(self):
        if self.unet_type not in ("DU", "U"):
            raise ValueError(f"unknown unet_type {self.unet_type!r}")
        if self.act_fun not in ACTIVATIONS:
            raise ValueError(f"unknown act_fun {self.act_fun!r}")
        if self.normalization not in NORMALIZATIONS:
            raise ValueError(f"unknown normalization {self.normalization!r}")
        if self.pool_method not in POOL_METHODS:
            raise ValueError(f"unknown pool_method {self.pool_method!r}")

    @property
    def depth(self) -> int:
        """Number of encoder levels (filters doubling f0 -> f1)."""
        n, f = 1, self.filters[0]
        while f < self.filters[1]:
            f *= 2
            n += 1
        return n

    @property
    def architecture(self) -> tuple:
        """Reference-format architecture tuple ('DU', 'conv', act, norm, filters)."""
        return (self.unet_type, self.pool_method, self.act_fun,
                self.normalization, list(self.filters))

    @classmethod
    def from_architecture(cls, arch: Sequence, label_type: str = "distance") -> "ModelConfig":
        """Build from a reference-format architecture tuple."""
        unet_type, pool_method, act_fun, normalization, filters = arch
        return cls(unet_type=unet_type, act_fun=act_fun, pool_method=pool_method,
                   normalization=normalization,
                   ch_out=1 if label_type == "distance" else 3,
                   filters=tuple(filters))


@dataclass(frozen=True)
class CellposeSAMConfig:
    """Architecture of Cellpose-SAM (Pachitariu, Rariden & Stringer 2025;
    MouseLand/cellpose ``cellpose/vit_sam.py::Transformer``): SAM's ViT-L
    image encoder with patches of 8 px, global attention with decomposed
    relative positions in every block, SAM's neck, and a readout of
    ``nout`` fields (dY, dX, cell probability) through a 1x1 convolution
    and a pixel shuffle.  The defaults are the published values.
    ``window_size`` 0 is global attention in every block; otherwise the
    blocks not in ``global_attn_indexes`` attend within windows of that
    many tokens a side (SAM's windowed blocks)."""

    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_dim: int = 4096
    patch_size: int = 8
    img_size: int = 256
    neck_dim: int = 256
    nout: int = 3
    ch_in: int = 3
    window_size: int = 0
    global_attn_indexes: Tuple[int, ...] = ()

    def __post_init__(self):
        _check_encoder(self)

    @property
    def grid(self) -> int:
        """Tokens along each side of an input."""
        return self.img_size // self.patch_size


@dataclass(frozen=True)
class MicroSAMConfig:
    """Architecture of muSAM's automatic instance segmentation (Archit et
    al., Nature Methods 2025; computational-cell-analytics/micro-sam
    ``instance_segmentation.py::get_unetr``): SAM's ViT-L image encoder
    (Kirillov et al. 2023, ``build_sam.py::build_sam_vit_l``: 16 px
    patches, windows of 14 tokens, global attention in blocks 5, 11, 17
    and 23, the neck to 256 channels) and torch_em's UNETR decoder without
    skip connections, ``decoder_features`` from its base to its last
    level, ``out_channels`` sigmoid fields (foreground, centre distance,
    boundary distance).  The defaults are the published values."""

    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_dim: int = 4096
    patch_size: int = 16
    img_size: int = 1024
    neck_dim: int = 256
    ch_in: int = 3
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (5, 11, 17, 23)
    decoder_features: Tuple[int, ...] = (512, 256, 128, 64)
    out_channels: int = 3

    def __post_init__(self):
        _check_encoder(self)
        # the encoder's grid doubles once a decoder level and once more
        # after it (deconv_out): the four deconvolutions reach the input
        if self.grid * 16 != self.img_size or len(self.decoder_features) != 4:
            raise ValueError(f"a UNETR decoder of {self.decoder_features} "
                             f"upsamples a grid by 16: img_size "
                             f"{self.img_size} needs patch_size 16")

    @property
    def grid(self) -> int:
        """Tokens along each side of an input."""
        return self.img_size // self.patch_size


def _check_encoder(cfg) -> None:
    if cfg.embed_dim % cfg.num_heads:
        raise ValueError(f"embed_dim {cfg.embed_dim} is not a multiple "
                         f"of num_heads {cfg.num_heads}")
    if cfg.img_size % cfg.patch_size:
        raise ValueError(f"img_size {cfg.img_size} is not a multiple "
                         f"of patch_size {cfg.patch_size}")
    if cfg.window_size < 0 or not all(
            0 <= i < cfg.depth for i in cfg.global_attn_indexes):
        raise ValueError(f"window_size {cfg.window_size} and "
                         f"global_attn_indexes {cfg.global_attn_indexes}: "
                         f"a size >= 0 and blocks 0 to {cfg.depth - 1}")


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters as recorded in the sidecar."""

    model: ModelConfig = field(default_factory=ModelConfig)
    label_type: str = "distance"
    loss: str = "smooth_l1"
    optimizer: str = "ranger"
    batch_size: int = 4
    run_name: str = "distance_model_01"
    max_epochs: Optional[int] = None
    seed: int = 0
    adam_lr: float = 8e-4
    ranger_lr: float = 6e-3
    ranger_finetune_factor: float = 0.09
    lookahead_alpha: float = 0.5
    lookahead_k: int = 6
    num_devices: Optional[int] = None
    compute_dtype: str = "bfloat16"
    train_state_every: int = 0

    def __post_init__(self):
        if self.label_type not in LABEL_TYPES:
            raise ValueError(f"unknown label_type {self.label_type!r}")
        if self.optimizer not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if self.loss not in LOSSES:
            raise ValueError(f"unknown loss {self.loss!r}")


@dataclass(frozen=True)
class InferConfig:
    """Inference settings."""

    th_cell: float = 0.10
    th_seed: float = 0.45
    apply_clahe: bool = False
    scale_factor: float = 1.0
    # frames per device batch at 256^2 (larger buckets batch fewer frames)
    batch_size: int = 16
    use_tiling: bool = False
    tile_size: int = 512
    tile_overlap: int = 64
    quantize: bool = False
    # test-time augmentation: average over the shape-preserving dihedral
    # transforms (4 flips, all 8 of D4 on square inputs)
    tta: bool = False
    # the flows post-processing (label_type "flows"), Cellpose 4's
    # defaults (cellpose/dynamics.py::compute_masks): Euler steps a
    # foreground pixel takes, the cell-probability threshold, the largest
    # mean squared flow error a mask keeps, the smallest mask, and the
    # largest mask as a share of the frame
    niter: int = 200
    cellprob_threshold: float = 0.0
    flow_threshold: float = 0.4
    min_size: int = 15
    max_size_fraction: float = 0.4
    # muSAM's automatic instance segmentation (label_type "ais"), the
    # defaults of micro-sam's InstanceSegmentationWithDecoder.generate:
    # seeds where both smoothed distances lie below their thresholds, the
    # mask where the smoothed foreground lies above its own, and the
    # Gaussian sigmas of the foreground and of the two distances
    center_distance_threshold: float = 0.5
    boundary_distance_threshold: float = 0.5
    foreground_threshold: float = 0.5
    foreground_smoothing: float = 1.0
    distance_smoothing: float = 1.6


@dataclass(frozen=True)
class EvalConfig:
    """Evaluation grid (reference: src/evaluation/eval.py:127-131)."""

    th_cells: Tuple[float, ...] = (0.05, 0.075, 0.10, 0.125)
    th_seeds: Tuple[float, ...] = (0.35, 0.45)
    batch_size: int = 8
    save_raw_pred: bool = False
    # border correction inset (reference: utils.py:25)
    border_width: int = 10
    # coarse-to-fine threshold search: after the coarse grid, evaluate
    # halved-spacing neighbours around the running best for this many
    # rounds (0 = grid only)
    refine_steps: int = 0
    # evaluate with test-time augmentation (InferConfig.tta)
    tta: bool = False
    # evaluate ALL given models as ONE ensemble (averaged predictions,
    # InferenceEngine.from_checkpoints) instead of one row per model
    ensemble: bool = False
    # extra per-image metric columns ('aji', 'dice', 'pq') computed at the
    # AJI+-selected best thresholds; model selection stays AJI+-driven
    extra_metrics: Tuple[str, ...] = ()

    def __post_init__(self):
        bad = set(self.extra_metrics) - {"aji", "dice", "pq"}
        if bad:
            raise ValueError(f"unknown extra_metrics {sorted(bad)} "
                             "(choose from aji, dice, pq)")


def get_max_epochs(n_samples: int, crop_size: int) -> int:
    """Epoch budget from the training set's size (reference:
    src/training/train.py:579-606)."""
    if n_samples >= 1000:
        max_epochs = 200
    elif n_samples >= 500:
        max_epochs = 240
    elif n_samples >= 200:
        max_epochs = 320
    elif n_samples >= 100:
        max_epochs = 400
    elif n_samples >= 50:
        max_epochs = 480
    else:
        max_epochs = 560
    max_epochs *= (320 / crop_size) ** 0.5
    return int(max_epochs - max_epochs % 20)


# Description of the training augmentation pipeline, stored under the
# sidecar's 'transforms' key as the reference stores the repr of its Compose.
AUGMENTATION_TRANSFORMS = (
    "Compose(Flip(p=1.0, D4), Contrast(p=0.45: clahe|stretch|gamma), "
    "Scaling(p=0.25, 0.85-1.15), Rotate(p=0.25, ±45°), "
    "Blur(p=0.3, σ 1-2), Noise(p=0.3, σ 1-5%), Normalize([-1,1]))")


def read_sidecar(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def train_config_from_sidecar(sidecar: dict) -> TrainConfig:
    """Rebuild a TrainConfig from a sidecar dict (either package's or the
    reference's)."""
    model = ModelConfig.from_architecture(sidecar["architecture"],
                                          label_type=sidecar["label_type"])
    return TrainConfig(
        model=model,
        label_type=sidecar["label_type"],
        loss=sidecar.get("loss", "smooth_l1"),
        optimizer=sidecar.get("optimizer", "ranger"),
        batch_size=sidecar.get("batch_size", 4),
        run_name=sidecar.get("run_name", "model"),
        max_epochs=sidecar.get("max_epochs"),
        seed=sidecar.get("seed", 0),
        compute_dtype=sidecar.get("compute_dtype", "bfloat16"),
    )
