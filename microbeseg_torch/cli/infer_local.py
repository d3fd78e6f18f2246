"""Local-file inference CLI on the port's engine.

Same argument contract and shape dispatch as
``microbeseg_tpu/cli/infer_local.py``.  Runs on the CUDA card; ``--device
cpu`` runs on the CPU.  ``--sliding_window`` forces tiled inference with
``--tile_size`` and ``--tile_overlap``; ``--quantize`` runs the large-spatial
3x3 convolutions in int8 (not with an ensemble).

    python -m microbeseg_torch.cli.infer_local -i <tif dir> -m <model stem>
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from microbeseg_torch.config import InferConfig
from microbeseg_torch.inference.engine import InferenceEngine
from microbeseg_torch.utils.tiff import imread, imwrite


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="microbeSEG inference script (PyTorch/CUDA)")
    parser.add_argument("--img_dir", "-i", required=True, type=str,
                        help="Directory with image files to process (.tif, .tiff)")
    parser.add_argument("--model", "-m", required=True, type=str, nargs="+",
                        help="Path to model; several paths form an ensemble "
                        "(averaged predictions)")
    parser.add_argument("--thresholds", "-t", default=[0.10, 0.45], type=float,
                        nargs="+", help="Thresholds for distance models "
                        "(th_cell th_seed)")
    parser.add_argument("--result_path", "-r", default=None, type=str,
                        help="Result path")
    parser.add_argument("--channel", "-c", default=0, type=int,
                        help="Channel to process")
    parser.add_argument("--batch_size", "-b", default=8, type=int,
                        help="Frames per device batch")
    parser.add_argument("--tile_size", default=1024, type=int,
                        help="Tile size for sliding-window inference")
    parser.add_argument("--tile_overlap", default=128, type=int,
                        help="Tile overlap (halo) in pixels")
    parser.add_argument("--sliding_window", default=False, action="store_true",
                        help="Force sliding-window tiled inference")
    parser.add_argument("--quantize", default=False, action="store_true",
                        help="int8 forward on the large-spatial conv layers")
    parser.add_argument("--tta", default=False, action="store_true",
                        help="Test-time augmentation: average predictions "
                        "over the dihedral transforms (4-8x forward cost)")
    parser.add_argument("--overwrite", "-o", default=False,
                        action="store_true", help="Overwrite existing results")
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card)")
    return parser


def resolve_model_stems(models) -> list:
    """Strip only a ``.ckpt`` suffix and require both the checkpoint and its
    architecture sidecar."""
    stems = []
    for model in map(Path, models):
        stem = model.with_suffix("") if model.suffix == ".ckpt" else model
        if not (stem.parent / f"{stem.name}.ckpt").is_file():
            raise FileNotFoundError(f"{stem}.ckpt not found!")
        if not (stem.parent / f"{stem.name}.json").is_file():
            raise FileNotFoundError(f"{stem}.json not found!")
        stems.append(stem)
    return stems


def build_engine(models, cfg: InferConfig, device=None) -> InferenceEngine:
    """One engine from one or several model paths (ensemble)."""
    stems = resolve_model_stems(models)
    if len(stems) == 1:
        return InferenceEngine.from_checkpoint(stems[0], cfg=cfg,
                                               device=device)
    return InferenceEngine.from_checkpoints(stems, cfg=cfg, device=device)


def dispatch_shape(img: np.ndarray, channel: int):
    """(T, H, W) stack from an image, or None if its shape is unsupported."""
    if img.ndim == 2:
        return img[None]
    if img.ndim == 3:
        if img.shape[-1] == 3:
            return img[..., channel][None]
        if img.shape[0] == 3:
            return img[channel][None]
        return img  # (T, H, W)
    if img.ndim == 4:
        return img[..., channel]  # (T, H, W, 3) pages, channel last
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    imgs_path = Path(args.img_dir)
    result_path = (Path.cwd() / "results" if args.result_path is None
                   else Path(args.result_path))
    result_path.mkdir(parents=True, exist_ok=True)

    if len(args.thresholds) != 2:
        raise ValueError(f"{len(args.thresholds)} thresholds given, needed are 2")

    cfg = InferConfig(th_cell=args.thresholds[0], th_seed=args.thresholds[1],
                      batch_size=args.batch_size, use_tiling=args.sliding_window,
                      tile_size=args.tile_size, tile_overlap=args.tile_overlap,
                      quantize=args.quantize, tta=args.tta)
    engine = build_engine(args.model, cfg, device=args.device)

    file_ids = sorted(imgs_path.glob("*.tif*"))
    if not file_ids:
        print("No files found")
        return 0

    print("--- Start inference ---")
    for img_id in file_ids:
        out_file = result_path / f"mask_{img_id.stem}_channel{args.channel}.tif"
        if out_file.is_file() and not args.overwrite:
            print(f"Skip {img_id.name} (already processed and overwriting "
                  "not enabled)")
            continue
        stack = dispatch_shape(imread(img_id), args.channel)
        if stack is None:
            print(f"Skip {img_id.name} (not supported image shape)")
            continue
        print(f"Process {img_id.name} (channel: {args.channel})")
        masks = engine.segment(stack)
        imwrite(out_file, np.squeeze(masks))
    print("--- Finished ---")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
