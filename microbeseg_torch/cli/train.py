"""Headless training CLI on the port (reference: train_script.py:14-129).

Same arguments as ``microbeseg_tpu/cli/train.py``, plus ``--device``
(default: the CUDA card; ``--device cpu`` runs on the CPU).  Label creation
then training on a local trainset folder with ``train/`` and ``val/`` (and
``test/``) subdirectories of img_ / mask_ TIFFs:

    python -m microbeseg_torch.cli.train --train_dir <trainset> --method distance

``--omero_id`` needs the server-backed store, which the port does not have
yet (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from microbeseg_torch.training.workers import create_labels, run_training


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="microbeSEG training (PyTorch/CUDA)")
    parser.add_argument("--omero_id", "-id", default=None, type=int,
                        help="Training dataset id (server-backed store; not "
                             "in the port yet)")
    parser.add_argument("--train_dir", default=None, type=str,
                        help="Local trainset directory (train/ + val/ subdirs)")
    parser.add_argument("--batch_size", "-b", default=4, type=int,
                        help="Batch size")
    parser.add_argument("--iterations", "-i", default=1, type=int,
                        help="Number of models to train")
    parser.add_argument("--method", "-m", default="distance", type=str,
                        help='"boundary" or "distance"')
    parser.add_argument("--optimizer", "-o", default="Ranger", type=str,
                        help='"Adam" or "Ranger"')
    parser.add_argument("--model_path", "-r", default=None, type=str,
                        help="Model path for saving")
    parser.add_argument("--num_devices", "-d", default=None, type=int,
                        help="Data-parallel devices; the port trains on one")
    parser.add_argument("--normalization", "-n", default="gn", type=str,
                        help='"gn" (default, robust) | "bn" (reference '
                        'configuration) | "in"')
    parser.add_argument("--save_train_state", default=0, type=int,
                        metavar="N",
                        help="Save a resumable training snapshot (weights + "
                             "optimizer state + RNG) every N epochs (0: off)")
    parser.add_argument("--resume", action="store_true",
                        help="Resume the most recent interrupted run from "
                             "its training snapshot")
    parser.add_argument("--max_epochs", default=None, type=int,
                        help="Override the dataset-size epoch heuristic")
    parser.add_argument("--pretrained", default=None, type=str,
                        help="Checkpoint stem to warm-start training from "
                             "(fine-tuning instead of from-scratch)")
    parser.add_argument("--username", default=None, type=str,
                        help="OMERO username")
    parser.add_argument("--password", default=None, type=str,
                        help="OMERO password")
    parser.add_argument("--host", default=None, type=str, help="OMERO host")
    parser.add_argument("--port", default=None, type=str, help="OMERO port")
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card)")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.method.lower() not in ("distance", "boundary"):
        raise ValueError(f"Unknown method {args.method}")
    if args.optimizer.lower() not in ("ranger", "adam"):
        raise ValueError(f"Unknown optimizer {args.optimizer}")
    if args.num_devices is not None and args.num_devices > 1:
        raise NotImplementedError(
            "data-parallel training is not in the port yet (ROADMAP Queue 1, "
            "the item after training); train on one device")

    if args.train_dir is not None:
        trainset_path = Path(args.train_dir)
    elif args.omero_id is not None:
        raise NotImplementedError(
            "--omero_id needs the server-backed store, which the port does "
            "not have yet (ROADMAP Queue 1 item 11); export the trainset and "
            "pass --train_dir")
    else:
        raise ValueError("Provide --train_dir or --omero_id")

    model_path = (Path.cwd() / "models" if args.model_path is None
                  else Path(args.model_path))
    model_path = model_path / trainset_path.name
    model_path.mkdir(parents=True, exist_ok=True)

    print(f"Create {args.method.lower()} labels")
    if not create_labels(trainset_path, args.method.lower(),
                         text_output=print, device=args.device):
        return 1

    print("Start training")
    ok = run_training(trainset_path, model_path, args.method.lower(),
                      args.iterations, args.optimizer.lower(),
                      args.batch_size, text_output=print,
                      normalization=args.normalization,
                      max_epochs=args.max_epochs,
                      train_state_every=args.save_train_state,
                      resume=args.resume,
                      pretrained=(Path(args.pretrained)
                                  if args.pretrained else None),
                      device=args.device)
    print("--- Finished ---")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
