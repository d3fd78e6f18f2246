"""Headless evaluation CLI on the port: AJI+ threshold-grid model evaluation.

Same arguments as ``microbeseg_tpu/cli/evaluate.py``, plus ``--device``
(default: the CUDA card; ``--device cpu`` runs on the CPU).  Give it a
trainset directory with ``test/`` and one or more checkpoints:

    python -m microbeseg_torch.cli.evaluate -d <trainset> -m <model.ckpt>
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

from microbeseg_torch.config import EvalConfig
from microbeseg_torch.evaluation.evaluator import Evaluator


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="microbeSEG evaluation (PyTorch/CUDA)")
    parser.add_argument("--data", "-d", required=True, type=str,
                        help="Trainset directory containing test/")
    parser.add_argument("--models", "-m", required=True, type=str, nargs="+",
                        help="Checkpoint paths (.ckpt or stem)")
    parser.add_argument("--results", "-r", default=None, type=str,
                        help="Results directory")
    parser.add_argument("--save_raw", default=False, action="store_true",
                        help="Save raw CNN outputs")
    parser.add_argument("--th_cells", type=float, nargs="+", default=None,
                        help="Mask-threshold grid (default: the reference's "
                             "0.05 0.075 0.10 0.125, eval.py:128)")
    parser.add_argument("--th_seeds", type=float, nargs="+", default=None,
                        help="Seed-threshold grid (default: the reference's "
                             "0.35 0.45)")
    parser.add_argument("--refine", type=int, default=0, metavar="N",
                        help="coarse-to-fine threshold search: after the "
                             "grid, evaluate halved-spacing neighbors of "
                             "the best point for N rounds (default 0 = grid "
                             "only)")
    parser.add_argument("--tta", default=False, action="store_true",
                        help="Test-time augmentation: average predictions "
                             "over the dihedral transforms (4-8x forward "
                             "cost)")
    parser.add_argument("--metrics", type=str, nargs="+", default=None,
                        choices=["aji", "dice", "pq"],
                        help="Extra per-image metric columns computed at "
                             "the AJI+-selected best thresholds")
    parser.add_argument("--ensemble", default=False, action="store_true",
                        help="Evaluate ALL --models as ONE ensemble "
                             "(averaged predictions) instead of one row per "
                             "model")
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card)")
    return parser


def format_rows(rows) -> str:
    """The aggregated table as aligned text, one line per model."""
    if not rows:
        return ""
    columns = list(rows[0])
    cells = [columns] + [[str(r.get(c)) for c in columns] for r in rows]
    widths = [max(len(line[i]) for line in cells)
              for i in range(len(columns))]
    return "\n".join(" ".join(v.rjust(w) for v, w in zip(line, widths))
                     for line in cells)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    path_data = Path(args.data)
    path_results = (Path(args.results) if args.results
                    else Path.cwd() / "evaluation" / path_data.name)
    path_results.mkdir(parents=True, exist_ok=True)
    cfg = EvalConfig(save_raw_pred=args.save_raw)
    if args.th_cells:
        cfg = dataclasses.replace(cfg, th_cells=tuple(args.th_cells))
    if args.th_seeds:
        cfg = dataclasses.replace(cfg, th_seeds=tuple(args.th_seeds))
    if args.refine:
        cfg = dataclasses.replace(cfg, refine_steps=args.refine)
    if args.tta:
        cfg = dataclasses.replace(cfg, tta=True)
    if args.ensemble:
        cfg = dataclasses.replace(cfg, ensemble=True)
    if args.metrics:
        cfg = dataclasses.replace(cfg, extra_metrics=tuple(args.metrics))
    ev = Evaluator(cfg, text_output=print, device=args.device)
    rows = ev.evaluate(path_data, path_results,
                       [Path(m) for m in args.models])
    if rows is None:
        return 1
    print(format_rows(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
