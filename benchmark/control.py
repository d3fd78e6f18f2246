"""Readings that the correctness limits are set from, on the card.

    python benchmark/control.py --workload <name> --seeds 1 2 3 \
        [--seconds 3] [--control] [--fault NAME]

For each seed, in one process: a run of the cell with a short window and
its compared numbers (the lower readings); with ``--control``, the same
with the lower-precision control in the program's place: the inference
cells' engine with its int8 path on (``InferConfig(quantize=True)``), the
training cell's reference with its convolutions' operands in float8
(``reference/lowp.py``).  ``--fault`` plants one of the faults of
``benchmark/faults.py`` under the timed path.  One JSON line a seed.
The benchmark's own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)

    import torch
    from benchmark import faults
    from benchmark.harness.common import Cell
    from benchmark.harness.core import run
    from benchmark.entries.train import Driver as TrainDriver
    from benchmark.reference.lowp import fp8

    cell = Cell(args.workload)
    undo = faults.plant(args.fault) if args.fault else None
    try:
        for seed in args.seeds:
            t0 = time.perf_counter()
            if args.control and cell.traffic["entry"] == "train":
                drv = TrainDriver(cell, seed, "cuda", log=print)
                drv.setup()
                drv.free()
                checks = drv.numbers(drv.reference(quant=fp8),
                                     drv.reference())
                out = {"checks": {c["name"]: c for c in checks},
                       "readings": drv.readings}
            else:
                out = run(cell, seed, args.seconds, False, "cuda", t0,
                          control=args.control, log=print)
            line = {"seed": seed, "control": args.control,
                    "fault": args.fault, "seconds": time.perf_counter() - t0,
                    "checks": {k: v["value"] for k, v in
                               out["checks"].items()}}
            line["checks"].update(out.get("readings", {}))
            print(json.dumps(line), flush=True)
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
    finally:
        if undo:
            undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
