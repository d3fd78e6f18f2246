"""The benchmark of microbeseg_torch: one run of one cell.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Reads the cell from ``BENCHMARK.json`` (its configuration, its traffic mix
in ``benchmark/traffic/``, its limits in ``benchmark/limits/``, its metrics'
readers in ``benchmark/metrics/``), makes the inputs and weights on the
card from the seed, warms up, measures for ``--seconds``, with ``--trace
1`` then traces a short sub-window, checks the outputs against the plain
reference in ``benchmark/reference/``, and prints one JSON line last.
Exits non-zero without a result when there is no CUDA card, when the cell
needs more cards than there are, and when JAX or the JAX package was
loaded.  Build, kernel and bytecode caches stay inside the checkout.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
# compiled bytecode too, also where the environment says not to write it:
# where the installed packages come without it, every run would compile
# some 1,900 modules (7 s of set-up); here only a checkout's first run does
sys.pycache_prefix = str(ROOT / "build" / "bench_cache" / "pycache")
sys.dont_write_bytecode = False
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchmark.harness.common import Cell
    from benchmark.harness.core import err, finish, run

    cell = Cell(args.workload)
    if not torch.cuda.is_available():
        err("no CUDA device: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        err(f"{cell.name} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    try:
        import microbeseg_torch  # noqa: F401
    except ImportError as exc:
        err(f"the program is not here: {exc}")
        return 3
    out = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    return finish(out)


if __name__ == "__main__":
    sys.exit(main())
