"""What every part of the harness shares: where things are, the cell a
workload name stands for, seeds, the card's peaks, the import check."""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict, List

from benchmark import families

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"

# one NVIDIA H100 SXM (data sheet): dense bf16 tensor-core peak and HBM3
# bandwidth; the int32 rate is derived, not published: 132 SMs x 64 int32
# results a clock (CUDA C++ Programming Guide, compute capability 9.0) x
# the 1.98 GHz boost clock
BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# top-level module names no run may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "microbeseg_tpu")


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one random stream of a run's seed."""
    return (int(seed) * 1_000_003 + stream * 7919) % (1 << 63)


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark_json() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic
    mix, correctness limits and metrics, each found by name."""

    def __init__(self, name: str, bench: dict = None):
        bench = bench if bench is not None else benchmark_json()
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = found[0]
        conf = [c for c in bench["configs"]
                if c["name"] == self.workload["config"]][0]
        self.config = load_json(ROOT / conf["file"])
        self.traffic = load_json(BENCH / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.limits = load_json(BENCH / "limits" / f"{name}.json")
        self.chips = self.workload["chips"]
        self.end_to_end = self._metrics(bench["end_to_end"])
        self.per_layer = self._metrics(bench["per_layer"])

    def _metrics(self, entries) -> List[dict]:
        return [m for m in entries
                if "workloads" not in m or self.name in m["workloads"]]


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


# a configuration file: its family's network keys (``benchmark/families``),
# the keys its entry's driver reads (``CONFIG_KEYS``) and notes (these, and
# optionally the family, what was ``assumed`` and the ``published`` values
# of what was ``reduced``)
NOTE_KEYS = ("name", "source", "reduced")
OPTIONAL_KEYS = ("family", "assumed", "published")


def model_config(config: dict) -> Dict:
    """The network's settings of a configuration file, as its family reads
    them."""
    return families.of(config).model_config(config)
