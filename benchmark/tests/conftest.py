"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the repository root (the CPU, at tiny sizes); the tests marked ``cuda`` run
on the card and skip without one."""

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness.common import Cell  # noqa: E402


def cell(name: str) -> Cell:
    return Cell(name)


def tiny(name: str) -> Cell:
    """The cell at a size the CPU runs in seconds: a narrow network
    (filters 8 -> 32), small frames and stacks, the same limits."""
    c = cell(name)
    c.config = dict(c.config, filters=[8, 32])
    t = dict(c.traffic)
    if t["entry"] == "segment":
        tiled = t["infer"].get("use_tiling")
        t.update(frame=160 if tiled else 64, stack=4, pool=3, sample=2,
                 objects=[2, 8], traced_seconds=0.5, must_launch=[])
        if tiled:
            t["infer"] = dict(t["infer"], tile_size=64, tile_overlap=16)
    else:
        t.update(frame=64, pool=16, objects=[2, 8], warm_steps=1)
    c.traffic = t
    c.limits = dict(c.limits, frames_compared=1)
    return c


def run_tiny(name: str, seed: int = 2147483700, seconds: float = 0.5):
    from benchmark.harness.core import run
    return run(tiny(name), seed, seconds, False, "cpu", time.perf_counter(),
               log=lambda *a: None)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
