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
    """The cell at a size the CPU runs in seconds: the configuration's
    family's preset (a narrow network) and the entry's (small frames,
    stacks or crops, and the limits that count them)."""
    from benchmark import families
    from benchmark.harness import drivers
    c = cell(name)
    c.config = families.of(c.config).tiny(c.config)
    c.traffic, c.limits = drivers.load(c.traffic["entry"]).tiny(c.traffic,
                                                                c.limits)
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
