"""Profiling / step-timing hooks.

The port of ``microbeseg_tpu/utils/profiling.py``.  The reference's only
instrumentation is wall-clock training time (reference:
src/training/train.py:432,448,552-557).  Here: a step timer that aggregates
per-phase statistics (a copy), and ``device_trace``, which records the
host's calls and the card's kernels with ``torch.profiler`` into a Chrome
trace (``chrome://tracing``, Perfetto) in place of ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, List


class StepTimer:
    """Collects wall-clock durations per named phase."""

    def __init__(self):
        self.durations: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.durations[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, ds in self.durations.items():
            n = len(ds)
            total = sum(ds)
            out[name] = {"count": n, "total_s": total, "mean_s": total / n,
                         "min_s": min(ds), "max_s": max(ds)}
        return out

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items()):
            lines.append(f"{name:24s} n={s['count']:5d} total={s['total_s']:8.2f}s "
                         f"mean={1e3 * s['mean_s']:8.2f}ms")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Record a ``torch.profiler`` trace of the block (host calls, and the
    card's kernels where CUDA is available) into
    ``log_dir/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
