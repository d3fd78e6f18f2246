"""One run of one cell: set-up, the measured window, the traced
sub-window, the check against the reference, the result line."""

from __future__ import annotations

import importlib.util
import math
import sys
import time
from typing import Callable, Dict, Optional

import torch

from benchmark.harness.common import BENCH, Cell, forbidden_modules
from benchmark.harness import drivers


def err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def reader(name: str) -> Callable[[dict], Optional[float]]:
    """``read`` of ``benchmark/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit() -> Optional[str]:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


def device_info(dev: torch.device, peak: int) -> Dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t0: float, control: bool = False, log=err) -> dict:
    """The result dict of one run; its ``checks`` are the numbers that
    decided ``correct``."""
    dev = torch.device(device)
    drv = drivers.load(cell.traffic["entry"])(cell, seed, dev, control, log)
    drv.setup()
    setup_s = time.perf_counter() - t0
    at, parts = t0, []
    for phase, end in drv.phases:
        parts.append(f"{phase} {end - at:.3f}")
        at = end
    log(f"set-up {setup_s:.3f} s: {', '.join(parts)}")
    win = drv.window(seconds)
    summary, traced = None, None
    if trace:
        from benchmark.harness.trace import traced as run_traced
        traced, summary = run_traced(drv.traced_window)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    drv.free()
    t_check = time.perf_counter()
    checks = drv.check()
    log(f"reference and comparison: {time.perf_counter() - t_check:.3f} s")
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks)
    ctx = {"cell": cell, "setup_s": setup_s, "window": win,
           "traced": traced, "trace": summary, "power_limit": power_limit()}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": int(win["attempted"]),
           "failed": int(win["failed"]), "metrics": metrics,
           "device": device_info(dev, peak)}
    if summary is not None:
        out["device"].update(busy_s=summary.busy_s,
                             window_s=summary.window_s)
        out["breakdown"] = summary.breakdown()
        log(f"trace read in {summary.read_s:.3f} s; {ctx['power_limit']}")
    # numbers logged beside the compared ones (``control.py`` prints them)
    out["readings"] = getattr(drv, "readings", {})
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return out


def finish(out: dict) -> int:
    """Refuse a process that holds a forbidden module; else print the
    compared numbers (standard error) and the result line (last on
    standard output)."""
    out = {k: v for k, v in out.items() if k != "readings"}
    bad = forbidden_modules()
    if bad:
        err(f"forbidden modules loaded: {', '.join(bad)}")
        return 4
    for name, c in out["checks"].items():
        err(f"{name} {c['value']!r} limit {c['limit']!r}")
    import json
    print(json.dumps(out), flush=True)
    return 0
