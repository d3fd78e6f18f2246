"""``csrc/rel_attention.cu``'s ``rel_attention_kernel`` where one forward
launches it on maps of more than one grid (SAM's windowed and global
blocks): its least time over its device time, in the traced sub-window.

The port counts each launch's maps (images x heads) under its grid g as
``attention_maps.g{g}``: a windowed block's maps are its windows' (g the
window), a global block's the tiles' (g the token grid).  The least time
is the sum over the grids of ``rel_attention_roofline.least_s(maps_g, g^2,
hd)`` (the two products over the tensor cores' bf16 rate, or q, k, v and
the output over the HBM bandwidth, whichever is longer), hd =
embed_dim / num_heads; the device time is every launch of the kernel in
the window.  Silent where the port keeps no count by grid."""

import importlib.util
import re
from pathlib import Path

from benchmark.harness.spans import recorded

KERNEL = "rel_attention_kernel"
_COUNTER = re.compile(r"attention_maps\.g(\d+)$")


def _least_s():
    path = Path(__file__).with_name("rel_attention_roofline.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_rel_attention_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.least_s


def least_s(maps_by_grid: dict, hd: int) -> float:
    """The least time of the maps counted by grid: {g: maps}."""
    f = _least_s()
    return sum(f(maps, g * g, hd) for g, maps in maps_by_grid.items())


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    seconds = sum(s for k, s in t.kernel_s.items() if KERNEL in k)
    maps = {int(m.group(1)): v
            for k, v in recorded()["counters"].items()
            if isinstance(v, int) and (m := _COUNTER.match(k))}
    if not seconds or not maps:
        return None
    cfg = ctx["cell"].config
    hd = cfg["embed_dim"] // cfg["num_heads"]
    return 100.0 * least_s(maps, hd) / seconds
