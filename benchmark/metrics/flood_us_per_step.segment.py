"""Device time of the marker-flood kernels in the traced sub-window (K1:
``flood_block_kernel``, and ``flood_kernel`` for more than 256 levels; K2:
``flood_front_kernel``) over the dependent steps that set their launches'
time, which the port counts as ``flood_steps`` (K1's images run side by
side: its launch's largest step count; K2 floods frame after frame: the
sum of its frames' counts)."""

from benchmark.harness.spans import recorded

# kernel -> the port's route name (``kernels/_build.LAUNCHES``) it runs for
KERNELS = {"flood_block_kernel": "flood_packed",
           "flood_kernel": "flood_packed_cluster",
           "flood_front_kernel": "flood_tiled"}


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    steps = recorded()["counters"].get("flood_steps", {})
    seconds = sum(s for name, s in t.kernel_s.items()
                  if name.split("(")[0] in KERNELS)
    n = sum(steps.get(route, 0) for route in KERNELS.values())
    return seconds * 1e6 / n if seconds and n else None
