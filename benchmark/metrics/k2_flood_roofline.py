"""K2 (``csrc/flood_frame.cu``: ``flood_front_kernel``): its least time
over its mean device time a launch, in the traced sub-window.

One launch floods one frame (the kernel's two int32 planes, built in
PyTorch before it, are its input).  The least time is the larger of its
bytes over the HBM bandwidth (3.35 TB/s) and its operations over the int32
rate (16.7 T/s, derived: 132 SMs x 64 lanes x 1.98 GHz, not a published
peak).  Bytes: the level plane and the seeded key plane read once, the
labels written once: 12 a pixel.  Operations: 6 a pixel (one 4-neighbour
minimum, a compare, a select)."""

from benchmark.harness.common import HBM_BYTES_PER_S, INT32_OPS_PER_S

KERNELS = ("flood_front_kernel",)
BYTES_PER_PX, OPS_PER_PX = 12, 6


def least_s(pixels: int) -> float:
    return max(pixels * BYTES_PER_PX / HBM_BYTES_PER_S,
               pixels * OPS_PER_PX / INT32_OPS_PER_S)


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    names = [k for k in t.kernel_s if k.split("(")[0] in KERNELS]
    n = sum(t.kernel_n[k] for k in names)
    if not n:
        return None
    pixels = ctx["cell"].traffic["frame"] ** 2
    mean_s = sum(t.kernel_s[k] for k in names) / n
    return 100.0 * least_s(pixels) / mean_s
