"""K1 (``csrc/flood.cu``: ``flood_block_kernel``, and the cluster kernel
``flood_kernel`` for more than 256 levels): its least time over its mean
device time a launch, in the traced sub-window.

One launch floods one post-processing batch of the cell's frames.  The
least time is the larger of its bytes over the HBM bandwidth (3.35 TB/s)
and its operations over the int32 rate (16.7 T/s, derived: 132 SMs x 64
lanes x 1.98 GHz, not a published peak).  Bytes: the value (float32), the
markers (int32) and the mask (bool) read once, the labels (int32) written
once: 13 a pixel.  Operations: 6 a pixel (one 4-neighbour minimum, a
compare, a select), the least any flood needs to visit each pixel once."""

from benchmark.harness.common import HBM_BYTES_PER_S, INT32_OPS_PER_S

KERNELS = ("flood_block_kernel", "flood_kernel")
BYTES_PER_PX, OPS_PER_PX = 13, 6


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
    mix = ctx["cell"].traffic
    batch = min(mix["infer"]["batch_size"], mix["stack"])
    pixels = batch * mix["frame"] ** 2
    mean_s = sum(t.kernel_s[k] for k in names) / n
    return 100.0 * least_s(pixels) / mean_s
