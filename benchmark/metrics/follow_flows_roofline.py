"""``csrc/follow.cu``'s ``follow_flows_kernel``: its least time over its
mean device time a launch, in the traced sub-window.

One launch takes a frame's foreground points through ``niter`` Euler
steps; the port counts the points as ``flow_points``.  The least time is
the larger of two bounds.  Bytes over the HBM bandwidth (3.35 TB/s): the
flow field read once, 8 B a pixel of the frame, and each point read and
written once, 16 B.  Operations over the card's float32 rate outside the
tensor cores (67 TFLOP/s, NVIDIA's H100 SXM data sheet): ``OPS_PER_STEP``
a point's step (grid_sample's source index 8, two floors, the four corner
weights 12, four taps of two channels 16, the add and clamp 6; a fused
multiply-add counts as 2, as the peak counts it), times ``niter``, times
the points."""

from benchmark.harness.common import HBM_BYTES_PER_S
from benchmark.harness.spans import recorded

KERNEL = "follow_flows_kernel"
FP32_FLOPS_PER_S = 67e12
OPS_PER_STEP = 44
BYTES_PER_PX, BYTES_PER_POINT = 8, 16


def least_s(pixels: int, points: float, niter: int) -> float:
    return max((pixels * BYTES_PER_PX + points * BYTES_PER_POINT)
               / HBM_BYTES_PER_S,
               points * niter * OPS_PER_STEP / FP32_FLOPS_PER_S)


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    names = [k for k in t.kernel_s if KERNEL + "(" in k]
    n = sum(t.kernel_n[k] for k in names)
    points = recorded()["counters"].get("flow_points")
    if not n or not points:
        return None
    mix = ctx["cell"].traffic
    mean_s = sum(t.kernel_s[k] for k in names) / n
    return 100.0 * least_s(mix["frame"] ** 2, points / n,
                           mix["infer"]["niter"]) / mean_s
