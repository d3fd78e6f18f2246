"""Device time of the kernels launched under ``aten::convolution``
(transposed convolutions included) in the traced sub-window, per
megapixel segmented there."""


def read(ctx):
    t, tw = ctx["trace"], ctx["traced"]
    if t is None or not tw or not tw.get("pixels"):
        return None
    s = t.operator_s.get("aten::convolution")
    return None if not s else s * 1e3 / (tw["pixels"] / 1e6)
