"""Device time of the kernels launched under ``aten::convolution`` and
``aten::convolution_backward`` in the traced sub-window, per training step
there."""


def read(ctx):
    t, tw = ctx["trace"], ctx["traced"]
    if t is None or not tw or not tw.get("steps"):
        return None
    s = (t.operator_s.get("aten::convolution", 0.0)
         + t.operator_s.get("aten::convolution_backward", 0.0))
    return None if not s else s * 1e3 / tw["steps"]
