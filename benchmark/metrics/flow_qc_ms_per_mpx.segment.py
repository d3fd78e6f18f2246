"""Device time between the edges of the port's
``mseg.segment.flows.qc`` spans (``ops/flows.py``: the flow check, each
mask's flows recomputed by heat diffusion and compared with the network's)
in the traced sub-window, per megapixel segmented there."""

from benchmark.harness.spans import device_s, per_mpx_ms


def read(ctx):
    return per_mpx_ms(device_s("mseg.segment.flows.qc"), ctx["traced"])
