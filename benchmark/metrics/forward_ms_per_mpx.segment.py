"""Device time between the edges of the port's ``mseg.segment.forward``
spans (``inference/engine.py``: prep, pad, the network, crop and resize a
bucket batch; the tile cut and the tile batches' forwards on the tiled
path) in the traced sub-window, per megapixel segmented there."""

from benchmark.harness.spans import device_s, per_mpx_ms


def read(ctx):
    return per_mpx_ms(device_s("mseg.segment.forward"), ctx["traced"])
