"""Device time between the edges of the port's ``mseg.vit.window`` spans
(``models/vit_sam.py``: a windowed block's zero pad and cut of its normed
map into windows, and the reassembly of the windows and the crop after
its attention) in the traced sub-window, per megapixel segmented there.
The stream's idle inside the spans counts too, as in
``attention_ms_per_mpx.segment``."""

from benchmark.harness.spans import device_s, per_mpx_ms


def read(ctx):
    return per_mpx_ms(device_s("mseg.vit.window"), ctx["traced"])
