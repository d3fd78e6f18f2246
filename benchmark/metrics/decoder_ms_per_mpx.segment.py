"""Device time between the edges of the port's ``mseg.unetr.decoder``
spans (``models/unetr.py``: muSAM's UNETR decoder, from the encoder's
neck output to the three sigmoid fields of a forward's tiles) in the
traced sub-window, per megapixel segmented there."""

from benchmark.harness.spans import device_s, per_mpx_ms


def read(ctx):
    return per_mpx_ms(device_s("mseg.unetr.decoder"), ctx["traced"])
