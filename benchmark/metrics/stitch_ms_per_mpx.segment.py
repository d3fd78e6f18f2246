"""Device time between the edges of the port's ``mseg.segment.stitch``
spans (``InferenceEngine._tiled_chunk``'s feathered stitching of the tile
predictions, and the resize of the stitched maps) in the traced
sub-window, per megapixel segmented there."""

from benchmark.harness.spans import device_s, per_mpx_ms


def read(ctx):
    return per_mpx_ms(device_s("mseg.segment.stitch"), ctx["traced"])
