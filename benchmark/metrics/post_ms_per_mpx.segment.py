"""Device time between the edges of the port's ``mseg.segment.postprocess``
spans (``InferenceEngine.postprocess``: the seeds, their prune, the flood
and the relabel of each post-processing batch) in the traced sub-window,
per megapixel segmented there."""

from benchmark.harness.spans import device_s, per_mpx_ms


def read(ctx):
    return per_mpx_ms(device_s("mseg.segment.postprocess"), ctx["traced"])
