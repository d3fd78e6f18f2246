"""Device time between the edges of the port's ``mseg.vit.attention``
spans (``models/vit_sam.py``: each block's decomposed relative-position
term, its einsums and add, and ``scaled_dot_product_attention``) in the
traced sub-window, per megapixel segmented there.  The stream's idle
inside the spans counts too (the host's launches around the term, which
the profiler slows): the trace summary attributes kernels to ATen
operators alone (``harness/trace.py``), not to the port's spans, so the
kernels' own time under a span is not read here."""

from benchmark.harness.spans import device_s, per_mpx_ms


def read(ctx):
    return per_mpx_ms(device_s("mseg.vit.attention"), ctx["traced"])
