"""Megapixels of frames whose uint16 masks came back to the host in the
window, over the window's seconds (closed loop, one caller)."""


def read(ctx):
    w = ctx["window"]
    return w["pixels"] / 1e6 / w["seconds"] if "pixels" in w else None
