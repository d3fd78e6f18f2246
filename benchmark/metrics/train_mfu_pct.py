"""Share of the card's dense bf16 peak (989 TFLOP/s) that the untraced
window's training reached: three times the forward convolutions' FLOPs of
an image (forward, and the two products of the backward) times the images
per second."""

from benchmark.harness.common import BF16_FLOPS_PER_S, model_config
from benchmark.reference.unet import forward_flops


def read(ctx):
    w, cell = ctx["window"], ctx["cell"]
    if not w.get("images"):
        return None
    side = cell.traffic["frame"]
    f = 3 * forward_flops(model_config(cell.config), side, side)
    return 100.0 * f * w["images"] / w["seconds"] / BF16_FLOPS_PER_S
