"""Share of the card's dense bf16 peak (989 TFLOP/s) that the untraced
window's training reached: three times one forward's FLOPs on an image
(the forward, and the two products of the backward), counted by the
configuration's family, times the images per second."""

from benchmark.families import forward_flops_of
from benchmark.harness.common import BF16_FLOPS_PER_S


def flops_per_image(config: dict, mix: dict) -> int:
    side = mix["frame"]
    return 3 * forward_flops_of(config, side, side)


def read(ctx):
    w, cell = ctx["window"], ctx["cell"]
    if not w.get("images"):
        return None
    f = flops_per_image(cell.config, cell.traffic)
    return 100.0 * f * w["images"] / w["seconds"] / BF16_FLOPS_PER_S
