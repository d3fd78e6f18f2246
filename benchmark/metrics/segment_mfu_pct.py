"""Share of the card's dense bf16 peak (989 TFLOP/s) that the untraced
window's segmentation reached: one forward's FLOPs at the cell's shapes
(the pad bucket, or every tile the tile and overlap cut), counted by the
configuration's family, times the frames segmented, over the window's
seconds."""

from benchmark.families import forward_flops_of
from benchmark.harness.common import BF16_FLOPS_PER_S
from benchmark.reference.infer import bucket, tile_starts


def flops_per_frame(config: dict, mix: dict) -> int:
    side = mix["frame"]
    inf = mix["infer"]
    tile = inf.get("tile_size", 512)
    if inf.get("use_tiling") and side > tile:
        n = len(tile_starts(side, tile, inf["tile_overlap"])) ** 2
        return n * forward_flops_of(config, tile, tile)
    return forward_flops_of(config, bucket(side), bucket(side))


def read(ctx):
    w, cell = ctx["window"], ctx["cell"]
    if not w.get("frames"):
        return None
    f = flops_per_frame(cell.config, cell.traffic)
    return 100.0 * f * w["frames"] / w["seconds"] / BF16_FLOPS_PER_S
