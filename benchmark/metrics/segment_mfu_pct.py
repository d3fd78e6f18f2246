"""Share of the card's dense bf16 peak (989 TFLOP/s) that the untraced
window's segmentation reached: the convolutions' FLOPs of one forward at the
cell's shapes (the pad bucket, or every tile the tile and overlap cut) times
the frames segmented, over the window's seconds."""

from benchmark.harness.common import BF16_FLOPS_PER_S, model_config
from benchmark.reference.infer import bucket, tile_starts
from benchmark.reference.unet import forward_flops


def flops_per_frame(config: dict, mix: dict) -> int:
    cfg = model_config(config)
    side = mix["frame"]
    inf = mix["infer"]
    tile = inf.get("tile_size", 512)
    if inf.get("use_tiling") and side > tile:
        n = len(tile_starts(side, tile, inf["tile_overlap"])) ** 2
        return n * forward_flops(cfg, tile, tile)
    return forward_flops(cfg, bucket(side), bucket(side))


def read(ctx):
    w, cell = ctx["window"], ctx["cell"]
    if not w.get("frames"):
        return None
    f = flops_per_frame(cell.config, cell.traffic)
    return 100.0 * f * w["frames"] / w["seconds"] / BF16_FLOPS_PER_S
