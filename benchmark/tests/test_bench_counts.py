"""The FLOP and byte counts against hand counts at small shapes."""

import importlib.util

import pytest
import torch
from torch import nn

from benchmark.harness.common import BENCH, HBM_BYTES_PER_S, Cell
from benchmark.reference.unet import conv_layers, forward_flops


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name, BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CFG = dict(unet_type="DU", act_fun="relu", pool_method="conv",
           normalization="bn", ch_in=1, ch_out=1, filters=(4, 8))


def test_forward_flops_by_hand():
    # 8 x 8 input, levels of 4 and 8 filters
    enc = 2 * 64 * (1 * 4 * 9 + 4 * 4 * 9)          # level 0 block
    pool = 2 * 16 * 4 * 4 * 9                        # strided conv to 4 x 4
    enc += pool + 2 * 16 * (4 * 8 * 9 + 8 * 8 * 9)   # level 1 block
    dec = (2 * 16 * 8 * 4 * 4                         # 2x2 transposed conv
           + 2 * 64 * (8 * 4 * 9 + 4 * 4 * 9)        # block on the concat
           + 2 * 64 * 4 * 1)                         # 1x1 head
    assert forward_flops(CFG, 8, 8) == enc + 2 * dec


def test_forward_flops_against_hooks():
    """The count agrees with the layer shapes a forward pass sees."""
    from microbeseg_torch.config import ModelConfig
    from microbeseg_torch.models.unet import build_unet

    model = build_unet(ModelConfig(**CFG)).eval()
    total = [0]

    def hook(m, inputs, out):
        k = m.kernel_size[0] * m.kernel_size[1]
        if isinstance(m, nn.ConvTranspose2d):
            i = inputs[0]
            total[0] += (2 * i.shape[0] * i.shape[2] * i.shape[3]
                         * m.in_channels * m.out_channels * k)
        else:
            total[0] += 2 * out.numel() * m.in_channels * k

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.zeros(1, 16, 24, 1))
    assert forward_flops(CFG, 16, 24) == total[0]
    assert len(conv_layers(CFG, 16, 24)) == sum(
        isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))
        for m in model.modules())


def test_flagship_forward_flops():
    """A third of PR 9's 1.9596 TFLOP a training step of four 256^2 crops."""
    cfg = dict(CFG, filters=(64, 1024), act_fun="mish", normalization="gn")
    f = forward_flops(cfg, 256, 256)
    assert f == pytest.approx(1.9596e12 / 12, rel=1e-3)


@pytest.mark.parametrize("name,per_px", [("k1_flood_roofline", 13),
                                          ("k2_flood_roofline", 12)])
def test_flood_bytes_by_hand(name, per_px):
    m = _metric(name)
    px = 16 * 256 * 256
    assert m.least_s(px) == pytest.approx(px * per_px / HBM_BYTES_PER_S)


def test_segment_flops_per_frame():
    m = _metric("segment_mfu_pct")
    conf = dict(CFG, filters=[4, 8])
    crops = {"frame": 256, "infer": {"use_tiling": False}}
    assert m.flops_per_frame(conf, crops) == forward_flops(CFG, 256, 256)
    tiled = {"frame": 2048, "infer": {"use_tiling": True, "tile_size": 512,
                                      "tile_overlap": 64}}
    # starts 0, 448, 896, 1344 and 1536: five a side
    assert m.flops_per_frame(conf, tiled) == 25 * forward_flops(CFG, 512,
                                                                512)


@pytest.mark.parametrize("name,metric,count,flops", [
    ("dunet-crops256", "segment_mfu_pct", "flops_per_frame",
     163_301_031_936),
    # 25 tiles of 512^2 a frame
    ("dunet-tiled2048", "segment_mfu_pct", "flops_per_frame",
     16_330_103_193_600),
    # three forwards at 256^2 an image
    ("dunet-mish-gn-train-b4", "train_mfu_pct", "flops_per_image",
     489_903_095_808),
])
def test_the_cells_flop_counts(name, metric, count, flops):
    """The counts the share of the peak reads in each cell, from its
    configuration's family."""
    c = Cell(name)
    assert getattr(_metric(metric), count)(c.config, c.traffic) == flops
