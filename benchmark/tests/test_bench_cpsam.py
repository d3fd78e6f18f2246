"""The Cellpose-SAM cell: its family's FLOP count, pinned and held against
PyTorch's own count of a forward; the roofline's bounds by hand; a fault
that drops the relative-position term comes out not correct; a U-Net
configuration is refused by the flows entry before set-up; on the card,
the float8 control comes out not correct where a sound run is correct."""

import importlib.util
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.families import cellpose_sam as fam
from benchmark.harness import drivers
from benchmark.harness.common import BENCH, HBM_BYTES_PER_S, Cell
from conftest import cell, run_tiny

CELL = "cpsam-tiled2048"


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_published_forward_flops():
    """727,023,878,144 a 256^2 tile: the patch embedding 402,653,184; each
    of 24 blocks 30,198,988,800 (qkv 6,442,450,944, q k^T and attention x v
    2,147,483,648 each, rel_h and rel_w 67,108,864 each, proj
    2,147,483,648, MLP 17,179,869,184); the neck 536,870,912 +
    1,207,959,552; the readout 100,663,296.  A frame is 100 tiles."""
    assert fam.forward_flops(fam.PUBLISHED, 256, 256) == 727_023_878_144
    c = Cell(CELL)
    assert _metric("segment_mfu_pct").flops_per_frame(
        c.config, c.traffic) == 72_702_387_814_400


@pytest.mark.parametrize("over", [{}, dict(num_heads=2, img_size=48)])
def test_forward_flops_against_pytorchs_count(over):
    """A forward at the tiny size, two FLOPs a multiply-add: PyTorch's
    counter sees the linear layers (addmm), the convolutions and the
    relative term's einsums (bmm); it does not see the CPU's fused
    attention, whose two products (q k^T, attention x v) forward hooks on
    the attention modules count from the shapes they see.  Together they
    give the family's count.  The port's one other product (mm), which
    spreads rel_h + rel_w over the keys with a 0/1 matrix, adds and
    multiplies nothing of the model's and is left out."""
    from microbeseg_torch.config import CellposeSAMConfig
    from microbeseg_torch.models.vit_sam import Attention, build_cellpose_sam
    cfg = dict(fam.tiny(dict(fam.PUBLISHED)), **over)
    model = build_cellpose_sam(CellposeSAMConfig(**cfg)).eval()
    products = [0]

    def hook(mod, args, out):
        B, g, _, d = args[0].shape
        products[0] += 2 * 2 * B * (g * g) ** 2 * d

    for m in model.modules():
        if isinstance(m, Attention):
            m.register_forward_hook(hook)
    s = cfg["img_size"]
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(torch.zeros(2, 3, s, s))
    counted = fc.get_flop_counts()["Global"]
    aten = torch.ops.aten
    assert set(counted) == {aten.convolution, aten.addmm, aten.bmm, aten.mm}
    spread = 2 * 2 * cfg["num_heads"] * (s // 8) ** 2 * 2 * (s // 8) * \
        (s // 8) ** 2 * cfg["depth"]
    assert counted[aten.mm] == spread
    assert fc.get_total_flops() - spread + products[0] == \
        2 * fam.forward_flops(cfg, s, s)


def test_follow_flows_bounds_by_hand():
    m = _metric("follow_flows_roofline")
    px, pts = 2048 * 2048, 2_000_000
    assert m.least_s(px, pts, 200) == pytest.approx(pts * 200 * 44 / 67e12)
    assert m.least_s(px, 10, 1) == pytest.approx(
        (px * 8 + 10 * 16) / HBM_BYTES_PER_S)


def test_dropping_the_relative_term_is_not_correct(monkeypatch):
    from microbeseg_torch.models import vit_sam

    def no_bias(q, rel_pos_h, rel_pos_w, g):
        n = q.shape[2]
        return q.new_zeros(q.shape[0], q.shape[1], n, n)

    monkeypatch.setattr(vit_sam, "rel_pos_bias", no_bias)
    out = run_tiny(CELL)
    assert out["correct"] is False
    c = out["checks"]["field_err"]
    assert c["value"] > 2 * c["limit"]


@pytest.mark.parametrize("config,entry", [("dunet_relu_bn", "segment_flows"),
                                          ("cpsam_vitl8", "segment")])
def test_another_family_is_refused_before_set_up(config, entry):
    c = cell(CELL if entry == "segment_flows" else "dunet-tiled2048")
    other = [w for w in (cell("dunet-tiled2048"), cell(CELL))
             if w.workload["config"] == config][0]
    c.config = other.config
    with pytest.raises(ValueError, match="family"):
        drivers.load(entry)(c, 1, "cpu")


@pytest.mark.cuda
def test_fp8_control_is_not_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.harness.core import run
    c = cell(CELL)
    sound = run(c, 2147483802, 2.0, False, "cuda", time.perf_counter())
    assert sound["correct"] is True, sound["checks"]
    ctl = run(c, 2147483802, 2.0, False, "cuda", time.perf_counter(),
              control=True)
    assert ctl["correct"] is False
    f = ctl["checks"]["field_err"]
    assert f["value"] > 3 * f["limit"]
