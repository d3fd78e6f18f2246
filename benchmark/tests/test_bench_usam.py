"""The muSAM cell: its family's FLOP count, pinned and held against
PyTorch's own count of a forward; the tiny cell runs on the CPU and comes
out correct; a fault that drops the relative-position term, and faults in
the decoder's own path, come out not correct; another family is refused by the ais entry before set-up; the
mixed-grid roofline's least time by hand and its reader silent without
the counts by grid; the reference and the family load nothing of the
port; on the card, the float8 control comes out not correct
where a sound run is correct."""

import importlib.util
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.families import micro_sam as fam
from benchmark.harness import drivers
from benchmark.harness.common import BENCH, HBM_BYTES_PER_S, Cell
from conftest import cell, run_tiny

CELL = "usam-vitl-tiled2048"


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_published_forward_flops():
    """3,597,042,057,216 a 1024^2 tile: the patch embedding 6,442,450,944;
    each of 20 windowed blocks 114,038,439,936 (qkv and proj on 4,900
    padded tokens 30,828,134,400 and 10,276,044,800, q k^T and attention
    x v over 25 windows of 196 tokens 3,933,798,400, the relative products
    280,985,600, the MLP on 4,096 tokens 68,719,476,736); each of 4 global
    blocks 172,872,433,664 (qkv 25,769,803,776, proj 8,589,934,592, q k^T
    and attention x v 68,719,476,736, relative products 1,073,741,824, MLP
    68,719,476,736); the neck 6,979,321,856; the decoder 611,361,751,040.
    A frame is 9 tiles."""
    window = (30_828_134_400 + 10_276_044_800 + 3_933_798_400
              + 280_985_600 + 68_719_476_736)
    glob = (25_769_803_776 + 8_589_934_592 + 68_719_476_736
            + 1_073_741_824 + 68_719_476_736)
    assert window == 114_038_439_936 and glob == 172_872_433_664
    assert 6_442_450_944 + 20 * window + 4 * glob + 6_979_321_856 \
        + 611_361_751_040 == 3_597_042_057_216
    assert fam.forward_flops(fam.PUBLISHED, 1024, 1024) == 3_597_042_057_216
    c = Cell(CELL)
    assert _metric("segment_mfu_pct").flops_per_frame(
        c.config, c.traffic) == 9 * 3_597_042_057_216


def test_forward_flops_against_pytorchs_count():
    """A forward at the tiny size, two FLOPs a multiply-add: PyTorch's
    counter sees the linear layers (addmm), the convolutions and
    transposed convolutions and the relative term's einsums (bmm); forward
    hooks on the attention modules count the CPU's fused attention's two
    products from the shapes they see.  The port's one other product (mm),
    which spreads rel_h + rel_w over the keys with a 0/1 matrix, is left
    out."""
    from microbeseg_torch.config import MicroSAMConfig
    from microbeseg_torch.models.unetr import build_micro_sam_ais
    from microbeseg_torch.models.vit_sam import Attention
    cfg = fam.model_config(fam.tiny(dict(fam.PUBLISHED)))
    model = build_micro_sam_ais(MicroSAMConfig(**cfg)).eval()
    products, spread = [0], [0]

    def hook(mod, args, out):
        B, g, _, d = args[0].shape
        n = g * g
        products[0] += 2 * 2 * B * n * n * d
        spread[0] += 2 * B * mod.heads * n * 2 * g * n

    for m in model.modules():
        if isinstance(m, Attention):
            m.register_forward_hook(hook)
    s = cfg["img_size"]
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(torch.zeros(2, 3, s, s))
    counted = fc.get_flop_counts()["Global"]
    aten = torch.ops.aten
    assert set(counted) == {aten.convolution, aten.addmm, aten.bmm, aten.mm}
    assert counted[aten.mm] == spread[0]
    assert fc.get_total_flops() - spread[0] + products[0] == \
        2 * fam.forward_flops(cfg, s, s)


def test_the_tiny_cell_runs_and_is_correct():
    out = run_tiny(CELL)
    assert out["correct"] is True, out["checks"]
    assert out["checks"]["post_mismatch"]["value"] == 0.0
    assert min(out["readings"]["masks_found"]) >= 3
    assert set(out["metrics"]) == {"segment_mpx_per_s", "setup_s"}


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


@pytest.mark.parametrize("fault", ["decoder_no_norm", "sampler_zeroed"])
def test_a_fault_in_the_decoders_own_path_is_not_correct(monkeypatch, fault):
    """The decoder's levels reach the fields (the seeded weights mix them
    in at ``PATH_MIX`` and ``HEAD_MIX``): its third level without its
    second instance norm, or its second sampler giving zeros, fails the
    tiny cell's ``field_err``."""
    from microbeseg_torch.models import unetr

    init = unetr.MicroSAMAIS.__init__

    def planted(self, *args, **kwargs):
        init(self, *args, **kwargs)
        if fault == "decoder_no_norm":
            self.decoder.blocks[2].block[3] = torch.nn.Identity()
        else:
            self.decoder.samplers[1].register_forward_hook(
                lambda mod, a, out: torch.zeros_like(out))

    monkeypatch.setattr(unetr.MicroSAMAIS, "__init__", planted)
    out = run_tiny(CELL)
    assert out["correct"] is False
    c = out["checks"]["field_err"]
    assert c["value"] > 2 * c["limit"]


@pytest.mark.parametrize("config,entry", [("cpsam_vitl8", "segment_ais"),
                                          ("usam_vitl16_ais",
                                           "segment_flows")])
def test_another_family_is_refused_before_set_up(config, entry):
    c = cell(CELL if entry == "segment_ais" else "cpsam-tiled2048")
    other = [w for w in (cell("cpsam-tiled2048"), cell(CELL))
             if w.workload["config"] == config][0]
    c.config = other.config
    with pytest.raises(ValueError, match="family"):
        drivers.load(entry)(c, 1, "cpu")


def test_mixed_grid_bounds_by_hand():
    """A forward of 8 tiles: 20 windowed blocks of 8 x 25 x 16 maps of 196
    tokens, which q, k, v and the output bound (8 N hd bytes a map over
    3.35 TB/s: 100,352 bytes, 3.0e-11 s, against 9,834,496 operations,
    9.9e-12 s), and 4 global blocks of 8 x 16 maps of 4,096, which the
    products bound (4 N^2 hd operations a map over 989 TFLOP/s)."""
    m = _metric("rel_attention_roofline.mixed_grids")
    maps = {14: 20 * 8 * 25 * 16, 64: 4 * 8 * 16}
    want = maps[14] * 8 * 196 * 64 / HBM_BYTES_PER_S \
        + maps[64] * 4 * 4096 ** 2 * 64 / 989e12
    assert m.least_s(maps, 64) == pytest.approx(want)
    assert m.least_s({1: 10}, 64) == pytest.approx(
        10 * 8 * 64 / HBM_BYTES_PER_S)


@pytest.mark.parametrize("counters", [{}, {"attention_maps": 256}])
def test_mixed_grid_reader_is_silent_without_counts_by_grid(monkeypatch,
                                                            counters):
    """A trace of the kernel without the port's counts by grid (the
    parent's program), or no trace at all, gives no value."""
    from benchmark.harness import spans
    m = _metric("rel_attention_roofline.mixed_grids")
    monkeypatch.setattr(m, "recorded", lambda: {"spans": {},
                                                "counters": counters})

    class Trace:
        kernel_s = {"void rel_attention_kernel<64, 0>(...)": 1e-3}
        kernel_n = {"void rel_attention_kernel<64, 0>(...)": 24}

    ctx = {"trace": Trace(), "cell": Cell(CELL)}
    assert m.read({"trace": None}) is None
    assert m.read(ctx) is None
    monkeypatch.setattr(m, "recorded", lambda: {"spans": {}, "counters": {
        "attention_maps.g14": 64000, "attention_maps.g64": 512}})
    assert m.read(ctx) == pytest.approx(
        100 * m.least_s({14: 64000, 64: 512}, 64) / 1e-3)
    assert spans.recorded() is not None


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


def test_the_reference_loads_nothing_of_the_port():
    import os
    import subprocess
    import sys

    from benchmark.harness.common import FORBIDDEN, ROOT
    res = subprocess.run(
        [sys.executable, "-c",
         "import benchmark.reference.micro_sam, benchmark.reference.ais\n"
         "import benchmark.families.micro_sam, sys\n"
         "print('\\n'.join(sorted(sys.modules)))"],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stderr[-2000:]
    top = {m.split(".")[0] for m in res.stdout.split()}
    assert not top & set(FORBIDDEN + ("microbeseg_torch",))
