"""muSAM's automatic instance segmentation in the port
(``microbeseg_torch/models/unetr.py``, the windowed ``models/vit_sam.py``,
``label_type="ais"``) against the plain reference (``tests/usam_reference.py``)
on the CPU at the tiny size, float32, on seeded weights with non-zero
relative-position tables: the network's fields, the windowed block's
padding, each block's relative tables, the post-processing's masks, the
engine's path end to end, its refusals, spans and counters, and the
published configuration's size.
"""

import dataclasses

import numpy as np
import pytest
import torch

import usam_reference as ref
from microbeseg_torch.config import InferConfig, MicroSAMConfig
from microbeseg_torch.inference.engine import InferenceEngine
from microbeseg_torch.inference.label_types import normalize_to_255
from microbeseg_torch.models import vit_sam
from microbeseg_torch.models.unetr import InstanceNorm, build_micro_sam_ais
from microbeseg_torch.ops.postprocessing import ais_postprocessing
from microbeseg_torch.utils import profiling

# four blocks (1 and 3 global) on an 8 x 8 grid that windows of 3 pad to
# 9 x 9, the decoder 32 -> 8
TINY = dict(embed_dim=64, depth=4, num_heads=4, mlp_dim=256, img_size=128,
            window_size=3, global_attn_indexes=(1, 3), neck_dim=32,
            decoder_features=(32, 16, 8, 8))
# float32 on the CPU: the two forwards differ in summation order, in the
# attention's formulation (SDPA on the built bias against explicit logits)
# and in the norms' (PyTorch's instance and batch norm against written-out
# means and variances), some 1e-6 of the fields' scale
TOL = 2e-5
INFER = dict(use_tiling=True, tile_size=128, tile_overlap=32, min_size=0)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def seeded_state(cfg: MicroSAMConfig, seed: int, rel_std: float = 0.5):
    """SAM's initialisation for the encoder (linear layers normal with std
    0.02), He-normal convolutions, every norm's affine parameters, the
    BatchNorms' running statistics, biases and positions drawn too, and
    relative-position tables normal with std ``rel_std``."""
    g = torch.Generator().manual_seed(seed)
    model = build_micro_sam_ais(cfg)
    state = {}
    for name, t in model.state_dict().items():
        if t.dtype == torch.int64:
            state[name] = t
            continue
        r = torch.randn(t.shape, generator=g)
        if "rel_pos" in name:
            r = r * rel_std
        elif name.endswith("running_var"):
            r = 1.0 + 0.2 * r.abs()
        elif name.endswith("running_mean"):
            r = 0.1 * r
        elif "norm" in name or "neck.1" in name or "neck.3" in name \
                or ".block.2." in name:
            r = (1.0 + 0.1 * r) if name.endswith("weight") else 0.1 * r
        elif name.endswith("bias") or name.endswith("pos_embed"):
            r = 0.02 * r
        elif r.ndim == 2:
            r = r * 0.02
        else:
            fan_in = r.shape[0] if "deconv" in name and ".block.0." in name \
                or "samplers" in name or "deconv_out" in name \
                else r[0].numel()
            r = r * (2.0 / fan_in) ** 0.5
        state[name] = r
    return state


def tiny_model(seed=0, **over):
    cfg = MicroSAMConfig(**dict(TINY, **over))
    state = seeded_state(cfg, seed)
    model = build_micro_sam_ais(cfg).eval()
    model.load_state_dict(state)
    return model, cfg, state


def cell_model():
    """The benchmark family's tiny network with its seeded weights, whose
    fields follow a frame's cells."""
    from benchmark.families import micro_sam as fam
    cfg = fam.model_config(fam.tiny(dict(fam.PUBLISHED)))
    state = fam.make_weights(cfg, 12, "cpu")
    model = build_micro_sam_ais(MicroSAMConfig(**cfg)).eval()
    model.load_state_dict(state)
    return model, MicroSAMConfig(**cfg), state


def ref_cfg(cfg):
    return dataclasses.asdict(cfg)


def rel_err(a, b):
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


def seeded_frames(n, size, seed, cells=12):
    """Bright disks of radius 4-8 on a noisy background, uint16."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    out = np.empty((n, size, size), np.uint16)
    for i in range(n):
        img = 2500 + 900 * rng.standard_normal((size, size))
        for _ in range(cells):
            cy, cx = rng.integers(8, size - 8, 2)
            r = rng.uniform(4, 8)
            img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] += 28000
        out[i] = np.clip(np.round(img), 0, 65535)
    return out


@pytest.mark.parametrize("over,seed", [({}, 0), (dict(num_heads=2), 1),
                                       (dict(window_size=5), 2),
                                       (dict(window_size=0,
                                             global_attn_indexes=()), 3)])
def test_forward_matches_reference(over, seed):
    model, cfg, state = tiny_model(seed, **over)
    x = torch.randn(2, 3, 128, 128,
                    generator=torch.Generator().manual_seed(seed + 10))
    with torch.no_grad():
        got = model(x)
    want = ref.Net(ref_cfg(cfg))(state, x)
    assert got.shape == want.shape == (2, 3, 128, 128)
    for c in range(3):
        assert rel_err(got[:, c], want[:, c]) < TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_instance_norm_keeps_the_layout_and_matches_pytorchs(dtype):
    """The decoder's instance norm on a channels-last input whose mean lies
    well off 0 (as the carried channel's does): the layout kept, float32
    within float32's rounding of ``nn.InstanceNorm2d``, bf16 within one
    bf16 step of it on the same (rounded) input."""
    g = torch.Generator().manual_seed(4)
    x = (4 + 2 * torch.randn(2, 6, 40, 24, generator=g)).to(dtype).to(
        memory_format=torch.channels_last)
    want = torch.nn.InstanceNorm2d(6)(x.float())
    with torch.inference_mode():
        got = InstanceNorm()(x)
    assert got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    err = (got.float() - want).abs()
    if dtype == torch.float32:
        assert float(err.max()) < 1e-5
    else:
        assert bool((err <= want.abs() * 2.0 ** -8 + 2.0 ** -12).all())


def test_the_relative_term_and_the_windows_move_the_fields():
    """Without the tables, or with every block global, the fields move far
    beyond the tolerance: both are held by the comparison above."""
    model, cfg, state = tiny_model(4)
    x = torch.randn(2, 3, 128, 128, generator=torch.Generator().manual_seed(5))
    want = ref.Net(ref_cfg(cfg))(state, x)
    flat = {k: (torch.zeros_like(v) if "rel_pos" in k else v)
            for k, v in state.items()}
    assert rel_err(ref.Net(ref_cfg(cfg))(flat, x), want) > 100 * TOL
    rows = {k: v for k, v in state.items() if "rel_pos" not in k}
    glob = dataclasses.replace(cfg, window_size=0, global_attn_indexes=())
    g_model = build_micro_sam_ais(glob).eval()
    g_state = dict(rows, **{k: v for k, v in g_model.state_dict().items()
                            if "rel_pos" in k})
    assert rel_err(ref.Net(ref_cfg(glob))(g_state, x), want) > 100 * TOL


def _masked_window_attention(attn, h, ws):
    """The windowed attention with the padded tokens masked out as keys:
    what SAM does not do."""
    B, g, _, d = h.shape
    n = -(-g // ws)
    w = vit_sam.window_partition(h, ws)
    qkv = attn.qkv(w).reshape(w.shape[0], ws * ws, 3, attn.heads, -1)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    bias = vit_sam.rel_pos_bias(q, attn.rel_pos_h, attn.rel_pos_w, ws)
    pos = torch.arange(n * ws)
    real = (pos < g)
    keep = torch.ones(B, n, n, ws, ws, dtype=torch.bool)
    keep &= real.view(n, ws)[None, :, None, :, None]     # (window, row)
    keep &= real.view(n, ws)[None, None, :, None, :]     # (window, column)
    keep = keep.reshape(B * n * n, 1, 1, ws * ws)
    logits = q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5 + bias
    logits = logits.masked_fill(~keep, float("-inf"))
    out = (logits.softmax(-1) @ v).transpose(1, 2).reshape(*w.shape)
    return vit_sam.window_unpartition(attn.proj(out), g)


def test_windowed_block_pads_with_zeros_and_masks_nothing():
    """A windowed block on the 8 x 8 grid that windows of 3 pad to 9 x 9:
    the pad and cut, qkv, the attention and proj on all 81 tokens, the
    windows put back and cropped equal the reference's block; masking the
    padded keys gives another answer."""
    model, cfg, state = tiny_model(6)
    blk = model.image_encoder.blocks[0]
    assert blk.window == 3
    h = torch.randn(2, 8, 8, 64, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        got = blk.attend(h)
        masked = _masked_window_attention(blk.attn, h, 3)
    want = ref.Net(ref_cfg(cfg)).windowed(
        state, "image_encoder.blocks.0.attn.", h, 3)
    assert got.shape == (2, 8, 8, 64) and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert rel_err(masked, want) > 100 * TOL
    w = vit_sam.window_partition(h, 3)
    assert w.shape == (2 * 9, 3, 3, 64)
    assert torch.equal(w[8, 2], torch.zeros(3, 64))       # row 8: padding
    assert torch.equal(vit_sam.window_unpartition(w, 8), h)


def test_each_blocks_relative_tables_fit_its_own_grid():
    """2g - 1 rows of the block's grid: the window in a windowed block,
    the token grid in a global one (Cellpose-SAM: every block global)."""
    model, cfg, _ = tiny_model()
    rows = [blk.attn.rel_pos_h.shape[0] for blk in model.image_encoder.blocks]
    assert rows == [5, 15, 5, 15]
    with torch.device("meta"):
        full = build_micro_sam_ais(MicroSAMConfig())
    rows = {blk.attn.rel_pos_w.shape for blk in full.image_encoder.blocks}
    assert rows == {(27, 64), (127, 64)}
    assert [i for i, b in enumerate(full.image_encoder.blocks)
            if b.window == 0] == [5, 11, 17, 23]
    cp = vit_sam.build_cellpose_sam(vit_sam.CellposeSAMConfig(
        embed_dim=64, depth=2, num_heads=4, mlp_dim=256, img_size=64))
    assert [b.attn.rel_pos_h.shape[0] for b in cp.encoder.blocks] == [15, 15]


def test_the_published_configuration():
    """Some 316M parameters (the encoder 308M, the decoder 7.9M) under
    SAM's and torch_em's names; 4,096 tokens a 1024^2 tile."""
    cfg = MicroSAMConfig()
    with torch.device("meta"):
        model = build_micro_sam_ais(cfg)
    n = sum(p.numel() for p in model.parameters())
    enc = sum(p.numel() for p in model.image_encoder.parameters())
    assert 314e6 < n < 318e6 and 307e6 < enc < 310e6
    assert cfg.grid ** 2 == 4096
    names = set(model.state_dict())
    for name in ("image_encoder.pos_embed",
                 "image_encoder.blocks.5.attn.rel_pos_h",
                 "image_encoder.neck.2.weight", "deconv1.block.0.block.weight",
                 "deconv4.block.2.running_var", "base.block.4.weight",
                 "decoder.samplers.2.block.weight",
                 "decoder.blocks.0.block.1.weight", "deconv_out.block.bias",
                 "decoder_head.block.1.weight", "out_conv.weight"):
        assert name in names
    assert model.decoder.blocks[0].block[1].in_channels == 512
    assert model.decoder_head.block[1].in_channels == 128


def _fields(seed, B, H, W):
    """Smooth (B, H, W, 3) fields: foreground high on disks, both
    distances low at their centres."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    d = np.full((B, H, W), 9.0)
    for b in range(B):
        for _ in range(10):
            cy, cx = rng.integers(4, H - 4), rng.integers(4, W - 4)
            r = rng.uniform(4, 9)
            d[b] = np.minimum(d[b], np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
                              / r)
    fg = 1 / (1 + np.exp(6 * (d - 1)))
    f = np.stack([fg, np.clip(d, 0, 1), np.clip(d * 1.1, 0, 1)], -1)
    f += rng.normal(0, 0.03, f.shape)
    return torch.from_numpy(f.astype(np.float32))


@pytest.mark.parametrize("min_size", [0, 40])
def test_postprocessing_matches_reference(min_size):
    f = _fields(min_size, 2, 96, 80)
    cfg = InferConfig(**dict(INFER, min_size=min_size))
    got = ais_postprocessing(f, cfg).to(torch.int32).numpy()
    want = ref.ais_masks(f.permute(0, 3, 1, 2), dataclasses.asdict(cfg))
    assert got.max() >= 5
    np.testing.assert_array_equal(got, want.astype(np.int32))


def test_normalisation_is_micro_sams():
    x = torch.tensor([[[100.0, 350.0], [1100.0, 100.0]]])
    torch.testing.assert_close(normalize_to_255(x),
                               torch.tensor([[[0.0, 63.0], [255.0, 0.0]]]))
    assert torch.equal(normalize_to_255(x), ref.to_image(x))
    assert torch.equal(normalize_to_255(torch.full((1, 3, 3), 7.0)),
                       torch.zeros(1, 3, 3))


def test_engine_ais_path_is_the_reference_pipeline():
    """Frames through ``InferenceEngine.segment``: its stitched fields
    against the reference's within the tolerance, its masks equal to the
    reference's post-processing of the engine's own fields and, end to
    end, of the reference's fields; a frame smaller than a tile is padded
    with 0 after SAM's standardisation."""
    model, cfg, state = cell_model()
    frames = seeded_frames(2, 200, 9)
    engine = InferenceEngine(model, "ais", cfg=InferConfig(**INFER),
                             device="cpu")
    got = engine.segment(frames)
    assert got.dtype == np.uint16 and got.shape == frames.shape
    seg = ref.Segmenter(ref_cfg(cfg), state,
                        dataclasses.asdict(InferConfig(**INFER)))
    want_f = seg.fields_of(frames, "cpu")
    fields = torch.from_numpy(engine.predict_raw(frames)[0]).permute(
        0, 3, 1, 2)
    for c in range(3):
        assert rel_err(fields[:, c], want_f[:, c]) < TOL
    np.testing.assert_array_equal(got, np.stack(seg.masks(fields)))
    np.testing.assert_array_equal(got, np.stack(seg.masks(want_f)))
    assert min(m.max() for m in got) >= 3
    small = frames[:1, :90, :70]
    f_small = torch.from_numpy(engine.predict_raw(small)[0]).permute(0, 3, 1,
                                                                     2)
    assert rel_err(f_small, seg.fields_of(small, "cpu")) < TOL


def test_engine_ais_spans_and_counters():
    from torch.profiler import ProfilerActivity, profile
    model, _, _ = cell_model()
    engine = InferenceEngine(model, "ais", cfg=InferConfig(**INFER),
                             device="cpu")
    frames = seeded_frames(1, 200, 11)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        masks = engine.segment(frames)
    s = profiling.summary()
    profiling.reset()
    # 4 tiles in one forward: 2 windowed blocks (a span before and after
    # the attention), 4 blocks' attention, one decoder
    assert s["spans"]["mseg.vit.window"]["count"] == 4
    assert s["spans"]["mseg.vit.attention"]["count"] == 4
    assert s["spans"]["mseg.unetr.decoder"]["count"] == 1
    for name in ("smooth", "seeds", "flood"):
        assert s["spans"][f"mseg.segment.ais.{name}"]["count"] == 1
    assert int(masks.max()) >= 1
    assert "attention_maps.g3" not in s["counters"]   # the card's kernel


@pytest.mark.parametrize("over", [dict(tta=True), dict(quantize=True),
                                  dict(scale_factor=0.5),
                                  dict(tile_size=256)])
def test_engine_refuses_what_the_ais_path_does_not_run(over):
    model, _, _ = tiny_model()
    with pytest.raises(ValueError, match="label_type 'ais'"):
        InferenceEngine(model, "ais", cfg=InferConfig(**dict(INFER, **over)),
                        device="cpu")


def test_ais_needs_a_micro_sam_model():
    cp = vit_sam.build_cellpose_sam(vit_sam.CellposeSAMConfig(
        embed_dim=64, depth=2, num_heads=4, mlp_dim=256, img_size=128))
    with pytest.raises(ValueError, match="muSAM"):
        InferenceEngine(cp, "ais", cfg=InferConfig(**INFER), device="cpu")
