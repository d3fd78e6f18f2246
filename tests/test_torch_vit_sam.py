"""Cellpose-SAM in the port (``microbeseg_torch/models/vit_sam.py``)
against the plain reference (``tests/cpsam_reference.py``) on the CPU at
the tiny size, float32, on seeded weights with non-zero relative-position
tables; the decomposed relative term's weight in the output; SDPA with
the built bias against an explicit softmax; the import of a state dict
under the published ``cpsam`` names; the published configuration's size.
"""

import re

import pytest
import torch
import torch.nn.functional as F

import cpsam_reference as ref
from microbeseg_torch.config import CellposeSAMConfig
from microbeseg_torch.models import torch_import
from microbeseg_torch.models.vit_sam import (build_cellpose_sam, rel_index,
                                             rel_pos_bias)

TINY = dict(embed_dim=64, depth=2, num_heads=4, mlp_dim=256, img_size=64)
# float32 on the CPU: the two forwards differ only in summation order and in
# the attention's formulation (SDPA against the explicit logits), some
# 1e-6 of the output's scale
TOL = 2e-5


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def seeded_state(cfg: CellposeSAMConfig, seed: int, rel_std: float = 0.5):
    """SAM's initialisation (linear layers normal with std 0.02) with
    LayerNorm affines, biases and positions drawn too, and relative-position
    tables normal with std ``rel_std``."""
    g = torch.Generator().manual_seed(seed)
    model = build_cellpose_sam(cfg)
    state = {}
    for name, t in model.state_dict().items():
        r = torch.randn(t.shape, generator=g)
        if "rel_pos" in name:
            r = r * rel_std
        elif "norm" in name or "neck.1" in name or "neck.3" in name:
            r = (1.0 + 0.1 * r) if name.endswith("weight") else 0.1 * r
        elif name.endswith("bias"):
            r = 0.02 * r
        elif name == "encoder.pos_embed":
            r = 0.02 * r
        else:
            r = r * 0.02 if r.ndim == 2 else r / (r[0].numel() ** 0.5)
        state[name] = r
    return state


def run_both(cfg, state, x):
    model = build_cellpose_sam(cfg).eval()
    model.load_state_dict(state)
    with torch.no_grad():
        got = model(x)
    want = ref.Net(cfg.__dict__)(state, x)
    return got, want


def rel_err(a, b):
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


@pytest.mark.parametrize("over,seed", [({}, 0), (dict(num_heads=2), 1),
                                       (dict(img_size=48, depth=3), 2)])
def test_forward_matches_reference(over, seed):
    cfg = CellposeSAMConfig(**dict(TINY, **over))
    state = seeded_state(cfg, seed)
    x = torch.randn(2, 3, cfg.img_size, cfg.img_size,
                    generator=torch.Generator().manual_seed(seed + 10))
    got, want = run_both(cfg, state, x)
    assert got.shape == want.shape == (2, 3, cfg.img_size, cfg.img_size)
    assert rel_err(got, want) < TOL


def test_the_relative_term_moves_the_output_far_beyond_the_tolerance():
    cfg = CellposeSAMConfig(**TINY)
    state = seeded_state(cfg, 3)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(4))
    got, _ = run_both(cfg, state, x)
    flat = {k: (torch.zeros_like(v) if "rel_pos" in k else v)
            for k, v in state.items()}
    without, _ = run_both(cfg, flat, x)
    assert rel_err(without, got) > 100 * TOL


def test_sdpa_with_the_bias_is_the_explicit_softmax():
    g = torch.Generator().manual_seed(5)
    B, heads, grid, c = 2, 3, 6, 16
    q, k, v = (torch.randn(B, heads, grid * grid, c, generator=g)
               for _ in range(3))
    rh, rw = (torch.randn(2 * grid - 1, c, generator=g) for _ in range(2))
    bias = rel_pos_bias(q, rh, rw, grid)
    # the decomposed term entry by entry: q . Rh[i - k] + q . Rw[j - l]
    i, j, kk, ll = 4, 1, 2, 5
    want = q[0, 1, i * grid + j] @ (rh[i - kk + grid - 1]
                                    + rw[j - ll + grid - 1])
    assert float(bias[0, 1, i * grid + j, kk * grid + ll]) == pytest.approx(
        float(want), rel=1e-5)
    logits = q @ k.transpose(-2, -1) / c ** 0.5 + bias
    explicit = logits.softmax(dim=-1) @ v
    sdpa = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    torch.testing.assert_close(sdpa, explicit, rtol=1e-5, atol=1e-6)
    assert tuple(rel_index(3)[0]) == (2, 1, 0)


def test_cpu_attention_is_the_bias_and_sdpa(monkeypatch):
    """On the CPU each block's attention is still rel_pos_bias (through
    that module name) and scaled_dot_product_attention, once a block, and
    the card's kernel is not launched."""
    from microbeseg_torch.kernels import _build
    from microbeseg_torch.models import vit_sam

    calls = {"bias": 0, "sdpa": 0}
    bias_fn, sdpa_fn = vit_sam.rel_pos_bias, F.scaled_dot_product_attention

    def bias(*args):
        calls["bias"] += 1
        return bias_fn(*args)

    def sdpa(*args, **kwargs):
        calls["sdpa"] += 1
        return sdpa_fn(*args, **kwargs)

    cfg = CellposeSAMConfig(**TINY)
    model = build_cellpose_sam(cfg).eval()
    model.load_state_dict(seeded_state(cfg, 6))
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        want = model(x)
        monkeypatch.setattr(vit_sam, "rel_pos_bias", bias)
        monkeypatch.setattr(F, "scaled_dot_product_attention", sdpa)
        before = _build.LAUNCHES["rel_attention"]
        got = model(x)
    assert calls == {"bias": cfg.depth, "sdpa": cfg.depth}
    assert _build.LAUNCHES["rel_attention"] == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("heads,hd,grid", [(4, 16, 8), (2, 64, 6),
                                           (2, 64, 12), (3, 16, 1)])
def test_rel_attention_plain_is_the_blocks_attention(heads, hd, grid):
    """The kernel's plain version (``ops/kernels/rel_attention.py``), from
    the qkv projection's own layout, against the block's CPU route (bias,
    SDPA, heads merged) before ``proj``, float32."""
    from microbeseg_torch.models.vit_sam import Attention
    from microbeseg_torch.ops.kernels.rel_attention import rel_attention_plain

    cfg = CellposeSAMConfig(embed_dim=heads * hd, num_heads=heads,
                            img_size=8 * grid, depth=1, mlp_dim=64)
    attn = Attention(cfg)
    gen = torch.Generator().manual_seed(heads * hd + grid)
    with torch.no_grad():
        for t in (attn.rel_pos_h, attn.rel_pos_w):
            t.copy_(0.5 * torch.randn(t.shape, generator=gen))
        attn.proj.weight.copy_(torch.eye(heads * hd))
        attn.proj.bias.zero_()
        x = torch.randn(2, grid, grid, heads * hd, generator=gen)
        want = attn(x).reshape(2, grid * grid, heads * hd)
        qkv = attn.qkv(x).reshape(2, grid * grid, 3 * heads * hd)
        got = rel_attention_plain(qkv, attn.rel_pos_h, attn.rel_pos_w,
                                  heads, grid)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_rel_attention_takes_cuda_tensors_only():
    """The wrapper runs the kernel alone: a CPU tensor is refused, since
    the block's CPU route is its own (bias, then SDPA)."""
    from microbeseg_torch.ops.kernels.rel_attention import rel_attention

    qkv = torch.zeros(1, 64, 3 * 2 * 64, dtype=torch.bfloat16)
    tab = torch.zeros(15, 64)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        rel_attention(qkv, tab, tab, 2, 8)


REFUSALS = [("ok", None), ("head_width", "head width 32"),
            ("grid", "1 to 64"), ("float32", "bfloat16"),
            ("strided", "contiguous"), ("tables", r"\(15, 64\) float32"),
            ("grad", "no backward"), ("shape", r"must be \(B, 64")]


@pytest.mark.parametrize("case,match", REFUSALS,
                         ids=[c for c, _ in REFUSALS])
def test_rel_attention_refusal(case, match):
    """What the kernel does not take, named (``refusal`` reads shapes,
    types, strides and autograd only, so it runs on CPU tensors)."""
    from microbeseg_torch.ops.kernels.rel_attention import refusal

    heads, grid, hd = 2, 8, 64
    if case == "head_width":
        hd = 32
    if case == "grid":
        grid = 65
    qkv = torch.zeros(1, grid * grid, 3 * heads * hd, dtype=torch.bfloat16)
    th = torch.zeros(2 * grid - 1, hd)
    tw = torch.zeros(2 * grid - 1, hd)
    if case == "float32":
        qkv = qkv.float()
    if case == "strided":
        qkv = torch.nn.functional.pad(qkv, (0, 8))[..., :-8]
    if case == "tables":
        tw = torch.zeros(2 * grid - 1, hd, dtype=torch.float64)
    if case == "grad":
        th.requires_grad_(True)
    if case == "shape":
        qkv = qkv[:, :-1]
    why = refusal(qkv, th, tw, heads, grid)
    if match is None:
        assert why is None
    else:
        assert why is not None and re.search(match, why), why


def published_dict(cfg, state, rows):
    """The port's state under the published file's layout: relative tables
    of ``rows[i % len(rows)]`` rows (SAM's sizes before Cellpose's
    interpolation), ``W2``, a DataParallel prefix."""
    sd = {}
    for name, t in state.items():
        if "rel_pos" in name:
            i = int(name.split(".")[2])
            n = rows[i % len(rows)]
            t = torch.randn(n, t.shape[1],
                            generator=torch.Generator().manual_seed(i))
        sd["module." + name] = t
    n, p = cfg.nout, cfg.patch_size
    sd["module.W2"] = torch.eye(n * p * p).reshape(n * p * p, n, p, p)
    return sd


def test_import_by_published_names_interpolates_the_tables(tmp_path):
    cfg = CellposeSAMConfig(**TINY)
    sd = published_dict(cfg, seeded_state(cfg, 6), rows=(27, 127))
    path = tmp_path / "cpsam"
    torch.save(sd, path)
    model = torch_import.load_cellpose_sam(path, cfg, device="cpu")
    got = model.state_dict()
    rows = 2 * cfg.grid - 1
    for i in range(cfg.depth):
        src = sd[f"module.encoder.blocks.{i}.attn.rel_pos_h"]
        # SAM's get_rel_pos, written out
        want = F.interpolate(src.reshape(1, src.shape[0], -1).permute(0, 2, 1),
                             size=rows, mode="linear").reshape(-1, rows).T
        torch.testing.assert_close(got[f"encoder.blocks.{i}.attn.rel_pos_h"],
                                   want)
    torch.testing.assert_close(got["out.weight"], sd["module.out.weight"])
    assert "W2" not in got


@pytest.mark.parametrize("key,shape", [
    ("encoder.pos_embed", (1, 16, 16, 64)),
    ("encoder.patch_embed.proj.weight", (64, 3, 16, 16)),
    ("W2", (192, 3, 8, 8)),
    ("encoder.blocks.0.mlp.lin1.weight", (128, 64))])
def test_import_refuses_another_size(key, shape):
    cfg = CellposeSAMConfig(**TINY)
    sd = published_dict(cfg, seeded_state(cfg, 7), rows=(15,))
    sd = {k[len("module."):]: v for k, v in sd.items()}
    sd[key] = torch.zeros(shape)
    with pytest.raises((ValueError, RuntimeError)):
        torch_import.cellpose_sam_from_state_dict(sd, cfg)


def test_the_published_configuration():
    """Some 305M parameters; tokens of 8 px, 1024 of them a 256^2 tile."""
    cfg = CellposeSAMConfig()
    with torch.device("meta"):
        model = build_cellpose_sam(cfg)
    n = sum(p.numel() for p in model.parameters())
    assert 300e6 < n < 310e6
    assert cfg.grid ** 2 == 1024
    assert model.encoder.blocks[0].attn.rel_pos_h.shape == (63, 64)


def _norm_and_stream(d, seed, shape=(2, 5, 7)):
    """A LayerNorm over ``d`` with drawn affine parameters (eps 1e-6), a
    float32 stream and a bf16 branch of ``shape + (d,)``."""
    from microbeseg_torch.models.vit_sam import LN_EPS

    gen = torch.Generator().manual_seed(seed)
    norm = torch.nn.LayerNorm(d, eps=LN_EPS)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.3 * torch.randn(d, generator=gen))
        norm.bias.copy_(0.2 * torch.randn(d, generator=gen))
    x = 1.5 + 2 * torch.randn(shape + (d,), generator=gen)
    h = torch.randn(shape + (d,), generator=gen).to(torch.bfloat16)
    return norm, x, h


@pytest.mark.parametrize("with_h", [True, False], ids=["branch", "stream"])
def test_add_layernorm_plain_is_the_module_chain(with_h):
    """The kernel's plain version against the module chain it replaces:
    ``x + h`` (float32, one rounding), the LayerNorm in float32, and the
    bf16 cast that autocast applies at the next linear layer (an identity
    ``nn.Linear`` under bf16 autocast, exact on bf16 values), bit for bit;
    the stream updated in place."""
    from microbeseg_torch.ops.kernels.add_layernorm import add_layernorm_plain

    d = 64
    norm, x, h = _norm_and_stream(d, 11)
    h = h if with_h else None
    eye = torch.nn.Linear(d, d, bias=False)
    with torch.no_grad():
        eye.weight.copy_(torch.eye(d))
    with torch.no_grad(), torch.autocast("cpu", torch.bfloat16):
        stream = x + h if with_h else x.clone()
        rows = norm(stream)
        assert rows.dtype == torch.float32
        want = eye(rows)
        got_x = x.clone()
        got = add_layernorm_plain(got_x, h, norm)
        assert got.dtype == want.dtype == torch.bfloat16
        assert torch.equal(eye(got), want)
    assert torch.equal(got, want)
    assert torch.equal(got_x, stream)
    if with_h:
        assert torch.equal(got_x, x + h.float())


@pytest.mark.parametrize("step,autocast", [("plain", True),
                                           ("modules", False)])
def test_card_route_block_order_is_the_forward(step, autocast):
    """The card's chain of add-norms (``run_blocks``: block 0's norm1 on
    the stream alone, attention into norm2, MLP into the next norm1, the
    last MLP a plain add) with the kernel's plain version under bf16
    autocast, and with the modules in float32, gives
    ``CellposeSAM.forward``'s output (the CPU route, each block's
    ``forward``) bit for bit, in 2 * depth steps."""
    from microbeseg_torch.models import vit_sam
    from microbeseg_torch.ops.kernels.add_layernorm import add_layernorm_plain

    cfg = CellposeSAMConfig(**dict(TINY, depth=3))
    model = build_cellpose_sam(cfg).eval()
    model.load_state_dict(seeded_state(cfg, 12))
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(13))
    calls = []

    def plain(x, h, norm):
        calls.append(norm)
        return add_layernorm_plain(x, h, norm)

    def modules(x, h, norm):
        calls.append(norm)
        if h is not None:
            x.add_(h)
        return norm(x)

    enc = model.encoder
    with torch.no_grad(), torch.autocast("cpu", torch.bfloat16,
                                         enabled=autocast):
        want = model(x)
        t = enc.patch_embed(x) + enc.pos_embed
        t = vit_sam.run_blocks(enc.blocks, t.contiguous(),
                               plain if step == "plain" else modules)
        got = F.pixel_shuffle(model.out(enc.neck(t.permute(0, 3, 1, 2))),
                              cfg.patch_size)
    assert torch.equal(got, want)
    assert calls == [n for b in enc.blocks for n in (b.norm1, b.norm2)]


def test_add_layernorm_takes_cuda_tensors_only():
    """The wrapper runs the kernel alone: CPU tensors are refused, since
    the CPU runs each block's ``forward``."""
    from microbeseg_torch.ops.kernels.add_layernorm import add_layernorm

    norm, x, h = _norm_and_stream(64, 14)
    with torch.no_grad(), torch.autocast("cpu", torch.bfloat16):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            add_layernorm(x, h, norm)


ADD_LN_REFUSALS = [
    ("ok", None), ("ok_stream_alone", None),
    ("dim_not_8", "multiple of 8"), ("dim_beyond_registers", "up to 1024"),
    ("float64_stream", "x must be float32"),
    ("strided_stream", "x must be float32, contiguous"),
    ("float32_branch", "h must be bfloat16"),
    ("branch_shape", "h must be bfloat16 of x's shape"),
    ("no_affine", "affine weight and bias"),
    ("float64_norm", "weight and bias must be float32"),
    ("grad", "no backward"), ("autocast_off", "autocast off"),
    ("autocast_float16", "autocast off")]


@pytest.mark.parametrize("case,match", ADD_LN_REFUSALS,
                         ids=[c for c, _ in ADD_LN_REFUSALS])
def test_add_layernorm_refusal(case, match):
    """What the kernel does not take, named (``refusal`` reads shapes,
    types, strides, autograd and autocast only, so it runs on CPU
    tensors); ``add_layernorm`` raises on it."""
    from microbeseg_torch.ops.kernels.add_layernorm import refusal

    d = {"dim_not_8": 60, "dim_beyond_registers": 1032}.get(case, 64)
    norm, x, h = _norm_and_stream(d, 15, shape=(3, 4))
    if case == "ok_stream_alone":
        h = None
    if case == "float64_stream":
        x = x.double()
    if case == "strided_stream":
        x = F.pad(x, (0, 8))[..., :-8]
    if case == "float32_branch":
        h = h.float()
    if case == "branch_shape":
        h = h[:, :-1]
    if case == "no_affine":
        norm = torch.nn.LayerNorm(d, elementwise_affine=False)
    if case == "float64_norm":
        norm = norm.double()
    if case == "grad":
        x.requires_grad_(True)
    dtype = torch.float16 if case == "autocast_float16" else torch.bfloat16
    with torch.set_grad_enabled(case == "grad"), torch.autocast(
            "cpu", dtype, enabled=case != "autocast_off"):
        why = refusal(x, h, norm)
    if match is None:
        assert why is None
    else:
        assert why is not None and re.search(match, why), why
