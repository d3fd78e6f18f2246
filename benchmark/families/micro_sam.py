"""muSAM's automatic instance segmentation (computational-cell-analytics/
micro-sam ``instance_segmentation.py::get_unetr``, the ``vit_l_lm``
generalist's encoder: SAM's ViT-L, facebookresearch/segment-anything
``build_sam.py::build_sam_vit_l``, with 16 px patches, windows of 14
tokens and global attention in blocks 5, 11, 17 and 23; torch_em's UNETR
decoder without skip connections): its keys, FLOP count, weights' entries,
CPU preset, and the seeded weights the inference cell runs.  The network
itself is ``benchmark/reference/micro_sam.py``.

The weights (``make_weights``).  Random weights have no trained scale, so
the weights are built to make the three fields follow the frames' cells,
and the ViT blocks and the decoder's own path are drawn on top:

- the patch embedding carries input channel 0 (the frame after SAM's
  standardisation) into the first c^2 channels of the stream, each the
  mean of an (16 / c)^2 block of the patch (c = 8 at full width, blocks
  of 2 x 2 px; c = 4 at the tiny size), and a pair of constant channels
  +-``CONST`` from its bias; ``pos_embed`` is 0;
- the blocks as ``families/cellpose_sam.py`` draws them (SAM's
  initialisation, relative tables of std ``REL_STD``, the value rows and
  lin1 reading nothing of the constant pair, proj and lin2 writing nothing
  into it), proj scaled by ``ATTN_SCALE`` and lin2 by ``MLP_SCALE``;
- the neck passes the carried channels on (times ``NECK_GAIN`` in its 3x3
  centre tap) beside the constant pair, with minus their sum shared out
  over the channels left, so that both LayerNorm2d's stay nearly linear
  (their spread is the constants'); z then carries each block's value
  times ``z_scale``;
- deconv1 to deconv4 undo that scale and unshuffle the carried blocks
  level by level (a transposed 2 x 2 kernel takes each output pixel's
  sub-block; past one block a pixel it copies), offset by ``OFFSET`` so
  that ReLU passes them; their 3x3 convolutions are the identity, their
  BatchNorms the identity (running mean 0, variance 1): z0's channel 0 is
  the frame's 2 x 2 block means plus ``OFFSET``, its other channels 0;
- base, the decoder levels and deconv_out are He-normal with zero biases,
  except that nothing reads z's constant pair (an instance norm would blow
  its rounding up): a random image of the tile that the head mixes in at
  ``PATH_MIX`` of its scale;
- decoder_head: its instance norm standardises z0's carried channel per
  tile; conv1's channel 0 smooths it with a 3x3 binomial kernel (+
  ``OFFSET``, so ReLU passes it), the other channels He-normal; after the
  second instance norm conv2's channels 0-2 smooth channel 0 again, so m,
  the frame twice smoothed and standardised per tile, reaches the readout;
- out_conv: foreground = sigmoid(``GAIN`` (m - ``T_FG``)), centre distance
  = sigmoid(-``GAIN`` (m - ``T_CENTER``)), boundary distance =
  sigmoid(-``GAIN`` (m - ``T_BOUNDARY``)), each plus the decoder's random
  channels at ``HEAD_MIX``.

So the mask is where the twice smoothed frame lies ``T_FG`` of its
per-tile spread above its mean, and the seeds where it lies ``T_CENTER``
above: clumps of touching cells, one seed a clump or a few.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.families.cellpose_sam import (ATTN_SCALE, CONST, MLP_SCALE,
                                             NECK_CONST, REL_STD, STD)
from benchmark.harness.gen import generator

KEYS = ("embed_dim", "depth", "num_heads", "mlp_dim", "patch_size",
        "img_size", "neck_dim", "ch_in", "window_size",
        "global_attn_indexes", "decoder_features", "out_channels")
PUBLISHED = {"embed_dim": 1024, "depth": 24, "num_heads": 16,
             "mlp_dim": 4096, "patch_size": 16, "img_size": 1024,
             "neck_dim": 256, "ch_in": 3, "window_size": 14,
             "global_attn_indexes": [5, 11, 17, 23],
             "decoder_features": [512, 256, 128, 64], "out_channels": 3}
WIDTHS = ("embed_dim", "num_heads", "mlp_dim", "neck_dim", "patch_size",
          "img_size", "window_size", "decoder_features")

NECK_GAIN = 16.0    # on the carried channels in the neck's 3x3 centre tap
OFFSET = 4.0        # lifts carried values above ReLU's knee
GAIN = 3.0          # the readout's slope in units of m's per-tile spread
T_FG, T_CENTER, T_BOUNDARY = 0.3, 1.0, 0.8
# the decoder's own path (base, its levels and samplers, deconv_out): its
# random image in conv1's channel 0, and conv2's random channels in each
# field's logit, each at a scale that a fault in that path moves the
# fields by well over the cell's field_err limit
PATH_MIX = 0.6
HEAD_MIX = 0.6
_TUPLES = ("global_attn_indexes", "decoder_features")


def model_config(config: dict) -> Dict:
    """The ``MicroSAMConfig`` fields of a configuration file."""
    return {k: (tuple(config[k]) if k in _TUPLES else config[k])
            for k in KEYS}


def tiny(config: dict) -> dict:
    """Four blocks (1 and 3 global) on an 8 x 8 grid that windows of 3
    pad to 9 x 9, embed 64, decoder 32 -> 8."""
    return dict(config, embed_dim=64, depth=4, global_attn_indexes=[1, 3],
                num_heads=4, mlp_dim=256, img_size=128, window_size=3,
                decoder_features=[32, 16, 8, 8])


def _block_grid(cfg, i: int) -> int:
    ws = cfg["window_size"]
    g = cfg["img_size"] // cfg["patch_size"]
    return g if (not ws or i in cfg["global_attn_indexes"]) else ws


def forward_flops(cfg, h: int, w: int) -> int:
    """One forward's FLOPs on an h x w input (h = w = img_size), two per
    multiply-add: the patch embedding; each block's qkv and proj on its
    tokens (a windowed block's padded ones included), q k^T and the
    weights times v, the two relative-position products, and the MLP on
    the grid's tokens; the neck's two convolutions; every convolution and
    transposed convolution of the decoder (a transposed 2 x 2 kernel with
    stride 2: one tap an output pixel).  Norms, softmax, GELU, ReLU, the
    sigmoid and additions are not counted."""
    p, d, m = cfg["patch_size"], cfg["embed_dim"], cfg["mlp_dim"]
    heads = cfg["num_heads"]
    hd = d // heads
    g = h // p
    n = g * g
    total = 2 * n * cfg["ch_in"] * p * p * d
    for i in range(cfg["depth"]):
        ws = _block_grid(cfg, i)
        if ws == g:
            nw, tok = 1, n
        else:
            nw = (-(-g // ws)) ** 2
            tok = nw * ws * ws
        t = ws * ws                                 # tokens a map
        total += (2 * tok * d * 3 * d + 2 * tok * d * d
                  + nw * heads * (4 * t * t * hd + 2 * t * 2 * ws * hd)
                  + 2 * 2 * n * d * m)
    nk = cfg["neck_dim"]
    total += 2 * n * d * nk + 2 * n * nk * nk * 9
    f = list(cfg["decoder_features"])

    def conv(side, cin, cout, k=9):
        return 2 * side * side * cin * cout * k

    def deconv(side_out, cin, cout):         # transposed conv + 3x3
        return conv(side_out, cin, cout, 1) + conv(side_out, cout, cout)

    def block(side, cin, cout):              # ConvBlock2d
        return conv(side, cin, cout) + conv(side, cout, cout)

    total += (deconv(2 * g, nk, f[1]) + deconv(4 * g, f[1], f[2])
              + deconv(8 * g, f[2], f[3]) + deconv(16 * g, f[3], f[3]))
    total += block(g, nk, f[0])
    for lvl in range(3):
        side = g * 2 ** (lvl + 1)
        total += conv(side, f[lvl], f[lvl + 1], 1) \
            + block(side, 2 * f[lvl + 1], f[lvl + 1])
    total += conv(16 * g, f[3], f[3], 1) + block(16 * g, 2 * f[3], f[3])
    total += conv(16 * g, f[3], cfg["out_channels"], 1)
    return total


def state_shapes(cfg) -> Dict[str, tuple]:
    """name -> (kind, shape) of every entry, in the port's order (SAM's
    ``image_encoder.*`` names, torch_em's for the decoder)."""
    d, m, p, nk = (cfg["embed_dim"], cfg["mlp_dim"], cfg["patch_size"],
                   cfg["neck_dim"])
    g = cfg["img_size"] // p
    hd = d // cfg["num_heads"]
    e = "image_encoder."
    out = {e + "patch_embed.proj.weight": ("conv", (d, cfg["ch_in"], p, p)),
           e + "patch_embed.proj.bias": ("bias", (d,)),
           e + "pos_embed": ("shift", (1, g, g, d))}
    for i in range(cfg["depth"]):
        b = f"{e}blocks.{i}."
        rows = 2 * _block_grid(cfg, i) - 1
        out.update({
            b + "norm1.weight": ("scale", (d,)),
            b + "norm1.bias": ("shift", (d,)),
            b + "attn.qkv.weight": ("conv", (3 * d, d)),
            b + "attn.qkv.bias": ("bias", (3 * d,)),
            b + "attn.proj.weight": ("conv", (d, d)),
            b + "attn.proj.bias": ("bias", (d,)),
            b + "attn.rel_pos_h": ("relpos", (rows, hd)),
            b + "attn.rel_pos_w": ("relpos", (rows, hd)),
            b + "norm2.weight": ("scale", (d,)),
            b + "norm2.bias": ("shift", (d,)),
            b + "mlp.lin1.weight": ("conv", (m, d)),
            b + "mlp.lin1.bias": ("bias", (m,)),
            b + "mlp.lin2.weight": ("conv", (d, m)),
            b + "mlp.lin2.bias": ("bias", (d,))})
    out.update({e + "neck.0.weight": ("conv", (nk, d, 1, 1)),
                e + "neck.1.weight": ("scale", (nk,)),
                e + "neck.1.bias": ("shift", (nk,)),
                e + "neck.2.weight": ("conv", (nk, nk, 3, 3)),
                e + "neck.3.weight": ("scale", (nk,)),
                e + "neck.3.bias": ("shift", (nk,))})
    f = list(cfg["decoder_features"])

    def conv_block(name, cin, cout):
        out.update({name + "block.1.weight": ("conv", (cout, cin, 3, 3)),
                    name + "block.1.bias": ("bias", (cout,)),
                    name + "block.4.weight": ("conv", (cout, cout, 3, 3)),
                    name + "block.4.bias": ("bias", (cout,))})

    def deconv_t(name, cin, cout):
        out.update({name + "weight": ("convT", (cin, cout, 2, 2)),
                    name + "bias": ("bias", (cout,))})

    def deconv_block(name, cin, cout):
        deconv_t(name + "block.0.block.", cin, cout)
        out.update({name + "block.1.block.weight": ("conv",
                                                    (cout, cout, 3, 3)),
                    name + "block.1.block.bias": ("bias", (cout,)),
                    name + "block.2.weight": ("scale", (cout,)),
                    name + "block.2.bias": ("shift", (cout,)),
                    name + "block.2.running_mean": ("mean", (cout,)),
                    name + "block.2.running_var": ("var", (cout,)),
                    name + "block.2.num_batches_tracked": ("count", ())})

    for lvl in range(3):
        conv_block(f"decoder.blocks.{lvl}.", 2 * f[lvl + 1], f[lvl + 1])
    for lvl in range(3):
        deconv_t(f"decoder.samplers.{lvl}.block.", f[lvl], f[lvl + 1])
    deconv_block("deconv1.", nk, f[1])
    deconv_block("deconv2.", f[1], f[2])
    deconv_block("deconv3.", f[2], f[3])
    deconv_block("deconv4.", f[3], f[3])
    conv_block("base.", nk, f[0])
    out.update({"out_conv.weight": ("conv", (cfg["out_channels"], f[3], 1,
                                             1)),
                "out_conv.bias": ("bias", (cfg["out_channels"],))})
    deconv_t("deconv_out.block.", f[3], f[3])
    conv_block("decoder_head.", 2 * f[3], f[3])
    return out


def carried(cfg) -> int:
    """Blocks carried along each side of a patch: the largest divisor c of
    the patch whose c^2 channels and the constant pair fit the stream with
    room for the neck's negated sum."""
    p, c = cfg["patch_size"], cfg["patch_size"]
    while c > 1 and (c * c + 3 > min(cfg["embed_dim"], cfg["neck_dim"])
                     or p % c):
        c -= 1
    return c


def z_scale(cfg) -> float:
    """z's carried channels over the carried block values: the neck's gain
    over the two LayerNorm2d's spreads, which the constant pairs set."""
    nk = cfg["neck_dim"]
    c1 = CONST * NECK_CONST[0]
    sigma1 = c1 * math.sqrt(2.0 / nk)
    sigma2 = NECK_CONST[1] * (c1 / sigma1) * math.sqrt(2.0 / nk)
    return NECK_GAIN / (sigma1 * sigma2)


def _binomial(device) -> torch.Tensor:
    k = torch.tensor([1.0, 2.0, 1.0], device=device)
    return (k[:, None] * k[None]) / 16.0


def _he(shape, g, device, fan_in) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=device) \
        * math.sqrt(2.0 / fan_in)


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded weights of the module docstring, on ``device``."""
    d, p, nk = cfg["embed_dim"], cfg["patch_size"], cfg["neck_dim"]
    f = list(cfg["decoder_features"])
    c = carried(cfg)
    s, cc = p // c, c * c
    shapes = state_shapes(cfg)
    g = generator(seed, 2, device)
    out = {}
    e = "image_encoder."
    for name, (kind, shape) in shapes.items():
        if kind in ("scale", "var"):
            out[name] = torch.ones(shape, device=device)
        elif kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
        elif kind == "relpos":
            out[name] = torch.randn(shape, generator=g,
                                    device=device) * REL_STD
        elif kind == "conv" and name.startswith(e + "blocks."):
            w = torch.randn(shape, generator=g, device=device) * STD
            if name.endswith("attn.proj.weight"):
                w = w * ATTN_SCALE
            if name.endswith("mlp.lin2.weight"):
                w = w * MLP_SCALE
            if name.endswith(("attn.proj.weight", "mlp.lin2.weight")):
                w[cc:cc + 2] = 0
            if name.endswith("attn.qkv.weight"):
                w[2 * d:, cc:cc + 2] = 0
            if name.endswith("mlp.lin1.weight"):
                w[:, cc:cc + 2] = 0
            out[name] = w
        elif kind in ("conv", "convT") and not name.startswith(e) \
                and not name.startswith(("deconv1.", "deconv2.", "deconv3.",
                                         "deconv4.", "out_conv.")):
            fan_in = (shape[0] if kind == "convT"
                      else shape[1] * shape[2] * shape[3])
            out[name] = _he(shape, g, device, fan_in)
        else:
            out[name] = torch.zeros(shape, device=device)
    # the patch embedding: block means of channel 0; +-CONST
    pe = out[e + "patch_embed.proj.weight"]
    for qy in range(c):
        for qx in range(c):
            pe[qy * c + qx, 0, qy * s:(qy + 1) * s, qx * s:(qx + 1) * s] = \
                1.0 / (s * s)
    pb = out[e + "patch_embed.proj.bias"]
    pb[cc], pb[cc + 1] = CONST, -CONST
    # the neck: the carried blocks, the constants, minus the blocks' sum
    n0 = out[e + "neck.0.weight"]
    idx = torch.arange(cc, device=device)
    n0[idx, idx, 0, 0] = 1.0
    n0[cc, cc, 0, 0] = NECK_CONST[0]
    n0[cc + 1, cc + 1, 0, 0] = NECK_CONST[0]
    n0[cc + 2:, :cc, 0, 0] = -1.0 / (nk - cc - 2)
    n2 = out[e + "neck.2.weight"]
    n2[idx, idx, 1, 1] = NECK_GAIN
    n2[cc, cc, 1, 1] = NECK_CONST[1]
    n2[cc + 1, cc + 1, 1, 1] = NECK_CONST[1]
    n2[cc + 2:, :cc, 1, 1] = -NECK_GAIN / (nk - cc - 2)
    # nothing of the decoder path reads z's constant pair
    out["base.block.1.weight"][:, cc:cc + 2] = 0
    # deconv1..4: unshuffle the carried blocks, k a side per position
    k, scale = c, 1.0 / z_scale(cfg)
    for lvl in range(1, 5):
        pre = f"deconv{lvl}.block."
        wt = out[pre + "0.block.weight"]             # (cin, cout, 2, 2)
        k2 = max(1, k // 2)
        for a in range(2):
            for b in range(2):
                for ry in range(k2):
                    for rx in range(k2):
                        qy, qx = (a * k2 + ry, b * k2 + rx) if k > 1 \
                            else (0, 0)
                        wt[qy * k + qx, ry * k2 + rx, a, b] = scale
        if lvl == 1:
            out[pre + "0.block.bias"][:k2 * k2] = OFFSET
        w3 = out[pre + "1.block.weight"]
        j = torch.arange(k2 * k2, device=device)
        w3[j, j, 1, 1] = 1.0
        k, scale = k2, 1.0
    # decoder_head: channel 0 the smoothed, standardised carried channel
    # with the path's random image mixed in; channels 0-2 of conv2 smooth
    # it again
    h1 = out["decoder_head.block.1.weight"]          # (f3, 2 f3, 3, 3)
    h1[0] = h1[0] * PATH_MIX
    h1[0, f[3]:] = 0
    h1[0, f[3]] = _binomial(device)
    out["decoder_head.block.1.bias"][0] = OFFSET
    h2 = out["decoder_head.block.4.weight"]          # (f3, f3, 3, 3)
    h2[:3] = 0
    h2[:3, 0] = _binomial(device)
    out["decoder_head.block.4.bias"][:3] = OFFSET
    # the readout: three ramps of m (conv2's channels 0-2 hold m + OFFSET)
    # and the decoder's random channels
    ow = out["out_conv.weight"]                      # (3, f3, 1, 1)
    ow[:, 3:, 0, 0] = torch.randn((3, f[3] - 3), generator=g,
                                  device=device) \
        * HEAD_MIX / math.sqrt(f[3] - 3)
    ob = out["out_conv.bias"]
    for ch, (sign, t) in enumerate(((1.0, T_FG), (-1.0, T_CENTER),
                                    (-1.0, T_BOUNDARY))):
        ow[ch, ch, 0, 0] = sign * GAIN
        ob[ch] = -sign * GAIN * (OFFSET + t)
    return out
