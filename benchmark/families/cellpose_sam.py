"""Cellpose-SAM (MouseLand/cellpose ``cellpose/vit_sam.py::Transformer``,
release 4; SAM's ViT-L image encoder, facebookresearch/segment-anything
``build_sam.py::build_sam_vit_l``, with patches of 8 px and global
attention in every block): its keys, FLOP count, weights' entries, CPU
preset, and the seeded weights the inference cell runs.  The network
itself is ``benchmark/reference/cellpose_sam.py``.

The weights (``make_weights``).  Random weights have no trained scale and
would turn the fields into speckle, so the weights are built to make the
fields follow the frames' cells, and the blocks are drawn at SAM's
initialisation on top:

- the patch embedding carries input channel 0's patch into the first
  c^2 channels of the stream, each the mean of an (8 / c)^2 block of it
  minus 0.5 (c = 8 at full width, every pixel; c = 4 where the stream is
  too narrow, ``tiny``), and a pair of constant channels +-``CONST`` from
  its bias; ``pos_embed`` is 0 (SAM's initialisation);
- each block's LayerNorms are SAM's initialisation (1, 0); qkv, proj,
  lin1 and lin2 are normal with std ``STD`` = 0.02 and zero biases; the
  value rows and lin1 read nothing of the constant pair (so no block adds a
  constant to every token), and proj and lin2 write nothing into it (so it
  stays exact in bfloat16); proj is scaled by ``ATTN_SCALE``, lin2 by
  ``MLP_SCALE``;
  ``rel_pos_h`` and ``rel_pos_w`` are normal with std ``REL_STD`` = 1.
  The queries take the constant pair, so q is nearly the same at every
  token and the relative-position term is a random kernel over the token
  grid, which the attention applies to the values;
- the neck: its 1x1 convolution passes the c^2 carried channels and the
  constant pair (x ``NECK_CONST``) on, and the channels left hold minus
  the carried channels' sum, shared out, so each LayerNorm2d sees a zero
  mean and a spread that the constants set: both stay nearly linear.
  Its 3x3 convolution over the token grid computes the three fields of
  every pixel of the token from the carried blocks of it and its 8
  neighbours (a window of +-8 px):
  cell probability ``CP_GAIN`` x the blocks smoothed with a Gaussian of
  std ``CP_SIGMA`` px, and flows (dY, dX) ``FLOW_GAIN`` x the gradient of
  the blocks smoothed with std ``FLOW_SIGMA`` px, which points to the
  bright cells' centres; again the constants and a negated sum;
- the readout undoes the two LayerNorm2d's scales; its bias is 0;
- all other biases are 0 and the LayerNorm affines 1 and 0.

So cell probability is above 0 where the smoothed frame is above the
middle of its 1st-99th percentile range, and the flows follow the cells.
The 24 blocks add some 6-12% of the fields' RMS, mostly through attention
that the relative-position term shapes: without that term the fields
move by some 4-5% (float32, a 256^2 tile of the cell's frames).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.harness.gen import generator

KEYS = ("embed_dim", "depth", "num_heads", "mlp_dim", "patch_size",
        "img_size", "neck_dim", "nout", "ch_in")
PUBLISHED = {"embed_dim": 1024, "depth": 24, "num_heads": 16,
             "mlp_dim": 4096, "patch_size": 8, "img_size": 256,
             "neck_dim": 256, "nout": 3, "ch_in": 3}
WIDTHS = ("embed_dim", "num_heads", "mlp_dim", "neck_dim", "patch_size",
          "img_size")

STD = 0.02          # SAM's initialisation of the linear layers
REL_STD = 1.0       # the relative-position tables
ATTN_SCALE = 8.0    # on proj
MLP_SCALE = 0.5     # on lin2
CONST = 256.0       # the stream's constant pair
# the neck's factors on the constant pair: large enough that LayerNorm2d's
# spread, and so the constants after it, hardly move with a token's
# content (a bfloat16 rounding of them then moves no token's scale)
NECK_CONST = (4.0, 8.0)
CP_SIGMA, CP_GAIN = 1.5, 6.0
FLOW_SIGMA, FLOW_GAIN = 3.0, 43.0
REACH = 8           # px of the fields' windows each side


def model_config(config: dict) -> Dict:
    """The ``CellposeSAMConfig`` fields of a configuration file."""
    return {k: config[k] for k in KEYS}


def tiny(config: dict) -> dict:
    return dict(config, embed_dim=64, depth=2, num_heads=4, mlp_dim=256,
                img_size=64)


def _grid(cfg) -> int:
    return cfg["img_size"] // cfg["patch_size"]


def forward_flops(cfg, h: int, w: int) -> int:
    """One forward's FLOPs on an h x w input, two per multiply-add: the
    patch embedding; each block's qkv, q k^T, the two relative-position
    einsums, the attention times v, proj and the MLP; the neck's two
    convolutions; the 1x1 readout.  The pixel shuffle, the LayerNorms,
    softmax, GELU and the additions are not counted."""
    p, d, m = cfg["patch_size"], cfg["embed_dim"], cfg["mlp_dim"]
    gh, gw = h // p, w // p
    n = gh * gw
    hd = d // cfg["num_heads"]
    heads = cfg["num_heads"]
    block = (2 * n * d * 3 * d                       # qkv
             + 2 * heads * n * n * hd                # q k^T
             + 2 * heads * n * (gh + gw) * hd        # rel_h, rel_w
             + 2 * heads * n * n * hd                # attention x v
             + 2 * n * d * d                         # proj
             + 2 * 2 * n * d * m)                    # lin1, lin2
    neck = cfg["neck_dim"]
    return (2 * n * cfg["ch_in"] * p * p * d         # patch embedding
            + cfg["depth"] * block
            + 2 * n * d * neck + 2 * n * neck * neck * 9
            + 2 * n * neck * cfg["nout"] * p * p)    # readout


def state_shapes(cfg) -> Dict[str, tuple]:
    """name -> (kind, shape) of every entry, in the port's order (the
    published ``cpsam`` names)."""
    d, m, p, nk = (cfg["embed_dim"], cfg["mlp_dim"], cfg["patch_size"],
                   cfg["neck_dim"])
    g = _grid(cfg)
    hd = d // cfg["num_heads"]
    out = {"encoder.patch_embed.proj.weight": ("conv", (d, cfg["ch_in"],
                                                        p, p)),
           "encoder.patch_embed.proj.bias": ("bias", (d,)),
           "encoder.pos_embed": ("shift", (1, g, g, d))}
    for i in range(cfg["depth"]):
        b = f"encoder.blocks.{i}."
        out.update({
            b + "norm1.weight": ("scale", (d,)), b + "norm1.bias": ("shift",
                                                                    (d,)),
            b + "attn.qkv.weight": ("conv", (3 * d, d)),
            b + "attn.qkv.bias": ("bias", (3 * d,)),
            b + "attn.proj.weight": ("conv", (d, d)),
            b + "attn.proj.bias": ("bias", (d,)),
            b + "attn.rel_pos_h": ("relpos", (2 * g - 1, hd)),
            b + "attn.rel_pos_w": ("relpos", (2 * g - 1, hd)),
            b + "norm2.weight": ("scale", (d,)), b + "norm2.bias": ("shift",
                                                                    (d,)),
            b + "mlp.lin1.weight": ("conv", (m, d)),
            b + "mlp.lin1.bias": ("bias", (m,)),
            b + "mlp.lin2.weight": ("conv", (d, m)),
            b + "mlp.lin2.bias": ("bias", (d,))})
    out.update({"encoder.neck.0.weight": ("conv", (nk, d, 1, 1)),
                "encoder.neck.1.weight": ("scale", (nk,)),
                "encoder.neck.1.bias": ("shift", (nk,)),
                "encoder.neck.2.weight": ("conv", (nk, nk, 3, 3)),
                "encoder.neck.3.weight": ("scale", (nk,)),
                "encoder.neck.3.bias": ("shift", (nk,)),
                "out.weight": ("conv", (cfg["nout"] * p * p, nk, 1, 1)),
                "out.bias": ("bias", (cfg["nout"] * p * p,))})
    return out


def carried(cfg) -> int:
    """Blocks carried along each side of a patch: 8, or fewer where the
    stream cannot hold them and the constant pair."""
    p, c = cfg["patch_size"], cfg["patch_size"]
    while c > 1 and (c * c + 2 > cfg["embed_dim"] or p % c):
        c -= 1
    return c


def _gauss(t: torch.Tensor, sigma: float, deriv: bool) -> torch.Tensor:
    """At offsets t px: a Gaussian of std ``sigma``, scaled to sum to 1
    over the whole pixels -REACH..REACH, or that times t / sigma^2 (minus
    its derivative, which weighs the pixels along +t); 0 beyond REACH."""
    whole = torch.arange(-REACH, REACH + 1, dtype=torch.float64)
    z = torch.exp(-whole * whole / (2 * sigma * sigma)).sum()
    g = torch.exp(-t * t / (2 * sigma * sigma)) / z
    g = g * t / (sigma * sigma) if deriv else g
    return torch.where(t.abs() <= REACH, g, 0.0)


def _neck_kernel(cfg) -> torch.Tensor:
    """(nout * p^2, c^2, 3, 3): each field (dY, dX, cell probability) of
    each pixel of a token from the carried blocks of the token and its 8
    neighbours, a block weighing as its (p / c)^2 pixels at its centre."""
    p, c = cfg["patch_size"], carried(cfg)
    s = p // c
    # offset of a block's centre from a pixel along one axis: [tap, block,
    # pixel]
    tap = torch.arange(3, dtype=torch.float64) - 1
    blk = torch.arange(c, dtype=torch.float64) * s + (s - 1) / 2
    pix = torch.arange(p, dtype=torch.float64)
    off = p * tap[:, None, None] + blk[None, :, None] - pix[None, None, :]
    fields = ((FLOW_GAIN, (FLOW_SIGMA, True), (FLOW_SIGMA, False)),
              (FLOW_GAIN, (FLOW_SIGMA, False), (FLOW_SIGMA, True)),
              (CP_GAIN, (CP_SIGMA, False), (CP_SIGMA, False)))
    out = []
    for gain, ky, kx in fields:
        wy = (_gauss(off, *ky) * s).permute(2, 1, 0)    # [pixel, block, tap]
        wx = (_gauss(off, *kx) * s).permute(2, 1, 0)
        # [py, px, qy, qx, ty, tx]
        k = gain * wy[:, None, :, None, :, None] \
            * wx[None, :, None, :, None, :]
        out.append(k.reshape(p * p, c * c, 3, 3))
    return torch.cat(out).float()


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded weights of the module docstring, on ``device``."""
    d, p, nk = cfg["embed_dim"], cfg["patch_size"], cfg["neck_dim"]
    c = carried(cfg)
    s, cc = p // c, c * c
    shapes = state_shapes(cfg)
    g = generator(seed, 2, device)
    out = {}
    for name, (kind, shape) in shapes.items():
        if kind == "scale":
            out[name] = torch.ones(shape, device=device)
        elif kind == "relpos":
            out[name] = torch.randn(shape, generator=g,
                                    device=device) * REL_STD
        elif kind == "conv" and name.startswith("encoder.blocks."):
            w = torch.randn(shape, generator=g, device=device) * STD
            if name.endswith("attn.proj.weight"):
                w = w * ATTN_SCALE
            if name.endswith("mlp.lin2.weight"):
                w = w * MLP_SCALE
            if name.endswith(("attn.proj.weight", "mlp.lin2.weight")):
                w[cc:cc + 2] = 0               # the constants stay exact
            if name.endswith("attn.qkv.weight"):
                w[2 * d:, cc:cc + 2] = 0       # the values
            if name.endswith("mlp.lin1.weight"):
                w[:, cc:cc + 2] = 0
            out[name] = w
        else:
            out[name] = torch.zeros(shape, device=device)
    # the patch embedding: block means of channel 0, minus 0.5; +-CONST
    pe = out["encoder.patch_embed.proj.weight"]
    for qy in range(c):
        for qx in range(c):
            pe[qy * c + qx, 0, qy * s:(qy + 1) * s, qx * s:(qx + 1) * s] = \
                1.0 / (s * s)
    pb = out["encoder.patch_embed.proj.bias"]
    pb[:cc] = -0.5
    pb[cc], pb[cc + 1] = CONST, -CONST
    # the neck's 1x1: the carried blocks, the constants, and minus the
    # blocks' sum spread over the channels left (each as small as a block,
    # so that rounding them moves the mean little)
    n0 = out["encoder.neck.0.weight"]
    n0[torch.arange(cc), torch.arange(cc), 0, 0] = 1.0
    n0[cc, cc, 0, 0] = NECK_CONST[0]
    n0[cc + 1, cc + 1, 0, 0] = NECK_CONST[0]
    n0[cc + 2:, :cc, 0, 0] = -1.0 / (nk - cc - 2)
    # the 3x3: the fields, the constants again, minus the fields' sum
    nf = cfg["nout"] * p * p
    n2 = out["encoder.neck.2.weight"]
    k = _neck_kernel(cfg).to(device)
    n2[:nf, :cc] = k
    n2[nf, cc, 1, 1] = NECK_CONST[1]
    n2[nf + 1, cc + 1, 1, 1] = NECK_CONST[1]
    n2[nf + 2:, :cc] = -k.sum(dim=0) / (nk - nf - 2)
    # the readout undoes the two LayerNorm2d's: each divides by the spread
    # its constants set, sqrt(2 / nk) x the constant
    c1 = CONST * NECK_CONST[0]
    sigma1 = c1 * math.sqrt(2.0 / nk)
    sigma2 = NECK_CONST[1] * (c1 / sigma1) * math.sqrt(2.0 / nk)
    ow = out["out.weight"]
    ow[torch.arange(nf), torch.arange(nf), 0, 0] = sigma1 * sigma2
    return out
