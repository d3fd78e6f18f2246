"""Cellpose-SAM: SAM's ViT-L image encoder with patches of 8 px, global
attention with decomposed relative positions in every block, SAM's neck
and a readout of three fields (dY, dX, cell probability).

Sources: Pachitariu, Rariden & Stringer, "Cellpose-SAM: superhuman
generalization for cellular segmentation" (bioRxiv 2025), MouseLand/cellpose
``cellpose/vit_sam.py::Transformer`` (release 4); Kirillov et al. 2023,
facebookresearch/segment-anything
``segment_anything/modeling/image_encoder.py``.  On an input x of shape
(B, ch_in, S, S), with G = S / patch_size tokens a side:

- ``encoder.patch_embed.proj``: a convolution with kernel and stride
  ``patch_size`` and a bias, to (B, G, G, D) tokens, channels last; plus
  ``encoder.pos_embed`` (1, G, G, D);
- each of ``depth`` blocks: x = x + Attn(LN1(x)), x = x + MLP(LN2(x)), the
  LayerNorms with eps 1e-6 and the MLP lin1 -> GELU (exact erf) -> lin2;
- Attn: qkv = Linear(D, 3D) split into q, k, v of (B, heads, G * G, D /
  heads); the logits q k^T / sqrt(D / heads) + rel_h + rel_w with
  rel_h[(i, j), (k, l)] = sum_c q[(i, j), c] rel_pos_h[i - k + G - 1, c]
  and rel_w likewise over columns with rel_pos_w (q unscaled, as SAM's
  ``add_decomposed_rel_pos`` takes it); softmax, times v, the heads merged,
  then ``proj`` = Linear(D, D);
- ``encoder.neck``: Conv1x1(D -> neck, no bias), LayerNorm2d, Conv3x3(neck
  -> neck, pad 1, no bias), LayerNorm2d, each LayerNorm2d over the channels
  at each token with eps 1e-6;
- ``out``: Conv1x1(neck -> nout * patch_size^2, bias), then a pixel
  shuffle by ``patch_size`` to (B, nout, S, S).  Cellpose writes the
  shuffle as ``conv_transpose2d`` against the fixed identity ``W2``; it is
  the same map.

The parameters carry Cellpose-SAM's published names (``encoder.blocks.{i}.
attn.rel_pos_h``, ...), so a ``cpsam`` state dict loads once its
relative-position tables are taken to 2G - 1 rows
(``models/torch_import.cellpose_sam_from_state_dict``).  The device of the
input picks the attention's route: on the card one launch of
``ops/kernels/rel_attention.py`` (``csrc/rel_attention.cu``) reads q, k and
v where the qkv projection wrote them, adds the relative terms to the
logits in registers and writes the heads merged; on the CPU
``F.scaled_dot_product_attention`` takes the decomposed bias that
``rel_pos_bias`` builds as its additive mask.  The span
``mseg.vit.attention`` marks the attention of each block, the relative
term included.
"""

from __future__ import annotations

from functools import lru_cache

import torch
import torch.nn.functional as F
from torch import nn

from microbeseg_torch.config import CellposeSAMConfig
from microbeseg_torch.ops.kernels.rel_attention import rel_attention
from microbeseg_torch.utils.profiling import span

LN_EPS = 1e-6


@lru_cache(maxsize=None)
def rel_index(g: int, device=None) -> torch.Tensor:
    """(g, g) rows of a (2g - 1)-row table: [i, k] -> i - k + g - 1 (one
    tensor a size and device, made once)."""
    r = torch.arange(g, device=device)
    return r[:, None] - r[None, :] + (g - 1)


@lru_cache(maxsize=None)
def _spread(g: int, dtype, device) -> torch.Tensor:
    """(2g, g * g) 0/1: row k puts a value on every key (k, l), row g + l
    on every key (k, l) (made once a size, type and device)."""
    r = torch.arange(g * g, device=device)
    rows = torch.arange(2 * g, device=device)[:, None]
    return ((rows == (r // g)[None]) | (rows == (g + r % g)[None])).to(dtype)


def rel_pos_bias(q: torch.Tensor, rel_pos_h: torch.Tensor,
                 rel_pos_w: torch.Tensor, g: int) -> torch.Tensor:
    """The decomposed relative-position term of the logits: q (B, heads,
    g * g, c) -> (B, heads, g * g, g * g), rel_h + rel_w.  The sum is
    spread over the keys by one product with a 0/1 matrix, each entry
    rel_h + rel_w rounded once to q's type as an add rounds it: a
    broadcast add over the 6-dimensional shape runs as PyTorch's generic
    strided kernel, some 10x slower on the card."""
    B, nh, n, c = q.shape
    idx = rel_index(g, q.device)
    r_q = q.reshape(B, nh, g, g, c)
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, rel_pos_h[idx].to(q.dtype))
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, rel_pos_w[idx].to(q.dtype))
    both = torch.cat([rel_h, rel_w], dim=-1).reshape(B, nh, n, 2 * g)
    return both @ _spread(g, both.dtype, q.device)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: CellposeSAMConfig):
        super().__init__()
        self.proj = nn.Conv2d(cfg.ch_in, cfg.embed_dim, cfg.patch_size,
                              stride=cfg.patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).permute(0, 2, 3, 1)


class Attention(nn.Module):
    def __init__(self, cfg: CellposeSAMConfig):
        super().__init__()
        d, self.heads = cfg.embed_dim, cfg.num_heads
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)
        rows, hd = 2 * cfg.grid - 1, d // cfg.num_heads
        self.rel_pos_h = nn.Parameter(torch.zeros(rows, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(rows, hd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, g, _, d = x.shape
        qkv = self.qkv(x)
        if qkv.is_cuda:
            with span("mseg.vit.attention"):
                x = rel_attention(qkv.reshape(B, g * g, 3 * d),
                                  self.rel_pos_h, self.rel_pos_w,
                                  self.heads, g)
            return self.proj(x.reshape(B, g, g, d))
        qkv = qkv.reshape(B, g * g, 3, self.heads, d // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        with span("mseg.vit.attention"):
            bias = rel_pos_bias(q, self.rel_pos_h, self.rel_pos_w, g)
            x = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        return self.proj(x.transpose(1, 2).reshape(B, g, g, d))


class MLP(nn.Module):
    def __init__(self, cfg: CellposeSAMConfig):
        super().__init__()
        self.lin1 = nn.Linear(cfg.embed_dim, cfg.mlp_dim)
        self.lin2 = nn.Linear(cfg.mlp_dim, cfg.embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(F.gelu(self.lin1(x)))


class Block(nn.Module):
    def __init__(self, cfg: CellposeSAMConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.embed_dim, eps=LN_EPS)
        self.attn = Attention(cfg)
        self.norm2 = nn.LayerNorm(cfg.embed_dim, eps=LN_EPS)
        self.mlp = MLP(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of (B, C, H, W) at each position."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.permute(0, 2, 3, 1), (x.shape[1],), self.weight,
                         self.bias, LN_EPS)
        return y.permute(0, 3, 1, 2)


class Encoder(nn.Module):
    def __init__(self, cfg: CellposeSAMConfig):
        super().__init__()
        self.patch_embed = PatchEmbed(cfg)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.grid, cfg.grid, cfg.embed_dim))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        n = cfg.neck_dim
        self.neck = nn.Sequential(
            nn.Conv2d(cfg.embed_dim, n, 1, bias=False), LayerNorm2d(n),
            nn.Conv2d(n, n, 3, padding=1, bias=False), LayerNorm2d(n))


class CellposeSAM(nn.Module):
    """(B, ch_in, img_size, img_size) -> (B, nout, img_size, img_size)."""

    def __init__(self, cfg: CellposeSAMConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.out = nn.Conv2d(cfg.neck_dim, cfg.nout * cfg.patch_size ** 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        enc = self.encoder
        x = enc.patch_embed(x) + enc.pos_embed
        for blk in enc.blocks:
            x = blk(x)
        x = enc.neck(x.permute(0, 3, 1, 2))
        return F.pixel_shuffle(self.out(x), self.cfg.patch_size)


def build_cellpose_sam(cfg: CellposeSAMConfig = CellposeSAMConfig()
                       ) -> CellposeSAM:
    return CellposeSAM(cfg)
