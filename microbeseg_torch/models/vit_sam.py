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

On the card the blocks also run as one chain (``run_blocks``): each
residual add, the LayerNorm after it and autocast's bf16 cast of that
LayerNorm's output are one launch of ``ops/kernels/add_layernorm.py``
(``csrc/add_layernorm.cu``), which updates the float32 stream in place,
2 * depth launches a forward; it raises on what it does not take, as
``rel_attention`` does.  On the CPU each block's ``forward`` runs as
written.  The parameters keep their names either way.

The same ``Encoder`` is SAM's image encoder with windowed attention
(``window_size`` > 0, as muSAM runs it, ``models/unetr.py``): a block not
in ``global_attn_indexes`` pads its normed (B, G, G, D) map with zeros at
the bottom and right to a multiple of the window, cuts it into windows of
window_size^2 tokens, runs qkv, the attention and proj on every token of
every window (the padded tokens, whose q, k and v are qkv's bias, are keys
and values like any other: SAM masks nothing), puts the windows back and
crops to G x G before the residual add (SAM's ``window_partition`` and
``window_unpartition``).  Each block's relative tables have 2 g - 1 rows of
its own grid g: the window in a windowed block, G in a global one.  On the
card a windowed block's attention is one launch of the same kernel over
all its windows; the span ``mseg.vit.window`` marks the pad and cut, and
the reassembly and crop.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from microbeseg_torch.config import CellposeSAMConfig, MicroSAMConfig
from microbeseg_torch.ops.kernels.add_layernorm import add_layernorm
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


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, G, G, D) -> (B * n^2, ws, ws, D) windows, n = ceil(G / ws),
    the map padded with zeros at the bottom and right first."""
    B, g, _, d = x.shape
    n = -(-g // ws)
    pad = n * ws - g
    if pad:
        x = F.pad(x, (0, 0, 0, pad, 0, pad))
    x = x.view(B, n, ws, n, ws, d).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B * n * n, ws, ws, d)


def window_unpartition(x: torch.Tensor, g: int) -> torch.Tensor:
    """``window_partition``'s windows (B * n^2, ws, ws, D) -> the (B, g, g,
    D) map, the padding cropped off, contiguous."""
    nb, ws, _, d = x.shape
    n = -(-g // ws)
    x = x.view(nb // (n * n), n, n, ws, ws, d).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(-1, n * ws, n * ws, d)
    return x[:, :g, :g].contiguous() if n * ws != g else x


class PatchEmbed(nn.Module):
    def __init__(self, cfg: CellposeSAMConfig):
        super().__init__()
        self.proj = nn.Conv2d(cfg.ch_in, cfg.embed_dim, cfg.patch_size,
                              stride=cfg.patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).permute(0, 2, 3, 1)


class Attention(nn.Module):
    """Attention over a g x g grid of tokens, its relative tables of 2g - 1
    rows: ``grid``, or the configuration's token grid where None."""

    def __init__(self, cfg: CellposeSAMConfig, grid: Optional[int] = None):
        super().__init__()
        d, self.heads = cfg.embed_dim, cfg.num_heads
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)
        rows, hd = 2 * (grid or cfg.grid) - 1, d // cfg.num_heads
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
    """``window`` 0: global attention over the token grid; otherwise
    attention within windows of ``window`` tokens a side."""

    def __init__(self, cfg: CellposeSAMConfig, window: int = 0):
        super().__init__()
        self.window = window
        self.norm1 = nn.LayerNorm(cfg.embed_dim, eps=LN_EPS)
        self.attn = Attention(cfg, window or None)
        self.norm2 = nn.LayerNorm(cfg.embed_dim, eps=LN_EPS)
        self.mlp = MLP(cfg)

    def attend(self, h: torch.Tensor) -> torch.Tensor:
        """The attention branch on the normed map h (B, G, G, D): global,
        or over h's windows and put back."""
        if not self.window:
            return self.attn(h)
        with span("mseg.vit.window"):
            w = window_partition(h, self.window)
        a = self.attn(w)
        with span("mseg.vit.window"):
            return window_unpartition(a, h.shape[1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attend(self.norm1(x))
        return x + self.mlp(self.norm2(x))


def run_blocks(blocks: nn.ModuleList, x: torch.Tensor,
               step: Callable) -> torch.Tensor:
    """The blocks' ``forward`` in sequence, as one chain of ``step(x, h,
    norm) -> rows`` (``x += h`` in place where ``h`` is given, then the
    rows ``norm(x)``): block 0's norm1 on the stream alone, each
    attention's output into its block's norm2, each MLP's into the next
    block's norm1; the last block's MLP output is a plain add, since the
    neck reads the float32 stream."""
    y = step(x, None, blocks[0].norm1)
    for i, blk in enumerate(blocks):
        y = step(x, blk.attend(y), blk.norm2)
        h = blk.mlp(y)
        if i + 1 == len(blocks):
            return x + h
        y = step(x, h, blocks[i + 1].norm1)


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
    """(B, ch_in, img_size, img_size) -> the neck's (B, neck_dim, G, G).
    ``cfg``: a ``CellposeSAMConfig`` or a ``MicroSAMConfig``."""

    def __init__(self, cfg: CellposeSAMConfig):
        super().__init__()
        self.patch_embed = PatchEmbed(cfg)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.grid, cfg.grid, cfg.embed_dim))
        self.blocks = nn.ModuleList(
            Block(cfg, 0 if i in cfg.global_attn_indexes else cfg.window_size)
            for i in range(cfg.depth))
        n = cfg.neck_dim
        self.neck = nn.Sequential(
            nn.Conv2d(cfg.embed_dim, n, 1, bias=False), LayerNorm2d(n),
            nn.Conv2d(n, n, 3, padding=1, bias=False), LayerNorm2d(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x) + self.pos_embed
        if x.is_cuda:
            x = run_blocks(self.blocks, x.contiguous(), add_layernorm)
        else:
            for blk in self.blocks:
                x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))


class CellposeSAM(nn.Module):
    """(B, ch_in, img_size, img_size) -> (B, nout, img_size, img_size)."""

    def __init__(self, cfg: CellposeSAMConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.out = nn.Conv2d(cfg.neck_dim, cfg.nout * cfg.patch_size ** 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.pixel_shuffle(self.out(self.encoder(x)), self.cfg.patch_size)


def build_cellpose_sam(cfg: CellposeSAMConfig = CellposeSAMConfig()
                       ) -> CellposeSAM:
    return CellposeSAM(cfg)


def build_sam_encoder(cfg: MicroSAMConfig = MicroSAMConfig()) -> Encoder:
    """SAM's ViT image encoder (``build_sam.py::build_sam_vit_l`` at the
    defaults: 1024^2 inputs in 16 px patches, a 64 x 64 grid, 24 blocks of
    16 heads, windows of 14 and global attention in blocks 5, 11, 17 and
    23, the neck to 256)."""
    return Encoder(cfg)
