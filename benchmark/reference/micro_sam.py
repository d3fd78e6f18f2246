"""muSAM's automatic-segmentation network in plain float32 PyTorch, from a
dict of weights under its module names: SAM's ViT image encoder
(facebookresearch/segment-anything ``segment_anything/modeling/
image_encoder.py``, ``build_sam.py::build_sam_vit_l``) and torch_em's
UNETR decoder without skip connections (constantpape/torch-em
``torch_em/model/unetr.py``, ``torch_em/model/unet.py``), as micro-sam's
``instance_segmentation.py::get_unetr`` builds them
(computational-cell-analytics/micro-sam).

Encoder, on x (B, ch_in, S, S), G = S / patch_size tokens a side, D
channels: patch embedding plus pos_embed; ``depth`` blocks x = x +
Attn(LN1(x)), x = x + MLP(LN2(x)) (LayerNorm eps 1e-6; lin1, exact GELU,
lin2).  In a block not in ``global_attn_indexes`` (with ``window_size`` w
> 0) LN1(x) is padded with zeros at the bottom and right to a multiple of
w, cut into w x w windows, Attn runs on every token of every window (qkv
and proj included) and the windows are put back and cropped to G x G
(SAM's ``window_partition``, ``window_unpartition``).  Attn builds the
logits explicitly, (q / sqrt(D / heads)) k^T plus SAM's
``add_decomposed_rel_pos`` term from the unscaled q, with the block's
tables of 2 g - 1 rows of its own grid g; softmax, times v, heads merged,
proj.  The neck: Conv1x1, LayerNorm2d, Conv3x3, LayerNorm2d (eps 1e-6).

Decoder, on the neck's z (B, E, G, G) with F = decoder_features:
z9..z0 from four Deconv2DBlocks (transposed 2 x 2 convolution with stride
2, 3 x 3 convolution, BatchNorm in eval mode with eps 1e-5, ReLU); base
(ConvBlock2d: InstanceNorm without affine and eps 1e-5, 3 x 3 convolution,
ReLU, InstanceNorm, 3 x 3 convolution, ReLU) on z; three levels of a
transposed 2 x 2 sampler and a ConvBlock2d on its concatenation with z9,
z6 and z3; a transposed 2 x 2 ``deconv_out``; ``decoder_head`` on its
concatenation with z0; the 1x1 ``out_conv`` and a sigmoid.  Departures
from torch_em, which the configuration file lists: the transposed
convolutions, the norms' places and the instance norms' missing affine are
taken as read, since no copy of torch_em is at hand to check them.

``quant``: an optional rounding of the operands of every layer with
weights (``quant(tensor, role)``): the lower-precision control
(``reference/lowp.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
LN_EPS = 1e-6
NORM_EPS = 1e-5


class Net:
    """The forward of one configuration (the family's ``model_config``)."""

    def __init__(self, cfg: dict, quant: Optional[Callable] = None):
        self.cfg = cfg
        self.q = quant

    def _ops(self, x, w):
        if self.q is None:
            return x, w
        return self.q(x, "input"), self.q(w, "weight")

    def linear(self, p: Params, name: str, x):
        x, w = self._ops(x, p[name + ".weight"])
        return x @ w.t() + p[name + ".bias"]

    def conv(self, p: Params, name: str, x, stride=1, padding=0):
        x, w = self._ops(x, p[name + ".weight"])
        return F.conv2d(x, w, p.get(name + ".bias"), stride=stride,
                        padding=padding)

    def conv_t(self, p: Params, name: str, x):
        x, w = self._ops(x, p[name + ".weight"])
        return F.conv_transpose2d(x, w, p[name + ".bias"], stride=2)

    @staticmethod
    def ln(p: Params, name: str, x):
        return F.layer_norm(x, x.shape[-1:], p[name + ".weight"],
                            p[name + ".bias"], LN_EPS)

    @staticmethod
    def ln2d(p: Params, name: str, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + LN_EPS)
        return p[name + ".weight"][:, None, None] * x \
            + p[name + ".bias"][:, None, None]

    @staticmethod
    def instance_norm(x):
        u = x.mean((2, 3), keepdim=True)
        s = (x - u).pow(2).mean((2, 3), keepdim=True)
        return (x - u) / torch.sqrt(s + NORM_EPS)

    @staticmethod
    def batch_norm(p: Params, name: str, x):
        a = p[name + ".weight"] / torch.sqrt(p[name + ".running_var"]
                                             + NORM_EPS)
        b = p[name + ".bias"] - p[name + ".running_mean"] * a
        return x * a[:, None, None] + b[:, None, None]

    # --- encoder ----------------------------------------------------------

    def attention(self, p: Params, pre: str, x):
        """x (B, g, g, D): the attention over its g x g tokens."""
        B, g, _, d = x.shape
        heads = self.cfg["num_heads"]
        hd = d // heads
        qkv = self.linear(p, pre + "qkv", x).reshape(B, g * g, 3, heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).reshape(
            3, B * heads, g * g, hd).unbind(0)
        attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
        r = torch.arange(g, device=x.device)
        idx = r[:, None] - r[None, :] + (g - 1)
        rh = p[pre + "rel_pos_h"][idx]
        rw = p[pre + "rel_pos_w"][idx]
        r_q = q.reshape(B * heads, g, g, hd)
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
        attn = (attn.view(B * heads, g, g, g, g) + rel_h[:, :, :, :, None]
                + rel_w[:, :, :, None, :]).view(B * heads, g * g, g * g)
        x = (attn.softmax(dim=-1) @ v).view(B, heads, g, g, hd)
        x = x.permute(0, 2, 3, 1, 4).reshape(B, g, g, d)
        return self.linear(p, pre + "proj", x)

    def windowed(self, p: Params, pre: str, x, ws: int):
        """SAM's window_partition, the attention, window_unpartition."""
        B, g, _, d = x.shape
        n = -(-g // ws)
        x = F.pad(x, (0, 0, 0, n * ws - g, 0, n * ws - g))
        x = x.view(B, n, ws, n, ws, d).permute(0, 1, 3, 2, 4, 5).reshape(
            B * n * n, ws, ws, d)
        x = self.attention(p, pre, x)
        x = x.view(B, n, n, ws, ws, d).permute(0, 1, 3, 2, 4, 5).reshape(
            B, n * ws, n * ws, d)
        return x[:, :g, :g]

    def encoder(self, p: Params, x):
        cfg = self.cfg
        e = "image_encoder."
        x = self.conv(p, e + "patch_embed.proj", x, stride=cfg["patch_size"])
        x = x.permute(0, 2, 3, 1) + p[e + "pos_embed"]
        for i in range(cfg["depth"]):
            pre = f"{e}blocks.{i}."
            h = self.ln(p, pre + "norm1", x)
            ws = cfg["window_size"]
            if ws and i not in cfg["global_attn_indexes"]:
                x = x + self.windowed(p, pre + "attn.", h, ws)
            else:
                x = x + self.attention(p, pre + "attn.", h)
            h = self.ln(p, pre + "norm2", x)
            x = x + self.linear(p, pre + "mlp.lin2", F.gelu(
                self.linear(p, pre + "mlp.lin1", h)))
        x = x.permute(0, 3, 1, 2)
        x = self.ln2d(p, e + "neck.1", self.conv(p, e + "neck.0", x))
        return self.ln2d(p, e + "neck.3",
                         self.conv(p, e + "neck.2", x, padding=1))

    # --- decoder ----------------------------------------------------------

    def deconv_block(self, p: Params, name: str, x):
        x = self.conv_t(p, name + "block.0.block", x)
        x = self.conv(p, name + "block.1.block", x, padding=1)
        return torch.relu(self.batch_norm(p, name + "block.2", x))

    def conv_block(self, p: Params, name: str, x):
        x = torch.relu(self.conv(p, name + "block.1", self.instance_norm(x),
                                 padding=1))
        return torch.relu(self.conv(p, name + "block.4",
                                    self.instance_norm(x), padding=1))

    @torch.no_grad()
    def __call__(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        z = self.encoder(p, x)
        z9 = self.deconv_block(p, "deconv1.", z)
        z6 = self.deconv_block(p, "deconv2.", z9)
        z3 = self.deconv_block(p, "deconv3.", z6)
        z0 = self.deconv_block(p, "deconv4.", z3)
        y = self.conv_block(p, "base.", z)
        for lvl, skip in enumerate((z9, z6, z3)):
            y = self.conv_t(p, f"decoder.samplers.{lvl}.block", y)
            y = self.conv_block(p, f"decoder.blocks.{lvl}.",
                                torch.cat([y, skip], dim=1))
        y = self.conv_t(p, "deconv_out.block", y)
        y = self.conv_block(p, "decoder_head.", torch.cat([y, z0], dim=1))
        return torch.sigmoid(self.conv(p, "out_conv", y))
