"""Cellpose-SAM's forward in plain float32 PyTorch (MouseLand/cellpose
``cellpose/vit_sam.py::Transformer``, release 4, on SAM's ViT image
encoder, facebookresearch/segment-anything
``segment_anything/modeling/image_encoder.py``), from a dict of weights
under the published ``cpsam`` names.

On x (B, ch_in, S, S), G = S / patch_size tokens a side, D channels:
patch embedding (a convolution with kernel and stride patch_size) plus
pos_embed; ``depth`` blocks x = x + Attn(LN1(x)), x = x + MLP(LN2(x))
(LayerNorm eps 1e-6; MLP lin1, exact GELU, lin2); Attn builds the logits
explicitly, (q / sqrt(D / heads)) k^T plus SAM's ``add_decomposed_rel_pos``
term rel_h + rel_w from the unscaled q, then softmax, times v, heads
merged, proj; the neck Conv1x1 -> LayerNorm2d -> Conv3x3 -> LayerNorm2d
(SAM's LayerNorm2d: mean and biased variance over the channels, eps
1e-6); the readout Conv1x1 and the identity ``W2`` as Cellpose applies it,
``conv_transpose2d`` with stride patch_size.

Departures from the published model, which the configuration file lists:
the relative-position tables are held at 2G - 1 rows (Cellpose
interpolates the checkpoint's 127- and 27-row tables to 63 at each call);
a one-channel frame fills input channel 0 and channels 1 and 2 are 0.

``quant``: an optional rounding of the operands of every layer with
weights (the patch embedding, qkv, proj, lin1, lin2, the neck's
convolutions, the readout), ``quant(tensor, role)``: the lower-precision
control (``reference/lowp.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
EPS = 1e-6


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

    @staticmethod
    def ln(p: Params, name: str, x):
        return F.layer_norm(x, x.shape[-1:], p[name + ".weight"],
                            p[name + ".bias"], EPS)

    @staticmethod
    def ln2d(p: Params, name: str, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + EPS)
        return p[name + ".weight"][:, None, None] * x \
            + p[name + ".bias"][:, None, None]

    def attention(self, p: Params, pre: str, x):
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

    @torch.no_grad()
    def __call__(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        ps = cfg["patch_size"]
        x = self.conv(p, "encoder.patch_embed.proj", x, stride=ps)
        x = x.permute(0, 2, 3, 1) + p["encoder.pos_embed"]
        for i in range(cfg["depth"]):
            pre = f"encoder.blocks.{i}."
            x = x + self.attention(p, pre + "attn.",
                                   self.ln(p, pre + "norm1", x))
            h = self.ln(p, pre + "norm2", x)
            x = x + self.linear(p, pre + "mlp.lin2", F.gelu(
                self.linear(p, pre + "mlp.lin1", h)))
        x = x.permute(0, 3, 1, 2)
        x = self.ln2d(p, "encoder.neck.1", self.conv(p, "encoder.neck.0", x))
        x = self.ln2d(p, "encoder.neck.3",
                      self.conv(p, "encoder.neck.2", x, padding=1))
        x = self.conv(p, "out", x)
        n = cfg["nout"]
        w2 = torch.eye(n * ps * ps, device=x.device).reshape(
            n * ps * ps, n, ps, ps)
        return F.conv_transpose2d(x, w2, stride=ps)
