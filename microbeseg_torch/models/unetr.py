"""muSAM's automatic instance segmentation network: SAM's ViT image encoder
and torch_em's UNETR decoder, three sigmoid fields per pixel.

Sources: Archit, Freckmann, Nair et al., "Segment Anything for Microscopy"
(Nature Methods 22, 2025), computational-cell-analytics/micro-sam
``micro_sam/instance_segmentation.py::get_unetr`` (``use_skip_connection=
False``, ``out_channels=3``, ``final_activation="Sigmoid"``), which builds
constantpape/torch-em ``torch_em/model/unetr.py::UNETR`` on the encoder of
``models/vit_sam.py`` (``build_sam_encoder``).  With F = decoder_features
(512, 256, 128, 64 published), E = neck_dim and z the encoder's (B, E, G,
G) output:

    z9 = deconv1(z)  E -> F1      z6 = deconv2(z9)  F1 -> F2
    z3 = deconv3(z6) F2 -> F3     z0 = deconv4(z3)  F3 -> F3
    x = base(z)                   ConvBlock2d E -> F0, at G x G
    x = decoder(x, [z9, z6, z3])  level i: samplers.i (F_i -> F_i+1), then
                                  blocks.i (2 F_i+1 -> F_i+1) on the
                                  concatenation with the level's z
    x = deconv_out(x)             F3 -> F3, at 16 G
    x = decoder_head(cat[x, z0])  ConvBlock2d 2 F3 -> F3
    y = sigmoid(out_conv(x))      1x1, F3 -> out_channels

(2 F_i+1 is torch_em's F_i at the published widths.)  A ``Deconv2DBlock``
is a transposed convolution 2 x 2 with stride 2 and a bias, a 3 x 3
convolution with a bias, BatchNorm and ReLU; a ``ConvBlock2d`` is
InstanceNorm (no affine, ``InstanceNorm``), 3 x 3 convolution, ReLU,
InstanceNorm, 3 x 3 convolution, ReLU; every sampler and ``deconv_out`` a transposed
convolution 2 x 2 with stride 2.  The module names are torch_em's, the
encoder's SAM's (``image_encoder.*``).  The decoder runs under the span
``mseg.unetr.decoder``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from microbeseg_torch.config import MicroSAMConfig
from microbeseg_torch.models.vit_sam import build_sam_encoder
from microbeseg_torch.utils.profiling import span


class SingleDeconv2DBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.block = nn.ConvTranspose2d(cin, cout, 2, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class SingleConv2DBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.block = nn.Conv2d(cin, cout, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class Deconv2DBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.block = nn.Sequential(
            SingleDeconv2DBlock(cin, cout), SingleConv2DBlock(cout, cout),
            nn.BatchNorm2d(cout), nn.ReLU(inplace=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class InstanceNorm(nn.Module):
    """``nn.InstanceNorm2d`` without affine (eps 1e-5) in the input's own
    memory layout.  A low-precision input (bf16 under autocast, no grad):
    its mean and mean square over (H, W) accumulate in float32 straight
    from the input, and one pass writes (x - mean) / sqrt(var + eps) in its
    dtype; float32 (or a graph to differentiate): two passes in float32.  ``nn.InstanceNorm2d`` copies a
    channels-last input to NCHW and back, four passes more over the
    decoder's largest activations."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = (2, 3)
        if x.dtype == torch.float32 or (torch.is_grad_enabled()
                                        and x.requires_grad):
            var, mean = torch.var_mean(x.float(), dim=dims, correction=0,
                                       keepdim=True)
            return ((x - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)
        mean = x.mean(dim=dims, keepdim=True, dtype=torch.float32)
        sq = torch.linalg.vector_norm(x, dim=dims, keepdim=True,
                                      dtype=torch.float32)
        var = sq.square() / (x.shape[2] * x.shape[3]) - mean.square()
        rstd = torch.rsqrt(var.clamp_min(0) + self.eps)
        # computed in float32, written once in x's dtype and layout
        return torch.addcmul(-mean * rstd, x, rstd,
                             out=torch.empty_like(x))


class ConvBlock2d(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.block = nn.Sequential(
            InstanceNorm(), nn.Conv2d(cin, cout, 3, padding=1),
            nn.ReLU(inplace=True), InstanceNorm(),
            nn.Conv2d(cout, cout, 3, padding=1), nn.ReLU(inplace=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class Decoder(nn.Module):
    def __init__(self, features: Sequence[int]):
        super().__init__()
        pairs = list(zip(features[:-1], features[1:]))
        self.blocks = nn.ModuleList(ConvBlock2d(2 * o, o) for _, o in pairs)
        self.samplers = nn.ModuleList(SingleDeconv2DBlock(i, o)
                                      for i, o in pairs)

    def forward(self, x: torch.Tensor, skips) -> torch.Tensor:
        for block, sampler, z in zip(self.blocks, self.samplers, skips):
            x = block(torch.cat([sampler(x), z], dim=1))
        return x


class MicroSAMAIS(nn.Module):
    """(B, ch_in, img_size, img_size) SAM-normalised tiles -> (B,
    out_channels, img_size, img_size) in [0, 1]: foreground, centre
    distance, boundary distance."""

    def __init__(self, cfg: MicroSAMConfig = MicroSAMConfig()):
        super().__init__()
        self.cfg = cfg
        f, e = tuple(cfg.decoder_features), cfg.neck_dim
        self.image_encoder = build_sam_encoder(cfg)
        self.decoder = Decoder(f)
        self.deconv1 = Deconv2DBlock(e, f[1])
        self.deconv2 = Deconv2DBlock(f[1], f[2])
        self.deconv3 = Deconv2DBlock(f[2], f[3])
        self.deconv4 = Deconv2DBlock(f[3], f[3])
        self.base = ConvBlock2d(e, f[0])
        self.out_conv = nn.Conv2d(f[3], cfg.out_channels, 1)
        self.deconv_out = SingleDeconv2DBlock(f[3], f[3])
        self.decoder_head = ConvBlock2d(2 * f[3], f[3])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = self.image_encoder(x)
        with span("mseg.unetr.decoder"):
            z9 = self.deconv1(z)
            z6 = self.deconv2(z9)
            z3 = self.deconv3(z6)
            z0 = self.deconv4(z3)
            y = self.decoder(self.base(z), [z9, z6, z3])
            y = self.decoder_head(torch.cat([self.deconv_out(y), z0], dim=1))
            return torch.sigmoid(self.out_conv(y))


def build_micro_sam_ais(cfg: MicroSAMConfig = MicroSAMConfig()
                        ) -> MicroSAMAIS:
    return MicroSAMAIS(cfg)
