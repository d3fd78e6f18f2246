"""U-Net architectures: single-decoder UNet and dual-decoder DUNet.

Encoder filters double f0 -> f1 (default 64 -> 1024, five levels), with
strided-conv or max pooling between levels, transposed-conv upsampling,
skip concatenation and 1x1 output convs.  DUNet shares the encoder between
two decoders: decoder 1 regresses the neighbor/border distance, decoder 2 the
cell distance.

The public ``forward`` takes and returns the JAX package's layout, NHWC
``(B, H, W, C)`` float32, and works in NCHW inside.  ``state_dict`` keys are
the reference's (``encoderConv.{i}.conv.{j}``, ``pooling.{i}.conv_pool.{j}``,
``decoder{1,2}Upconv.{i}.up.0`` / ``.norm``, ``decoder{1,2}Conv.{i}``, a
trailing 1x1 conv; ``decoderUpconv`` / ``decoderConv`` for UNet).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from microbeseg_torch.config import ModelConfig
from microbeseg_torch.models.blocks import (
    ConvBlock,
    ConvPool,
    TranspConvBlock,
    max_pool_2x2,
)


def _level_features(filters: Tuple[int, int]) -> List[int]:
    feats = [filters[0]]
    while feats[-1] < filters[1]:
        feats.append(feats[-1] * 2)
    return feats


def _decoder(feats: List[int], ch_out: int, act_fun: str,
             normalization: str) -> Tuple[nn.ModuleList, nn.ModuleList]:
    ups = nn.ModuleList([TranspConvBlock(f, f // 2, normalization)
                         for f in reversed(feats[1:])])
    convs = nn.ModuleList([ConvBlock(f, f // 2, act_fun, normalization)
                           for f in reversed(feats[1:])])
    convs.append(nn.Conv2d(feats[0], ch_out, 1))
    return ups, convs


class UNet(nn.Module):
    """Single-decoder U-Net; ch_out=3 for the 3-class boundary method."""

    def __init__(self, ch_in: int = 1, ch_out: int = 3,
                 pool_method: str = "conv", act_fun: str = "relu",
                 normalization: str = "bn",
                 filters: Tuple[int, int] = (64, 1024)):
        super().__init__()
        feats = _level_features(filters)
        self.pool_method = pool_method
        self.encoderConv = nn.ModuleList(
            [ConvBlock(ch_in if i == 0 else feats[i - 1], f, act_fun,
                       normalization) for i, f in enumerate(feats)])
        if pool_method == "conv":
            self.pooling = nn.ModuleList(
                [ConvPool(f, act_fun, normalization) for f in feats[:-1]])
        self._init_decoders(feats, ch_out, act_fun, normalization)

    def _init_decoders(self, feats, ch_out, act_fun, normalization):
        self.decoderUpconv, self.decoderConv = _decoder(
            feats, ch_out, act_fun, normalization)

    def _encode(self, x):
        skips = []
        for i, block in enumerate(self.encoderConv[:-1]):
            x = block(x)
            skips.append(x)
            x = (self.pooling[i](x) if self.pool_method == "conv"
                 else max_pool_2x2(x))
        return self.encoderConv[-1](x), skips[::-1]

    @staticmethod
    def _decode(x, skips, ups, convs):
        for up, conv, skip in zip(ups, convs[:-1], skips):
            x = conv(torch.cat([up(x), skip], 1))
        return convs[-1](x)

    @staticmethod
    def _nhwc_in(x):
        return x.permute(0, 3, 1, 2)

    @staticmethod
    def _nhwc_out(y):
        return y.float().permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, ch_in) -> (B, H, W, ch_out) float32."""
        x, skips = self._encode(self._nhwc_in(x))
        return self._nhwc_out(
            self._decode(x, skips, self.decoderUpconv, self.decoderConv))


class DUNet(UNet):
    """Shared-encoder, dual-decoder U-Net for the distance method.

    Returns (border_pred, cell_pred), each (B, H, W, 1) float32."""

    def __init__(self, ch_in: int = 1, ch_out: int = 1,
                 pool_method: str = "conv", act_fun: str = "relu",
                 normalization: str = "bn",
                 filters: Tuple[int, int] = (64, 1024)):
        super().__init__(ch_in, ch_out, pool_method, act_fun, normalization,
                         filters)

    def _init_decoders(self, feats, ch_out, act_fun, normalization):
        self.decoder1Upconv, self.decoder1Conv = _decoder(
            feats, ch_out, act_fun, normalization)
        self.decoder2Upconv, self.decoder2Conv = _decoder(
            feats, 1, act_fun, normalization)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x, skips = self._encode(self._nhwc_in(x))
        border = self._decode(x, skips, self.decoder1Upconv,
                              self.decoder1Conv)
        cell = self._decode(x, skips, self.decoder2Upconv, self.decoder2Conv)
        return self._nhwc_out(border), self._nhwc_out(cell)


def build_unet(cfg: ModelConfig) -> UNet:
    """Model factory: DUNet for unet_type 'DU', UNet for 'U'."""
    cls = DUNet if cfg.unet_type == "DU" else UNet
    return cls(ch_in=cfg.ch_in, ch_out=cfg.ch_out,
               pool_method=cfg.pool_method, act_fun=cfg.act_fun,
               normalization=cfg.normalization, filters=tuple(cfg.filters))
