"""The (D)U-Net of microbeSEG as plain functions over a state dict.

Follows hip-satomi/microbeSEG ``src/utils/unets.py``: five levels of
filters 64 -> 1024 (doubling), each ``ConvBlock`` = [3x3 conv -> act ->
norm] x 2, strided 3x3 conv pooling (conv -> act -> norm), 2x2 stride-2
transposed-conv upsampling followed by a norm, skip concatenation, a 1x1
output conv.  The DUNet shares its encoder between two decoders: decoder 1
regresses the neighbour (border) distance, decoder 2 the cell distance.
The state dict keys are the reference's.

``quant`` is an optional operand rounding ``(tensor, role) -> tensor``
applied to every convolution's input and weight, which is how the
lower-precision control computes the same network.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def level_features(filters) -> List[int]:
    feats = [int(filters[0])]
    while feats[-1] < int(filters[1]):
        feats.append(feats[-1] * 2)
    return feats


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "relu":
        return F.relu(x)
    if name == "mish":
        return x * torch.tanh(F.softplus(x))
    raise ValueError(f"unsupported activation {name!r}")


def _norm(p: Params, key: str, x: torch.Tensor, kind: str,
          train: bool) -> torch.Tensor:
    if kind == "gn":
        return F.group_norm(x, 8, p[key + ".weight"], p[key + ".bias"],
                            eps=1e-5)
    if kind == "bn":
        if train:
            raise ValueError("the reference runs BatchNorm in eval mode only")
        return F.batch_norm(x, p[key + ".running_mean"],
                            p[key + ".running_var"], p[key + ".weight"],
                            p[key + ".bias"], training=False, eps=1e-5)
    raise ValueError(f"unsupported normalization {kind!r}")


class Net:
    """The network of a configuration dict (``unet_type``, ``act_fun``,
    ``normalization``, ``pool_method``, ``filters``, ``ch_in``,
    ``ch_out``) over a state dict."""

    def __init__(self, cfg: dict, quant: Optional[Callable] = None):
        if cfg["pool_method"] != "conv":
            raise ValueError("the reference implements conv pooling only")
        self.cfg = cfg
        self.feats = level_features(cfg["filters"])
        self.q = quant or (lambda t, role: t)

    def _conv(self, p, key, x, stride=1, padding=1):
        w = self.q(p[key + ".weight"], "weight")
        return F.conv2d(self.q(x, "input"), w, p[key + ".bias"],
                        stride=stride, padding=padding)

    def _block(self, p, key, x, train):
        a, n = self.cfg["act_fun"], self.cfg["normalization"]
        x = _norm(p, key + ".conv.2", _act(self._conv(p, key + ".conv.0", x),
                                           a), n, train)
        return _norm(p, key + ".conv.5", _act(self._conv(p, key + ".conv.3",
                                                         x), a), n, train)

    def _decode(self, p, name, x, skips, train):
        n = self.cfg["normalization"]
        for i, skip in enumerate(skips):
            up = F.conv_transpose2d(
                self.q(x, "input"), self.q(p[f"{name}Upconv.{i}.up.0.weight"],
                                           "weight"),
                p[f"{name}Upconv.{i}.up.0.bias"], stride=2)
            up = _norm(p, f"{name}Upconv.{i}.norm", up, n, train)
            x = self._block(p, f"{name}Conv.{i}", torch.cat([up, skip], 1),
                            train)
        return self._conv(p, f"{name}Conv.{len(skips)}", x, padding=0)

    def __call__(self, p: Params, x: torch.Tensor, train: bool = False
                 ) -> Tuple[torch.Tensor, ...]:
        """(B, 1, H, W) float32 -> DUNet: (border, cell), each (B, H, W);
        UNet: (B, ch_out, H, W)."""
        skips = []
        for i in range(len(self.feats)):
            x = self._block(p, f"encoderConv.{i}", x, train)
            if i < len(self.feats) - 1:
                skips.append(x)
                x = _norm(p, f"pooling.{i}.conv_pool.2", _act(
                    self._conv(p, f"pooling.{i}.conv_pool.0", x, stride=2),
                    self.cfg["act_fun"]), self.cfg["normalization"], train)
        skips = skips[::-1]
        if self.cfg["unet_type"] == "DU":
            border = self._decode(p, "decoder1", x, skips, train)
            cell = self._decode(p, "decoder2", x, skips, train)
            return border[:, 0], cell[:, 0]
        return (self._decode(p, "decoder", x, skips, train),)


def state_shapes(cfg: dict) -> Dict[str, Tuple[str, tuple]]:
    """Every entry of the network's state dict, in order: name -> (kind,
    shape); kinds ``conv`` (out, in, kh, kw), ``convT`` (in, out, 2, 2),
    ``bias``, ``scale``, ``shift``, ``mean``, ``var``, ``count``."""
    out = {}
    norm = cfg["normalization"]

    def conv(key, ci, co, k=3):
        out[key + ".weight"] = ("conv", (co, ci, k, k))
        out[key + ".bias"] = ("bias", (co,))

    def norm_of(key, c):
        out[key + ".weight"] = ("scale", (c,))
        out[key + ".bias"] = ("shift", (c,))
        if norm == "bn":
            out[key + ".running_mean"] = ("mean", (c,))
            out[key + ".running_var"] = ("var", (c,))
            out[key + ".num_batches_tracked"] = ("count", ())

    def block(key, ci, co):
        conv(key + ".conv.0", ci, co)
        norm_of(key + ".conv.2", co)
        conv(key + ".conv.3", co, co)
        norm_of(key + ".conv.5", co)

    feats = level_features(cfg["filters"])
    for i, f in enumerate(feats):
        block(f"encoderConv.{i}", cfg["ch_in"] if i == 0 else feats[i - 1], f)
    for i, f in enumerate(feats[:-1]):
        conv(f"pooling.{i}.conv_pool.0", f, f)
        norm_of(f"pooling.{i}.conv_pool.2", f)
    heads = ([("decoder1", cfg["ch_out"]), ("decoder2", 1)]
             if cfg["unet_type"] == "DU" else [("decoder", cfg["ch_out"])])
    for name, ch_out in heads:
        for i, f in enumerate(reversed(feats[1:])):
            out[f"{name}Upconv.{i}.up.0.weight"] = ("convT", (f, f // 2, 2, 2))
            out[f"{name}Upconv.{i}.up.0.bias"] = ("bias", (f // 2,))
            norm_of(f"{name}Upconv.{i}.norm", f // 2)
        for i, f in enumerate(reversed(feats[1:])):
            block(f"{name}Conv.{i}", f, f // 2)
        conv(f"{name}Conv.{len(feats) - 1}", feats[0], ch_out, k=1)
    return out


def conv_layers(cfg: dict, h: int, w: int) -> List[Tuple[int, int, int, int,
                                                         int, int]]:
    """Every convolution of one forward on an (h, w) input as (out_h,
    out_w, c_in, c_out, kh, kw); transposed convolutions as the product
    they compute (each input pixel times a 2x2 kernel)."""
    feats = level_features(cfg["filters"])
    layers, sizes = [], []
    c = cfg["ch_in"]
    for i, f in enumerate(feats):
        layers += [(h, w, c, f, 3, 3), (h, w, f, f, 3, 3)]
        c = f
        if i < len(feats) - 1:
            sizes.append((h, w, f))
            h, w = (h + 1) // 2, (w + 1) // 2
            layers.append((h, w, f, f, 3, 3))
    heads = ([cfg["ch_out"], 1] if cfg["unet_type"] == "DU"
             else [cfg["ch_out"]])
    for ch_out in heads:
        hh, ww, cc = h, w, c
        for (sh, sw, f) in reversed(sizes):
            # transposed 2x2 stride 2: each of the hh * ww inputs times
            # (cc -> f) for each of the 4 taps
            layers.append((hh, ww, cc, f, 2, 2))
            layers += [(sh, sw, 2 * f, f, 3, 3), (sh, sw, f, f, 3, 3)]
            hh, ww, cc = sh, sw, f
        layers.append((hh, ww, cc, ch_out, 1, 1))
    return layers


def forward_flops(cfg: dict, h: int, w: int) -> int:
    """FLOPs of the convolutions of one forward on one (h, w) input, two
    per multiply-add."""
    return sum(2 * oh * ow * ci * co * kh * kw
               for oh, ow, ci, co, kh, kw in conv_layers(cfg, h, w))
