"""Carry the JAX package's weights across to the port.

``state_dict_from_variables`` turns a flax ``{'params', 'batch_stats'}`` tree
(nested dicts of numpy arrays, as ``models/io.load_model`` or a checkpoint
reader returns it) into a ``state_dict`` for ``models.unet``:

- Conv kernel (kH, kW, I, O) -> Conv2d weight (O, I, kH, kW);
- ConvTranspose kernel (kH, kW, I, O) -> ConvTranspose2d weight
  (I, O, kH, kW) with the spatial taps REVERSED: flax's ConvTranspose runs
  a zero-inserted forward conv with the unflipped kernel, torch's scatters
  weight patches;
- BatchNorm_0 {scale, bias} + batch_stats {mean, var} -> weight, bias,
  running_mean, running_var; GroupNorm_0 {scale, bias} -> weight, bias;
  instance norm carries no parameters on either side.

The architecture (depth, pooling, heads, norm kind) is read off the tree.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

_NORM_INNER = ("BatchNorm_0", "GroupNorm_0")


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def state_dict_from_variables(variables: Dict[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}

    def conv(key: str, tree: dict) -> None:
        sd[f"{key}.weight"] = _f32(
            np.asarray(tree["kernel"], np.float32).transpose(3, 2, 0, 1))
        sd[f"{key}.bias"] = _f32(tree["bias"])

    def conv_t(key: str, tree: dict) -> None:
        k = np.asarray(tree["kernel"], np.float32)[::-1, ::-1]
        sd[f"{key}.weight"] = _f32(k.transpose(2, 3, 0, 1))
        sd[f"{key}.bias"] = _f32(tree["bias"])

    def norm(key: str, tree_p: Optional[dict], tree_s: Optional[dict]) -> None:
        for inner in _NORM_INNER:
            if tree_p and inner in tree_p:
                sd[f"{key}.weight"] = _f32(tree_p[inner]["scale"])
                sd[f"{key}.bias"] = _f32(tree_p[inner]["bias"])
                if inner == "BatchNorm_0":
                    sd[f"{key}.running_mean"] = _f32(tree_s[inner]["mean"])
                    sd[f"{key}.running_var"] = _f32(tree_s[inner]["var"])
                    sd[f"{key}.num_batches_tracked"] = torch.tensor(0)

    def conv_block(key: str, tree_p: dict, tree_s: Optional[dict]) -> None:
        tree_s = tree_s or {}
        conv(f"{key}.conv.0", tree_p["conv0"])
        norm(f"{key}.conv.2", tree_p.get("norm0"), tree_s.get("norm0"))
        conv(f"{key}.conv.3", tree_p["conv1"])
        norm(f"{key}.conv.5", tree_p.get("norm1"), tree_s.get("norm1"))

    enc_p, enc_s = params["encoder"], stats.get("encoder", {})
    depth = sum(1 for k in enc_p if k.startswith("enc"))
    for i in range(depth):
        conv_block(f"encoderConv.{i}", enc_p[f"enc{i}"], enc_s.get(f"enc{i}"))
        if f"pool{i}" in enc_p:
            conv(f"pooling.{i}.conv_pool.0", enc_p[f"pool{i}"]["conv"])
            norm(f"pooling.{i}.conv_pool.2", enc_p[f"pool{i}"].get("norm"),
                 enc_s.get(f"pool{i}", {}).get("norm"))

    heads = ([("decoder", "decoderUpconv", "decoderConv")]
             if "decoder" in params else
             [("decoder1", "decoder1Upconv", "decoder1Conv"),
              ("decoder2", "decoder2Upconv", "decoder2Conv")])
    for ours, up_key, conv_key in heads:
        dec_p, dec_s = params[ours], stats.get(ours, {})
        for i in range(depth - 1):
            conv_t(f"{up_key}.{i}.up.0", dec_p[f"up{i}"]["up"])
            norm(f"{up_key}.{i}.norm", dec_p[f"up{i}"].get("norm"),
                 dec_s.get(f"up{i}", {}).get("norm"))
            conv_block(f"{conv_key}.{i}", dec_p[f"dec{i}"],
                       dec_s.get(f"dec{i}"))
        conv(f"{conv_key}.{depth - 1}", dec_p["out"])
    return sd
