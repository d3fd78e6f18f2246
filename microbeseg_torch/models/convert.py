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
``variables_from_state_dict`` is the inverse, for writing a checkpoint the
JAX package reads.

``act_amax_to_model`` and ``act_amax_from_model`` carry the int8 activation
maxima (flax's ``quant`` collection, one ``act_amax`` per calibrated
``QuantConv``) into the port's layers and back, so both sides can run from
the same scales.
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


def variables_from_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The flax ``{'params', 'batch_stats'}`` tree (nested dicts of float32
    numpy arrays) of a ``models.unet`` ``state_dict``: every transform of
    ``state_dict_from_variables`` undone.  ``batch_stats`` is left out when
    the model has no batch norm, as flax leaves it out."""
    def arr(key: str) -> np.ndarray:
        return sd[key].detach().cpu().numpy().astype(np.float32)

    def conv(key: str) -> dict:
        return {"kernel": np.ascontiguousarray(
            arr(f"{key}.weight").transpose(2, 3, 1, 0)),
            "bias": arr(f"{key}.bias")}

    def conv_t(key: str) -> dict:
        k = arr(f"{key}.weight").transpose(2, 3, 0, 1)[::-1, ::-1]
        return {"kernel": np.ascontiguousarray(k), "bias": arr(f"{key}.bias")}

    def norm(key: str, name: str, params: dict, stats: dict) -> None:
        if f"{key}.weight" not in sd:     # instance norm: no parameters
            return
        inner = ("BatchNorm_0" if f"{key}.running_mean" in sd
                 else "GroupNorm_0")
        params[name] = {inner: {"scale": arr(f"{key}.weight"),
                                "bias": arr(f"{key}.bias")}}
        if inner == "BatchNorm_0":
            stats[name] = {inner: {"mean": arr(f"{key}.running_mean"),
                                   "var": arr(f"{key}.running_var")}}

    def conv_block(key: str):
        params, stats = {"conv0": conv(f"{key}.conv.0")}, {}
        norm(f"{key}.conv.2", "norm0", params, stats)
        params["conv1"] = conv(f"{key}.conv.3")
        norm(f"{key}.conv.5", "norm1", params, stats)
        return params, stats

    def put(tree: dict, name: str, sub: dict) -> None:
        if sub:
            tree[name] = sub

    params: Dict[str, Any] = {"encoder": {}}
    stats: Dict[str, Any] = {"encoder": {}}
    depth = 1 + max(int(k.split(".")[1]) for k in sd
                    if k.startswith("encoderConv."))
    for i in range(depth):
        p, st = conv_block(f"encoderConv.{i}")
        params["encoder"][f"enc{i}"] = p
        put(stats["encoder"], f"enc{i}", st)
        if f"pooling.{i}.conv_pool.0.weight" in sd:
            p, st = {"conv": conv(f"pooling.{i}.conv_pool.0")}, {}
            norm(f"pooling.{i}.conv_pool.2", "norm", p, st)
            params["encoder"][f"pool{i}"] = p
            put(stats["encoder"], f"pool{i}", st)
    heads = ([("decoder", "decoderUpconv", "decoderConv")]
             if "decoderConv.0.conv.0.weight" in sd else
             [("decoder1", "decoder1Upconv", "decoder1Conv"),
              ("decoder2", "decoder2Upconv", "decoder2Conv")])
    for ours, up_key, conv_key in heads:
        params[ours], stats[ours] = {}, {}
        for i in range(depth - 1):
            p, st = {"up": conv_t(f"{up_key}.{i}.up.0")}, {}
            norm(f"{up_key}.{i}.norm", "norm", p, st)
            params[ours][f"up{i}"] = p
            put(stats[ours], f"up{i}", st)
            p, st = conv_block(f"{conv_key}.{i}")
            params[ours][f"dec{i}"] = p
            put(stats[ours], f"dec{i}", st)
        params[ours]["out"] = conv(f"{conv_key}.{depth - 1}")
    stats = {k: v for k, v in stats.items() if v}
    return {"params": params, **({"batch_stats": stats} if stats else {})}


def _quant_module_name(top: str, block: str, conv: str) -> str:
    """flax path (encoder | decoder[12], enc<i> | dec<i>, conv0 | conv1) ->
    the port's module name of that convolution."""
    blocks = "encoderConv" if top == "encoder" else f"{top}Conv"
    return f"{blocks}.{block[3:]}.conv.{0 if conv == 'conv0' else 3}"


def act_amax_to_model(model: torch.nn.Module, quant: Dict[str, Any]) -> None:
    """Set each layer named in the flax ``quant`` collection calibrated,
    with the collection's ``act_amax``."""
    for top, blocks in quant.items():
        for block, convs in blocks.items():
            for conv, leaf in convs.items():
                layer = model.get_submodule(
                    _quant_module_name(top, block, conv))
                layer.act_amax = _f32(leaf["act_amax"]).to(layer.act_amax)
                layer.calibrated = True


def act_amax_from_model(model: torch.nn.Module) -> Dict[str, Any]:
    """The flax ``quant`` collection of the port's calibrated layers."""
    tops = {"encoderConv": "encoder", "decoderConv": "decoder",
            "decoder1Conv": "decoder1", "decoder2Conv": "decoder2"}
    quant: Dict[str, Any] = {}
    for name, layer in model.named_modules():
        if not getattr(layer, "calibrated", False):
            continue
        blocks, idx, _, pos = name.split(".")
        top = tops[blocks]
        block = ("enc" if top == "encoder" else "dec") + idx
        quant.setdefault(top, {}).setdefault(block, {})[
            "conv0" if pos == "0" else "conv1"] = {
                "act_amax": np.float32(layer.act_amax.item())}
    return quant
