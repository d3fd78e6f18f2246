"""Reference ``.pth`` + ``.json`` pairs through the port's
``models/torch_import.py`` against the JAX package's, on the CPU.

A reference-layout state_dict with numpy-drawn values, imported by both
packages, gives the same flax variable tree bit for bit, for DU / U x bn /
gn x relu / mish.  Exported back from one ``.ckpt``, both packages write
equal ``.pth`` tensors and the same JSON, and the tensors are the ones
imported.
"""

import json

import numpy as np
import pytest
import torch

from microbeseg_tpu.models import torch_import as jti
from microbeseg_torch.config import ModelConfig
from microbeseg_torch.models import torch_import as tti
from microbeseg_torch.models.io import load_variables
from microbeseg_torch.models.unet import build_unet

_CASES = [(u, n, a) for u in ("DU", "U") for n in ("bn", "gn")
          for a in ("relu", "mish")]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _reference_pair(tmp_path, unet_type, norm, act, seed, prefix=""):
    """A ``.pth`` in the reference's layout (the port's model has its keys
    and shapes) with numpy-drawn values, and its sidecar."""
    label_type = "distance" if unet_type == "DU" else "boundary"
    arch = [unet_type, "conv", act, norm, [8, 16]]
    model = build_unet(ModelConfig.from_architecture(arch, label_type))
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[prefix + k] = torch.tensor(int(rng.integers(0, 99)))
        elif k.endswith("running_var"):
            sd[prefix + k] = torch.from_numpy(
                rng.uniform(0.5, 2.0, v.shape).astype(np.float32))
        else:
            sd[prefix + k] = torch.from_numpy(
                rng.standard_normal(v.shape).astype(np.float32))
    pth = tmp_path / f"{label_type}_ref_{unet_type}{norm}{act}.pth"
    torch.save(sd, pth)
    pth.with_suffix(".json").write_text(json.dumps({
        "architecture": arch, "label_type": label_type, "loss": "smooth_l1",
        "optimizer": "ranger", "batch_size": 8}))
    return pth, sd


@pytest.mark.parametrize("unet_type,norm,act", _CASES)
def test_import_matches_jax_bit_for_bit(tmp_path, unet_type, norm, act):
    pth, _ = _reference_pair(tmp_path, unet_type, norm, act, seed=len(act),
                             prefix="module." if norm == "bn" else "")
    ours = tti.import_torch_checkpoint(pth, tmp_path / "torch", device="cpu")
    ref = jti.import_torch_checkpoint(pth, tmp_path / "jax")
    assert ours.name == ref.name == pth.stem + ".ckpt"
    a, b = _flat(load_variables(ours)), _flat(load_variables(ref))
    assert sorted(a) == sorted(b) and len(a) > 20
    for k in b:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    side = json.loads(ours.with_suffix(".json").read_text())
    assert side["architecture"] == [unet_type, "conv", act, norm, [8, 16]]
    assert side["imported_from"] == str(pth) and side["batch_size"] == 8


@pytest.mark.parametrize("unet_type,norm,act", _CASES[::3])
def test_export_matches_jax(tmp_path, unet_type, norm, act):
    """From one ``.ckpt`` (written by the port's import): equal ``.pth``
    tensors and JSON from both packages, and the tensors imported."""
    pth, sd = _reference_pair(tmp_path, unet_type, norm, act, seed=3)
    ckpt = tti.import_torch_checkpoint(pth, tmp_path / "ckpt", device="cpu")
    ours = tti.export_torch_checkpoint(ckpt, tmp_path / "torch",
                                       device="cpu")
    ref = jti.export_torch_checkpoint(ckpt, tmp_path / "jax")
    assert ours.name == ref.name == pth.name
    a = torch.load(ours, weights_only=True)
    b = torch.load(ref, weights_only=True)
    assert sorted(a) == sorted(b) == sorted(
        k for k in sd if not k.endswith("num_batches_tracked")
        or norm == "bn")
    for k in b:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(a[k], sd[k]), k
    assert (ours.with_suffix(".json").read_text()
            == ref.with_suffix(".json").read_text())


def test_import_refuses_a_mismatched_architecture(tmp_path):
    pth, sd = _reference_pair(tmp_path, "DU", "gn", "relu", seed=1)
    sd.pop("encoderConv.0.conv.0.bias")
    torch.save(sd, pth)
    with pytest.raises(RuntimeError, match="Missing key"):
        tti.import_torch_checkpoint(pth, tmp_path / "out", device="cpu")
    assert not (tmp_path / "out" / (pth.stem + ".ckpt")).exists()


def test_entry_points_need_the_card_or_device_cpu(tmp_path, monkeypatch):
    pth, _ = _reference_pair(tmp_path, "U", "gn", "mish", seed=2)
    ckpt = tti.import_torch_checkpoint(pth, tmp_path / "ckpt", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tti.import_torch_checkpoint(pth, tmp_path / "out")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tti.export_torch_checkpoint(ckpt, tmp_path / "out")
