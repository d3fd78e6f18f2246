"""Port vs JAX end to end: both engines from one checkpoint written by the
JAX package, on the synthetic blobs of ``scripts/parity_gate.py``; plus the
port's import isolation, its refusal to fall back to the CPU silently, and
its inference CLI.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from microbeseg_tpu.config import InferConfig as JInferConfig
from microbeseg_tpu.config import ModelConfig as JModelConfig
from microbeseg_tpu.config import TrainConfig
from microbeseg_tpu.inference.engine import InferenceEngine as JEngine
from microbeseg_tpu.models.io import load_model as jload, save_model
from microbeseg_tpu.models.unet import build_unet as jbuild
from microbeseg_torch.config import InferConfig
from microbeseg_torch.inference.engine import InferenceEngine
from microbeseg_torch.ops.postprocessing import distance_postprocessing
from scripts.parity_gate import blob_sample
from tests.oracles import masks_iou
from tests.test_torch_models import random_variables

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A JAX-written checkpoint with numpy-drawn weights.  Every kernel is
    made non-negative and normalised to sum 1 per output channel, so each
    conv is a weighted average: random signed kernels turn the blobs into
    speckle that the seed prune removes entirely, averaging kernels give
    smooth fields that follow the blobs."""
    rng = np.random.default_rng(12)
    jcfg = JModelConfig(filters=(8, 16))
    variables = random_variables(jbuild(jcfg, dtype=jnp.float32), rng)

    def averaging(path, leaf):
        if not jax.tree_util.keystr(path).endswith("['kernel']"):
            return leaf
        k = np.abs(leaf)
        return (k / k.sum(axis=(0, 1, 2), keepdims=True)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(averaging, variables)
    path = tmp_path_factory.mktemp("ckpt")
    save_model(variables, TrainConfig(model=jcfg, run_name="port_01"), path)
    return path / "port_01"


def _frames(n=4, size=64):
    rng = np.random.default_rng(0)
    return np.stack([blob_sample(rng, size, n_blobs=8)[0] for _ in range(n)])


def test_engine_end_to_end_matches_jax(checkpoint):
    frames = _frames()
    model, variables, tcfg = jload(checkpoint, dtype=jnp.float32)
    with jax.default_matmul_precision("highest"):
        jeng = JEngine(model, variables, tcfg.label_type, cfg=JInferConfig())
        border, cell = jeng.predict_raw(frames)
        th_cell = float(np.quantile(cell, 0.45))
        th_seed = float(np.quantile(cell, 0.85))
        ref = jeng.segment(frames, th_cell=th_cell, th_seed=th_seed)

    eng = InferenceEngine.from_checkpoint(checkpoint, device="cpu")
    ours = eng.segment(frames, th_cell=th_cell, th_seed=th_seed)
    assert ours.dtype == np.uint16 and ours.shape == frames.shape
    for r, o in zip(ref, ours):
        assert len(np.unique(r)) > 2  # the masks hold instances
        assert masks_iou(r, o) >= 0.99
    assert eng.oom_count == 0

    # fed the JAX predictions, the port's post-processing gives JAX's masks
    fed = distance_postprocessing(torch.tensor(border),
                                  torch.tensor(cell), th_seed, th_cell)
    np.testing.assert_array_equal(fed.numpy(), ref)

    # the port's own predictions agree with JAX's at f32
    pb, pc = eng.predict_raw(frames)
    np.testing.assert_allclose(pc, cell, atol=1e-4, rtol=0)
    np.testing.assert_allclose(pb, border, atol=1e-4, rtol=0)


def test_engine_tta_and_ensemble(checkpoint):
    """TTA averages 8 dihedral variants on square frames; an ensemble of
    one model twice equals the model alone."""
    frames = _frames(n=2)
    single = InferenceEngine.from_checkpoint(checkpoint, device="cpu")
    pair = InferenceEngine.from_checkpoints([checkpoint, checkpoint],
                                            device="cpu")
    np.testing.assert_allclose(pair.predict_raw(frames)[1],
                               single.predict_raw(frames)[1], atol=1e-6)
    model, variables, tcfg = jload(checkpoint, dtype=jnp.float32)
    with jax.default_matmul_precision("highest"):
        jt = JEngine(model, variables, tcfg.label_type,
                     cfg=JInferConfig(tta=True)).predict_raw(frames)
    tta = InferenceEngine.from_checkpoint(checkpoint, cfg=InferConfig(tta=True),
                                          device="cpu").predict_raw(frames)
    np.testing.assert_allclose(tta[1], jt[1], atol=1e-4, rtol=0)


def test_engine_unported_options_raise(checkpoint):
    for cfg in (InferConfig(scale_factor=0.5), InferConfig(apply_clahe=True),
                InferConfig(quantize=True), InferConfig(use_tiling=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            InferenceEngine.from_checkpoint(checkpoint, cfg=cfg, device="cpu")
    eng = InferenceEngine.from_checkpoint(checkpoint, device="cpu")
    with pytest.raises(NotImplementedError, match="tiled"):
        eng.segment(np.zeros((1, 8, 9000), np.uint16))


def test_no_silent_cpu(checkpoint, monkeypatch):
    """Without CUDA and without device='cpu' the entry points raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine.from_checkpoint(checkpoint)
    net = InferenceEngine.from_checkpoint(checkpoint, device="cpu").models[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(net)


def test_cli_infer_local(checkpoint, tmp_path):
    from microbeseg_torch.cli.infer_local import main
    from microbeseg_torch.utils.tiff import imread, imwrite

    frames = _frames(n=2, size=48)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    imwrite(imgs / "a.tif", frames[0])
    imwrite(imgs / "stack.tif", frames)
    out = tmp_path / "out"
    assert main(["-i", str(imgs), "-m", str(checkpoint), "-r", str(out),
                 "--device", "cpu"]) == 0
    a = imread(out / "mask_a_channel0.tif")
    stack = imread(out / "mask_stack_channel0.tif")
    assert a.shape == (48, 48) and a.dtype == np.uint16
    assert stack.shape == (2, 48, 48)
    np.testing.assert_array_equal(stack[0], a)


def test_port_imports_without_jax_or_the_jax_package():
    """Every module of microbeseg_torch imports in a fresh process where
    jax, flax, msgpack, triton and microbeseg_tpu cannot be imported; and no
    source names them in an import."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'flax', 'msgpack', 'triton', 'microbeseg_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import microbeseg_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    microbeseg_torch.__path__, 'microbeseg_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'PIL' not in sys.modules\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15
    banned = {"jax", "flax", "msgpack", "triton", "microbeseg_tpu"}
    pattern = re.compile(r"^\s*(?:from\s+(\S+)\s+import|import\s+(.+))")
    for src in [*(REPO / "microbeseg_torch").rglob("*.py"),
                REPO / "chip_smoke.py"]:
        for line in src.read_text().splitlines():
            m = pattern.match(line)
            if m:
                mods = [m.group(1)] if m.group(1) else [
                    part.split()[0] for part in m.group(2).split(",")]
                roots = {mod.split(".")[0] for mod in mods}
                assert not roots & banned, f"{src}: {line}"
