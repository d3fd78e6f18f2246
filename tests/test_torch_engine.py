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


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the cores, and
    the step loops here are thousands of small tensor operations."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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


@pytest.fixture(scope="module")
def boundary_checkpoint(tmp_path_factory):
    """A JAX-written 3-class U-Net checkpoint with numpy-drawn weights."""
    rng = np.random.default_rng(13)
    jcfg = JModelConfig(unet_type="U", ch_out=3, filters=(8, 16))
    variables = random_variables(jbuild(jcfg, dtype=jnp.float32), rng)
    path = tmp_path_factory.mktemp("ckpt_b")
    save_model(variables, TrainConfig(model=jcfg, label_type="boundary",
                                      loss="ce", run_name="bnd_01"), path)
    return path / "bnd_01"


def _both_engines(ckpt, **cfg):
    """The JAX engine (float32) and the port's CPU engine from one
    checkpoint, under the same InferConfig fields."""
    model, variables, tcfg = jload(ckpt, dtype=jnp.float32)
    jeng = JEngine(model, variables, tcfg.label_type, cfg=JInferConfig(**cfg))
    eng = InferenceEngine.from_checkpoint(ckpt, cfg=InferConfig(**cfg),
                                          device="cpu")
    return jeng, eng


def _thresholds(cell):
    return float(np.quantile(cell, 0.45)), float(np.quantile(cell, 0.85))


def _assert_masks_agree(ref, ours):
    """Per-frame IoU >= 0.99 (the bar of the JAX suite for a second
    implementation: ulp-level differences in the fields may move single
    boundary pixels)."""
    assert ours.dtype == np.uint16 and ours.shape == ref.shape
    for r, o in zip(ref, ours):
        assert len(np.unique(r)) > 2  # the masks hold instances
        assert masks_iou(r, o) >= 0.99


TILED = dict(use_tiling=True, tile_size=64, tile_overlap=16)


@pytest.mark.parametrize("shape", [(2, 160, 160), (3, 100, 150),
                                   (2, 40, 200)])
def test_tiled_predict_raw_matches_jax(checkpoint, shape):
    """Tile 64, overlap 16: square, ragged (3 frames, non-multiple sizes)
    and narrow (one side below the tile) frames.  atol 1e-4 at float32, as
    for the bucket path."""
    rng = np.random.default_rng(1)
    frames = np.stack([blob_sample(rng, max(shape[1:]), n_blobs=10)[0]
                       [:shape[1], :shape[2]] for _ in range(shape[0])])
    with jax.default_matmul_precision("highest"):
        jeng, eng = _both_engines(checkpoint, **TILED)
        ref = jeng.predict_raw(frames)
    ours = eng.predict_raw(frames)
    for o, r in zip(ours, ref):
        assert o.shape == frames.shape
        np.testing.assert_allclose(o, r, atol=1e-4, rtol=0)
    # tiles really differ from the whole-frame forward near the seams
    whole = InferenceEngine.from_checkpoint(checkpoint, device="cpu")
    assert np.abs(whole.predict_raw(frames)[1] - ours[1]).max() > 1e-4
    assert eng.oom_count == 0


def test_tiled_boundary_predict_raw_and_segment_match_jax(boundary_checkpoint):
    frames = _frames(n=2, size=100)
    with jax.default_matmul_precision("highest"):
        jeng, eng = _both_engines(boundary_checkpoint, **TILED)
        (ref,) = jeng.predict_raw(frames)
        ref_masks = jeng.segment(frames)
    (ours,) = eng.predict_raw(frames)
    assert ours.shape == (2, 100, 100, 3)
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ours.sum(-1), 1.0, atol=1e-5)
    masks = eng.segment(frames)
    assert masks.dtype == np.uint16 and masks.shape == frames.shape
    for r, o in zip(ref_masks, masks):
        assert masks_iou(r, o) >= 0.99
    # fed JAX's probabilities, the port's boundary method gives JAX's masks
    from microbeseg_torch.ops.postprocessing import boundary_postprocessing
    fed = boundary_postprocessing(torch.tensor(ref)).numpy()
    np.testing.assert_array_equal(fed, ref_masks)
    with pytest.raises(ValueError, match="distance models"):
        eng.segment_grid(frames[0], [(0.1, 0.45)])


def test_boundary_bucket_segment_matches_jax(boundary_checkpoint):
    """A boundary model on the bucket path; random weights give a class
    map without cells, so the argmax is steered by the frame itself."""
    frames = _frames(n=3, size=64)
    with jax.default_matmul_precision("highest"):
        jeng, eng = _both_engines(boundary_checkpoint)
        (ref,) = jeng.predict_raw(frames)
        ref_masks = jeng.segment(frames)
    (ours,) = eng.predict_raw(frames)
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)
    masks = eng.segment(frames)
    for r, o in zip(ref_masks, masks):
        assert masks_iou(r, o) >= 0.99


@pytest.mark.parametrize("cfg", [
    TILED, dict(scale_factor=0.5), dict(apply_clahe=True),
    dict(scale_factor=0.5, apply_clahe=True, **TILED)],
    ids=["tiled", "scaled", "clahe", "tiled-scaled-clahe"])
def test_segment_options_match_jax(checkpoint, cfg):
    """Tiled, scaled and CLAHE segment against the JAX engine from one
    checkpoint: predictions at atol 2e-3 (CLAHE's bfloat16 tables may round
    a mapping to the neighbouring step; without CLAHE the two agree to
    1e-4), masks at per-frame IoU >= 0.99."""
    frames = _frames(n=3, size=144)
    with jax.default_matmul_precision("highest"):
        jeng, eng = _both_engines(checkpoint, **cfg)
        border, cell = jeng.predict_raw(frames)
        th_cell, th_seed = _thresholds(cell)
        ref = jeng.segment(frames, th_cell=th_cell, th_seed=th_seed)
    pb, pc = eng.predict_raw(frames)
    atol = 2e-3 if cfg.get("apply_clahe") else 1e-4
    np.testing.assert_allclose(pc, cell, atol=atol, rtol=0)
    np.testing.assert_allclose(pb, border, atol=atol, rtol=0)
    ours = eng.segment(frames, th_cell=th_cell, th_seed=th_seed)
    _assert_masks_agree(ref, ours)
    assert eng.oom_count == 0


def test_segment_grid_matches_jax(checkpoint):
    frame = _frames(n=1, size=96)[0]
    with jax.default_matmul_precision("highest"):
        jeng, eng = _both_engines(checkpoint)
        border, cell = jeng.predict_raw(frame[None])
        pairs = [(float(np.quantile(cell, qc)), float(np.quantile(cell, qs)))
                 for qc in (0.45, 0.55) for qs in (0.80, 0.85)]
        ref = jeng.segment_grid(frame, pairs)
    ours = eng.segment_grid(frame, pairs)
    assert ours.shape == (4, 96, 96) and ours.dtype == np.uint16
    _assert_masks_agree(ref, ours)
    for (c, s), m in zip(pairs, ours):
        np.testing.assert_array_equal(
            m, eng.segment(frame, th_cell=c, th_seed=s))
    # fed JAX's predictions, the port's grid gives JAX's masks
    from microbeseg_torch.ops.postprocessing import (
        distance_postprocessing_grid)
    fed = distance_postprocessing_grid(torch.tensor(border[0]),
                                       torch.tensor(cell[0]), pairs).numpy()
    np.testing.assert_array_equal(fed, ref)


def test_segment_with_a_side_above_768_matches_jax(checkpoint):
    """A frame with a side above 768 (beyond K1) segments; on the CPU the
    flood is the watershed, as in the JAX package."""
    rng = np.random.default_rng(4)
    frames = np.concatenate([blob_sample(rng, 48, n_blobs=4)[0]
                             for _ in range(17)], axis=1)[None]
    assert frames.shape == (1, 48, 816)
    with jax.default_matmul_precision("highest"):
        jeng, eng = _both_engines(checkpoint)
        _, cell = jeng.predict_raw(frames)
        th_cell, th_seed = _thresholds(cell)
        ref = jeng.segment(frames, th_cell=th_cell, th_seed=th_seed)
    ours = eng.segment(frames, th_cell=th_cell, th_seed=th_seed)
    _assert_masks_agree(ref, ours)


def test_frames_beyond_the_bucket_table_tile(checkpoint):
    """A side above the largest pad bucket tiles without use_tiling."""
    eng = InferenceEngine.from_checkpoint(
        checkpoint, cfg=InferConfig(tile_size=64, tile_overlap=16),
        device="cpu")
    frames = np.zeros((1, 8, 8200), np.uint16)
    frames[0, :, ::7] = 500
    border, cell = eng.predict_raw(frames)
    assert cell.shape == (1, 8, 8200) and np.isfinite(cell).all()
    assert eng.segment(frames).shape == (1, 8, 8200)


def test_tiled_chunking_rule():
    """Frames per chunk and tiles per forward call at the sizes the card
    runs: 2048^2 at tile 512, overlap 64 is 25 tiles, 8 a call."""
    from microbeseg_torch.inference.tiling import tile_positions
    eng = InferenceEngine(torch.nn.Identity(), device="cpu")
    assert len(tile_positions(2048, 512, 64)) ** 2 == 25
    assert eng._device_batch(512, 512) == 8
    assert eng._device_batch(2048, 2048) == 1
    assert eng._seeds_cap(2048, 2048) == 16384
    assert eng._seeds_cap(4096, 4096) == 32768
    assert eng._scaled_hw(101, 64) == (101, 64)
    half = InferenceEngine(torch.nn.Identity(), device="cpu",
                           cfg=InferConfig(scale_factor=0.5))
    assert half._scaled_hw(101, 64) == (50, 32)
    assert eng._prep_chunk_cap(2048, 2048) == 1 << 30
    clahe = InferenceEngine(torch.nn.Identity(), device="cpu",
                            cfg=InferConfig(apply_clahe=True))
    assert clahe._prep_chunk_cap(2048, 2048) == 8


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
    """No InferConfig option is refused any more: each builds an engine."""
    for cfg in (InferConfig(scale_factor=0.5), InferConfig(apply_clahe=True),
                InferConfig(use_tiling=True), InferConfig(quantize=True)):
        InferenceEngine.from_checkpoint(checkpoint, cfg=cfg, device="cpu")


def test_quantized_engine_matches_jax(checkpoint):
    """``quantize=True`` on both engines from one checkpoint, on 256^2 blob
    frames (the size from which layers take the int8 path): both calibrate
    on the first 2 frames, and the masks reach per-frame IoU >= 0.99."""
    rng = np.random.default_rng(7)
    frames = np.stack([blob_sample(rng, 256, n_blobs=40)[0]
                       for _ in range(3)])
    with jax.default_matmul_precision("highest"):
        jeng, eng = _both_engines(checkpoint, quantize=True, batch_size=2)
        _, cell = jeng.predict_raw(frames)
        th_cell, th_seed = _thresholds(cell)
        ref = jeng.segment(frames, th_cell=th_cell, th_seed=th_seed)
    assert jeng._quant_calibrated and "quant" in jeng.variables
    ours = eng.segment(frames, th_cell=th_cell, th_seed=th_seed)
    assert eng._quant_shapes == {(256, 256)} and eng.oom_count == 0
    _assert_masks_agree(ref, ours)
    # the int8 layers are the ones JAX calibrated, with its maxima to 1e-3
    from microbeseg_torch.models.convert import act_amax_from_model
    got = act_amax_from_model(eng.models[0])
    want = jax.tree_util.tree_map(np.asarray, dict(jeng.variables["quant"]))
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-3)
    # int8 really ran: the predictions differ from the float32 engine's
    plain = InferenceEngine.from_checkpoint(checkpoint, device="cpu")
    assert np.abs(plain.predict_raw(frames[:1])[1]
                  - eng.predict_raw(frames[:1])[1]).max() > 1e-4


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
    # --sliding_window reaches the engine: tiles of 32 change the result's
    # path, the masks keep their shape
    out_t = tmp_path / "out_tiled"
    assert main(["-i", str(imgs), "-m", str(checkpoint), "-r", str(out_t),
                 "--device", "cpu", "--sliding_window", "--tile_size", "32",
                 "--tile_overlap", "8"]) == 0
    assert imread(out_t / "mask_stack_channel0.tif").shape == (2, 48, 48)


def test_cli_quantize_reaches_the_engine(checkpoint, tmp_path, monkeypatch):
    from microbeseg_torch.cli import infer_local
    from microbeseg_torch.utils.tiff import imread, imwrite

    engines = []
    real = infer_local.build_engine

    def spy(models, cfg, device=None):
        engines.append(real(models, cfg, device=device))
        return engines[-1]

    monkeypatch.setattr(infer_local, "build_engine", spy)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    imwrite(imgs / "a.tif", _frames(n=1, size=256)[0])
    out = tmp_path / "out"
    assert infer_local.main(["-i", str(imgs), "-m", str(checkpoint), "-r",
                             str(out), "--device", "cpu",
                             "--quantize"]) == 0
    assert engines[0].cfg.quantize
    assert engines[0]._quant_shapes == {(256, 256)}
    assert imread(out / "mask_a_channel0.tif").shape == (256, 256)
    with pytest.raises(ValueError, match="ensembles"):
        infer_local.main(["-i", str(imgs), "-m", str(checkpoint),
                          str(checkpoint), "-r", str(out), "--device", "cpu",
                          "--quantize"])


def test_port_imports_without_jax_or_the_jax_package():
    """Every module of microbeseg_torch imports in a fresh process where
    jax, flax, msgpack, triton, pandas and microbeseg_tpu cannot be
    imported (the GUI on the repo's fake Qt, installed first); and no
    source names them in an import."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'flax', 'msgpack', 'triton', 'pandas',\n"
        "          'microbeseg_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from tests import fake_qt\n"
        "fake_qt.install()\n"
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
    assert int(res.stdout.strip()) >= 30
    for mod in ("inference.tiling", "inference.label_types", "ops.resize",
                "ops.augment",
                "ops.kernels.matmul", "evaluation.metrics",
                "evaluation.evaluator", "cli.evaluate", "ops.morphology",
                "ops.edt", "ops.regionprops", "ops.labelgen",
                "training.workers", "ops.filters", "training.losses",
                "training.schedules", "training.optimizers", "training.data",
                "training.trainer", "cli.train", "client.contours",
                "client.native", "client.store", "client.workers",
                "cli.serve", "cli.infer_store", "models.torch_import",
                "utils.profiling", "parallel.mesh", "gui.app",
                "models.vit_sam", "models.unetr"):
        assert (REPO / "microbeseg_torch" / (mod.replace(".", "/") + ".py")
                ).is_file()
    banned = {"jax", "flax", "msgpack", "triton", "pandas", "microbeseg_tpu"}
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


@pytest.mark.parametrize("case", ["distance-bucket", "distance-tiled",
                                  "boundary-bucket", "boundary-tiled",
                                  "flows", "ais"])
def test_out_of_memory_gives_zero_fields_and_masks(request, monkeypatch,
                                                    case):
    """A forward that runs out of memory: each chunk's fields are all zero
    in the normal path's shapes, ``segment`` returns all-zero uint16 masks
    of the frames' shape, and ``oom_count`` rises by one a chunk (each
    chunk's first forward raises and ends the chunk)."""
    if case == "flows":
        from tests.test_torch_flows import INFER, seeded_frames, tiny_model
        engine = InferenceEngine(tiny_model()[0], "flows",
                                 cfg=InferConfig(**INFER, batch_size=2),
                                 device="cpu")
        frames = seeded_frames(2, 100, 4)
    elif case == "ais":
        from tests.test_torch_usam import INFER, seeded_frames, tiny_model
        engine = InferenceEngine(tiny_model()[0], "ais",
                                 cfg=InferConfig(**INFER, batch_size=2),
                                 device="cpu")
        frames = seeded_frames(2, 130, 4)
    else:
        kind, path = case.split("-")
        ckpt = request.getfixturevalue(
            "checkpoint" if kind == "distance" else "boundary_checkpoint")
        cfg = dict(TILED) if path == "tiled" else {}
        engine = InferenceEngine.from_checkpoint(
            ckpt, cfg=InferConfig(batch_size=2, **cfg), device="cpu")
        frames = _frames(3, 100 if path == "tiled" else 64)
    want = engine.predict_raw(frames)
    raised = []

    def out_of_memory(*args, **kwargs):
        raised.append(1)
        raise torch.cuda.OutOfMemoryError("out of memory")

    monkeypatch.setattr(engine, "_forward", out_of_memory)
    got = engine.predict_raw(frames)
    chunks = len(raised)
    assert chunks >= 2 and engine.oom_count == chunks
    assert [g.shape for g in got] == [w.shape for w in want]
    for g in got:
        assert g.dtype == np.float32 and not g.any()
    masks = engine.segment(frames)
    assert len(raised) == engine.oom_count == 2 * chunks
    assert masks.dtype == np.uint16 and masks.shape == frames.shape
    assert not masks.any()
