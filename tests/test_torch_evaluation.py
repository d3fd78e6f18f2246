"""Port vs JAX package: model evaluation.

Both ``Evaluator``s get the same predictions from one stub engine (an object
with ``predict_raw`` and ``label_type``, put in place of each package's
``InferenceEngine`` factory) and must write the same tree: equal mask and
raw TIFFs, byte-equal ``scores.csv`` and aggregated CSV, the same members of
``test_set.zip``.  The runs cover the distance threshold grid, one round of
refinement, the extra metrics, the boundary method, a second model joining
the aggregated table, a repeated model replacing its row, and a new test
set evicting the stale rows.  Then one run end to end from a small
checkpoint that both packages load, and the CLI.
"""

import hashlib
import importlib
import shutil
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from microbeseg_tpu.config import EvalConfig as JEvalConfig
from microbeseg_tpu.config import ModelConfig as JModelConfig
from microbeseg_tpu.config import TrainConfig
from microbeseg_tpu.models.io import save_model
from microbeseg_tpu.models.unet import build_unet as jbuild
from microbeseg_torch.cli import evaluate as cli_evaluate
from microbeseg_torch.config import EvalConfig
from microbeseg_torch.evaluation import evaluator as tev
from microbeseg_torch.evaluation.evaluator import Evaluator, _Table
from microbeseg_torch.inference.engine import InferenceEngine
from microbeseg_torch.ops.labelgen import boundary_label
from microbeseg_torch.utils.tiff import imread, imwrite
from scripts.parity_gate import blob_sample
from tests.oracles import distance_label_oracle
from tests.test_torch_models import random_variables

jev = importlib.import_module("microbeseg_tpu.evaluation.evaluator")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the cores, and
    the floods here are thousands of small tensor operations."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# test sets and the stub engine
# ---------------------------------------------------------------------------

def _test_set(root: Path, seed: int, names, shapes):
    """``root/test`` with img/mask TIFFs of blob frames cut to ``shapes``;
    returns {image bytes: (image, mask)}."""
    rng = np.random.default_rng(seed)
    (root / "test").mkdir(parents=True)
    frames = {}
    for name, (h, w) in zip(names, shapes):
        img, mask = blob_sample(rng, max(h, w), n_blobs=9)
        img, mask = img[:h, :w], mask[:h, :w]
        imwrite(root / "test" / f"img{name}.tif", img)
        imwrite(root / "test" / f"mask{name}.tif", mask)
        frames[img.tobytes()] = (img, mask)
    return frames


def _distance_maps(mask, rng):
    cell, nb = distance_label_oracle(mask, 8)
    noise = rng.normal(0, 0.04, (2,) + mask.shape).astype(np.float32)
    return nb + noise[0], cell + noise[1]


def _boundary_probs(mask, rng):
    classes = boundary_label(torch.from_numpy(mask.astype(np.int32))).numpy()
    logits = 4.0 * np.eye(3, dtype=np.float32)[classes]
    logits += rng.normal(0, 1.0, logits.shape).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


class StubEngine:
    """``predict_raw`` from per-frame predictions made once from the
    ground truth (looked up by the frame's bytes)."""

    def __init__(self, label_type, frames, seed):
        rng = np.random.default_rng(seed)
        self.label_type = label_type
        self.preds = {k: (_distance_maps(m, rng) if label_type == "distance"
                          else (_boundary_probs(m, rng),))
                      for k, (_, m) in frames.items()}
        self.calls = []

    def predict_raw(self, stack):
        self.calls.append(stack.shape)
        per_frame = [self.preds[f.tobytes()] for f in stack]
        return tuple(np.stack(p) for p in zip(*per_frame))


class StubFactory:
    """Takes the place of ``InferenceEngine`` in an evaluator module: the
    checkpoint's stem names the stub."""

    def __init__(self, stubs):
        self.stubs = stubs

    def from_checkpoint(self, model_path, cfg=None, **kw):
        return self.stubs[Path(model_path).stem]

    def from_checkpoints(self, paths, cfg=None, **kw):
        return self.stubs[Path(paths[0]).stem]


def _tree(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p
            for p in sorted(root.rglob("*")) if p.is_file()}


def _assert_same_tree(ref_root: Path, our_root: Path):
    ref, ours = _tree(ref_root), _tree(our_root)
    assert list(ours) == list(ref)
    for rel, p in ref.items():
        q = ours[rel]
        if p.suffix == ".tif":
            a, b = imread(p), imread(q)
            assert a.dtype == b.dtype, rel
            np.testing.assert_array_equal(b, a, err_msg=rel)
        elif p.suffix == ".zip":
            with zipfile.ZipFile(p) as za, zipfile.ZipFile(q) as zb:
                assert zb.namelist() == za.namelist(), rel
        else:
            assert q.read_bytes() == p.read_bytes(), rel
    return ref


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_data")
    frames_a = _test_set(root / "setA", 0, ["_00", "_01", "_02", "_03"],
                         [(64, 64), (48, 56), (64, 64), (48, 56)])
    frames_b = _test_set(root / "setB", 1, ["_10", "_11"],
                         [(64, 64), (64, 64)])
    frames = {**frames_a, **frames_b}
    stubs = {"dist_01": StubEngine("distance", frames, 3),
             "dist_02": StubEngine("distance", frames, 4),
             "bnd_01": StubEngine("boundary", frames, 5)}
    return root, stubs


# (test set, model stems, EvalConfig fields) of the runs, in order, into
# one results directory
RUNS = [
    ("setA", ["dist_01"], dict(refine_steps=1, save_raw_pred=True,
                               extra_metrics=("aji", "dice", "pq"))),
    ("setA", ["bnd_01"], dict(save_raw_pred=True)),
    ("setA", ["dist_02"], dict(th_cells=(0.2, 0.3), th_seeds=(0.5,),
                               extra_metrics=("pq",))),
    ("setA", ["dist_01"], dict()),
    ("setB", ["dist_02", "bnd_01"], dict(extra_metrics=("dice",))),
    ("setB", ["dist_01", "dist_02"], dict(ensemble=True)),
]


@pytest.fixture(scope="module")
def both_runs(data, tmp_path_factory):
    """Every run of RUNS through both evaluators; after each run, a copy of
    both output trees."""
    root, stubs = data
    out = tmp_path_factory.mktemp("eval_out")
    snapshots = []
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jev, "InferenceEngine", StubFactory(stubs))
        mp.setattr(tev, "InferenceEngine", StubFactory(stubs))
        for k, (test_set, models, fields) in enumerate(RUNS):
            trees, tables = {}, {}
            for side, ev in (
                    ("jax", jev.Evaluator(JEvalConfig(**fields))),
                    ("port", Evaluator(EvalConfig(**fields),
                                       device="cpu"))):
                res = out / side / "results" / "run"
                tables[side] = ev.evaluate(
                    root / test_set, res,
                    [root / "models" / f"{m}.ckpt" for m in models])
                trees[side] = out / side / "results"
            snap = out / f"snap{k}"
            for side, tree in trees.items():
                shutil.copytree(tree, snap / side)
            snapshots.append((snap, tables))
    finally:
        mp.undo()
    return snapshots


@pytest.mark.parametrize("k", range(len(RUNS)))
def test_evaluator_writes_the_jax_tree(both_runs, k):
    snap, tables = both_runs[k]
    files = _assert_same_tree(snap / "jax", snap / "port")
    agg = (snap / "port" / "run.csv").read_text()
    # the returned rows are the aggregated table's
    ref = tables["jax"]
    assert [r["model"] for r in tables["port"]] == list(ref["model"])
    assert list(tables["port"][0]) == list(ref.columns)
    assert agg.splitlines()[0] == ",".join(ref.columns)
    test_set, models, fields = RUNS[k]
    # an ensemble is one row and one directory, named after all members
    for m in ["+".join(models)] if fields.get("ensemble") else models:
        assert f"run/models_{m}/scores.csv" in files
        assert f"run/models_{m}/test_set.zip" in files
    if k == 0:
        # refinement added points between the grid's: the grid has 8
        # directories; the best one's masks and raws moved to the top
        assert "run/models_dist_01/mask_01.tif" in files
        assert "run/models_dist_01/raw_01.tif" in files
        assert agg.splitlines()[0].endswith(
            "aji (mean),dice (mean),pq (mean),test set version")
    if k == 1:
        # the boundary row's thresholds (-1) join a float column
        assert ",-1.0,-1.0," in agg
    if k == 4:
        # a new test set evicts the stale rows
        assert len(agg.splitlines()) == 3
    if k == 5:
        assert len(agg.splitlines()) == 4


def test_refinement_ran_and_grouped_by_shape(data, tmp_path):
    """The refine round evaluates the 3x3 neighbourhood of the best grid
    point; predict_raw runs once per frame shape and inference round."""
    root, stubs = data
    stub = stubs["dist_01"]
    stub.calls.clear()
    ev = Evaluator(EvalConfig(refine_steps=1), device="cpu")
    out = tmp_path / "out"
    out.mkdir()
    grid = [(c, s) for c in ev.cfg.th_cells for s in ev.cfg.th_seeds]
    ev._inference(stub, root / "setA" / "test", grid, out)
    ev._refine(stub, root / "setA" / "test", out, grid)
    assert sorted(stub.calls) == [(2, 48, 56), (2, 48, 56), (2, 64, 64),
                                  (2, 64, 64)]
    assert len([d for d in out.iterdir() if d.is_dir()]) > len(grid)


def test_csv_read_keeps_the_version_a_string(data, tmp_path):
    """A sha1 prefix made only of digits: pandas reads it back as an
    integer, so the JAX evaluator evicts that test set's rows as stale on
    its next run; the port reads it as the string it wrote and keeps
    them."""
    root, stubs = data
    k = next(k for k in range(100000)
             if hashlib.sha1(str([f"mask_{k}a", f"mask_{k}b"]).encode(
                 "UTF-8")).hexdigest()[:10].isdigit())
    frames = _test_set(tmp_path / "digits", 2, [f"_{k}a", f"_{k}b"],
                       [(64, 64), (64, 64)])
    factory = StubFactory({"dist_01": StubEngine("distance", frames, 6),
                           "dist_02": StubEngine("distance", frames, 7)})
    rows = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jev, "InferenceEngine", factory)
        mp.setattr(tev, "InferenceEngine", factory)
        for side, make in (("jax", lambda: jev.Evaluator()),
                           ("port", lambda: Evaluator(device="cpu"))):
            for m in ("dist_01", "dist_02"):
                rows[side] = make().evaluate(
                    tmp_path / "digits", tmp_path / side / "run",
                    [tmp_path / "models" / f"{m}.ckpt"])
    assert len(rows["jax"]) == 1
    assert [r["model"] for r in rows["port"]] == ["models: dist_01",
                                                  "models: dist_02"]
    table = _Table.read(tmp_path / "port" / "run.csv")
    assert table.kinds["test set version"] == "str"
    assert table.rows[0]["test set version"].isdigit()


def test_csv_floats_round_trip_as_pandas_reads_them(tmp_path):
    """pandas' default parser reads some 17-digit reprs an ulp off; the
    port reads them the same way, so rewritten rows stay byte-equal."""
    import pandas as pd

    rng = np.random.default_rng(9)
    vals = [float(v) for v in rng.random(2000)] + [0.0, -1.0, 1e-05]
    path = tmp_path / "t.csv"
    path.write_text("a,b\n" + "".join(f"{v!r},x{i}\n"
                                       for i, v in enumerate(vals)))
    table = _Table.read(path)
    ref = pd.read_csv(path)["a"].to_numpy()
    np.testing.assert_array_equal([r["a"] for r in table.rows], ref)
    assert any(r["a"] != v for r, v in zip(table.rows, vals))
    table.write(tmp_path / "u.csv")
    ref_out = tmp_path / "v.csv"
    pd.read_csv(path).to_csv(ref_out, header=True, index=False)
    assert (tmp_path / "u.csv").read_bytes() == ref_out.read_bytes()


# ---------------------------------------------------------------------------
# end to end from a checkpoint, and the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A JAX-written distance DUNet (filters (8, 16)) with averaging
    kernels, so that its fields follow the blobs."""
    rng = np.random.default_rng(21)
    jcfg = JModelConfig(filters=(8, 16))
    variables = random_variables(jbuild(jcfg, dtype=jnp.float32), rng)

    def averaging(path, leaf):
        if not jax.tree_util.keystr(path).endswith("['kernel']"):
            return leaf
        k = np.abs(leaf)
        return (k / k.sum(axis=(0, 1, 2), keepdims=True)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(averaging, variables)
    path = tmp_path_factory.mktemp("eval_ckpt")
    save_model(variables, TrainConfig(model=jcfg, run_name="evalnet_01"),
               path)
    return path / "evalnet_01.ckpt"


def test_evaluate_end_to_end_from_a_checkpoint(data, checkpoint, tmp_path):
    """Both evaluators load the checkpoint themselves (the JAX engine in
    bfloat16, the port's on the CPU in float32): the same artifacts and the
    same best thresholds, on a grid spread over the fields' range."""
    root, _ = data
    eng = InferenceEngine.from_checkpoint(checkpoint, device="cpu")
    stack = np.stack([imread(p) for p in sorted(
        (root / "setB" / "test").glob("img*.tif"))])
    _, cell = eng.predict_raw(stack)
    lo, hi = np.quantile(cell, 0.5), np.quantile(cell, 0.99)
    cfg = dict(th_cells=(round(float(lo + 0.3 * (hi - lo)), 4),),
               th_seeds=tuple(round(float(lo + f * (hi - lo)), 4)
                              for f in (0.55, 0.95)))
    rows = {}
    for side, ev in (("jax", jev.Evaluator(JEvalConfig(**cfg))),
                     ("port", Evaluator(EvalConfig(**cfg), device="cpu"))):
        rows[side] = ev.evaluate(root / "setB", tmp_path / side / "run",
                                 [checkpoint])
    ours, ref = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert list(ours) == list(ref)
    ref_th = (float(rows["jax"]["th_cell"].iloc[0]),
              float(rows["jax"]["th_seed"].iloc[0]))
    assert (rows["port"][0]["th_cell"], rows["port"][0]["th_seed"]) == ref_th
    assert rows["port"][0]["aji+ (mean)"] > 0.0
    masks = imread(tmp_path / "port" / "run" /
                   f"{checkpoint.parent.name}_evalnet_01" / "mask_10.tif")
    assert masks.dtype == np.uint16 and masks.max() >= 1


def test_cli_evaluate(data, checkpoint, tmp_path, capsys):
    root, _ = data
    assert cli_evaluate.main([
        "-d", str(root / "setB"), "-m", str(checkpoint), "-r",
        str(tmp_path / "res"), "--th_cells", "0.1", "--th_seeds", "0.3",
        "0.5", "--metrics", "pq", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"{checkpoint.parent.name}: evalnet_01" in out
    assert "pq (mean)" in out and (tmp_path / "res.csv").is_file()
    assert (tmp_path / "res" / f"{checkpoint.parent.name}_evalnet_01" /
            "scores.csv").is_file()
    # too few test images: exit 1
    (tmp_path / "empty" / "test").mkdir(parents=True)
    assert cli_evaluate.main(["-d", str(tmp_path / "empty"), "-m",
                              str(checkpoint), "-r", str(tmp_path / "r2"),
                              "--device", "cpu"]) == 1


def test_evaluator_needs_the_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Evaluator()
