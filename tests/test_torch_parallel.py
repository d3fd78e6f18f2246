"""Data parallelism in the port, on the CPU (mirrors ``tests/test_parallel.py``).

Training: 2 gloo ranks (spawned processes, ``tests/torch_dp_workers.py``)
against the one-process trainer from the same weights and draws, at the
JAX suite's tolerances for its mesh 8 against mesh 1 (loss ``rtol=1e-5``;
gradients and BatchNorm statistics ``rtol=1e-3, atol=1e-5``), and the
port's 2 ranks against JAX's ``get_mesh(2)`` step within 1e-5.
Inference: an engine on a mesh of 2 CPU replicas against no mesh (maps
within 1e-5, masks equal), and ``Evaluator(mesh=)``.  Every group joins
through a ``file://`` rendezvous under ``tmp_path`` and is terminated if it
runs past its time limit.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from microbeseg_tpu.config import ModelConfig as JModelConfig
from microbeseg_tpu.models.unet import build_unet as jbuild
from microbeseg_tpu.ops.augment import augment_batch as jaugment_batch
from microbeseg_tpu.parallel import mesh as jmesh
from microbeseg_tpu.training import losses as jl
from microbeseg_torch.config import EvalConfig, InferConfig, ModelConfig
from microbeseg_torch.config import TrainConfig
from microbeseg_torch.evaluation import evaluator as tev
from microbeseg_torch.inference.engine import InferenceEngine
from microbeseg_torch.models.blocks import CrossReplicaBatchNorm2d, QuantConv
from microbeseg_torch.models.convert import variables_from_state_dict
from microbeseg_torch.models.unet import build_unet
from microbeseg_torch.ops.augment import apply_params, draw_params, take_params
from microbeseg_torch.parallel import mesh
from microbeseg_torch.training.data import (SplitArrays, TrainingData,
                                            epoch_batches)
from microbeseg_torch.training.trainer import Trainer, init_like_flax
from tests import torch_dp_workers as W
from tests.test_torch_engine import TILED, _frames, _thresholds, checkpoint  # noqa: F401
from tests.test_torch_evaluation import data  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 120.0


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; each rank here
    takes 2 threads too."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _toy_data(rng, n=8, size=16):
    images = rng.integers(0, 65535, (n, size, size, 1)).astype(np.float32)
    labels = {
        "border_label": rng.random((n, size, size, 1)).astype(np.float32),
        "cell_label": rng.random((n, size, size, 1)).astype(np.float32)}
    split = SplitArrays(images=images, labels=labels,
                        ids=[str(i) for i in range(n)])
    return TrainingData(train=split, val=split, crop_size=size)


def _cfg(norm="gn", **kw):
    base = dict(model=ModelConfig(filters=(8, 16), act_fun="mish",
                                  normalization=norm),
                optimizer="adam", batch_size=8, run_name="dp_model_01",
                max_epochs=20, compute_dtype="float32", seed=42)
    base.update(kw)
    return TrainConfig(**base)


def _ranks(fn, args, tmp_path, world=2):
    """``fn`` on ``world`` spawned gloo ranks; what each rank saved."""
    out = tmp_path / "ranks"
    out.mkdir()
    mesh.spawn(fn, (world, mesh.file_init_method(out), str(out), *args),
               world, timeout_s=RANK_TIMEOUT_S)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _assert_step_equal(ref, got):
    loss, grads, stats = ref
    assert np.isclose(got[0], loss, rtol=1e-5)
    assert set(got[1]) == set(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(got[1][k], g, rtol=1e-3, atol=1e-5)
    assert set(got[2]) == set(stats)
    for k, s in stats.items():
        np.testing.assert_allclose(got[2][k], s, rtol=1e-3, atol=1e-5)


# ---------------------------------------------------------------------------
# training: 2 ranks against 1
# ---------------------------------------------------------------------------

def _step_cases():
    """{name: (cfg, images, labels, weights, state, augmentation draw)}:
    one full step batch of 8 for 'gn' and 'bn', and the ragged tail of an
    epoch (2 real samples, 2 wrapped slots of weight 0; rank 1 holds only
    padding)."""
    cases = {}
    for norm in ("gn", "bn"):
        d = _toy_data(np.random.default_rng(42))
        cfg = _cfg(norm)
        cases[norm] = (cfg, d.train.images, d.train.labels,
                       np.ones(8, np.float32),
                       init_like_flax(build_unet(cfg.model), 7).state_dict(),
                       draw_params(torch.Generator().manual_seed(11), 8, 16))
    d = _toy_data(np.random.default_rng(43), n=6)
    cfg = _cfg("bn", batch_size=4)
    idx, w = list(epoch_batches(6, 4, np.random.default_rng(3),
                                shuffle=True))[-1]
    cases["ragged"] = (cfg, d.train.images[idx],
                       {k: v[idx] for k, v in d.train.labels.items()}, w,
                       init_like_flax(build_unet(cfg.model), 2).state_dict(),
                       draw_params(torch.Generator().manual_seed(5), 4, 16))
    return cases


def _jax_case():
    """A batch of 4 (one slot of weight 0) already augmented by JAX's
    ``augment_batch``, as a step case without a draw."""
    d = _toy_data(np.random.default_rng(21), n=4)
    cfg = _cfg("bn", batch_size=4)
    aug_img, aug_lab = jaugment_batch(
        jax.random.PRNGKey(9), jnp.asarray(d.train.images),
        {k: jnp.asarray(v) for k, v in d.train.labels.items()})
    return (cfg, np.array(aug_img),
            {k: np.array(v) for k, v in aug_lab.items()},
            np.array([1, 1, 1, 0], np.float32),
            init_like_flax(build_unet(cfg.model), 4).state_dict(), None)


def _train_case():
    """The training protocol on 8 images of 16^2, 'bn'."""
    return _cfg("bn"), _toy_data(np.random.default_rng(44))


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Every step case and the training case on 2 ranks in one group, and
    on 1 process."""
    cases = {**_step_cases(), "jax": _jax_case()}
    tmp = tmp_path_factory.mktemp("steps")
    ranks = _ranks(W.grad_rank, (cases, _train_case()), tmp)
    one = {name: W.grad_step(Trainer(cfg, tmp / "one", device="cpu"), *args)
           for name, (cfg, *args) in cases.items()}
    cfg, d = _train_case()
    one["train"] = []
    Trainer(cfg, tmp / "train", device="cpu",
            text_output=one["train"].append).train(d)
    return cases, one, ranks


@pytest.mark.parametrize("norm", ["gn", "bn"])
def test_single_step_two_ranks_match_one(steps, norm):
    """ONE augmented step (the global batch's draw, each rank applying its
    slice) on 2 ranks gives the loss, the gradients and, for 'bn', the
    global-batch running statistics of the 1-process step."""
    _, one, ranks = steps
    ref = one[norm]
    assert bool(ref[2]) == (norm == "bn")
    for got in ranks:
        _assert_step_equal(ref, got[norm])
    for k in ranks[0][norm][1]:   # DDP leaves every rank the same gradient
        torch.testing.assert_close(ranks[1][norm][1][k],
                                   ranks[0][norm][1][k], rtol=0, atol=0)


def test_ragged_batch_two_ranks_match_one(steps):
    """The ragged tail (weights 1, 1, 0, 0): the step equals the 1-process
    step, whose loss is the mean over the 2 real samples."""
    cases, one, ranks = steps
    np.testing.assert_array_equal(cases["ragged"][3], [1, 1, 0, 0])
    for got in ranks:
        _assert_step_equal(one["ragged"], got["ragged"])


def test_epoch_loss_history_two_ranks_match_one(steps):
    """The training protocol ('bn': synced statistics, the precise-BN pass
    before every validation, the validation loss summed over the ranks):
    the first loss lines at reporting precision, as the JAX suite holds
    mesh 8 against mesh 1."""
    _, one, ranks = steps
    ref = [m.split(":", 1)[1] for m in one["train"] if "Loss" in m][:3]
    assert len(ref) == 3
    for got in ranks:
        assert [m.split(":", 1)[1] for m in got["train"]
                if "Loss" in m][:3] == ref


def test_batch_split_over_devices(monkeypatch):
    """``pad_batch_to_devices`` as JAX's; a step batch's rank slices are
    contiguous and cover it; ``batch_sharding`` gives one contiguous share
    per device; ``replicated_sharding`` one copy per device; ``get_mesh``
    counts CPU replicas and refuses more cards than there are."""
    for n in range(1, 20):
        for k in (1, 2, 3, 8):
            assert (mesh.pad_batch_to_devices(n, k)
                    == jmesh.pad_batch_to_devices(n, k))
    tr = Trainer.__new__(Trainer)
    tr.world = 4
    slices = []
    for r in range(4):
        tr.rank = r
        slices.append(tr._rank_slice(mesh.pad_batch_to_devices(6, 4)))
    assert slices == [(0, 2), (2, 4), (4, 6), (6, 8)]
    m = mesh.get_mesh(3, device="cpu")
    assert m.size == 3
    assert mesh.get_mesh(device="cpu").size == 1
    x = torch.arange(8 * 4).view(8, 4)
    shares = mesh.batch_sharding(m, x)
    assert [s.shape[0] for s in shares] == [3, 3, 2]
    torch.testing.assert_close(torch.cat(shares), x)
    mod = torch.nn.Linear(2, 2)
    reps = mesh.replicated_sharding(m, mod)
    assert reps[0] is mod and len({id(r) for r in reps}) == 3
    for r in reps[1:]:
        torch.testing.assert_close(r.weight, mod.weight)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh.get_mesh().devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        mesh.get_mesh(2)


def test_take_params_slices_a_global_draw(rng):
    """Augmenting a rank's slice with ``take_params`` of the global draw
    gives that slice of the globally augmented batch, noise images
    included."""
    d = _toy_data(rng, n=8, size=16)
    images = torch.from_numpy(d.train.images)
    labels = {k: torch.from_numpy(v) for k, v in d.train.labels.items()}
    p = draw_params(torch.Generator().manual_seed(1), 8, 16)
    assert 0 < int(p["do_noise"].sum()) < 8
    full_img, full_lab = apply_params(images, labels, p)
    for lo, hi in ((0, 4), (4, 8), (2, 5)):
        img, lab = apply_params(images[lo:hi],
                                {k: v[lo:hi] for k, v in labels.items()},
                                take_params(p, lo, hi))
        torch.testing.assert_close(img, full_img[lo:hi], rtol=0, atol=1e-6)
        for k in lab:
            torch.testing.assert_close(lab[k], full_lab[k][lo:hi], rtol=0,
                                       atol=1e-6)


def test_cross_replica_bn_is_batchnorm_outside_a_group():
    """Outside a process group 'bn' builds ``nn.BatchNorm2d`` (state-dict
    keys as before), and the cross-replica class computes exactly what
    ``nn.BatchNorm2d`` computes."""
    model = build_unet(ModelConfig(filters=(8, 16), normalization="bn"))
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert bns and all(type(m) is torch.nn.BatchNorm2d for m in bns)
    x = torch.randn(3, 8, 5, 5)
    a, b = torch.nn.BatchNorm2d(8), CrossReplicaBatchNorm2d(8)
    b.load_state_dict(a.state_dict())
    torch.testing.assert_close(b(x), a(x), rtol=0, atol=0)
    assert list(b.state_dict()) == list(a.state_dict())


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_two_rank_gradients_match_jax_mesh2(steps):
    """One batch augmented by JAX's ``augment_batch``; JAX's gradient of
    the weighted mean loss on ``get_mesh(2)`` (the batch sharded, the 'bn'
    statistics global) against the port's 2 ranks from the same weights:
    every gradient within 1e-5."""
    cases, _, ranks = steps
    _, images, labels, w, state, _ = cases["jax"]
    jmodel = jbuild(JModelConfig(filters=(8, 16), act_fun="mish",
                                 normalization="bn"), dtype=jnp.float32)
    variables = variables_from_state_dict(state)
    batch_loss = jl.get_batch_loss("smooth_l1", "distance")
    m2 = jmesh.get_mesh(2)
    bsh, rsh = jmesh.batch_sharding(m2), jmesh.replicated_sharding(m2)

    def grad_step(params, bs, images, labels, weights):
        def losses(p):
            preds, _ = jmodel.apply({"params": p, "batch_stats": bs}, images,
                                    train=True, mutable=["batch_stats"])
            return (batch_loss(preds, labels, weights)
                    / jnp.maximum(jnp.sum(weights), 1.0))
        return jax.grad(losses)(params)

    with jax.default_matmul_precision("highest"):
        step = jax.jit(grad_step, in_shardings=(rsh, rsh, bsh, bsh, bsh),
                       out_shardings=rsh)
        want = step(variables["params"], variables["batch_stats"],
                    jnp.asarray(images),
                    {k: jnp.asarray(v) for k, v in labels.items()},
                    jnp.asarray(w))
    flat_w = jax.tree_util.tree_leaves(want)
    for got in ranks:
        grads = variables_from_state_dict({**state, **got["jax"][1]})[
            "params"]
        flat_g = jax.tree_util.tree_leaves(grads)
        assert len(flat_w) == len(flat_g) > 0
        for a, b in zip(flat_w, flat_g):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0,
                                       atol=1e-5)


# ---------------------------------------------------------------------------
# inference and evaluation on a mesh of CPU replicas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [dict(batch_size=2), TILED],
                         ids=["bucket", "tiled"])
def test_engine_mesh_of_two_cpu_replicas(checkpoint, cfg):  # noqa: F811
    """The bucket path (5 frames of 64^2 in device batches of 2 x 2, the
    tail padded) and the tiled path (2 frames of 160^2, tile 64): maps
    within 1e-5, masks equal and holding instances; ``segment_grid``'s
    pairs split over the devices give the same masks."""
    one = InferenceEngine.from_checkpoint(checkpoint, cfg=InferConfig(**cfg),
                                          device="cpu")
    two = InferenceEngine.from_checkpoint(checkpoint, cfg=InferConfig(**cfg),
                                          mesh=mesh.get_mesh(2, device="cpu"))
    assert len(two._replicas) == 2
    assert two._replicas[1][0] is not two._replicas[0][0]
    frames = (_frames(n=5, size=64) if "tile_size" not in cfg
              else _frames(n=2, size=160))
    h, w = frames.shape[1:]
    assert two._device_batch(h, w) == 2 * one._device_batch(h, w)
    a, b = one.predict_raw(frames), two.predict_raw(frames)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, rtol=0, atol=1e-5)
    th_cell, th_seed = _thresholds(a[1])
    ma = one.segment(frames, th_cell, th_seed)
    mb = two.segment(frames, th_cell, th_seed)
    np.testing.assert_array_equal(mb, ma)
    assert all(len(np.unique(m)) > 2 for m in ma)
    pairs = [(th_cell, th_seed), (th_cell, 0.5 * (th_cell + th_seed)),
             (0.9 * th_cell, th_seed)]
    np.testing.assert_array_equal(two.segment_grid(frames[0], pairs),
                                  one.segment_grid(frames[0], pairs))


def test_int8_mesh_replicas_share_one_calibration(checkpoint):  # noqa: F811
    """``quantize`` on a mesh of 2: one calibration, the same activation
    scales in every replica, and the masks of the one-device int8
    engine."""
    cfg = InferConfig(batch_size=1, quantize=True)
    one = InferenceEngine.from_checkpoint(checkpoint, cfg=cfg, device="cpu")
    two = InferenceEngine.from_checkpoint(checkpoint, cfg=cfg,
                                          mesh=mesh.get_mesh(2, device="cpu"))
    frames = _frames(n=2, size=256)
    th_cell, th_seed = _thresholds(one.predict_raw(frames)[1])
    ma = one.segment(frames, th_cell, th_seed)
    mb = two.segment(frames, th_cell, th_seed)
    q = [[m for m in reps[0].modules() if isinstance(m, QuantConv)]
         for reps in two._replicas]
    assert sum(m.calibrated for m in q[0]) >= 2
    for a, b in zip(*q):
        assert b.calibrated == a.calibrated and b is not a
        torch.testing.assert_close(b.act_amax, a.act_amax, rtol=0, atol=0)
    np.testing.assert_array_equal(mb, ma)


def test_evaluator_passes_its_mesh_to_the_engines(data, checkpoint,  # noqa: F811
                                                  tmp_path, monkeypatch):
    """``Evaluator(mesh=)`` builds its engines on that mesh, and scores as
    the evaluator without one."""
    root, _ = data
    seen = []
    real = tev.InferenceEngine.from_checkpoint.__func__

    def recording(cls, path, cfg=None, device=None, mesh=None):
        seen.append(mesh)
        return real(cls, path, cfg=cfg, device=device, mesh=mesh)

    monkeypatch.setattr(tev.InferenceEngine, "from_checkpoint",
                        classmethod(recording))
    m2 = mesh.get_mesh(2, device="cpu")
    ecfg = EvalConfig(th_cells=(0.1,), th_seeds=(0.3, 0.45))
    rows = tev.Evaluator(ecfg, mesh=m2).evaluate(
        root / "setB", tmp_path / "mesh", [checkpoint])
    ref = tev.Evaluator(ecfg, device="cpu").evaluate(
        root / "setB", tmp_path / "one", [checkpoint])
    assert seen == [m2, None]
    assert rows == ref


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_train_two_cpu_ranks(tmp_path):
    """``cli.train --num_devices 2 --device cpu`` trains the full-width
    model on 2 gloo ranks (one epoch on 2 + 2 crops of 32^2): rank 0's
    messages reach the terminal, and the checkpoint, sidecar, loss history
    and trainset zip are written once."""
    from tests.test_torch_training import _trainset

    root = _trainset(tmp_path, np.random.default_rng(3))
    code = ("import sys, torch\n"
            "torch.set_num_threads(2)\n"
            "from microbeseg_torch.cli import train\n"
            "sys.exit(train.main(sys.argv[1:]))\n")
    res = subprocess.run(
        [sys.executable, "-c", code, "--train_dir", str(root),
         "--max_epochs", "1", "--model_path", str(tmp_path / "models"),
         "--device", "cpu", "--num_devices", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "1 / 1: Loss train / val:" in res.stdout
    assert "Train/validate on 2/2 images" in res.stdout
    out = tmp_path / "models" / "trainset"
    for name in ("distance_model_01.ckpt", "distance_model_01.json",
                 "distance_model_01_loss.txt",
                 "distance_model_01_trainset.zip"):
        assert (out / name).is_file(), name
    assert not list(out.glob("distance_model_02*"))
