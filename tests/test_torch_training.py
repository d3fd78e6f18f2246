"""Port vs JAX package: training (losses, schedules, the epoch budget,
batching, Ranger and AMSGrad against optax, one train step against JAX's
``model.apply`` + loss + ``tx.update``, precise BN), and the port's trainer,
``run_training`` and ``cli.train`` on the CPU.

Models are narrow (filters (8, 16)), crops 16^2 to 32^2, float32; JAX runs
under matmul precision 'highest'.  Each tolerance is stated with the value
these tests measured on the CPU.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
import optax

from microbeseg_tpu.config import ModelConfig as JModelConfig
from microbeseg_tpu.config import TrainConfig as JTrainConfig
from microbeseg_tpu.config import get_max_epochs as jget_max_epochs
from microbeseg_tpu.models.io import load_model as jload_model
from microbeseg_tpu.models.unet import build_unet as jbuild
from microbeseg_tpu.ops.augment import augment_batch as jaugment_batch
from microbeseg_tpu.training import losses as jl
from microbeseg_tpu.training import optimizers as jo
from microbeseg_tpu.training import schedules as js
from microbeseg_tpu.training.data import epoch_batches as jepoch_batches
from microbeseg_tpu.training.trainer import Trainer as JTrainer
from microbeseg_torch.cli import train as cli_train
from microbeseg_torch.config import ModelConfig, TrainConfig, get_max_epochs
from microbeseg_torch.models.convert import (
    state_dict_from_variables,
    variables_from_state_dict,
)
from microbeseg_torch.models.io import load_model
from microbeseg_torch.models.unet import build_unet
from microbeseg_torch.training import losses as tl
from microbeseg_torch.training import optimizers as to
from microbeseg_torch.training import schedules as ts
from microbeseg_torch.training import workers
from microbeseg_torch.training.data import (
    SplitArrays,
    TrainingData,
    epoch_batches,
)
from microbeseg_torch.training.trainer import Trainer, init_like_flax
from microbeseg_torch.utils.image import unique_path
from microbeseg_torch.utils.tiff import imwrite
from tests.conftest import synthetic_blobs

ARCH = dict(filters=(8, 16), act_fun="mish", normalization="gn")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


# --- losses ---------------------------------------------------------------

def _loss_inputs(seed, label_type):
    rng = np.random.default_rng(seed)
    if label_type == "distance":
        pred = tuple(rng.normal(0.3, 0.8, (3, 16, 16, 1)).astype(np.float32)
                     for _ in range(2))
        batch = {k: rng.uniform(0, 1, (3, 16, 16, 1)).astype(np.float32)
                 for k in ("border_label", "cell_label")}
    else:
        pred = rng.normal(0, 2, (3, 16, 16, 3)).astype(np.float32)
        batch = {"label": rng.integers(0, 3, (3, 16, 16, 1)).astype(np.int32)}
    return pred, batch


def _as(tensor_fn, tree):
    if isinstance(tree, tuple):
        return tuple(tensor_fn(t) for t in tree)
    if isinstance(tree, dict):
        return {k: tensor_fn(v) for k, v in tree.items()}
    return tensor_fn(tree)


@pytest.mark.parametrize("loss,label_type", [
    ("smooth_l1", "distance"), ("l1", "distance"), ("l2", "distance"),
    ("ce", "boundary"), ("ce_dice", "boundary")])
def test_losses_match_jax(loss, label_type):
    """``get_loss`` and ``get_batch_loss`` (one padded slot of weight 0)
    within 1e-6 relative (measured: at most 3.5e-7)."""
    pred, batch = _loss_inputs(3, label_type)
    w = np.array([1.0, 1.0, 0.0], np.float32)
    want = float(jl.get_loss(loss, label_type)(_as(jnp.asarray, pred),
                                               _as(jnp.asarray, batch)))
    got = float(tl.get_loss(loss, label_type)(_as(torch.from_numpy, pred),
                                              _as(torch.from_numpy, batch)))
    assert got == pytest.approx(want, rel=1e-6)
    want = float(jl.get_batch_loss(loss, label_type)(
        _as(jnp.asarray, pred), _as(jnp.asarray, batch), jnp.asarray(w)))
    got = float(tl.get_batch_loss(loss, label_type)(
        _as(torch.from_numpy, pred), _as(torch.from_numpy, batch),
        torch.from_numpy(w)))
    assert got == pytest.approx(want, rel=1e-6)


def test_loss_names_are_checked():
    with pytest.raises(ValueError):
        tl.get_loss("nope", "distance")
    with pytest.raises(ValueError):
        tl.get_batch_loss("ce", "distance")
    with pytest.raises(ValueError):
        tl.get_batch_loss("l1", "boundary")


# --- schedules, epoch budget, batching (exact) -------------------------------

def test_schedules_match_jax():
    vals = [1.0, 0.9, 0.95, 0.95, 0.94, 0.97, 0.96, 0.99, 0.9, 0.91, 0.92,
            0.93, 0.94, 0.95, 0.96]
    for make in (lambda m: m.ReduceLROnPlateau(6e-3, factor=0.25,
                                               patience=2, min_lr=4.5e-4),
                 lambda m: m.CosineAnnealingLR(5.4e-4, t_max=6,
                                               eta_min=3e-5)):
        a, b = make(js), make(ts)
        assert [a.step(v) for v in vals] == [b.step(v) for v in vals]


def test_get_max_epochs_matches_jax():
    for n in (2, 40, 49, 50, 99, 100, 200, 500, 999, 1000, 5000):
        for crop in (64, 128, 256, 320, 512):
            assert get_max_epochs(n, crop) == jget_max_epochs(n, crop)


@pytest.mark.parametrize("n,bs,step,shuffle", [
    (35, 4, 0, True), (5, 4, 0, False), (9, 8, 0, True), (7, 2, 4, True)])
def test_epoch_batches_match_jax(n, bs, step, shuffle):
    """The same ``np.random.default_rng`` seeds give JAX's batches."""
    a = list(jepoch_batches(n, bs, np.random.default_rng(7), shuffle, step))
    b = list(epoch_batches(n, bs, np.random.default_rng(7), shuffle, step))
    assert len(a) == len(b)
    for (ia, wa), (ib, wb) in zip(a, b):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(wa, wb)


def test_unique_path_counts_from_one(tmp_path):
    assert unique_path(tmp_path, "m_{:02d}.ckpt").name == "m_01.ckpt"
    (tmp_path / "m_01.ckpt").touch()
    assert unique_path(tmp_path, "m_{:02d}.ckpt").name == "m_02.ckpt"


# --- optimizers against optax ----------------------------------------------

def _opt_model():
    """A conv, a transposed conv and their biases: both centralisation
    layouts."""
    m = nn.Sequential(nn.Conv2d(3, 5, 3), nn.ConvTranspose2d(4, 6, 2, 2))
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(
                np.float32)))
    return m


def _flax_tree(ps):
    """The flax layout of ``_opt_model``'s tensors (copies)."""
    w, b, wt, bt = (p.detach().numpy().copy() for p in ps)
    return {"conv": {"kernel": w.transpose(2, 3, 1, 0), "bias": b},
            "convt": {"kernel": wt.transpose(2, 3, 0, 1), "bias": bt}}


@pytest.mark.parametrize("name", ["ranger", "adam"])
def test_optimizer_matches_optax(name):
    """12 steps on the same gradients (two Lookahead syncs for Ranger, rho
    crossing 5 at step 6), jitted optax as the trainer runs it: every
    parameter within 1e-6 absolute (measured: 1.2e-7, one ulp of the O(1)
    parameters)."""
    m = _opt_model()
    ps = list(m.parameters())
    if name == "ranger":
        opt = to.Ranger(ps, 6e-3, gc_dims=to.centralization_dims(m))
        tx = jo.ranger(6e-3)
    else:
        opt = to.AMSGrad(ps, 8e-4)
        tx = jo.adam_amsgrad(8e-4)
    jp = jax.tree_util.tree_map(jnp.asarray, _flax_tree(ps))
    state = tx.init(jp)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(1)
    worst = 0.0
    for _ in range(12):
        grads = [torch.from_numpy(rng.standard_normal(p.shape).astype(
            np.float32)) for p in ps]
        for p, g in zip(ps, grads):
            p.grad = g
        opt.step()
        u, state = update(jax.tree_util.tree_map(jnp.asarray,
                                                 _flax_tree(grads)),
                          state, jp)
        jp = optax.apply_updates(jp, u)
        for a, b in zip(_leaves(jp), _leaves(_flax_tree(ps))):
            worst = max(worst, float(np.abs(a - b).max()))
    assert worst <= 1e-6


def test_rho_matches_optax():
    """rho_t as optax computes it inside the jitted step, for t = 1..12,
    bit for bit (rho_6 = 5.97473; op by op XLA reads 5.95483)."""
    b2 = 0.999

    @jax.jit
    def rho(count):   # the lines of optax's scale_by_radam
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = b2 ** count
        return ro_inf - 2 * count * b2t / (1 - b2t)

    for t in range(1, 13):
        assert float(to.radam_rho(t, b2)[0]) == float(
            rho(jnp.asarray(t, jnp.int32)))
    assert float(to.radam_rho(6)[0]) == pytest.approx(5.97473, abs=1e-5)


def test_centralization_dims_follow_each_layout():
    m = nn.Sequential(nn.Conv2d(3, 5, 3), nn.ConvTranspose2d(4, 6, 2, 2),
                      nn.GroupNorm(2, 6))
    assert to.centralization_dims(m) == [(1, 2, 3), None, (0, 2, 3), None,
                                         None, None]


def test_set_learning_rate_and_finetune_factor():
    cfg = TrainConfig(model=ModelConfig(**ARCH))
    model = nn.Conv2d(1, 8, 3)
    opt, lr = to.build_optimizer(cfg, model, second_run=True)
    assert lr == pytest.approx(6e-3 * 0.09)
    to.set_learning_rate(opt, 1e-4)
    assert opt.param_groups[0]["lr"] == 1e-4
    opt, lr = to.build_optimizer(dataclasses.replace(cfg, optimizer="adam"),
                                 model)
    assert isinstance(opt, to.AMSGrad) and lr == 8e-4


# --- one train step against JAX ---------------------------------------------

def _train_batch(seed, n=2, size=32):
    rng = np.random.default_rng(seed)
    masks = [synthetic_blobs(rng, shape=(size, size), n_blobs=4,
                             r_range=(3, 7)) for _ in range(n)]
    images = np.stack([((m > 0) * 30000 + 4000 + rng.normal(0, 500, m.shape))
                       for m in masks]).astype(np.float32)[..., None]
    labels = {"border_label": rng.uniform(0, 0.5, images.shape).astype(
        np.float32),
        "cell_label": np.stack([(m > 0) for m in masks]).astype(
            np.float32)[..., None]}
    return images, labels


def test_train_step_matches_jax():
    """From the same weights, on one augmented batch (JAX's
    ``augment_batch``), 6 Ranger steps of the port's ``forward_backward`` +
    ``optimizer.step`` against JAX's ``model.apply`` + loss + ``tx.update``:
    the loss of each step within 1e-5 relative (measured: 2.4e-7), every
    parameter after 1 and after 6 steps (a Lookahead sync) within 1e-5
    absolute (measured: 1.5e-8 and 7.2e-7)."""
    cfg = TrainConfig(model=ModelConfig(**ARCH), compute_dtype="float32",
                      run_name="step")
    model = init_like_flax(build_unet(cfg.model), 0)
    images, labels = _train_batch(1)
    aug_img, aug_lab = jaugment_batch(
        jax.random.PRNGKey(4), jnp.asarray(images),
        {k: jnp.asarray(v) for k, v in labels.items()})
    w = np.ones(2, np.float32)

    jmodel = jbuild(JModelConfig(**ARCH), dtype=jnp.float32)
    tx, _ = jo.build_optimizer(JTrainConfig(model=JModelConfig(**ARCH)))
    batch_loss = jl.get_batch_loss("smooth_l1", "distance")

    def jstep(params, opt_state):
        def losses(params):
            preds = jmodel.apply({"params": params}, aug_img, train=True)
            s = batch_loss(preds, aug_lab, jnp.asarray(w))
            return s / jnp.maximum(jnp.sum(jnp.asarray(w)), 1.0), s
        (_, s), g = jax.value_and_grad(losses, has_aux=True)(params)
        u, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, u), opt_state, s

    opt = to.build_optimizer(cfg, model)[0]
    loss_fn = tl.get_batch_loss("smooth_l1", "distance")
    t_img = torch.from_numpy(np.asarray(aug_img))
    t_lab = {k: torch.from_numpy(np.asarray(v)) for k, v in aug_lab.items()}
    with jax.default_matmul_precision("highest"):
        params = jax.tree_util.tree_map(
            jnp.asarray, variables_from_state_dict(model.state_dict())[
                "params"])
        opt_state = tx.init(params)
        step = jax.jit(jstep)
        for i in range(6):
            params, opt_state, want = step(params, opt_state)
            model.train()
            s = loss_fn(model(t_img), t_lab, torch.from_numpy(w))
            opt.zero_grad()
            (s / 2.0).backward()
            opt.step()
            assert float(s) == pytest.approx(float(want), rel=1e-5)
            if i in (0, 5):
                got = variables_from_state_dict(model.state_dict())["params"]
                for a, b in zip(_leaves(params), _leaves(got)):
                    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


# --- precise BN -------------------------------------------------------------

def test_precise_bn_moments_match_jax(tmp_path):
    """The pooled moments of every BatchNorm layer over 5 images in
    batches of 2 (the ragged tail wraps around) against the JAX trainer's
    ``_precise_stats``: means within 1e-5 absolute, variances within 1e-4
    relative (measured: 1.6e-7 and 8.5e-7)."""
    arch = dict(ARCH, normalization="bn")
    jcfg = JTrainConfig(model=JModelConfig(**arch), compute_dtype="float32",
                        num_devices=1)
    images, _ = _train_batch(2, n=5, size=16)
    model = init_like_flax(build_unet(ModelConfig(**arch)), 3)
    variables = variables_from_state_dict(model.state_dict())
    jt = JTrainer(jcfg, tmp_path / "jax")
    with jax.default_matmul_precision("highest"):
        zero = jax.tree_util.tree_map(jnp.zeros_like,
                                      variables["batch_stats"])
        want = jt._precise_stats(jt._make_stat_step(zero),
                                 variables["params"], images, 2)
    cfg = TrainConfig(model=ModelConfig(**arch), compute_dtype="float32")
    tr = Trainer(cfg, tmp_path / "port", device="cpu")
    tr.model.load_state_dict(state_dict_from_variables(variables))
    tr._precise_stats(SplitArrays(images, {}, ["a"] * 5), 2)
    got = variables_from_state_dict(tr.model.state_dict())["batch_stats"]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g) > 0
    for path, w_leaf in flat_w:
        g_leaf = flat_g[path]
        if jax.tree_util.keystr(path).endswith("['mean']"):
            np.testing.assert_allclose(g_leaf, w_leaf, rtol=0, atol=1e-5)
        else:
            np.testing.assert_allclose(g_leaf, w_leaf, rtol=1e-4, atol=1e-7)


# --- the trainer on the CPU ---------------------------------------------------

def _data(seed, n=8, size=16):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 65535, (n, size, size, 1)).astype(np.float32)
    labels = {"border_label": rng.random((n, size, size, 1)).astype(
        np.float32), "cell_label": rng.random((n, size, size, 1)).astype(
        np.float32)}
    split = SplitArrays(images=images, labels=labels,
                        ids=[str(i) for i in range(n)])
    return TrainingData(train=split, val=split, crop_size=size)


def _cfg(**kw):
    base = dict(model=ModelConfig(**ARCH), optimizer="ranger", batch_size=4,
                max_epochs=4, run_name="distance_model_01",
                compute_dtype="float32", train_state_every=2)
    base.update(kw)
    return TrainConfig(**base)


def _stop_after(n_epochs, msgs):
    return lambda: sum("Loss" in m for m in msgs) >= n_epochs


def test_resume_continues_with_the_same_losses(tmp_path):
    """Four epochs in one run against two, a stop, and a resume from the
    epoch-2 snapshot: the same loss history and bit-identical weights."""
    data = _data(0)
    whole = Trainer(_cfg(), tmp_path / "whole", device="cpu")
    whole.train(data)
    msgs = []
    first = Trainer(_cfg(), tmp_path / "cut", text_output=msgs.append,
                    device="cpu")
    first.should_stop = _stop_after(2, msgs)
    first.train(data)
    assert first.stopped
    said = []
    second = Trainer(_cfg(), tmp_path / "cut", text_output=said.append,
                     device="cpu")
    second.train(data, resume=True)
    assert "Resume training from epoch 3" in said
    hist = "distance_model_01_loss.txt"
    assert ((tmp_path / "whole" / hist).read_text()
            == (tmp_path / "cut" / hist).read_text())
    for (k, a), b in zip(whole.model.state_dict().items(),
                         second.model.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)


def test_mismatched_snapshot_is_refused_with_the_jax_message(tmp_path):
    data = _data(1)
    msgs = []
    first = Trainer(_cfg(train_state_every=1), tmp_path,
                    text_output=msgs.append, device="cpu")
    first.should_stop = _stop_after(1, msgs)
    first.train(data)
    assert (tmp_path / "distance_model_01_state.train_state").is_file()
    said = []
    other = Trainer(_cfg(batch_size=2, train_state_every=1), tmp_path,
                    text_output=said.append, device="cpu")
    other.should_stop = _stop_after(1, said)
    other.train(data, resume=True)
    assert ("Training snapshot found but rejected (batch_size differ) — "
            "starting from scratch") in said
    assert not any("Resume training" in m for m in said)


def test_fit_checkpoint_loads_in_jax_with_the_port_predictions(tmp_path):
    """A two-phase fit writes the best ``.ckpt``, its sidecar (with the
    training times) and the loss history; the JAX ``load_model`` reads the
    checkpoint and its forward equals the port's within 1e-5 (measured
    3.3e-6)."""
    data = _data(2)
    tr = Trainer(_cfg(train_state_every=1, max_epochs=10), tmp_path,
                 device="cpu")
    tr.fit(data)
    side = json.loads((tmp_path / "distance_model_01.json").read_text())
    assert side["framework"] == "microbeseg_torch"
    assert side["trained_epochs"] >= 1 and "training_time" in side
    assert "trained_epochs_run2" in side
    assert not (tmp_path / "distance_model_01_state.train_state").exists()
    rows = (tmp_path / "distance_model_01_loss.txt").read_text()
    assert rows.startswith("# Epoch, training loss, validation loss")
    x = np.random.default_rng(3).uniform(-1, 1, (2, 16, 16, 1)).astype(
        np.float32)
    jmodel, variables, jcfg = jload_model(tmp_path / "distance_model_01.ckpt",
                                          dtype=jnp.float32, input_size=16)
    assert jcfg.model.filters == (8, 16)
    with jax.default_matmul_precision("highest"):
        want = jmodel.apply(variables, jnp.asarray(x), train=False)
    model, _ = load_model(tmp_path / "distance_model_01.ckpt", device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


def test_bn_fit_recalibrates_and_groupnorm_is_left_alone(tmp_path):
    """With 'bn' the checkpoint's running statistics are the pooled
    moments of the best weights over the train images; 'gn' has none."""
    data = _data(4)
    msgs = []
    cfg = _cfg(model=ModelConfig(**dict(ARCH, normalization="bn")),
               optimizer="adam", max_epochs=2, train_state_every=0)
    tr = Trainer(cfg, tmp_path, text_output=msgs.append, device="cpu")
    tr.fit(data)
    assert any(m.startswith("Recalibrated BatchNorm") for m in msgs)
    model, _ = load_model(tmp_path / "distance_model_01.ckpt", device="cpu")
    probe = Trainer(cfg, tmp_path / "probe", device="cpu")
    probe.model.load_state_dict(model.state_dict())
    saved = {id(p): m for p, m in zip(probe.model.modules(),
                                       model.modules())}
    pooled = probe.pooled_bn_moments(torch.from_numpy(data.train.images), 4)
    assert len(pooled) == len(probe._bn_layers()) == 11
    for m, (mean, var) in pooled.items():
        torch.testing.assert_close(saved[id(m)].running_mean, mean)
        torch.testing.assert_close(saved[id(m)].running_var, var)
    gn = Trainer(_cfg(train_state_every=0), tmp_path / "gn", device="cpu")
    assert gn._bn_layers() == []


def test_entry_points_need_a_card_or_an_explicit_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(_cfg(), tmp_path)
    root = _trainset(tmp_path, np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        workers.run_training(root, tmp_path / "m", "distance", 1, "ranger", 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_train.main(["--train_dir", str(root)])


# --- run_training and the CLI ---------------------------------------------

def _trainset(tmp_path, rng, n_train=2, n_val=2, size=32):
    root = tmp_path / "trainset"
    for split, n in (("train", n_train), ("val", n_val)):
        (root / split).mkdir(parents=True)
        for i in range(n):
            mask = synthetic_blobs(rng, shape=(size, size), n_blobs=3,
                                   r_range=(3, 7))
            img = ((mask > 0) * 40000 + 5000).astype(np.uint16)
            imwrite(root / split / f"img_{split}{i}.tif", img)
            imwrite(root / split / f"mask_{split}{i}.tif", mask)
    return root


class _OOMTrainer:
    """Stands in for the trainer: records each configuration, runs out of
    memory."""
    seen = []

    def __init__(self, cfg, path_models, **kw):
        self.cfg = cfg
        self.stopped = False
        _OOMTrainer.seen.append((cfg.batch_size, cfg.model.filters))

    def fit(self, data, **kw):
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                     "allocate 2.00 GiB")


def test_oom_ladder_descends_and_gives_up(tmp_path, monkeypatch):
    root = _trainset(tmp_path, np.random.default_rng(1))
    workers.create_labels(root, "distance", device="cpu")
    _OOMTrainer.seen = []
    monkeypatch.setattr(workers, "Trainer", _OOMTrainer)
    msgs = []
    assert not workers.run_training(root, tmp_path / "m", "distance", 1,
                                    "ranger", 16, text_output=msgs.append,
                                    device="cpu")
    assert _OOMTrainer.seen == [(16, (64, 1024)), (8, (64, 1024)),
                                (4, (64, 1024)), (4, (32, 512)),
                                (4, (32, 256))]
    assert msgs[-1].startswith("Please, try again")
    assert workers._is_oom(RuntimeError("RESOURCE_EXHAUSTED: oom"))
    assert not workers._is_oom(RuntimeError("shape mismatch"))


def test_non_oom_errors_propagate_and_pretrained_mismatch_stops(
        tmp_path, monkeypatch):
    root = _trainset(tmp_path, np.random.default_rng(2))
    workers.create_labels(root, "distance", device="cpu")

    class Broken(_OOMTrainer):
        def fit(self, data, **kw):
            raise ValueError("not a memory problem")

    monkeypatch.setattr(workers, "Trainer", Broken)
    with pytest.raises(ValueError):
        workers.run_training(root, tmp_path / "m", "distance", 1, "ranger",
                             4, device="cpu")
    # a warm start whose width the ladder would leave: a clean stop
    (tmp_path / "warm.json").write_text(json.dumps(
        {"architecture": ["DU", "conv", "mish", "gn", [64, 1024]],
         "label_type": "distance"}))
    _OOMTrainer.seen = []
    monkeypatch.setattr(workers, "Trainer", _OOMTrainer)
    msgs = []
    assert not workers.run_training(root, tmp_path / "m", "distance", 1,
                                    "ranger", 4, text_output=msgs.append,
                                    pretrained=tmp_path / "warm",
                                    device="cpu")
    assert _OOMTrainer.seen == [(4, (64, 1024))]
    assert "The pretrained checkpoint has filters" in msgs[-1]


def test_cli_train_runs_end_to_end_on_the_cpu(tmp_path):
    """``cli.train --device cpu`` on a trainset of 2 + 2 crops of 32^2:
    labels, the full-width run_training for one epoch (and the second
    run's zero), the checkpoint, sidecar, loss history and trainset zip."""
    root = _trainset(tmp_path, np.random.default_rng(3))
    rc = cli_train.main(["--train_dir", str(root), "--max_epochs", "1",
                         "--model_path", str(tmp_path / "models"),
                         "--device", "cpu"])
    assert rc == 0
    out = tmp_path / "models" / "trainset"
    for name in ("distance_model_01.ckpt", "distance_model_01.json",
                 "distance_model_01_loss.txt",
                 "distance_model_01_trainset.zip"):
        assert (out / name).is_file(), name
    side = json.loads((out / "distance_model_01.json").read_text())
    assert side["architecture"] == ["DU", "conv", "mish", "gn", [64, 1024]]
    assert side["batch_size"] == 4 and side["optimizer"] == "ranger"
    assert (root / "train" / "cell_dist_train0.tif").is_file()
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        cli_train.main(["--omero_id", "3", "--device", "cpu"])
