"""ConvBlock-level rematerialisation in the port
(``build_unet(remat_policy=)``).

The port against itself: for 'dots' and 'nothing', with 'bn' + relu and
with 'gn' + mish, one training forward and backward of the remat model
equals the plain model's bit for bit (outputs, gradients, BatchNorm
buffers), the convolutions recomputed in the backward pass number 0 for
'dots' and 2 a ConvBlock for 'nothing', and the ``state_dict`` keys do not
change.  The port against JAX: the same step against JAX's
``build_unet(remat_policy=dots_saveable | nothing_saveable)`` in train mode
(float32, matmul precision 'highest').  Two gloo ranks with the
cross-replica BatchNorm: the same step with and without remat.

Models are the JAX suite's remat size: DUNet, filters (8, 32), batch 2 of
32^2, weights drawn with numpy and carried across with
``state_dict_from_variables``.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from microbeseg_tpu.config import ModelConfig as JModelConfig
from microbeseg_tpu.models.io import load_checkpoint, variables_template
from microbeseg_tpu.models.unet import build_unet as jbuild
from microbeseg_torch.config import ModelConfig, TrainConfig
from microbeseg_torch.models import blocks
from microbeseg_torch.models.convert import (state_dict_from_variables,
                                             variables_from_state_dict)
from microbeseg_torch.models.io import save_checkpoint
from microbeseg_torch.models.unet import build_unet
from microbeseg_torch.ops.augment import draw_params
from microbeseg_torch.parallel import mesh
from microbeseg_torch.training.trainer import Trainer, init_like_flax
from tests import torch_dp_workers as W
from tests.test_torch_models import random_variables

ARCHS = {"bn": dict(act_fun="relu", normalization="bn"),
         "gn": dict(act_fun="mish", normalization="gn")}
FILTERS = (8, 32)
POLICIES = {"dots": jax.checkpoint_policies.dots_saveable,
            "nothing": jax.checkpoint_policies.nothing_saveable}
RANK_TIMEOUT_S = 120.0


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _Convolutions(TorchDispatchMode):
    """Counts the convolutions that run under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _cfg(kind):
    return ModelConfig(filters=FILTERS, **ARCHS[kind])


def _jcfg(kind):
    return JModelConfig(filters=FILTERS, **ARCHS[kind])


def _inputs(kind):
    rng = np.random.default_rng(sum(map(ord, "remat" + kind)))
    variables = random_variables(jbuild(_jcfg(kind), dtype=jnp.float32), rng)
    x = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)
    return variables, x


def _port_step(kind, policy, variables, x):
    """One training forward and backward of the port's model from the
    carried weights: (outputs, gradients by name, buffers by name, the
    convolutions run in ``backward()``, the BatchNorm layers' input sizes
    per channel by buffer prefix)."""
    model = build_unet(_cfg(kind), remat_policy=policy).train()
    model.load_state_dict(state_dict_from_variables(variables), strict=True)
    sizes = {}
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.register_forward_pre_hook(
                lambda m, inp, name=name: sizes.__setitem__(
                    name, inp[0].numel() // inp[0].shape[1]))
    border, cell = model(torch.from_numpy(x))
    loss = (border ** 2).mean() + (cell ** 2).mean()
    with _Convolutions() as convs:
        loss.backward()
    return ((border.detach(), cell.detach()),
            {n: p.grad.clone() for n, p in model.named_parameters()},
            {n: b.clone() for n, b in model.named_buffers()}, convs.n, sizes)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def steps(request):
    kind = request.param
    variables, x = _inputs(kind)
    return kind, variables, x, {p: _port_step(kind, p, variables, x)
                                for p in (None, "dots", "nothing")}


@pytest.mark.parametrize("policy", ["dots", "nothing"])
def test_remat_step_equals_the_plain_step_bit_for_bit(steps, policy):
    """Outputs, every gradient and every buffer (running statistics and
    ``num_batches_tracked``, updated once) equal the plain model's."""
    kind, _, _, got = steps
    ref, out = got[None], got[policy]
    for a, b in zip(out[0], ref[0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert set(out[1]) == set(ref[1])
    for k, g in ref[1].items():
        torch.testing.assert_close(out[1][k], g, rtol=0, atol=0, msg=k)
    assert set(out[2]) == set(ref[2])
    for k, b in ref[2].items():
        torch.testing.assert_close(out[2][k], b, rtol=0, atol=0, msg=k)
    tracked = [int(v) for k, v in out[2].items()
               if k.endswith("num_batches_tracked")]
    assert (len(tracked) > 0) == (kind == "bn") and set(tracked) <= {1}


@pytest.mark.parametrize("policy", [None, "dots", "nothing"])
def test_convolutions_recomputed_in_backward(steps, policy):
    """'dots' keeps every convolution's output: none runs again in the
    backward pass; 'nothing' runs both of each ConvBlock's again (3 encoder
    and 2 x 2 decoder blocks: 14); ConvPool, the upsampling and the heads
    are never recomputed."""
    assert steps[3][policy][3] == {None: 0, "dots": 0, "nothing": 14}[policy]


@pytest.mark.parametrize("policy", ["dots", "nothing"])
def test_remat_step_matches_jax_remat(steps, policy):
    """Against JAX's model with the same policy in train mode, at the
    port's bars against JAX: outputs within 1e-4 of their scale (the largest
    |output|; ``tests/test_torch_models.py`` holds unit-scale outputs within
    1e-4), gradients within 1e-5 + 1e-4 |g| and, for 'bn', the updated
    ``batch_stats``: means within 1e-5 and variances within 1e-4 relative
    (the precise-BN bars of ``tests/test_torch_training.py``).  Measured on
    the CPU at 2 threads: outputs 8.9e-5 from JAX's at a scale of 5.2 with
    'bn' (batch statistics of the 4^2 level amplify float32 rounding), 7.4e-6
    with 'gn'; gradients at most 0.62 of their bar; means 1.2e-7, variances
    5.4e-7.  ``nn.BatchNorm2d`` puts the unbiased batch variance into its
    running buffer and flax the biased one, so the port's variance update is
    taken back to the biased one with its layer's count n: ``(new - 0.9 old)
    (n - 1) / n``."""
    kind, variables, x, got = steps
    out, grads, buffers, _, sizes = got[policy]
    model = jbuild(_jcfg(kind), dtype=jnp.float32,
                   remat_policy=POLICIES[policy])
    stats = variables.get("batch_stats", {})

    def loss(params):
        (border, cell), upd = model.apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(x),
            train=True, mutable=["batch_stats"])
        return (jnp.mean(border ** 2) + jnp.mean(cell ** 2),
                (border, cell, upd))

    with jax.default_matmul_precision("highest"):
        (_, (border, cell, upd)), g = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(variables["params"])
    for a, b in zip(out, (border, cell)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-4 * np.abs(b).max())
    state = state_dict_from_variables(variables)
    flat_g = jax.tree_util.tree_leaves(
        variables_from_state_dict({**state, **grads})["params"])
    flat_w = jax.tree_util.tree_leaves(g)
    assert len(flat_g) == len(flat_w) > 0
    for a, b in zip(flat_g, flat_w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    if kind != "bn":
        assert not sizes
        return
    want = state_dict_from_variables({"params": variables["params"],
                                      "batch_stats": upd["batch_stats"]})
    assert len(sizes) == 20   # 2 a ConvBlock, 2 ConvPools, 2 x 2 upsamplings
    for name, n in sizes.items():
        np.testing.assert_allclose(buffers[f"{name}.running_mean"],
                                   want[f"{name}.running_mean"], rtol=0,
                                   atol=1e-5, err_msg=name)
        old = state[f"{name}.running_var"]
        biased = (buffers[f"{name}.running_var"] - 0.9 * old) * (n - 1) / n
        np.testing.assert_allclose(biased + 0.9 * old,
                                   want[f"{name}.running_var"], rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("policy", ["dots", "nothing"])
def test_checkpoints_cross_between_the_packages(tmp_path, policy):
    """A JAX checkpoint carried across loads into a remat model with
    ``strict=True`` (the keys are the plain model's), and a ``.ckpt``
    written from a remat model loads into JAX's remat model, whose forward
    equals the port's within 1e-4."""
    variables, x = _inputs("bn")
    model = build_unet(_cfg("bn"), remat_policy=policy)
    assert list(model.state_dict()) == list(build_unet(_cfg("bn"))
                                            .state_dict())
    model.load_state_dict(state_dict_from_variables(variables), strict=True)
    path = save_checkpoint(model, tmp_path / "remat")
    jmodel = jbuild(_jcfg("bn"), dtype=jnp.float32,
                    remat_policy=POLICIES[policy])
    loaded = load_checkpoint(variables_template(jmodel, (32, 32)), path)
    with jax.default_matmul_precision("highest"):
        want = jmodel.apply(loaded, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)


def test_eval_no_grad_and_quantize_take_the_plain_forward(monkeypatch):
    """Eval mode, ``no_grad`` in train mode and the int8 path (eval only)
    never checkpoint, and give the plain model's outputs bit for bit."""
    variables, x = _inputs("bn")
    sd = state_dict_from_variables(variables)
    xt = torch.from_numpy(x)
    ref = build_unet(_cfg("bn"), quantize=True)
    ref.load_state_dict(sd)
    model = build_unet(_cfg("bn"), quantize=True, remat_policy="nothing")
    model.load_state_dict(sd)

    def refused(*a, **k):
        raise AssertionError("checkpointed outside a training step")

    monkeypatch.setattr(blocks, "checkpoint", refused)
    with torch.no_grad():
        for a, b in zip(model.eval()(xt), ref.eval()(xt)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        for a, b in zip(model.train()(xt), ref.train()(xt)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(AssertionError, match="outside a training step"):
        model.train()(xt)


@pytest.mark.parametrize("policy", ["everything", "nothing_saveable", True,
                                    jax.checkpoint_policies.dots_saveable])
def test_unknown_policy_is_refused(policy, tmp_path):
    with pytest.raises(ValueError, match="remat_policy"):
        build_unet(_cfg("gn"), remat_policy=policy)
    with pytest.raises(ValueError, match="remat_policy"):
        Trainer(TrainConfig(model=_cfg("gn")), tmp_path, device="cpu",
                remat_policy=policy)


def test_two_gloo_ranks_with_remat_match_without(tmp_path):
    """Two gloo ranks under DDP with the cross-replica BatchNorm, whose
    all-reduce runs again in the recomputation inside DDP's backward: the
    step with 'dots' and with 'nothing' equals the step without remat bit
    for bit on each rank (loss, gradients, running statistics), and
    ``num_batches_tracked`` is 1 everywhere."""
    cfg = TrainConfig(model=ModelConfig(filters=(8, 16), act_fun="mish",
                                        normalization="bn"),
                      optimizer="adam", batch_size=4, run_name="remat_01",
                      compute_dtype="float32")
    rng = np.random.default_rng(17)
    images = rng.integers(0, 65535, (4, 16, 16, 1)).astype(np.float32)
    labels = {k: rng.random((4, 16, 16, 1)).astype(np.float32)
              for k in ("border_label", "cell_label")}
    state = init_like_flax(build_unet(cfg.model), 3).state_dict()
    draw = draw_params(torch.Generator().manual_seed(2), 4, 16)
    cases = {str(p): (cfg, p, images, labels, np.ones(4, np.float32), state,
                      draw) for p in (None, "dots", "nothing")}
    out = tmp_path / "ranks"
    out.mkdir()
    mesh.spawn(W.remat_rank, (2, mesh.file_init_method(out), str(out),
                              cases), 2, timeout_s=RANK_TIMEOUT_S)
    for r in range(2):
        got = torch.load(out / f"rank{r}.pt", weights_only=False)
        ref = got["None"]
        assert ref[4] == {"CrossReplicaBatchNorm2d"}
        for policy in ("dots", "nothing"):
            loss, grads, stats, tracked, _ = got[policy]
            assert loss == ref[0]
            for k, g in ref[1].items():
                torch.testing.assert_close(grads[k], g, rtol=0, atol=0,
                                           msg=k)
            assert set(stats) == set(ref[2]) and stats
            for k, s in ref[2].items():
                torch.testing.assert_close(stats[k], s, rtol=0, atol=0,
                                           msg=k)
            assert tracked == ref[3] and set(tracked.values()) == {1}
