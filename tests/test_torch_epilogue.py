"""The fused convolution epilogue on the CPU: ``conv_epilogue``'s plain
version against the module chain it stands for, what it refuses, and the
route that ``models/blocks.py`` takes to it (``epilogue_route``).

The kernel runs only on the card (``tests/test_torch_kernels_cuda.py``); the
route's wiring is exercised here by letting ``epilogue_route`` treat the
CPU as the card, so that the blocks call the plain version."""

import pytest
import torch
from torch import nn

from microbeseg_torch.config import ModelConfig
from microbeseg_torch.kernels import _build
from microbeseg_torch.models import blocks
from microbeseg_torch.models.blocks import epilogue_route, make_act, make_norm
from microbeseg_torch.models.unet import build_unet
from microbeseg_torch.ops.kernels.epilogue import (ACTIVATIONS, conv_epilogue,
                                                   conv_epilogue_plain,
                                                   refusal)

F32_EPS = torch.finfo(torch.float32).eps


def _bn(C, gen):
    """An eval BatchNorm2d with non-trivial parameters and statistics:
    weights of both signs, non-zero shift and mean, variance away from 1."""
    bn = nn.BatchNorm2d(C, eps=1e-5).eval()
    with torch.no_grad():
        sign = torch.where(torch.rand(C, generator=gen) < 0.3, -1.0, 1.0)
        bn.weight.copy_(sign * (0.5 + torch.rand(C, generator=gen)))
        bn.bias.copy_(torch.randn(C, generator=gen) * 0.5)
        bn.running_mean.copy_(torch.randn(C, generator=gen) * 0.3)
        bn.running_var.copy_(0.2 + 2 * torch.rand(C, generator=gen))
    return bn


def _chain(act, C_in=16, C=32, seed=0):
    """(conv, act module or None, bn, x channels-last): an upsampling chain
    for 'identity', else a 3x3 convolution chain."""
    gen = torch.Generator().manual_seed(seed)
    if act == "identity":
        conv, act_mod = nn.ConvTranspose2d(C_in, C, 2, stride=2), None
    else:
        conv, act_mod = nn.Conv2d(C_in, C, 3, padding=1), make_act(act)
    with torch.no_grad():
        conv.bias.copy_(torch.randn(C, generator=gen) * 0.5)
    x = torch.randn(2, C_in, 12, 10, generator=gen).contiguous(
        memory_format=torch.channels_last)
    return conv, act_mod, _bn(C, gen), x


def _unbiased(conv, x):
    if isinstance(conv, nn.ConvTranspose2d):
        return nn.functional.conv_transpose2d(x, conv.weight, None, 2, 0, 0)
    return conv._conv_forward(x, conv.weight, None)


@pytest.mark.parametrize("act", ACTIVATIONS)
def test_plain_epilogue_equals_the_module_chain(act):
    conv, act_mod, bn, x = _chain(act)
    with torch.no_grad():
        z = conv(x)
        want = bn(z if act_mod is None else act_mod(z))
        zb = _unbiased(conv, x)
        t = zb + conv.bias.view(1, -1, 1, 1)
        if act_mod is not None:
            t = act_mod(t)
        a = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
        # float32 rounding of each term: the chain normalises as
        # (t - mean) * invstd * w + beta, the epilogue as t * a + b
        scale = (t.abs() * a.abs().view(1, -1, 1, 1)
                 + bn.bias.abs().view(1, -1, 1, 1)
                 + (bn.running_mean * a).abs().view(1, -1, 1, 1))
        got = conv_epilogue_plain(zb, conv.bias, bn, act)
        assert bool(((got - want).abs() <= 8 * F32_EPS * scale).all())
        # the wrapper on the CPU: the plain version, in place
        out = conv_epilogue(zb, conv.bias, bn, act)
    assert out.data_ptr() == zb.data_ptr()
    torch.testing.assert_close(out, got, rtol=0, atol=0)
    assert out.is_contiguous(memory_format=torch.channels_last)


def _refused(**change):
    conv, _, bn, x = _chain("relu")
    with torch.no_grad():
        z = _unbiased(conv, x)
    args = dict(z=z, bias=conv.bias.detach(), bn=bn, act="relu")
    args.update({k: v(args) for k, v in change.items()})
    return refusal(**args), args


@pytest.mark.parametrize("case,change", [
    ("act", dict(act=lambda a: "gelu")),
    ("half", dict(z=lambda a: a["z"].half())),
    ("contiguous", dict(z=lambda a: a["z"].contiguous())),
    ("channels", dict(z=lambda a: a["z"][:, :12])),
    ("bias", dict(bias=lambda a: a["bias"][:16])),
    ("bias_dtype", dict(bias=lambda a: a["bias"].double())),
    ("groupnorm", dict(bn=lambda a: nn.GroupNorm(8, 32))),
    ("no_stats", dict(bn=lambda a: nn.BatchNorm2d(
        32, track_running_stats=False))),
    ("not_affine", dict(bn=lambda a: nn.BatchNorm2d(32, affine=False))),
])
def test_conv_epilogue_refuses_what_the_kernel_does_not_take(case, change):
    why, args = _refused(**change)
    assert why is not None, case
    with pytest.raises(ValueError, match="conv_epilogue"):
        conv_epilogue(**args)


def test_conv_epilogue_takes_both_working_types():
    for dtype in (torch.float32, torch.bfloat16):
        why, _ = _refused(z=lambda a: a["z"].to(dtype))
        assert why is None, (dtype, why)


BN = make_norm("bn", 64)
GN = make_norm("gn", 64)
IN = make_norm("in", 64)


@pytest.mark.parametrize(
    "training,grad,device,norm,act,channels,quantize,want", [
    (False, False, "cuda", BN, nn.ReLU(), 64, False, "fused"),
    (False, False, "cuda", BN, None, 64, False, "fused"),
    (False, False, "cuda", BN, blocks.Mish(), 64, False, "fused"),
    (False, False, "cuda", BN, nn.ELU(), 64, False, "fused"),
    (False, False, "cuda", BN, nn.LeakyReLU(0.01), 64, False, "fused"),
    (True, False, "cuda", BN, nn.ReLU(), 64, False, None),
    (False, True, "cuda", BN, nn.ReLU(), 64, False, None),
    (False, False, "cpu", BN, nn.ReLU(), 64, False, None),
    (False, False, "cuda", GN, nn.ReLU(), 64, False, None),
    (False, False, "cuda", IN, nn.ReLU(), 64, False, None),
    (False, False, "cuda", BN, nn.ReLU(), 64, True, "fallback"),
    (False, False, "cuda", BN, nn.ReLU(), 36, False, "fallback"),
    (False, False, "cuda", BN, nn.LeakyReLU(0.2), 64, False, "fallback"),
    (False, False, "cuda", BN, nn.GELU(), 64, False, "fallback"),
    (False, False, "cuda", nn.BatchNorm2d(64, track_running_stats=False),
     nn.ReLU(), 64, False, "fallback"),
])
def test_epilogue_route(training, grad, device, norm, act, channels,
                        quantize, want):
    assert epilogue_route(training, grad, device, norm, act, channels,
                          quantize) == want


@pytest.fixture
def cpu_as_card(monkeypatch):
    """``epilogue_route`` taking the CPU for the card: the blocks then run
    the plain epilogue where the card runs the kernel.  Yields the count of
    ``conv_epilogue`` calls (the CPU launches no kernel to count)."""
    route, fused = blocks.epilogue_route, blocks.conv_epilogue_unchecked
    calls = {"conv_epilogue": 0}

    def counted(*args):
        calls["conv_epilogue"] += 1
        return fused(*args)

    monkeypatch.setattr(blocks, "epilogue_route",
                        lambda tr, g, dev, *a: route(tr, g, "cuda", *a))
    monkeypatch.setattr(blocks, "conv_epilogue_unchecked", counted)
    _build.reset_launches()
    yield calls
    _build.reset_launches()


def _dunet(act, norm, filters=(8, 16), seed=0):
    torch.manual_seed(seed)
    model = build_unet(ModelConfig(act_fun=act, normalization=norm,
                                   filters=filters))
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.load_state_dict(_bn(m.num_features, gen).state_dict())
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.2)
    return model.eval().to(memory_format=torch.channels_last)


@pytest.mark.parametrize("act", ["relu", "mish", "elu", "leakyrelu"])
def test_dunet_takes_the_fused_route(cpu_as_card, act):
    """filters (8, 16): 2 levels, 11 chains with a BatchNorm (4 encoder
    convolutions, 1 pool, 2 x (1 upsampling + 2 convolutions)); the fused
    forward against the module chain (grad on) in float32."""
    model = _dunet(act, "bn")
    x = torch.rand(2, 32, 32, 1)
    want = model(x)
    assert cpu_as_card["conv_epilogue"] == 0
    with torch.inference_mode():
        got = model(x)
    assert cpu_as_card["conv_epilogue"] == 11
    assert _build.LAUNCHES["conv_epilogue_fallback"] == 0
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_dunet_route_bypassed_and_fallbacks(cpu_as_card):
    """Training mode and GroupNorm never reach the route; channels that are
    not a multiple of 8 fall back on every chain."""
    x = torch.rand(2, 32, 32, 1)
    with torch.no_grad():
        _dunet("relu", "bn").train()(x)
        _dunet("relu", "gn")(x)
    assert cpu_as_card["conv_epilogue"] == 0
    assert _build.LAUNCHES["conv_epilogue_fallback"] == 0
    model = _dunet("relu", "bn", filters=(10, 20))
    want = model(x)
    with torch.no_grad():
        got = model(x)
    assert cpu_as_card["conv_epilogue"] == 0
    assert _build.LAUNCHES["conv_epilogue_fallback"] == 11
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
