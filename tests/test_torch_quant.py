"""Port vs JAX: int8 inference (``InferConfig.quantize``).

Kernel K5's plain versions against the TPU kernel's own product, ``QuantConv``
alone, the quantised model with activation scales carried across, and the
engine's calibration (the two engines side by side are in
``test_torch_engine.py``).  JAX runs at float32 under matmul precision
'highest'; inputs and weights are drawn with numpy.
"""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from microbeseg_tpu.config import ModelConfig as JModelConfig
from microbeseg_tpu.models import blocks as jblocks
from microbeseg_tpu.models.unet import build_unet as jbuild
from microbeseg_torch.config import InferConfig, ModelConfig
from microbeseg_torch.inference.engine import InferenceEngine
from microbeseg_torch.models import blocks
from microbeseg_torch.models.convert import (
    _quant_module_name,
    act_amax_from_model,
    act_amax_to_model,
    state_dict_from_variables,
)
from microbeseg_torch.models.unet import build_unet
from microbeseg_torch.ops.kernels.matmul import (
    conv3x3_int8,
    conv3x3_int8_plain,
    matmul_bf16,
    matmul_bf16_plain,
    matmul_int8,
    matmul_int8_plain,
)
from tests.test_torch_models import random_variables

ARCH = dict(filters=(8, 32), act_fun="mish", normalization="gn")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


# --- K5 -------------------------------------------------------------------

def _tpu_kernel_product(a, b, acc_dtype):
    """The body of the TPU kernel (``matmul_kernel``'s ``dot_general``) on
    whole operands.  The kernel itself keeps its accumulator in TPU VMEM
    scratch, which the CPU cannot allocate, interpreted or not."""
    return jax.lax.dot_general(jnp.asarray(a), jnp.asarray(b),
                               (((1,), (0,)), ((), ())),
                               preferred_element_type=acc_dtype)


@pytest.mark.parametrize("shape", [(64, 2304, 16), (37, 200, 9)])
def test_matmul_int8_plain_is_the_tpu_kernels_product(shape):
    """Exact, at the deepest K of the path (2304 taps of up to 127 * 127
    pass 2^24, where a float32 product would round) and at a ragged shape;
    the extremes +-127 included."""
    M, K, N = shape
    rng = np.random.default_rng(K)
    a = rng.integers(-127, 128, (M, K), dtype=np.int8)
    b = rng.integers(-127, 128, (K, N), dtype=np.int8)
    a[0], b[:, 0] = 127, -127
    ref = np.asarray(_tpu_kernel_product(a, b, jnp.int32))
    assert ref[0, 0] == -127 * 127 * K
    got = matmul_int8_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    # on CPU tensors the wrapper is the plain version
    np.testing.assert_array_equal(
        matmul_int8(torch.from_numpy(a), torch.from_numpy(b)).numpy(), ref)


@pytest.mark.parametrize("shape", [(64, 2304, 16), (37, 200, 9)])
def test_matmul_bf16_plain_is_the_tpu_kernels_product(shape):
    """Both sum float32 products of the same bfloat16 values and round to
    bfloat16 once; the orders of summation differ, so a sum next to a
    rounding boundary may land one bfloat16 step away: rtol 2^-7, and atol
    for sums near zero from the float32 sums' own difference."""
    M, K, N = shape
    rng = np.random.default_rng(K + 1)
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    with jax.default_matmul_precision("highest"):
        ref = _tpu_kernel_product(
            jnp.asarray(a.float().numpy(), jnp.bfloat16),
            jnp.asarray(b.float().numpy(), jnp.bfloat16),
            jnp.float32).astype(jnp.bfloat16)
    ref = np.asarray(ref.astype(jnp.float32))
    got = matmul_bf16_plain(a, b)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2.0 ** -7,
                               atol=1e-6 * K * 16)
    torch.testing.assert_close(matmul_bf16(a, b), got, rtol=0, atol=0)


def test_matmul_wrappers_refuse_what_the_kernel_does_not_take():
    a = torch.zeros((4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="do not multiply"):
        matmul_int8(a, torch.zeros((7, 2), dtype=torch.int8))
    with pytest.raises(ValueError, match="must be"):
        matmul_int8(a.float(), torch.zeros((8, 2)))
    with pytest.raises(ValueError, match="must be"):
        matmul_bf16(a, torch.zeros((8, 2), dtype=torch.int8))
    with pytest.raises(ValueError, match="empty"):
        matmul_int8(a[:0], torch.zeros((8, 2), dtype=torch.int8))


# --- QuantConv alone ------------------------------------------------------

def _jax_quant_stages(kernel, x, x_scale):
    """The stages of the JAX ``QuantConv`` (``blocks.py``), step by step."""
    w_amax = jnp.max(jnp.abs(kernel), axis=(0, 1, 2))
    w_scale = jnp.maximum(w_amax, 1e-12) / 127.0
    w_q = jnp.clip(jnp.round(kernel / w_scale), -127, 127).astype(jnp.int8)
    x_q = jnp.clip(jnp.round(x / x_scale), -127, 127).astype(jnp.int8)
    y = jax.lax.conv_general_dilated(
        x_q, w_q, window_strides=(1, 1), padding=((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    return np.asarray(w_q), np.asarray(x_q), np.asarray(y)


@pytest.mark.parametrize("act_amax", [None, 2.5], ids=["dynamic", "static"])
def test_quantconv_matches_jax(act_amax):
    """One layer, the same float32 input (2 x 256 x 256 x 8), kernel and
    bias: ``w_q``, ``x_q`` and the int32 sums are identical, the output
    agrees to 1e-6 relative.  Dynamic scales, then one given ``act_amax``
    (below the input's maximum, so the clip saturates some values)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 256, 256, 8)).astype(np.float32)
    x[1] *= 0.3   # the two samples get different dynamic scales
    kernel = (rng.standard_normal((3, 3, 8, 16)) / 8).astype(np.float32)
    bias = (rng.standard_normal(16) * 0.1).astype(np.float32)

    variables = {"params": {"kernel": jnp.asarray(kernel),
                            "bias": jnp.asarray(bias)}}
    if act_amax is None:
        x_scale = jnp.maximum(jnp.max(jnp.abs(x), axis=(1, 2, 3),
                                      keepdims=True), 1e-12) / 127.0
    else:
        variables["quant"] = {"act_amax": jnp.float32(act_amax)}
        x_scale = jnp.maximum(jnp.float32(act_amax), 1e-12) / 127.0
    ref = np.asarray(jblocks.QuantConv(16, jnp.float32).apply(
        variables, jnp.asarray(x)))
    ref_wq, ref_xq, ref_y = _jax_quant_stages(kernel, x, x_scale)

    layer = blocks.QuantConv(8, 16).eval()
    layer.load_state_dict({
        "weight": torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
        "bias": torch.from_numpy(bias)})
    if act_amax is not None:
        layer.act_amax = torch.tensor(act_amax)
        layer.calibrated = True
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        w_q, _ = layer.quantized_weight()
        x_q, _ = layer.quantized_input(xt)
        y = layer.int32_conv(x_q, w_q)
        out = layer.forward_int8(xt)
    np.testing.assert_array_equal(w_q.numpy().reshape(3, 3, 8, 16), ref_wq)
    np.testing.assert_array_equal(x_q.numpy(), ref_xq)
    assert y.dtype == torch.int32
    np.testing.assert_array_equal(y.numpy(), ref_y)
    if act_amax is not None:
        assert (np.abs(ref_xq) == 127).mean() > 1e-3   # the clip saturated
    assert out.shape == (2, 16, 256, 256) and out.dtype == torch.float32
    assert out.is_contiguous()
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=1e-6, atol=1e-6)
    # a channels-last input comes back channels-last, with the same values
    with torch.no_grad():
        out_cl = layer.forward_int8(
            xt.contiguous(memory_format=torch.channels_last))
    assert out_cl.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(out_cl, out, rtol=0, atol=0)


@pytest.mark.parametrize("channels", [8, 12, 10, 9])
def test_tap_operand_is_the_3x3_unfold(channels):
    """The 9-tap operand against ``F.unfold`` of the same values in float32,
    for channel counts that move as 8-, 4-, 2- and 1-byte words, from a
    contiguous and from a permuted ``x_q``."""
    rng = np.random.default_rng(channels)
    x_q = torch.from_numpy(
        rng.integers(-127, 128, (2, 7, 5, channels), dtype=np.int8))
    nchw = x_q.permute(0, 3, 1, 2).float()
    ref = torch.nn.functional.unfold(nchw, 3, padding=1)   # (B, C*9, H*W)
    ref = ref.view(2, channels, 9, 35).permute(0, 3, 2, 1).reshape(70, -1)
    for x in (x_q, x_q.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)):
        got = blocks.QuantConv.tap_operand(x)
        assert got.dtype == torch.int8 and got.is_contiguous()
        torch.testing.assert_close(got.float(), ref, rtol=0, atol=0)


def test_quantconv_output_dtype_follows_autocast():
    """The working dtype comes from autocast, not from the input."""
    layer = blocks.QuantConv(8, 8).eval()
    x = torch.randn(1, 8, 16, 16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert layer.forward_int8(x.to(torch.bfloat16)).dtype == torch.float32
        with torch.autocast("cpu", dtype=torch.bfloat16):
            assert layer.forward_int8(x).dtype == torch.bfloat16
    assert "act_amax" not in layer.state_dict()
    assert set(layer.state_dict()) == {"weight", "bias"}


@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
@pytest.mark.parametrize("working", ["float32", "bf16_autocast"])
@pytest.mark.parametrize("width", [32, 40])
@pytest.mark.parametrize("channels", [8, 16, 64])
@pytest.mark.parametrize("scales", ["calibrated", "per_sample"])
def test_conv3x3_int8_is_the_chain_bit_for_bit(scales, channels, width,
                                               working, layout):
    """``forward_int8`` (one ``conv3x3_int8`` call) equals ``int32_conv`` then
    ``dequantize`` bit for bit on the CPU, for one scale per layer and one per
    sample, both working types and both memory formats of the input."""
    rng = np.random.default_rng(channels + width)
    layer = blocks.QuantConv(channels, 12).eval()
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(
            rng.standard_normal(layer.weight.shape).astype(np.float32)))
        layer.bias.copy_(torch.from_numpy(
            rng.standard_normal(12).astype(np.float32)))
    if scales == "calibrated":
        layer.act_amax = torch.tensor(2.5)
        layer.calibrated = True
    x = torch.from_numpy(
        (rng.standard_normal((3, channels, 24, width))
         * np.array([0.5, 1.0, 3.0]).reshape(3, 1, 1, 1)).astype(np.float32))
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    autocast = torch.autocast("cpu", dtype=torch.bfloat16,
                              enabled=working == "bf16_autocast")
    with torch.no_grad(), autocast:
        w_q, w_scale = layer.quantized_weight()
        x_q, x_scale = layer.quantized_input(x)
        chain = layer.dequantize(layer.int32_conv(x_q, w_q), x_scale,
                                 w_scale, x)
        got = layer.forward_int8(x)
        direct = conv3x3_int8(x_q, w_q, x_scale * w_scale,
                              layer.bias.detach().float(), chain.dtype)
    assert got.dtype == chain.dtype == (
        torch.bfloat16 if working == "bf16_autocast" else torch.float32)
    assert got.shape == (3, 12, 24, width)
    assert got.is_contiguous(
        memory_format=torch.channels_last) == (layout == "channels_last")
    assert got.stride() == chain.stride()
    assert torch.equal(got, chain)
    assert torch.equal(direct.permute(0, 3, 1, 2), chain)
    assert float(got.float().abs().max()) > 0


def test_conv3x3_int8_wrapper_refuses_what_the_kernel_does_not_take():
    x_q = torch.zeros((2, 4, 4, 8), dtype=torch.int8)
    w_q = torch.zeros((72, 3), dtype=torch.int8)
    scale, bias = torch.ones(3), torch.zeros(3)
    for fn in (conv3x3_int8, conv3x3_int8_plain):
        out = fn(x_q, w_q, scale, bias)
        assert out.shape == (2, 4, 4, 3) and out.dtype == torch.float32
        assert fn(x_q, w_q, torch.ones(2, 1, 1, 3), bias,
                  torch.bfloat16).dtype == torch.bfloat16
        with pytest.raises(ValueError, match=r"\(9 \* C, O\)"):
            fn(x_q, w_q[:71], scale, bias)
        with pytest.raises(ValueError, match="must be int8"):
            fn(x_q.float(), w_q, scale, bias)
        with pytest.raises(ValueError, match="must be float32"):
            fn(x_q, w_q, scale.double(), bias)
        with pytest.raises(ValueError, match="out_dtype"):
            fn(x_q, w_q, scale, bias, torch.float16)
        with pytest.raises(ValueError, match="do not fit"):
            fn(x_q, w_q, torch.ones(5), bias)
        with pytest.raises(ValueError, match="empty"):
            fn(x_q[:0], w_q, scale, bias)
    with pytest.raises(RuntimeError, match="unsupported device"):
        conv3x3_int8(x_q.to("meta"), w_q.to("meta"), scale.to("meta"),
                     bias.to("meta"))


@pytest.mark.parametrize("h,w,c_in,c_out,expected", [
    (256, 256, 64, 64, True),
    (512, 512, 128, 128, True),     # large tile, levels 0 and 1
    (128, 128, 128, 128, False),    # below the spatial cut
    (256, 256, 1, 64, False),       # the input convolution
    (32, 32, 512, 512, False),      # a deep level
    (64, 64, 256, 256, False),      # below the spatial cut
])
def test_quantize_this_is_the_jax_predicate(h, w, c_in, c_out, expected):
    assert blocks._quantize_this(h, w, c_in, c_out) is expected
    assert jblocks._quantize_this(h, w, c_in, c_out) is expected


# --- the model ------------------------------------------------------------

@pytest.fixture(scope="module")
def model_case():
    """One set of weights in both frameworks, one input, and the JAX
    outputs: int8 on dynamic scales, and calibrated, with what went into and
    came out of each int8 layer of the calibrated run.  The weights are flax's
    own initialisation from ``PRNGKey(0)``, as in the JAX suite's int8
    tests, whose bars are held below: with ``random_variables`` (random
    biases and norm affines) the JAX model itself misses its calibrated
    against dynamic bar (0.110 against 0.086)."""
    rng = np.random.default_rng(21)
    jcfg = JModelConfig(**ARCH)
    x = rng.standard_normal((2, 256, 256, 1)).astype(np.float32)
    variables = jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        jbuild(jcfg, dtype=jnp.float32).init(
            jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    jquant = jbuild(jcfg, dtype=jnp.float32, quantize=True)
    layers = []   # (flax path, input, output) of each QuantConv, in order

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if (isinstance(context.module, jblocks.QuantConv)
                and context.method_name == "__call__"):
            layers.append((context.module.path, np.array(args[0]),
                           np.array(out)))
        return out

    with jax.default_matmul_precision("highest"):
        dyn = jquant.apply(variables, jnp.asarray(x), train=False)
        _, upd = jquant.apply(variables, jnp.asarray(x), train=False,
                              mutable=["quant"])
        with nn.intercept_methods(record):
            static = jquant.apply({**variables, **upd}, jnp.asarray(x),
                                  train=False)
    quant = jax.tree_util.tree_map(np.array, dict(upd["quant"]))
    return dict(variables=variables, x=x, quant=quant, layers=layers,
                dyn=[np.asarray(o) for o in dyn],
                static=[np.asarray(o) for o in static])


def _port_model(variables, **kw):
    net = build_unet(ModelConfig(**ARCH), **kw).eval()
    net.load_state_dict(state_dict_from_variables(variables))
    return net


def _apply(net, x):
    with torch.no_grad():
        return [o.numpy() for o in net(torch.from_numpy(x))]


def test_quantized_model_keys_and_train_mode(model_case):
    """``quantize=True`` keeps the state_dict keys, and train mode is
    bit-identical to the unquantised model.

    Both forwards run on one CPU thread: the CPU library splits a
    convolution's and a GroupNorm's sums by thread count, and float32 sums
    split another way differ by ~1e-5 here.  Bit-identity is a claim about
    the port's code path, so the library's partitioning is pinned."""
    plain = _port_model(model_case["variables"])
    quant = _port_model(model_case["variables"], quantize=True)
    assert list(plain.state_dict()) == list(quant.state_dict())
    x = model_case["x"][:, :64, :64]
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            a = plain.train()(torch.from_numpy(x))
            b = quant.train()(torch.from_numpy(x))
    finally:
        torch.set_num_threads(n_threads)
    for pa, pb in zip(a, b):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)


def test_quantized_layers_match_jax_on_jax_inputs(model_case):
    """Every int8 layer of the model, given what JAX's layer of the same
    name was given in the calibrated run and the carried ``act_amax``: the
    same ``x_q``, and JAX's output to 1e-6 relative (measured: equal).  So
    each layer quantises on JAX's scale; what is left between the two
    models comes from upstream of the layers, see the next test."""
    quant = _port_model(model_case["variables"], quantize=True)
    act_amax_to_model(quant, model_case["quant"])
    assert len(model_case["layers"]) == 5
    for path, x_in, y_out in model_case["layers"]:
        layer = quant.get_submodule(_quant_module_name(*path))
        assert isinstance(layer, blocks.QuantConv) and layer.calibrated
        scale = np.maximum(np.float32(layer.act_amax.item()),
                           np.float32(1e-12)) / np.float32(127.0)
        ref_xq = np.clip(np.round(x_in / scale), -127, 127).astype(np.int8)
        xt = torch.from_numpy(x_in).permute(0, 3, 1, 2).contiguous()
        with torch.no_grad():
            x_q, _ = layer.quantized_input(xt)
            out = layer.forward_int8(xt)
        np.testing.assert_array_equal(x_q.numpy(), ref_xq, err_msg=str(path))
        np.testing.assert_allclose(
            out.permute(0, 2, 3, 1).numpy(), y_out, rtol=1e-6,
            atol=1e-6 * np.abs(y_out).max(), err_msg=str(path))


def _own_layer_inputs(net, x):
    """The model's outputs for ``x`` and what each int8 layer was given."""
    seen = {}
    for name, m in net.named_modules():
        if isinstance(m, blocks.QuantConv):
            def spy(t, name=name, fwd=m.forward_int8):
                seen[name] = t.detach().clone()
                return fwd(t)
            m.forward_int8 = spy
    return _apply(net, x), seen


def test_quantized_model_matches_jax_from_carried_scales(model_case):
    """Eval outputs from JAX's calibrated ``act_amax`` values; the carry
    goes both ways.

    Why the outputs are not equal, shown on the first int8 layer the data
    reaches (``enc0.conv1``): the float32 convolution, mish and group norm
    upstream sum in another order in the two frameworks, so the layer's
    input differs by 1.2e-5 of its maximum (held: 1e-4).  That moves
    0.008% of its values (held: 0.1%) across a rounding boundary, each by
    one int8 step and each within 4.5e-4 of a step of the boundary in
    JAX's own input (held: 5e-3).  Every other value of ``x_q`` is equal.
    One step is 0.8% of a layer's range, so from there on the two models
    compute on slightly different activations, and the later layers' inputs
    differ by up to 1.3% of their maximum with 2.5% of ``x_q`` moved.

    End to end, measured: 1.07% and 1.20% of RMS with torch on 2 threads,
    0.56% and 0.64% on 4 (another summation order).  Held: RMS difference
    <= 2.5% of RMS, twice the worst reading, and less than half the
    difference between int8 and float32."""
    quant = _port_model(model_case["variables"], quantize=True)
    act_amax_to_model(quant, model_case["quant"])
    n_layers = sum(m.calibrated for m in quant.modules()
                   if isinstance(m, blocks.QuantConv))
    assert n_layers == len(jax.tree_util.tree_leaves(model_case["quant"])) == 5
    back = act_amax_from_model(quant)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(model_case["quant"]))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(model_case["quant"])):
        assert a == b
    outs, seen = _own_layer_inputs(quant, model_case["x"])

    path, x_jax, _ = model_case["layers"][0]
    assert path == ("encoder", "enc0", "conv1")
    layer = quant.get_submodule(_quant_module_name(*path))
    x_own = seen[_quant_module_name(*path)]
    assert (np.abs(x_own.permute(0, 2, 3, 1).numpy() - x_jax).max()
            <= 1e-4 * np.abs(x_jax).max())
    with torch.no_grad():
        q_own, x_scale = layer.quantized_input(x_own)
        q_jax, _ = layer.quantized_input(
            torch.from_numpy(x_jax).permute(0, 3, 1, 2))
    moved = (q_own.int() - q_jax.int()).numpy() != 0
    assert moved.mean() <= 1e-3
    assert np.abs((q_own.int() - q_jax.int()).numpy()).max() <= 1
    steps = x_jax / np.float32(x_scale.item())
    assert np.abs(steps % 1 - 0.5)[moved].max(initial=0) <= 5e-3

    plain = _apply(_port_model(model_case["variables"]), model_case["x"])
    for o, r, p in zip(outs, model_case["static"], plain):
        assert o.shape == r.shape == (2, 256, 256, 1)
        assert _rms(o - r) <= 0.025 * _rms(r)
        assert _rms(o - r) < 0.5 * _rms(o - p)


def test_quantized_model_dynamic_scales_match_jax(model_case):
    """Without calibration both sides quantise per sample (measured: 1.22%
    and 1.34% of RMS on 2 threads; held to twice the worst reading)."""
    quant = _port_model(model_case["variables"], quantize=True)
    for o, r in zip(_apply(quant, model_case["x"]), model_case["dyn"]):
        assert _rms(o - r) <= 0.027 * _rms(r)


def test_quantized_model_quality_bars(model_case):
    """The JAX suite's own bars: int8 against the port's float32 model, RMS
    difference < 0.08 RMS + 1e-3; calibrated against dynamic scales, within
    0.05 RMS + 1e-3.  The port calibrates itself here, as the engine does:
    one calibrating pass, then a commit."""
    x = model_case["x"]
    plain = _apply(_port_model(model_case["variables"]), x)
    quant = _port_model(model_case["variables"], quantize=True)
    dyn = _apply(quant, x)
    layers = [m for m in quant.modules() if isinstance(m, blocks.QuantConv)]
    for m in layers:
        m.calibrating = True
    during = _apply(quant, x)
    for m in layers:
        m.commit_calibration()
        m.calibrating = False
    assert sum(m.calibrated for m in layers) == 5
    # the port's own maxima are JAX's, to float32 summation order upstream
    for a, b in zip(jax.tree_util.tree_leaves(act_amax_from_model(quant)),
                    jax.tree_util.tree_leaves(model_case["quant"])):
        assert a > 0 and abs(a - b) <= 1e-4 * b
    static = _apply(quant, x)
    for p, d, c, s in zip(plain, dyn, during, static):
        np.testing.assert_array_equal(c, d)  # the pass runs on dynamic scales
        assert _rms(p - d) < 0.08 * _rms(p) + 1e-3
        assert _rms(d - s) < 0.05 * max(_rms(d), 1e-6) + 1e-3
        assert _rms(d - s) > 0   # the static scales are in use


# --- the engine -----------------------------------------------------------

def _engine(variables, **cfg):
    return InferenceEngine(_port_model(variables), "distance",
                           cfg=InferConfig(quantize=True, batch_size=2, **cfg),
                           device="cpu")


def _amaxes(engine):
    return jax.tree_util.tree_leaves(act_amax_from_model(engine.models[0]))


def test_engine_calibrates_once_and_is_deterministic(model_case):
    rng = np.random.default_rng(30)
    x = rng.standard_normal((3, 256, 256)).astype(np.float32)
    model = _port_model(model_case["variables"])
    eng = InferenceEngine(model, "distance", device="cpu",
                          cfg=InferConfig(quantize=True, batch_size=2))
    assert not eng._quant_calibrated and _amaxes(eng) == []
    m1 = eng.segment(x)
    assert eng._quant_calibrated and eng._quant_shapes == {(256, 256)}
    first = _amaxes(eng)
    assert len(first) == 5 and all(a > 0 for a in first)
    m2 = eng.segment(x)
    np.testing.assert_array_equal(m1, m2)
    assert _amaxes(eng) == first     # no second calibration
    # the caller's model is left as it was
    assert not any(getattr(m, "quantize", False) or
                   getattr(m, "calibrated", False) for m in model.modules())
    # calibration sample: the first min(4, device batch, n) = 2 frames
    # through the forward's own prep; its maxima are the layers' own
    solo = InferenceEngine(model, "distance", device="cpu",
                           cfg=InferConfig(quantize=True, batch_size=2))
    solo.segment(x[:2])
    assert _amaxes(solo) == first


def test_engine_calibrates_per_shape(model_case):
    """256^2 then 128^2: the second shape runs its own pass, quantises no
    layer, and the earlier maxima survive; a larger maximum merges in."""
    rng = np.random.default_rng(31)
    eng = _engine(model_case["variables"])
    frames = rng.standard_normal((2, 256, 256)).astype(np.float32)
    eng.segment(frames)
    first = _amaxes(eng)
    assert (256, 256) in eng._quant_shapes and len(first) == 5
    eng.segment(rng.standard_normal((2, 128, 128)).astype(np.float32))
    assert eng._quant_shapes == {(256, 256), (128, 128)}
    assert _amaxes(eng) == first
    # maxima only grow: a pass on a sample with an outlier raises them, a
    # pass on the first sample again changes nothing
    eng._quant_shapes.clear()
    spiky = frames.copy()
    spiky[0, 100:140, 100:140] = 40.0
    eng.segment(spiky)
    raised = _amaxes(eng)
    assert all(b >= a for a, b in zip(first, raised)) and raised != first
    eng._quant_shapes.clear()
    eng.segment(frames)
    assert _amaxes(eng) == raised


def test_engine_calibrates_tiled_path(model_case):
    rng = np.random.default_rng(32)
    x = rng.standard_normal((1, 384, 384)).astype(np.float32)
    eng = _engine(model_case["variables"], use_tiling=True, tile_size=256,
                  tile_overlap=64)
    masks = eng.segment(x)
    assert masks.shape == (1, 384, 384) and masks.dtype == np.uint16
    assert eng._quant_shapes == {(256, 256)} and len(_amaxes(eng)) == 5
    assert eng.oom_count == 0


def test_engine_quantize_refuses_an_ensemble(model_case):
    a = _port_model(model_case["variables"])
    with pytest.raises(ValueError, match="ensembles"):
        InferenceEngine(a, "distance", cfg=InferConfig(quantize=True),
                        device="cpu", extra=[a])
    # a model without ConvBlocks has nothing to calibrate
    eng = InferenceEngine(torch.nn.Identity(), device="cpu",
                          cfg=InferConfig(quantize=True))
    assert eng._quant_shapes is None and not eng._quant_calibrated


def test_engine_calibration_out_of_memory_keeps_dynamic_scales(model_case,
                                                               monkeypatch):
    """A calibration pass that runs out of memory leaves every layer on the
    per-sample scales and marks the shape done; other errors are raised."""
    rng = np.random.default_rng(33)
    x = rng.standard_normal((2, 256, 256)).astype(np.float32)
    eng = _engine(model_case["variables"])
    net = eng.models[0]
    real = type(net).forward

    def failing(self, inp):
        if any(m.calibrating for m in self.modules()
               if isinstance(m, blocks.QuantConv)):
            real(self, inp)   # layers see their maxima, then memory runs out
            raise torch.cuda.OutOfMemoryError("calibration")
        return real(self, inp)

    monkeypatch.setattr(type(net), "forward", failing)
    masks = eng.segment(x)
    assert masks.shape == x.shape and eng.oom_count == 0
    assert eng._quant_shapes == {(256, 256)} and _amaxes(eng) == []
    assert not any(m.calibrating or m._seen_amax is not None
                   for m in net.modules() if isinstance(m, blocks.QuantConv))

    def broken(self, inp):
        raise RuntimeError("not memory")

    eng2 = _engine(model_case["variables"])
    monkeypatch.setattr(type(net), "forward", broken)
    with pytest.raises(RuntimeError, match="not memory"):
        eng2.segment(x)
