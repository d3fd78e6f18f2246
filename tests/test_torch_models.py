"""Port vs JAX: the (D)U-Net forward pass and checkpoint loading.

Weights are drawn with numpy into the flax variable tree, carried to the
port with ``state_dict_from_variables``, and both forwards run at float32
(flax under matmul precision 'highest': at the default the CPU truncates
f32 convolutions to bf16).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from microbeseg_tpu.config import ModelConfig as JModelConfig
from microbeseg_tpu.models.unet import build_unet as jbuild
from microbeseg_torch.config import ModelConfig
from microbeseg_torch.models.convert import state_dict_from_variables
from microbeseg_torch.models.unet import build_unet


def random_variables(model, rng, size=32):
    """Flax variables of ``model`` with numpy-drawn leaves: fan-in scaled
    kernels, nonzero biases and norm affines, nonzero running stats."""
    tmpl = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 1)), train=False))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) * np.sqrt(1.0 / fan_in))
        if name.endswith("['var']"):
            return rng.uniform(0.5, 2.0, shape)
        if name.endswith("['scale']"):
            return rng.uniform(0.5, 1.5, shape)
        return rng.standard_normal(shape) * 0.1

    leaves = jax.tree_util.tree_map_with_path(draw, tmpl)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), leaves)


def _flax_forward(mcfg, variables, x):
    model = jbuild(mcfg, dtype=jnp.float32)
    with jax.default_matmul_precision("highest"):
        return model.apply(variables, jnp.asarray(x), train=False)


@pytest.mark.parametrize("kind,act,pool", [
    ("bn", "relu", "conv"), ("gn", "mish", "conv"), ("in", "relu", "max"),
    ("bn", "mish", "max"), ("gn", "relu", "max"), ("in", "mish", "conv"),
])
def test_dunet_forward_matches_flax(kind, act, pool):
    rng = np.random.default_rng(sum(map(ord, kind + act + pool)))
    arch = dict(unet_type="DU", act_fun=act, pool_method=pool,
                normalization=kind, filters=(8, 16))
    jcfg = JModelConfig(**arch)
    variables = random_variables(jbuild(jcfg, dtype=jnp.float32), rng)
    x = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)
    ref = _flax_forward(jcfg, variables, x)

    net = build_unet(ModelConfig(**arch)).eval()
    net.load_state_dict(state_dict_from_variables(variables))
    with torch.no_grad():
        ours = net(torch.from_numpy(x))
    assert len(ours) == 2
    for o, r in zip(ours, ref):
        assert o.shape == (2, 32, 32, 1) and o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=0)


def test_unet_boundary_forward_matches_flax():
    rng = np.random.default_rng(4)
    arch = dict(unet_type="U", ch_out=3, normalization="bn", filters=(4, 16))
    jcfg = JModelConfig(**arch)
    variables = random_variables(jbuild(jcfg, dtype=jnp.float32), rng)
    x = rng.standard_normal((1, 32, 32, 1)).astype(np.float32)
    ref = np.asarray(_flax_forward(jcfg, variables, x))
    net = build_unet(ModelConfig(**arch)).eval()
    net.load_state_dict(state_dict_from_variables(variables))
    with torch.no_grad():
        ours = net(torch.from_numpy(x)).numpy()
    assert ours.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)


def test_state_dict_keys_are_the_reference_layout():
    """The port's keys are what the reference .pth carries (the layout the
    JAX package's exporter writes)."""
    from microbeseg_tpu.models.torch_import import export_state_dict

    rng = np.random.default_rng(5)
    jcfg = JModelConfig(filters=(4, 16))
    variables = random_variables(jbuild(jcfg, dtype=jnp.float32), rng)
    sd = state_dict_from_variables(variables)
    ref = export_state_dict(variables, jcfg)
    assert set(sd) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(sd[k].numpy(), ref[k], err_msg=k)
    assert set(build_unet(ModelConfig(filters=(4, 16))).state_dict()) == set(sd)


def test_checkpoint_written_by_jax_loads(tmp_path):
    from microbeseg_tpu.config import TrainConfig
    from microbeseg_tpu.models.io import save_model
    from microbeseg_torch.models.io import load_model, load_variables

    rng = np.random.default_rng(6)
    jcfg = JModelConfig(normalization="gn", act_fun="mish", filters=(8, 16))
    variables = random_variables(jbuild(jcfg, dtype=jnp.float32), rng)
    ckpt = save_model(variables, TrainConfig(model=jcfg, run_name="m_01"),
                      tmp_path)
    loaded = load_variables(ckpt)
    assert (jax.tree_util.tree_structure(loaded)
            == jax.tree_util.tree_structure(variables))
    for a, b in zip(jax.tree_util.tree_leaves(loaded),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, b)

    net, cfg = load_model(tmp_path / "m_01", device="cpu")
    assert cfg.model.filters == (8, 16) and cfg.label_type == "distance"
    assert not net.training
    x = rng.standard_normal((1, 32, 32, 1)).astype(np.float32)
    ref = _flax_forward(jcfg, variables, x)
    with torch.no_grad():
        ours = net(torch.from_numpy(x))
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=0)


def test_msgpack_reader_matches_msgpack():
    """The port's reader decodes every type it claims, as msgpack does."""
    msgpack = pytest.importorskip("msgpack")
    from microbeseg_torch.models.io import read_msgpack

    obj = {"a": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**40,
                 -1, -32, -33, -128, -129, -32768, -40000, -2**40],
           "b": [0.5, -1e300, True, False, None, "x" * 40, "y" * 300],
           "c": {"nested": {str(i): i for i in range(20)}},
           "d": b"\x00\x01" * 200, "e": list(range(20))}
    assert read_msgpack(msgpack.packb(obj, use_bin_type=True)) == obj
    assert read_msgpack(msgpack.packb(1.5, use_single_float=True)) == 1.5
    with pytest.raises(ValueError, match="chunked"):
        read_msgpack(msgpack.packb({"__msgpack_chunked_array__": True}))


@pytest.mark.parametrize("arch", [
    dict(unet_type="DU", normalization="bn", filters=(8, 32)),
    dict(unet_type="DU", normalization="gn", act_fun="mish",
         pool_method="max", filters=(8, 16)),
    dict(unet_type="U", ch_out=3, normalization="in", filters=(4, 16)),
], ids=["DU-bn", "DU-gn-max", "U-in"])
def test_checkpoint_written_by_the_port_loads_in_jax(tmp_path, arch):
    """``save_model`` writes the flax tree the weights came from, leaf for
    leaf, and both packages load it."""
    from microbeseg_tpu.models.io import load_model as jload
    from microbeseg_torch.config import TrainConfig
    from microbeseg_torch.models.convert import variables_from_state_dict
    from microbeseg_torch.models.io import load_model, save_model

    rng = np.random.default_rng(9)
    jcfg = JModelConfig(**arch)
    variables = random_variables(jbuild(jcfg, dtype=jnp.float32), rng)
    net = build_unet(ModelConfig(**arch))
    net.load_state_dict(state_dict_from_variables(variables))
    back = variables_from_state_dict(net.state_dict())
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(variables))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, b)

    label_type = "boundary" if arch["unet_type"] == "U" else "distance"
    ckpt = save_model(net, TrainConfig(model=ModelConfig(**arch),
                                       label_type=label_type,
                                       run_name="port_w"), tmp_path)
    assert ckpt == tmp_path / "port_w.ckpt"
    jmodel, jvars, jtcfg = jload(tmp_path / "port_w", dtype=jnp.float32)
    assert jtcfg.model == jcfg and jtcfg.label_type == label_type
    for a, b in zip(jax.tree_util.tree_leaves(jvars),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), b)
    again, tcfg = load_model(ckpt, device="cpu")
    assert tcfg.model == ModelConfig(**arch)
    for k, v in net.state_dict().items():
        torch.testing.assert_close(again.state_dict()[k], v, rtol=0, atol=0)


def test_write_msgpack_round_trips():
    from microbeseg_torch.models.io import read_msgpack, write_msgpack

    obj = {"a": [0, 1, 127, 128, 65536, 2**40, -1, -33, -2**40],
           "b": [0.5, -1e300, True, False, None, "x" * 40, "y" * 300,
                 "z" * 70000],
           "c": {"nested": {str(i): i for i in range(20)}},
           "d": b"\x00\x01" * 200, "e": list(range(20)),
           "f": {"k": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
                 "s": np.float32(2.5), "big": np.zeros((300, 300), np.int8)}}
    got = read_msgpack(write_msgpack(obj))
    assert {k: got[k] for k in "abcde"} == {k: obj[k] for k in "abcde"}
    np.testing.assert_array_equal(got["f"]["k"], obj["f"]["k"])
    assert got["f"]["k"].dtype == np.float32
    assert got["f"]["s"] == np.float32(2.5)
    np.testing.assert_array_equal(got["f"]["big"], obj["f"]["big"])
    with pytest.raises(TypeError, match="cannot encode"):
        write_msgpack({"x": object()})
    msgpack = pytest.importorskip("msgpack")
    plain = {k: obj[k] for k in "abcde"}
    assert msgpack.unpackb(write_msgpack(plain), raw=False,
                           strict_map_key=False) == plain


@pytest.mark.parametrize("num_devices", [None, 4])
def test_sidecar_matches_jax_write_sidecar(tmp_path, num_devices):
    """``save_model``'s sidecar has the keys of JAX's ``write_sidecar`` on
    the same ``TrainConfig``, with the same values apart from the writing
    package's name: ``num_gpus`` (``num_devices or 1``) and ``transforms``
    included."""
    import json

    from microbeseg_tpu.config import TrainConfig as JTrainConfig
    from microbeseg_tpu.config import write_sidecar
    from microbeseg_torch.config import TrainConfig
    from microbeseg_torch.models.io import save_model

    arch = dict(unet_type="DU", normalization="bn", filters=(8, 16))
    kw = dict(label_type="distance", run_name="side_01", batch_size=6,
              num_devices=num_devices)
    save_model(build_unet(ModelConfig(**arch)),
               TrainConfig(model=ModelConfig(**arch), **kw), tmp_path / "port")
    (tmp_path / "jax").mkdir()
    write_sidecar(JTrainConfig(model=JModelConfig(**arch), **kw),
                  tmp_path / "jax")
    ours = json.loads((tmp_path / "port" / "side_01.json").read_text())
    ref = json.loads((tmp_path / "jax" / "side_01.json").read_text())
    assert list(ours) == list(ref)
    assert ours["num_gpus"] == ref["num_gpus"] == (num_devices or 1)
    assert ours["transforms"] == ref["transforms"]
    assert ours.pop("framework") == "microbeseg_torch"
    assert ref.pop("framework") == "microbeseg_tpu"
    assert ours == ref
