"""Port vs JAX package: label generation and its building blocks.

Morphology, the EDT (with its ``valid`` domain), ``relabel_sequential`` and
the integer label types are held bit for bit; region moments within 1e-5
relative; the float label types within 1e-5 absolute.  Masks: seeded blob
masks of 64^2 and one 256^2 mask of ``data/real_glutamicum``.
"""

import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from microbeseg_tpu.training.workers import create_labels as jcreate_labels
from microbeseg_torch.ops import cc as tcc
from microbeseg_torch.ops import edt as tedt
from microbeseg_torch.ops import labelgen as tl
from microbeseg_torch.ops import morphology as tmorph
from microbeseg_torch.ops import regionprops as trp
from microbeseg_torch.training.workers import create_labels
from microbeseg_torch.utils.tiff import imread, imwrite
from tests.conftest import synthetic_blobs

# the JAX package's ops/__init__ re-exports functions under some module
# names, so the modules are taken from importlib
jcc = importlib.import_module("microbeseg_tpu.ops.cc")
jedt = importlib.import_module("microbeseg_tpu.ops.edt")
jl = importlib.import_module("microbeseg_tpu.ops.labelgen")
jmorph = importlib.import_module("microbeseg_tpu.ops.morphology")
jrp = importlib.import_module("microbeseg_tpu.ops.regionprops")

REAL = Path(__file__).resolve().parents[1] / "data" / "real_glutamicum"
LABEL_TYPES = ("boundary", "border", "j4", "adapted_border", "cell_dist",
               "cell_dist_clipped", "distance")
EXACT_TYPES = ("boundary", "border", "j4", "adapted_border")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _blob_mask(seed):
    """Touching and separate disks, some near the border."""
    rng = np.random.default_rng(seed)
    return synthetic_blobs(rng, shape=(64, 64), n_blobs=12, r_range=(3, 10))


MASKS = {"blobs0": lambda: _blob_mask(0), "blobs1": lambda: _blob_mask(1),
         "real40": lambda: imread(REAL / "mask_40.tif")}


@pytest.fixture(scope="module")
def masks():
    return {k: f() for k, f in MASKS.items()}


@pytest.fixture(scope="module")
def jax_labels(masks):
    """The JAX package's labels, each computed once."""
    out = {}
    for name, m in masks.items():
        mal = jl.max_major_axis_length(m)
        out[name] = mal, {t: jl.get_label(m, t, max_mal=mal)
                          for t in LABEL_TYPES}
    return out


@pytest.mark.parametrize("name", list(MASKS))
@pytest.mark.parametrize("label_type", LABEL_TYPES)
def test_get_label_matches_jax(masks, jax_labels, name, label_type):
    mask = masks[name]
    mal, ref = jax_labels[name]
    assert tl.max_major_axis_length(mask, device="cpu") == mal
    ours = tl.get_label(mask, label_type, max_mal=mal, device="cpu")
    ref = ref[label_type]
    if label_type == "distance":
        for o, r in zip(ours, ref):
            assert o.dtype == np.float32 and o.shape == mask.shape
            np.testing.assert_allclose(o, r, rtol=0, atol=1e-5)
        assert ours[0].max() == 1.0 and ours[1].max() > 0.5
    elif label_type in EXACT_TYPES:
        assert ours.dtype == ref.dtype and ours.shape == mask.shape
        np.testing.assert_array_equal(ours, ref)
        assert ours.max() >= 1
    else:
        assert ours.dtype == np.float32
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
        assert ours.max() > 0.5


def test_distance_label_gap_path_runs_connected_components(masks,
                                                           monkeypatch):
    """The gap step labels the bottom hat with ``cc.connected_components``
    (kernel K3 on the card), then ``relabel_sequential``."""
    calls = []
    real = tcc.connected_components

    def spy(m, *a, **k):
        calls.append(tuple(m.shape))
        return real(m, *a, **k)

    monkeypatch.setattr(tcc, "connected_components", spy)
    mask = masks["real40"]
    tl.get_label(mask, "distance", max_mal=tl.max_major_axis_length(
        mask, device="cpu"), device="cpu")
    assert calls == [(256, 256)]


def test_label_entry_points_need_the_card_or_the_cpu(masks, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.get_label(masks["blobs0"], "boundary")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_labels(tmp_path, "distance")


def test_too_many_instances_raise():
    mask = np.zeros(64 * 129, np.int32)
    mask[:8193] = np.arange(1, 8194)
    mask = mask.reshape(64, 129)
    with pytest.raises(ValueError, match="8192-instance"):
        tl.get_label(mask, "distance", max_mal=2, device="cpu")
    with pytest.raises(ValueError, match="not known"):
        tl.get_label(mask[:8, :8], "nope", device="cpu")


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

SES = {"cross": jmorph.generate_binary_structure(2, 1),
       "square": jmorph.generate_binary_structure(2, 2),
       "disk3": jmorph.disk(3), "disk4": jmorph.disk(4)}


@pytest.mark.parametrize("se", list(SES))
def test_binary_morphology_matches_jax(se):
    rng = np.random.default_rng(5)
    np.testing.assert_array_equal(tmorph.disk(4), jmorph.disk(4))
    for shape, p in (((37, 53), 0.5), ((64, 64), 0.85), ((3, 9), 0.3)):
        x = np.stack([rng.random(shape) < p, np.zeros(shape, bool),
                      np.ones(shape, bool)])
        for fn in ("binary_dilation", "binary_erosion", "binary_closing",
                   "binary_opening"):
            ours = getattr(tmorph, fn)(torch.from_numpy(x), SES[se]).numpy()
            for i in range(len(x)):
                ref = np.asarray(getattr(jmorph, fn)(jnp.asarray(x[i]),
                                                     SES[se]))
                np.testing.assert_array_equal(ours[i], ref, err_msg=fn)


def test_grey_closing_matches_jax():
    rng = np.random.default_rng(6)
    for shape in ((37, 53), (64, 64), (2, 5)):
        x = rng.random(shape).astype(np.float32)
        np.testing.assert_array_equal(
            tmorph.grey_closing(torch.from_numpy(x)).numpy(),
            np.asarray(jmorph.grey_closing(jnp.asarray(x))))


@pytest.mark.parametrize("shape", [(37, 53), (64, 64), (1, 17), (40, 3)])
def test_edt_matches_jax(shape):
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    for p in (0.05, 0.5, 0.95, 1.0):
        feature = rng.random(shape) < p
        valid = rng.random(shape) < 0.8
        valid[:, : shape[1] // 3] = True
        ours = tedt.edt(torch.from_numpy(np.stack([feature, feature])),
                        torch.from_numpy(np.stack([valid, np.ones_like(
                            valid)]))).numpy()
        np.testing.assert_array_equal(
            ours[0], np.asarray(jedt.edt(jnp.asarray(feature),
                                         jnp.asarray(valid))))
        np.testing.assert_array_equal(
            ours[1], np.asarray(jedt.edt(jnp.asarray(feature))))
        np.testing.assert_array_equal(
            tedt.edt(torch.from_numpy(feature)).numpy(), ours[1])


def test_relabel_sequential_matches_jax(masks):
    rng = np.random.default_rng(8)
    for m in masks.values():
        sparse = np.where(m > 0, m.astype(np.int32) * 97 + 5, 0)
        sparse[rng.random(m.shape) < 0.01] = -4
        ours = tcc.relabel_sequential(torch.from_numpy(sparse)).numpy()
        for bound in (0, int(sparse.max()) + 1):
            np.testing.assert_array_equal(
                ours, np.asarray(jcc.relabel_sequential(jnp.asarray(sparse),
                                                        id_bound=bound)))
        assert int(tcc.num_labels(torch.from_numpy(sparse))) == int(
            jcc.num_labels(jnp.asarray(sparse))) == len(np.unique(m)) - 1


def test_regionprops_matches_jax(masks):
    """Area and centroid exactly; the moment-derived lengths within 1e-5
    relative; and the decisions label generation takes on them,
    ceil(major axis) and minor axis >= 3, the same."""
    for m in masks.values():
        dense, n = tl._dense_relabel(m)
        for cap in (tl._bucket(n + 1), max(n // 2, 1)):
            ours = trp.regionprops(torch.from_numpy(dense), max_labels=cap)
            ref = jrp.regionprops(jnp.asarray(dense), max_labels=cap)
            for field in ref._fields:
                o = getattr(ours, field).numpy()
                r = np.asarray(getattr(ref, field))
                if field in ("area", "centroid"):
                    np.testing.assert_array_equal(o, r)
                else:
                    np.testing.assert_allclose(o, r, rtol=1e-5, atol=0)
            np.testing.assert_array_equal(
                np.ceil(ours.major_axis_length.numpy()),
                np.ceil(np.asarray(ref.major_axis_length)))
            np.testing.assert_array_equal(
                ours.minor_axis_length.numpy() >= 3.0,
                np.asarray(ref.minor_axis_length) >= 3.0)


@pytest.mark.parametrize("label_type", ["distance", "border"])
def test_create_labels_writes_what_jax_writes(tmp_path, label_type):
    """The same file names and contents on a small train/val tree."""
    trees = {}
    for side in ("jax", "port"):
        root = tmp_path / side
        for split, seeds in (("train", (10, 11)), ("val", (12, 13))):
            (root / split).mkdir(parents=True)
            for s in seeds:
                imwrite(root / split / f"mask_{s:02d}.tif",
                        _blob_mask(s).astype(np.uint16))
        trees[side] = root
    messages = []
    assert jcreate_labels(trees["jax"], label_type)
    assert create_labels(trees["port"], label_type,
                         text_output=messages.append, device="cpu")
    assert messages == ["Create labels"]
    for split in ("train", "val"):
        names = sorted(p.name for p in (trees["jax"] / split).iterdir())
        assert names == sorted(p.name for p in (trees["port"] / split)
                               .iterdir())
        assert len(names) == (6 if label_type == "distance" else 4)
        for name in names:
            ref = imread(trees["jax"] / split / name)
            ours = imread(trees["port"] / split / name)
            assert ours.dtype == ref.dtype
            np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    assert not create_labels(trees["port"] / "train", label_type,
                             text_output=messages.append, device="cpu")
    assert "at least two annotated images" in messages[-1]
