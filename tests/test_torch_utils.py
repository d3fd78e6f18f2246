"""Port vs JAX: the host-side image utilities the port keeps its own copies
of (``microbeseg_torch/utils/image.py``), exported from
``microbeseg_torch.utils`` as the JAX package exports them."""

import numpy as np
import pytest

import microbeseg_tpu.utils as jutils
import microbeseg_torch.utils as tutils


@pytest.mark.parametrize("shape", [
    (64, 64), (64, 50), (50, 64), (100, 130), (1, 1), (3, 50, 64),
    (2, 64, 60), (2, 40, 64)])
@pytest.mark.parametrize("dtype,pad_val", [(np.uint16, 0),
                                           (np.float32, -1.5)])
def test_zero_pad_model_input_matches_jax(shape, dtype, pad_val):
    """Up-left padding to the bucket shape: the same padded array and pads,
    for frames and (T, H, W) stacks that need padding on both sides, on one
    side only, or on none."""
    rng = np.random.default_rng(sum(shape))
    img = (rng.random(shape) * 1000).astype(dtype)
    got, pads = tutils.zero_pad_model_input(img, pad_val)
    want, jpads = jutils.zero_pad_model_input(img, pad_val)
    assert pads == jpads
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[..., pads[0]:, pads[1]:], img)


def test_zero_pad_model_input_refuses_what_jax_refuses():
    big = np.zeros((9000, 10), np.uint16)
    for fn in (tutils.zero_pad_model_input, jutils.zero_pad_model_input):
        with pytest.raises(ValueError, match="largest pad bucket"):
            fn(big)


@pytest.mark.parametrize("dtype", [np.uint16, np.int32, np.float32])
def test_get_nucleus_ids_matches_jax(dtype):
    """Instance ids above 0 of seeded label images (negative values where
    the type has them, an empty image)."""
    rng = np.random.default_rng(7)
    low = -3 if np.dtype(dtype).kind != "u" else 0
    for img in (rng.integers(low, 40, (30, 45)).astype(dtype),
                np.where(rng.random((16, 16)) < 0.9, 0, 7).astype(dtype),
                np.zeros((8, 8), dtype)):
        got = tutils.get_nucleus_ids(img)
        want = jutils.get_nucleus_ids(img)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_package_exports_the_jax_packages_names():
    names = ("imread", "imwrite", "border_correction", "get_nucleus_ids",
             "min_max_normalization", "pad_bucket_shape", "unique_path",
             "zero_pad_model_input")
    for name in names:
        assert callable(getattr(jutils, name))
        assert getattr(tutils, name).__module__.startswith("microbeseg_torch")
