"""Port vs JAX: tile positions and stitching, resize, CLAHE.

Same numpy-seeded inputs through both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import microbeseg_tpu.inference.tiling as jt
from microbeseg_tpu.ops.augment import clahe as jclahe
from microbeseg_torch.inference import tiling as tt
from microbeseg_torch.ops.augment import clahe
from microbeseg_torch.ops.resize import resize, weight_matrix


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the cores, and
    the step loops here are thousands of small tensor operations."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("size,tile,overlap", [
    (2048, 512, 64), (200, 64, 16), (64, 64, 16), (40, 64, 16),
    (65, 64, 16), (1000, 512, 64), (8192, 1024, 128)])
def test_tile_positions_equal(size, tile, overlap):
    ours = tt.tile_positions(size, tile, overlap)
    assert ours == jt.tile_positions(size, tile, overlap)
    assert ours[0] == 0 and ours[-1] + tile >= size


@pytest.mark.parametrize("shape,tile,overlap", [((100, 150), 64, 16),
                                                ((64, 200), 64, 8)])
def test_stitching_matches_jax_and_numpy_reference(shape, tile, overlap):
    """atol 1e-6: float32 sums of at most 4 weighted tiles per pixel, added
    in the same tile order on both sides; the numpy reference sums in
    float64."""
    rng = np.random.default_rng(0)
    imgs = rng.random((3,) + shape).astype(np.float32)
    tiles, pos = zip(*(tt.extract_tiles(im, tile, overlap) for im in imgs))
    jtiles, jpos = jt.extract_tiles(imgs[0], tile, overlap)
    assert pos[0] == jpos
    np.testing.assert_array_equal(tiles[0], jtiles)
    tiles = np.stack(tiles)
    dev_tiles = tt.extract_tiles_device(torch.from_numpy(imgs), tile, pos[0])
    np.testing.assert_array_equal(dev_tiles.numpy(), tiles)
    # stitching the frame's own tiles gives the frame back
    noisy = tiles + rng.normal(0, 0.1, tiles.shape).astype(np.float32)
    for batch, back in ((tiles, imgs), (noisy, None)):
        ours = tt.stitch_tiles_device(torch.from_numpy(batch), pos[0],
                                      shape).numpy()
        ref = np.asarray(jt.stitch_tiles_device(jnp.asarray(batch), pos[0],
                                                shape))
        np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
        for i in range(len(batch)):
            np.testing.assert_allclose(
                ours[i], tt.stitch_predictions(batch[i], pos[0], shape),
                atol=1e-6, rtol=0)
        if back is not None:
            np.testing.assert_allclose(ours, back, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tt._feather_weight(tile),
                                  jt._feather_weight(tile))
    wrapped = tt.stitch_predictions_batch(noisy, pos[0], shape, device="cpu")
    np.testing.assert_array_equal(wrapped, ours)


@pytest.mark.parametrize("src,dst,method", [
    ((64, 64), (32, 32), "cubic"), ((50, 50), (23, 23), "cubic"),
    ((64, 50), (32, 23), "cubic"), ((32, 23), (64, 50), "linear"),
    ((23, 23), (50, 50), "linear"), ((40, 64), (20, 64), "cubic")])
def test_resize_matches_jax_image_resize(src, dst, method):
    """atol 1e-5: the same float32 weights, products summed in another
    order."""
    rng = np.random.default_rng(1)
    x = (rng.random((2,) + src).astype(np.float32) * 2 - 1)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2,) + dst, method))
    ours = resize(torch.from_numpy(x), dst, method).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)
    x4 = rng.random((2,) + src + (3,)).astype(np.float32)
    ref4 = np.asarray(jax.image.resize(jnp.asarray(x4), (2,) + dst + (3,),
                                       method))
    np.testing.assert_allclose(resize(torch.from_numpy(x4), dst,
                                      method).numpy(), ref4, atol=1e-5,
                               rtol=0)


def test_resize_weights_are_jax_weights_not_torch_bicubic():
    from jax._src.image.scale import _fill_keys_cubic_kernel, compute_weight_mat
    ref = np.asarray(compute_weight_mat(50, 23, 23 / 50, 0.0,
                                        _fill_keys_cubic_kernel, True))
    np.testing.assert_allclose(weight_matrix(50, 23, "cubic"), ref,
                               atol=1e-6, rtol=0)
    # the antialiased Keys a = -0.5 kernel is not F.interpolate's bicubic
    x = torch.from_numpy(np.random.default_rng(2).random((1, 1, 64, 64))
                         .astype(np.float32))
    theirs = torch.nn.functional.interpolate(x, size=(32, 32),
                                             mode="bicubic")[0]
    assert (resize(x[0], (32, 32), "cubic") - theirs).abs().max() > 1e-2
    with pytest.raises(ValueError, match="method"):
        resize(x[0], (32, 32), "lanczos3")


@pytest.mark.parametrize("shape", [(64, 64), (50, 70), (33, 129)])
def test_clahe_matches_jax(shape):
    """Tolerance: the per-pixel lookup reads bfloat16 tables on both sides.
    Where the two float32 cdfs differ in their last bit, a table entry may
    round to the other bfloat16 neighbour, one bfloat16 step of 2^-8 at
    values near 1; hence atol 4e-3 on any pixel, while the mean difference
    stays below 1e-5."""
    rng = np.random.default_rng(3)
    img = (rng.random(shape).astype(np.float32) ** 2)
    ref = np.asarray(jclahe(jnp.asarray(img)))
    ours = clahe(torch.from_numpy(img))
    assert ours.shape == shape and ours.dtype == torch.float32
    diff = np.abs(ours.numpy() - ref)
    assert diff.max() <= 4e-3 and diff.mean() < 1e-5
    batched = clahe(torch.from_numpy(np.stack([img, img[::-1].copy()])))
    torch.testing.assert_close(batched[0], ours, rtol=0, atol=0)
    assert float(ours.std()) > float(img.std())  # contrast went up
