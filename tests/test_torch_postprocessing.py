"""Port vs JAX: distance post-processing on identical prediction maps.

Both sides get the same numpy border/cell maps.  The port works on the
whole batch at once; the JAX function runs per frame (the engine vmaps it).
The uint16 masks must be identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import microbeseg_tpu.ops.postprocessing as jpp
from microbeseg_torch.ops import postprocessing as tpp
from tests.conftest import synthetic_blobs
from tests.oracles import distance_label_oracle, regionprops_oracle


def _predictions(rng, shape=(64, 64), n_blobs=6):
    mask = synthetic_blobs(rng, shape=shape, n_blobs=n_blobs)
    props = regionprops_oracle(mask)
    max_mal = int(np.ceil(max(p["major_axis_length"] for p in props)))
    cell, nb = distance_label_oracle(mask, int(np.ceil(0.75 * max_mal)))
    noise = rng.normal(0, 0.03, cell.shape).astype(np.float32)
    return nb.astype(np.float32), (cell + noise).astype(np.float32)


def _batch(seed, n=3, shape=(64, 64)):
    rng = np.random.default_rng(seed)
    preds = [_predictions(rng, shape) for _ in range(n)]
    return (np.stack([p[0] for p in preds]), np.stack([p[1] for p in preds]))


def test_flood_method_batched_matches_jax():
    border, cell = _batch(1)
    ours = tpp.distance_postprocessing(
        torch.from_numpy(border), torch.from_numpy(cell), 0.45, 0.10,
        method="flood").numpy()
    assert ours.dtype == np.uint16 and ours.shape == border.shape
    for i in range(len(cell)):
        ref = np.asarray(jpp.distance_postprocessing(
            jnp.asarray(border[i]), jnp.asarray(cell[i]), jnp.float32(0.45),
            jnp.float32(0.10), method="flood"))
        np.testing.assert_array_equal(ours[i], ref)
        assert ref.max() >= 3


def test_pallas_method_matches_jax_stages_and_flood_interpret():
    """'pallas' = the packed-key flood: JAX's gaussian, seed and prune
    stages, then flood_pallas in interpret mode."""
    from microbeseg_tpu.ops.filters import gaussian_filter
    from microbeseg_tpu.ops.pallas.flood import flood_pallas

    border, cell = _batch(2)
    ours = tpp.distance_postprocessing(
        torch.from_numpy(border), torch.from_numpy(cell), 0.45, 0.10,
        method="pallas").numpy()
    for i in range(len(cell)):
        c = gaussian_filter(jnp.asarray(cell[i]), sigma=0.5)
        b = jnp.clip(jnp.asarray(border[i]), 0.0, 1.0)
        bb = jnp.tan(b * b)
        bb = jnp.clip(jnp.where(bb < 0.05, 0.0, bb), 0.0, 1.0)
        seeds = jpp._prune_small_seeds((c - bb) > jnp.float32(0.45), 4.0,
                                       0.10, max_seeds=256)
        ref = np.asarray(flood_pallas(-c, seeds, c > jnp.float32(0.10),
                                      label_bits=12, interpret=True))
        np.testing.assert_array_equal(ours[i], ref.astype(np.uint16))


@pytest.mark.parametrize("method", ["flood", "pallas"])
def test_stages_after_the_gaussian_match_jax(method):
    """The JAX stages start from the port's own smoothed cell map and
    borders, so the thresholds, the prune and the flood are held bit for
    bit whatever ulp the two gaussians (or tans) differ by."""
    from microbeseg_tpu.ops.pallas.flood import flood_pallas
    from microbeseg_tpu.ops.watershed import watershed as jws
    from microbeseg_torch.ops.filters import gaussian_filter

    border, cell = _batch(3)
    ours = tpp.distance_postprocessing(
        torch.from_numpy(border), torch.from_numpy(cell), 0.45, 0.10,
        method=method).numpy()
    smoothed = gaussian_filter(torch.from_numpy(cell), sigma=0.5)
    b = torch.clamp(torch.from_numpy(border), 0.0, 1.0)
    borders = torch.tan(b * b)
    borders = torch.clamp(torch.where(borders < 0.05, 0.0, borders), 0.0, 1.0)
    for i in range(len(cell)):
        c = jnp.asarray(smoothed[i].numpy())
        seeds = jpp._prune_small_seeds(
            (c - jnp.asarray(borders[i].numpy())) > jnp.float32(0.45), 4.0,
            0.10, max_seeds=256)
        mask = c > jnp.float32(0.10)
        if method == "flood":
            ref = jws(-c, seeds, mask, n_levels=128)
        else:
            ref = flood_pallas(-c, seeds, mask, label_bits=12,
                               interpret=True)
        np.testing.assert_array_equal(ours[i],
                                      np.asarray(ref).astype(np.uint16))
        assert ours[i].max() >= 3


def test_auto_off_cpu_raises_for_labels_beyond_packed_key():
    """With more seeds than the packed key holds, 'auto' takes the
    watershed flood on the CPU and raises on any other device."""
    z = torch.zeros((1, 16, 16))
    out = tpp.distance_postprocessing(z, z, 0.45, 0.10, max_seeds=1 << 24)
    assert int(out.sum()) == 0
    meta = z.to("meta")
    with pytest.raises(NotImplementedError, match="item 13"):
        tpp.distance_postprocessing(meta, meta, 0.45, 0.10,
                                    max_seeds=1 << 24)


def test_speckle_beyond_cap_keeps_real_seeds():
    """600 one-pixel speckles in raster order before 3 real seeds, with
    a cap of 256: the area prune runs before the cap, so exactly the 3 real
    seeds survive, as in the JAX package.  Batched with a plain frame, the
    prune statistics stay per image."""
    seeds = np.zeros((2, 160, 160), bool)
    for k in range(600):
        seeds[0, 2 * (k // 75), 2 * (k % 75) + 1] = True
    real = [(120, 20), (130, 80), (150, 140)]
    for cy, cx in real:
        seeds[:, cy - 2:cy + 3, cx - 2:cx + 3] = True
    seeds[1, 10:13, 10:13] = True  # area 9: kept in frame 1 only
    for rel_mean in (0.0, 0.10):
        ours = tpp._prune_small_seeds(torch.from_numpy(seeds), 4.0, rel_mean,
                                      max_seeds=256).numpy()
        for i in range(2):
            ref = np.asarray(jpp._prune_small_seeds(
                jnp.asarray(seeds[i]), min_area_floor=4.0,
                rel_mean=rel_mean, max_seeds=256))
            np.testing.assert_array_equal(ours[i], ref)
        assert int(ours[0].max()) == 3
        assert {int(ours[0][cy, cx]) for cy, cx in real} == {1, 2, 3}
        assert int(ours[1].max()) == 4


def test_empty_and_constant_predictions():
    z = torch.zeros((2, 32, 32))
    for method in ("flood", "pallas"):
        out = tpp.distance_postprocessing(z, z, 0.45, 0.10, method=method)
        assert out.shape == (2, 32, 32) and int(out.sum()) == 0
    single = tpp.distance_postprocessing(z[0], z[0] + 1.0, 0.45, 0.10)
    assert single.shape == (32, 32)
