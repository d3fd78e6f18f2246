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


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the cores, and
    the step loops here are thousands of small tensor operations."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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


def _boundary_probs(seed, n=3, shape=(64, 64)):
    """Softmax maps (n, H, W, 3) with cells ringed by a boundary class."""
    from scipy import ndimage
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        inst = synthetic_blobs(rng, shape=shape, n_blobs=6)
        mask = inst > 0
        inner = np.zeros(shape, bool)
        for k in np.unique(inst)[1:]:  # each cell gets its own ring
            inner |= ndimage.binary_erosion(inst == k, iterations=2)
        logits = rng.normal(0, 0.4, shape + (3,)).astype(np.float32)
        logits[..., 0] += 3.0 * ~mask
        logits[..., 1] += 3.0 * inner
        logits[..., 2] += 3.0 * (mask & ~inner)
        e = np.exp(logits - logits.max(-1, keepdims=True))
        out.append((e / e.sum(-1, keepdims=True)).astype(np.float32))
    return np.stack(out)


def test_boundary_postprocessing_matches_jax():
    """Same softmax maps, the watershed flood on both sides: identical."""
    probs = _boundary_probs(4)
    ours = tpp.boundary_postprocessing(torch.from_numpy(probs)).numpy()
    assert ours.dtype == np.uint16 and ours.shape == probs.shape[:3]
    for i in range(len(probs)):
        ref = np.asarray(jpp.boundary_postprocessing(jnp.asarray(probs[i])))
        np.testing.assert_array_equal(ours[i], ref)
        assert ref.max() >= 3
    single = tpp.boundary_postprocessing(torch.from_numpy(probs[0]))
    np.testing.assert_array_equal(single.numpy(), ours[0])


def test_boundary_packed_flood_matches_jax_pallas_interpret():
    """The card's route ('pallas': the packed flood with 2 levels) against
    JAX's prune and ``flood_pallas`` in interpret mode."""
    from microbeseg_tpu.ops.pallas.flood import flood_pallas

    probs = _boundary_probs(5, n=2)
    ours = tpp._boundary_postprocessing(torch.from_numpy(probs),
                                        method="pallas").numpy()
    for i in range(len(probs)):
        p = jnp.asarray(probs[i])
        mask = jnp.argmax(p, axis=-1) == 1
        seeds = jpp._prune_small_seeds((p[..., 1] * (1.0 - p[..., 2])) > 0.5,
                                       4.0, 0.0, max_seeds=256)
        ref = np.asarray(flood_pallas(-mask.astype(jnp.float32), seeds, mask,
                                      n_levels=2, label_bits=12,
                                      interpret=True))
        np.testing.assert_array_equal(ours[i], ref.astype(np.uint16))
        assert ref.max() >= 3


def test_threshold_grid_matches_jax_and_single_calls():
    """8 threshold pairs as one batch: identical to JAX's vmapped grid and
    to 8 single calls of the port."""
    border, cell = _batch(6, n=1)
    pairs = np.array([(tc, ts) for tc in (0.05, 0.10, 0.15, 0.20)
                      for ts in (0.35, 0.45)], np.float32)
    ours = tpp.distance_postprocessing_grid(
        torch.from_numpy(border[0]), torch.from_numpy(cell[0]), pairs).numpy()
    assert ours.shape == (8, 64, 64) and ours.dtype == np.uint16
    ref = np.asarray(jpp.distance_postprocessing_grid(
        jnp.asarray(border[0]), jnp.asarray(cell[0]), jnp.asarray(pairs)))
    np.testing.assert_array_equal(ours, ref)
    for i, (tc, ts) in enumerate(pairs):
        one = tpp.distance_postprocessing(
            torch.from_numpy(border[0]), torch.from_numpy(cell[0]),
            float(ts), float(tc)).numpy()
        np.testing.assert_array_equal(ours[i], one)
    assert len({int(m.sum()) for m in ours}) > 1  # the thresholds matter


def test_threshold_grid_big_side_runs_pair_by_pair():
    """A side above 768 takes the pairs one after the other; same masks."""
    rng = np.random.default_rng(8)
    border, cell = _predictions(rng, shape=(48, 800), n_blobs=6)
    pairs = [(0.10, 0.45), (0.20, 0.35)]
    ours = tpp.distance_postprocessing_grid(
        torch.from_numpy(border), torch.from_numpy(cell), pairs).numpy()
    assert ours.shape == (2, 48, 800)
    for i, (tc, ts) in enumerate(pairs):
        ref = np.asarray(jpp.distance_postprocessing(
            jnp.asarray(border), jnp.asarray(cell), jnp.float32(ts),
            jnp.float32(tc), method="flood"))
        np.testing.assert_array_equal(ours[i], ref)


def test_prune_at_the_largest_seed_cap():
    """max_seeds 32768 (a 2048^2 frame's cap): the area table has 131073
    entries, ids stay within uint16, and the port equals JAX."""
    seeds = np.zeros((1, 96, 96), bool)
    for k in range(200):
        cy, cx = 4 + 6 * (k // 15), 3 + 6 * (k % 15)
        seeds[0, cy:cy + 3, cx:cx + 3] = True
    ours = tpp._prune_small_seeds(torch.from_numpy(seeds), 4.0, 0.10,
                                  max_seeds=32768).numpy()
    ref = np.asarray(jpp._prune_small_seeds(
        jnp.asarray(seeds[0]), min_area_floor=4.0, rel_mean=0.10,
        max_seeds=32768))
    np.testing.assert_array_equal(ours[0], ref)
    assert ours.max() == 200


def test_packed_method_on_a_big_side_takes_the_frame_flood():
    """method='pallas' on a side above 768 routes to ``flood_tiled`` (24
    label bits, the whole frame as one window): identical coverage and
    per-instance IoU >= 0.99 against the watershed flood, the JAX suite's
    bar for its tiled flood."""
    rng = np.random.default_rng(9)
    border, cell = _predictions(rng, shape=(48, 800), n_blobs=6)
    args = (torch.from_numpy(border), torch.from_numpy(cell), 0.45, 0.10)
    packed = tpp.distance_postprocessing(*args, method="pallas").numpy()
    ref = tpp.distance_postprocessing(*args, method="flood").numpy()
    assert ref.max() >= 3
    assert np.array_equal(packed > 0, ref > 0)
    for k in range(1, int(ref.max()) + 1):
        a, b = packed == k, ref == k
        assert (a & b).sum() / max((a | b).sum(), 1) >= 0.99


@pytest.mark.parametrize("rel_mean", [0.10, 0.0])
def test_prune_takes_one_label_fn_and_matches_jax(rel_mean):
    """``_prune_small_seeds`` numbers the seed components with one function,
    ``cc.ranked_components`` unless the caller names another, and gives what
    JAX's gives from its two: blobs plus 600 speckles, the distance method's
    and the boundary method's ``rel_mean``."""
    from microbeseg_torch.ops import cc

    rng = np.random.default_rng(17)
    _, cell = _predictions(rng, shape=(64, 80))
    seeds = cell > 0.5
    seeds.flat[rng.choice(seeds.size, size=600, replace=False)] = True
    calls = []

    def label_fn(mask):
        calls.append(tuple(mask.shape))
        return cc.sequentialize_components_plain(
            cc.connected_components_plain(mask))

    ours = tpp._prune_small_seeds(torch.from_numpy(seeds[None]), 4.0,
                                  rel_mean, max_seeds=256)
    named = tpp._prune_small_seeds(torch.from_numpy(seeds[None]), 4.0,
                                   rel_mean, max_seeds=256,
                                   label_fn=label_fn)
    ref = np.asarray(jpp._prune_small_seeds(jnp.asarray(seeds), 4.0,
                                            rel_mean, max_seeds=256))
    assert calls == [(1, 64, 80)]
    np.testing.assert_array_equal(ours[0].numpy(), ref)
    np.testing.assert_array_equal(named[0].numpy(), ref)
    assert 0 < ours.max() < 600


def test_postprocessing_label_fn_reaches_both_methods():
    """``label_fn`` and ``flood_fn`` are the only kernels the distance and
    the boundary method take; the plain pair gives the default's masks."""
    from microbeseg_torch.ops import cc
    from microbeseg_torch.ops.kernels import flood

    border, cell = _batch(23, n=2)
    probs = _boundary_probs(29, n=2)
    plain = dict(label_fn=cc.ranked_components_plain,
                 flood_fn=flood.flood_or_fallback)
    got = tpp._distance_postprocessing(
        torch.from_numpy(border), torch.from_numpy(cell), 0.45, 0.09,
        method="pallas", **plain)
    want = tpp.distance_postprocessing(
        torch.from_numpy(border), torch.from_numpy(cell), 0.45, 0.09,
        method="pallas")
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert got.numpy().max() > 0
    got = tpp._boundary_postprocessing(torch.from_numpy(probs),
                                       method="pallas", **plain)
    want = tpp._boundary_postprocessing(torch.from_numpy(probs),
                                        method="pallas")
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert got.numpy().max() > 0


def _cones(centers, shape=(64, 64)):
    """The cone fields of the JAX suite's ``TestWatershedFast``."""
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    cell = np.zeros(shape, np.float32)
    for cy, cx in centers:
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        cell = np.maximum(cell, np.clip(1 - d / 12.0, 0, 1))
    return cell


@pytest.mark.parametrize("connectivity", [1, 2])
def test_watershed_fast_matches_jax(connectivity):
    """Drainage labelling and flood cleanup, batched (B = 2), bit for bit
    against the JAX ``watershed_fast`` per frame: the JAX suite's three
    cones, and a noisy blob field whose minima are not all seeded (the
    cleanup fills those basins)."""
    from scipy import ndimage

    from microbeseg_tpu.ops.watershed import watershed_fast as jfast
    from microbeseg_torch.ops.watershed import watershed_fast

    rng = np.random.default_rng(41)
    cones = _cones(((20, 20), (20, 40), (44, 30)))
    blobs = _cones(((12, 14), (30, 50), (50, 20), (40, 40)))
    blobs = blobs + rng.normal(0, 0.03, blobs.shape).astype(np.float32)
    cell = np.stack([cones, blobs])
    mask = cell > 0.1
    seeds = np.stack([ndimage.label(c > 0.6)[0] for c in cell])
    seeds[1][seeds[1] == 2] = 0  # one basin without its marker
    ours = watershed_fast(torch.from_numpy(-cell), torch.from_numpy(seeds),
                          torch.from_numpy(mask), connectivity).numpy()
    assert ours.dtype == np.int32 and ours.shape == cell.shape
    for i in range(2):
        ref = np.asarray(jfast(jnp.asarray(-cell[i]), jnp.asarray(seeds[i]),
                               jnp.asarray(mask[i]),
                               connectivity=connectivity))
        np.testing.assert_array_equal(ours[i], ref)
        assert set(np.unique(ref)) - {0} == set(np.unique(seeds[i])) - {0}
    np.testing.assert_array_equal(
        watershed_fast(torch.from_numpy(-cones), torch.from_numpy(seeds[0]),
                       torch.from_numpy(mask[0]), connectivity).numpy(),
        ours[0])


def test_fast_method_matches_jax():
    """``method='fast'`` on the JAX suite's random blob fields (distance
    maps of synthetic blobs), B = 2, bit for bit against the JAX
    ``distance_postprocessing(..., method='fast')`` per frame."""
    rng = np.random.default_rng(1234)
    preds = []
    for _ in range(2):
        mask = synthetic_blobs(rng, shape=(96, 96), n_blobs=7)
        props = regionprops_oracle(mask)
        mal = max(p["major_axis_length"] for p in props)
        cell, nb = distance_label_oracle(mask, int(np.ceil(0.75 * mal)))
        preds.append((nb.astype(np.float32), cell.astype(np.float32)))
    border = np.stack([p[0] for p in preds])
    cell = np.stack([p[1] for p in preds])
    ours = tpp.distance_postprocessing(
        torch.from_numpy(border), torch.from_numpy(cell), 0.45, 0.10,
        method="fast").numpy()
    assert ours.dtype == np.uint16 and ours.shape == border.shape
    for i in range(2):
        ref = np.asarray(jpp.distance_postprocessing(
            jnp.asarray(border[i]), jnp.asarray(cell[i]), jnp.float32(0.45),
            jnp.float32(0.10), method="fast"))
        np.testing.assert_array_equal(ours[i], ref)
        assert ref.max() >= 3
