"""Port vs JAX: the large-frame flood (kernel K2's plain version).

The JAX package floods (tile + 2 * halo)^2 windows with ``_flood_packed``
and sweeps up what crosses a halo; the port floods the whole frame as one
window.  On one ring-guarded window the two are the same function and must
agree bit for bit.  On whole frames the JAX suite's own bar for its tiled
flood applies: identical coverage and per-instance IoU >= 0.99.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from microbeseg_tpu.ops.pallas.flood import _flood_packed, flood_tiled
from microbeseg_tpu.ops.watershed import watershed as jwatershed
from microbeseg_torch.ops.kernels import flood
from tests.test_graft_and_pallas import _blob_field


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the cores, and
    the step loops here are thousands of small tensor operations."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rod_field(rng, size=256):
    """Capsules much longer than a 32-px halo (the rods of the JAX suite)."""
    from scipy import ndimage
    yy, xx = np.mgrid[0:size, 0:size]
    cell = np.zeros((size, size), np.float32)
    for _ in range(10):
        cy, cx = rng.integers(20, size - 20, 2)
        ang = rng.uniform(0, np.pi)
        L, r = 80, 7
        dy, dx = np.sin(ang), np.cos(ang)
        t = np.clip((yy - cy) * dy + (xx - cx) * dx, -L / 2, L / 2)
        d = np.sqrt((yy - cy - t * dy) ** 2 + (xx - cx - t * dx) ** 2)
        cell = np.maximum(cell, np.clip(1 - d / r, 0, 1))
    seeds, _ = ndimage.label(cell > 0.6)
    return cell.astype(np.float32), seeds.astype(np.int32), cell > 0.1


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _ringed_field(shape):
    """Discs of radius 3 to 9 at random centres, one per 400 pixels, with
    noise; the mask's outer ring is cleared (the TPU kernel's contract) and
    every seed pixel draws its own marker above 4095."""
    H, W = shape
    rng = np.random.default_rng(H + W)
    yy, xx = np.mgrid[0:H, 0:W]
    cell = np.zeros(shape, np.float32)
    for _ in range(H * W // 400):
        cy, cx = rng.integers(0, H), rng.integers(0, W)
        cell = np.maximum(cell, np.clip(1 - np.sqrt(
            (yy - cy) ** 2 + (xx - cx) ** 2) / rng.uniform(3, 9), 0, 1))
    cell += rng.normal(0, 0.02, shape).astype(np.float32)
    mask = cell > 0.1
    mask[[0, -1], :] = False
    mask[:, [0, -1]] = False
    markers = np.where(cell > 0.6, rng.integers(5000, 9000, shape), 0)
    return cell, markers.astype(np.int32), mask


@pytest.mark.parametrize("n_levels, shape", [
    (8, (128, 128)), (128, (128, 128)), (128, (800, 13)), (128, (769, 40))],
    ids=["8", "128", "800x13", "769x40"])
def test_planes_flood_bit_exact_vs_pallas_interpret(n_levels, shape):
    """One ring-guarded window, markers above 4095: a 128 x 128 frame, and
    the frames whose bitplane words the card's front kernel has to split
    mid-row: an 800 x 13 strip and a 769 x 40 frame (one word and two words
    a row)."""
    cell, markers, mask = _ringed_field(shape)
    value, markers_t, mask_t = _t(-cell[None], markers[None], mask[None])
    qs, key0 = flood.packed_planes(value, markers_t, mask_t, n_levels)
    assert int(qs[0, 0, 0]) == flood.BIG_KEY
    ref = np.asarray(_flood_packed(jnp.asarray(qs.numpy()),
                                   jnp.asarray(key0.numpy()), n_levels,
                                   label_bits=24, interpret=True))
    ours = flood.flood_planes_plain(qs, key0, n_levels).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert ours.max() > 5000 and (ours > 0).sum() > (markers > 0).sum()


def _assert_same_instances(out, ref, n):
    assert np.array_equal(out > 0, ref > 0)  # identical coverage
    for k in range(1, n + 1):
        a, b = out == k, ref == k
        iou = (a & b).sum() / max((a | b).sum(), 1)
        assert iou >= 0.99, f"instance {k}: IoU {iou}"


@pytest.mark.parametrize("field", ["blobs", "rods"])
def test_whole_frame_flood_vs_jax_tiled_and_watershed(field):
    """128 levels, as in production; JAX's tiled flood at tile 64, halo 32
    in interpret mode, and the JAX watershed flood."""
    rng = np.random.default_rng(11)
    cell, seeds, mask = (_blob_field(rng, 256) if field == "blobs"
                         else _rod_field(rng))
    ours = flood.flood_tiled(*_t(-cell, seeds, mask)).numpy()
    assert ours.shape == cell.shape and ours.dtype == np.int32
    args = (jnp.asarray(-cell), jnp.asarray(seeds), jnp.asarray(mask))
    tiled = np.asarray(flood_tiled(*args, n_levels=128, tile=64, halo=32,
                                   interpret=True))
    _assert_same_instances(ours, tiled, seeds.max())
    ws = np.asarray(jwatershed(*args, n_levels=128))
    _assert_same_instances(ours, ws, seeds.max())


def test_ids_above_12_bits_come_through():
    rng = np.random.default_rng(3)
    cell, seeds, mask = _blob_field(rng, 128, n_blobs=8)
    shifted = np.where(seeds > 0, seeds + 5000, 0).astype(np.int32)
    out = flood.flood_tiled(*_t(-cell, shifted, mask), n_levels=8).numpy()
    assert set(np.unique(out)) - {0} == set(np.unique(shifted)) - {0}
    ref = np.asarray(flood_tiled(jnp.asarray(-cell), jnp.asarray(shifted),
                                 jnp.asarray(mask), n_levels=8, tile=64,
                                 halo=32, interpret=True))
    assert np.array_equal(out > 0, ref > 0)


def test_batched_frames_quantise_per_frame():
    """Two frames in one call equal two calls: each frame has its own
    level grid."""
    rng = np.random.default_rng(5)
    a = _blob_field(rng, 96, n_blobs=6)
    b = _blob_field(rng, 96, n_blobs=6)
    both = flood.flood_tiled_plain(*_t(
        np.stack([-a[0], -2.0 * b[0]]), np.stack([a[1], b[1]]),
        np.stack([a[2], b[2]])), n_levels=16)
    for i, (c, s, m) in enumerate((a, b)):
        scale = 1.0 if i == 0 else 2.0
        one = flood.flood_tiled_plain(*_t(-scale * c, s, m), n_levels=16)
        torch.testing.assert_close(both[i], one, rtol=0, atol=0)


def test_routing_by_side_and_label_capacity(monkeypatch):
    big = (1 << 24) - 1
    assert flood.packed_label_bits(768, 128, 4095) == 12
    assert flood.packed_label_bits(768, 128, 4096) == 24
    assert flood.packed_label_bits(769, 128, 255) == 24
    assert flood.packed_label_bits(2048, 128, big - 1) == 24
    assert flood.packed_label_bits(2048, 128, big) is None
    assert flood.packed_label_bits(2048, 129, 255) is None
    calls = []
    monkeypatch.setattr(flood, "flood_tiled", lambda *a, **k: calls.append(
        "tiled") or flood.flood_tiled_plain(*a, **k))
    monkeypatch.setattr(flood, "flood_packed", lambda *a, **k: calls.append(
        f"packed{k['label_bits']}") or flood.flood_packed_plain(*a, **k))
    v = torch.zeros((1, 4, 770))
    mk = torch.zeros((1, 4, 770), dtype=torch.int32)
    m = torch.zeros((1, 4, 770), dtype=torch.bool)
    flood.flood_or_fallback(v, mk, m, n_levels=2, max_label=300)
    flood.flood_or_fallback(v[..., :768], mk[..., :768], m[..., :768],
                            n_levels=2, max_label=300)
    flood.flood_or_fallback(v[..., :768], mk[..., :768], m[..., :768],
                            n_levels=2, max_label=5000)
    assert calls == ["tiled", "packed12", "packed24"]
    out = flood.flood_or_fallback(v, mk, m, n_levels=2, max_label=big)
    assert out.shape == v.shape  # the watershed flood, on the CPU
    with pytest.raises(NotImplementedError, match="item 13"):
        flood.flood_or_fallback(v.to("meta"), mk.to("meta"), m.to("meta"),
                                n_levels=2, max_label=big)
    with pytest.raises(ValueError, match="n_levels"):
        flood.flood_tiled_plain(v, mk, m, n_levels=129)
