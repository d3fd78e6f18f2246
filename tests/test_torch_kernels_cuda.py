"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device.  This file imports
no JAX, so on a machine with the card (and no JAX) it runs with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from microbeseg_torch.ops import cc
from microbeseg_torch.ops.kernels.flood import flood_packed, flood_packed_plain


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fields(seed, B, H, W):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    cell = np.zeros((B, H, W), np.float32)
    for b in range(B):
        for _ in range(8):
            cy, cx = rng.integers(3, H - 3), rng.integers(3, W - 3)
            r = float(rng.uniform(3, 9))
            cell[b] = np.maximum(cell[b], np.clip(
                1 - np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2) / r, 0, 1))
    cell += rng.normal(0, 0.02, cell.shape).astype(np.float32)
    return cell, rng.random((B, H, W)) < 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 64, 80), (3, 30, 46), (2, 12, 700)])
def test_kernels_match_plain(dev, shape):
    cell, speckle = _fields(sum(shape), *shape)
    v = torch.from_numpy(-cell).to(dev)
    mask = v < -0.1
    seeds_bin = (v < -0.6) | (torch.from_numpy(speckle).to(dev) & mask)
    for conn in (1, 2):
        lab = cc.connected_components(seeds_bin, conn)
        torch.testing.assert_close(
            lab, cc.connected_components_plain(seeds_bin, conn), rtol=0,
            atol=0)
        rank = cc.sequentialize_components(lab)
        torch.testing.assert_close(
            rank, cc.sequentialize_components_plain(lab), rtol=0, atol=0)
    for bits, offset in ((12, 0), (24, 5000)):
        markers = torch.where(rank > 0, rank + offset, 0)
        torch.testing.assert_close(
            flood_packed(v, markers, mask, label_bits=bits),
            flood_packed_plain(v, markers, mask, label_bits=bits),
            rtol=0, atol=0)


# csrc/cc.cu's tiles are 32^2 or 64^2 pixels: every K3_CORNER-th row and
# column is a tile edge of both
K3_CORNER = 32


def _k3_snake(H, W, tile=64):
    """A one-pixel serpentine on the last row of every tile row, joined at
    alternating ends: one component that crosses every tile."""
    m = np.zeros((H, W), bool)
    rows = list(range(min(tile, H) - 1, H, tile))
    for k, y in enumerate(rows):
        m[y] = True
        if k + 1 < len(rows):
            m[y:rows[k + 1] + 1, W - 1 if k % 2 == 0 else 0] = True
    return m


def _k3_masks(seed, B, H, W):
    """K3's cases on one shape, numpy bool (B, H, W): blobs, gap-like thin
    segments, dense speckle, tiles in a checkerboard with single-pixel
    diagonals through the tile corners (4- and 8-connectivity differ
    there), an empty and a full mask."""
    rng = np.random.default_rng(seed)
    cell, _ = _fields(seed, B, H, W)
    gaps = np.zeros((B, H, W), bool)
    steps = ((0, 1), (1, 0), (1, 1), (1, -1))
    for b in range(B):
        for _ in range(max(4, H * W // 1500)):
            y, x = rng.integers(0, H), rng.integers(0, W)
            dy, dx = steps[rng.integers(0, 4)]
            for k in range(rng.integers(2, 13)):
                if 0 <= y + k * dy < H and 0 <= x + k * dx < W:
                    gaps[b, y + k * dy, x + k * dx] = True
    yy, xx = np.mgrid[0:H, 0:W]
    T = K3_CORNER
    checker = (((yy // T + xx // T) % 2 == 0) | (yy - xx == T)
               | (yy + xx == 2 * T - 1))
    return {"blobs": cell > 0.6, "gaps": gaps,
            "speckle": rng.random((B, H, W)) < 0.45,
            "checker": np.repeat(checker[None], B, axis=0),
            "empty": np.zeros((B, H, W), bool),
            "full": np.ones((B, H, W), bool)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 256, 256), (1, 320, 320), (3, 30, 46),
                                   (2, 12, 700), (1, 48, 816),
                                   (16, 256, 256), (1, 1000, 1402)])
def test_cc_tile_kernel_matches_plain(dev, shape):
    """K3's one-launch tiled kernel bit for bit against the plain version,
    4- and 8-connected, on shapes the tiles do and do not divide (32^2 tiles
    below 132 tiles of 64^2, 64^2 tiles from 16 x 256^2 on; 1402 columns
    take the byte loads)."""
    for name, mask in _k3_masks(sum(shape), *shape).items():
        m = torch.from_numpy(mask).to(dev)
        for conn in (1, 2):
            want = cc.connected_components_plain(m, conn)
            got = cc.connected_components(m, conn)
            assert got.dtype == torch.int32 and got.shape == m.shape, name
            torch.testing.assert_close(got, want, rtol=0, atol=0,
                                       msg=f"{name}, connectivity {conn}")
    # one image, no batch axis; a mask that starts off a 4-byte boundary
    torch.testing.assert_close(cc.connected_components(m[0]),
                               cc.connected_components_plain(m[0]), rtol=0,
                               atol=0)
    flat = torch.from_numpy(_k3_masks(1, 1, *shape[1:])["blobs"]).to(dev)
    shifted = torch.zeros(flat.numel() + 1, dtype=torch.bool, device=dev)
    shifted[1:] = flat.reshape(-1)
    view = shifted[1:].view(flat.shape)
    torch.testing.assert_close(cc.connected_components(view),
                               cc.connected_components_plain(view), rtol=0,
                               atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2048, 2048), (2, 2048, 2048)])
def test_cc_tile_kernel_snake_crosses_every_tile(dev, shape):
    """A serpentine through every tile of a 2048^2 frame: one component
    whose id, the last pixel's linear index + 1, must travel across 1024
    tiles.  With 2 frames the tiles outnumber the blocks that fit on the
    card, so Phase C rebuilds each block's forests."""
    B, H, W = shape
    snake = _k3_snake(H, W)
    masks = np.stack([snake] + [_k3_masks(5, 1, H, W)["checker"][0]]
                     * (B - 1))
    m = torch.from_numpy(masks).to(dev)
    for conn in (1, 2):
        got = cc.connected_components(m, conn)
        torch.testing.assert_close(
            got, cc.connected_components_plain(m, conn), rtol=0, atol=0)
        last = int(np.flatnonzero(snake)[-1])
        assert set(got[0][m[0]].unique().tolist()) == {last + 1}


@pytest.mark.cuda
def test_cc_tile_kernel_4096_and_refusals(dev):
    """4096^2 (4096 tiles, more than the card holds at once) on blobs and
    the checkerboard, and the wrapper's refusals."""
    masks = _k3_masks(9, 1, 4096, 4096)
    for name in ("blobs", "checker"):
        m = torch.from_numpy(masks[name]).to(dev)
        torch.testing.assert_close(cc.connected_components(m),
                                   cc.connected_components_plain(m), rtol=0,
                                   atol=0, msg=name)
    huge = torch.zeros(1, dtype=torch.bool, device=dev).expand(2, 32768,
                                                               32768)
    with pytest.raises(ValueError, match="int32 indices"):
        cc.connected_components(huge)
    with pytest.raises(ValueError, match="connectivity"):
        cc.connected_components(m, 3)


def _flood_cases(seed, B, H, W):
    """(name, value, markers, mask) numpy inputs for K1 on one shape: blobs
    with their seeds' ids, an empty mask, a full mask with two seeds, every
    in-mask pixel seeded, and dense speckle seeds (large fronts).  Ids stay
    below 2**12."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    cell = np.zeros((B, H, W), np.float32)
    for b in range(B):
        for _ in range(max(2, H * W // 2000)):
            cy, cx = rng.integers(0, H), rng.integers(0, W)
            cell[b] = np.maximum(cell[b], np.clip(1 - np.sqrt(
                (yy - cy) ** 2 + (xx - cx) ** 2) / rng.uniform(3, 9), 0, 1))
    cell += rng.normal(0, 0.02, cell.shape).astype(np.float32)
    speckle = rng.random((B, H, W)) < 0.1
    mask = cell > 0.1
    ids = rng.integers(1, 4096, (B, H, W)).astype(np.int32)
    blobs = np.where(cell > 0.6, ids, 0)
    two = np.zeros((B, H, W), np.int32)
    two[:, 0, 0], two[:, H - 1, W - 1] = 7, 4095
    dense = rng.random((B, H, W)) < 0.4
    return [("blobs", -cell, blobs, mask),
            ("empty", -cell, blobs, np.zeros_like(mask)),
            ("full", -cell, two, np.ones_like(mask)),
            ("all_seeded", -cell, np.where(mask, ids, 0), mask),
            ("speckle", -cell, np.where(dense | speckle, ids, 0), mask)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (16, 256, 256), (4, 64, 64), (4, 128, 128), (2, 320, 320),
    (2, 512, 512), (1, 768, 768), (3, 30, 46), (2, 12, 700), (2, 9, 7),
    (3, 1, 300)])
def test_flood_block_kernel_matches_plain(dev, shape):
    """K1's one-block kernel against the plain version, exactly, on every
    bucket side up to 768, odd widths and one-row images; 2 and 128 levels
    with 12- and 24-bit keys (ids + 5000 for 24 bits) and 256 levels with
    12-bit keys.  Its step and work counts equal the cluster kernel's."""
    from microbeseg_torch.ops.kernels import flood

    B = shape[0]
    for name, value, markers, mask in _flood_cases(sum(shape), *shape):
        v, m = torch.from_numpy(value).to(dev), torch.from_numpy(mask).to(dev)
        for n_levels, bits in ((2, 12), (128, 12), (256, 12), (2, 24),
                               (128, 24)):
            offset = 5000 if bits == 24 else 0
            mk = torch.from_numpy(np.where(markers > 0, markers + offset,
                                           0)).to(dev)
            want = flood.flood_packed_plain(v, mk, m, n_levels,
                                            label_bits=bits)
            counts = {}
            for route in ("block", "cluster"):
                steps = torch.empty((B,), dtype=torch.int32, device=dev)
                work = torch.zeros((B,), dtype=torch.int64, device=dev)
                got = flood._launch_packed(v, mk, m, n_levels, 2, bits, steps,
                                           work, route=route)
                assert torch.equal(got, want), (name, n_levels, bits, route)
                counts[route] = steps.tolist(), work.tolist()
            assert counts["block"] == counts["cluster"], (name, n_levels,
                                                          bits)


@pytest.mark.cuda
def test_flood_packed_takes_the_block_kernel_up_to_256_levels(dev):
    """The wrapper's shape rule on the card: up to 256 levels launch the
    one-block kernel, more the cluster kernel; both equal the plain
    version.  One image without a batch axis."""
    from microbeseg_torch.kernels import _build
    from microbeseg_torch.ops.kernels import flood

    (_, value, markers, mask), *_ = _flood_cases(3, 2, 40, 72)
    v, mk, m = (torch.from_numpy(a).to(dev) for a in (value, markers, mask))
    for n_levels, route in ((128, "flood_packed"), (256, "flood_packed"),
                            (257, "flood_packed_cluster"),
                            (4096, "flood_packed_cluster")):
        before = dict(_build.LAUNCHES)
        got = flood.flood_packed(v, mk, m, n_levels)
        assert {k: _build.LAUNCHES[k] - before[k]
                for k in ("flood_packed", "flood_packed_cluster")} == {
            "flood_packed": int(route == "flood_packed"),
            "flood_packed_cluster": int(route != "flood_packed")}
        assert torch.equal(got, flood.flood_packed_plain(v, mk, m, n_levels))
    assert torch.equal(flood.flood_packed(v[0], mk[0], m[0]),
                       flood.flood_packed_plain(v[0], mk[0], m[0]))
    with pytest.raises(ValueError, match="256 levels"):
        flood._launch_packed(v, mk, m, 300, 2, 12, route="block")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 256, 256), (1, 1000, 1400),
                                   (3, 48, 816), (2, 9, 7)])
def test_ranked_components_matches_plain(dev, shape):
    """K4 for K3's ids, ranks from the mask in one call: blobs, blobs plus
    600 speckles, dense speckle, an empty and a full mask, 4- and
    8-connected, on shapes that the kernels' blocks of 256 pixels do and do
    not divide."""
    cell, _ = _fields(sum(shape), *shape)
    rng = np.random.default_rng(shape[1])
    blobs = cell > 0.6
    speckled = blobs.copy()
    n_px = shape[1] * shape[2]
    for b in range(shape[0]):
        speckled[b].flat[rng.choice(n_px, size=min(600, n_px // 2),
                                    replace=False)] = True
    dense = rng.random(shape) < 0.45
    for mask in (blobs, speckled, dense, np.zeros(shape, bool),
                 np.ones(shape, bool)):
        m = torch.from_numpy(mask).to(dev)
        for conn in (1, 2):
            got = cc.ranked_components(m, conn)
            assert got.dtype == torch.int32 and got.shape == m.shape
            torch.testing.assert_close(
                got, cc.ranked_components_plain(m, conn), rtol=0, atol=0)
            torch.testing.assert_close(
                got, cc.sequentialize_components(
                    cc.connected_components(m, conn)), rtol=0, atol=0)
    # one image, no batch axis
    torch.testing.assert_close(
        cc.ranked_components(m[0]), cc.ranked_components_plain(m[0]), rtol=0,
        atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 800, 800), (2, 12, 900)])
def test_frame_flood_matches_plain(dev, shape):
    """K2 on frames with a side above 768, markers above 4095."""
    from microbeseg_torch.ops.kernels.flood import (
        flood_or_fallback, flood_tiled, flood_tiled_plain)

    cell, _ = _fields(sum(shape), *shape)
    v = torch.from_numpy(-cell).to(dev)
    mask = v < -0.1
    rank = cc.ranked_components(v < -0.6)
    markers = torch.where(rank > 0, rank + 5000, 0)
    for n_levels in (128, 2):
        got = flood_tiled(v, markers, mask, n_levels=n_levels)
        torch.testing.assert_close(
            got, flood_tiled_plain(v, markers, mask, n_levels=n_levels),
            rtol=0, atol=0)
    assert int(got.max()) > 5000
    torch.testing.assert_close(
        flood_or_fallback(v, markers, mask, n_levels=2, max_label=6000), got,
        rtol=0, atol=0)


def _frame_cases(seed, B, H, W):
    """(name, value, markers, mask) numpy inputs for K2 on one shape, as
    ``_flood_cases`` but with each cone drawn in its own window (so 2048^2
    takes no longer than a small frame) and ids above 4095: blobs, an empty
    mask, a full mask with two seeds, every in-mask pixel seeded, and dense
    speckle seeds."""
    rng = np.random.default_rng(seed)
    cell = np.zeros((B, H, W), np.float32)
    for b in range(B):
        for _ in range(max(2, H * W // 2000)):
            cy, cx = int(rng.integers(0, H)), int(rng.integers(0, W))
            r = rng.uniform(3, 9)
            y0, y1 = max(cy - 9, 0), min(cy + 10, H)
            x0, x1 = max(cx - 9, 0), min(cx + 10, W)
            yy, xx = np.mgrid[y0:y1, x0:x1]
            win = cell[b, y0:y1, x0:x1]
            np.maximum(win, np.clip(1 - np.sqrt(
                (yy - cy) ** 2 + (xx - cx) ** 2) / r, 0, 1), out=win)
    cell += rng.normal(0, 0.02, cell.shape).astype(np.float32)
    speckle = rng.random((B, H, W)) < 0.1
    mask = cell > 0.1
    ids = rng.integers(4096, 1 << 20, (B, H, W)).astype(np.int32)
    blobs = np.where(cell > 0.6, ids, 0)
    two = np.zeros((B, H, W), np.int32)
    two[:, 0, 0], two[:, H - 1, W - 1] = 7, (1 << 24) - 2
    dense = rng.random((B, H, W)) < 0.4
    return [("blobs", -cell, blobs, mask),
            ("empty", -cell, blobs, np.zeros_like(mask)),
            ("full", -cell, two, np.ones_like(mask)),
            ("all_seeded", -cell, np.where(mask, ids, 0), mask),
            ("speckle", -cell, np.where(dense | speckle, ids, 0), mask)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1024, 1024), (1, 1000, 1400),
                                   (1, 769, 1), (1, 800, 13),
                                   (1, 2048, 2048)])
def test_frame_front_kernel_matches_plain(dev, shape):
    """K2's front kernel against the plain version, exactly, with a work
    count within its bound (none of an empty mask): two frames a call, a
    width that 32 does not divide, one- and 13-pixel-wide strips (word
    ranges that start mid-row, blocks with no word), 2048^2; five mask and
    seed cases, 128 and 2 levels, ids above 4095 up to 2^24 - 2; one
    ``flood_tiled`` launch a call."""
    from microbeseg_torch.kernels import _build
    from microbeseg_torch.ops.kernels import flood

    B = shape[0]
    for name, value, markers, mask in _frame_cases(sum(shape), *shape):
        v, mk, m = (torch.from_numpy(a).to(dev)
                    for a in (value, markers, mask))
        for n_levels in (128, 2):
            want = flood.flood_tiled_plain(v, mk, m, n_levels)
            steps = torch.empty((B,), dtype=torch.int32, device=dev)
            work = torch.zeros((B,), dtype=torch.int64, device=dev)
            got = flood.flood_tiled(v, mk, m, n_levels, steps, work)
            assert torch.equal(got, want), (name, n_levels)
            # per frame, at most its in-mask pixels on each step
            in_mask = m.flatten(1).sum(1)
            assert ((work >= 0) & (work <= steps.long() * in_mask)).all(), (
                name, n_levels)
            if name == "empty":
                assert not work.any(), n_levels
    before = _build.LAUNCHES["flood_tiled"]
    flood.flood_tiled(v, mk, m)
    assert _build.LAUNCHES["flood_tiled"] - before == 1


@pytest.mark.cuda
def test_flood_steps_counts_what_the_kernels_ran(dev):
    """While a profiler records, ``flood_steps`` takes a K1 launch's
    largest step count (its images run side by side) and the sum of a K2
    call's (one launch a frame); with none recording, nothing is kept."""
    from torch.profiler import ProfilerActivity, profile

    from microbeseg_torch.ops.kernels import flood
    from microbeseg_torch.utils import profiling

    profiling.reset()
    k1 = [torch.from_numpy(a).to(dev)
          for a in _flood_cases(5, 4, 128, 128)[0][1:]]
    k2 = [torch.from_numpy(a).to(dev)
          for a in _frame_cases(6, 2, 1024, 1024)[0][1:]]
    flood.flood_packed(*k1)
    flood.flood_tiled(*k2)
    assert profiling.summary() == {"spans": {}, "counters": {}}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        flood.flood_packed(*k1)
        flood.flood_tiled(*k2)
        torch.cuda.synchronize()
    steps1 = torch.empty((4,), dtype=torch.int32, device=dev)
    flood.flood_packed(*k1, steps_out=steps1)
    steps2 = torch.empty((2,), dtype=torch.int32, device=dev)
    flood.flood_tiled(*k2, steps_out=steps2)
    want = {"flood_packed": max(steps1.tolist()),
            "flood_tiled": sum(steps2.tolist())}
    assert profiling.summary()["counters"] == {"flood_steps": want}
    profiling.reset()


def bf16_tolerance(a, b):
    """Bound on |kernel - plain| for the bf16 product: both round a float32
    sum to bfloat16, so they differ by at most one bfloat16 step of the
    result (2^-7 relative) where the two float32 sums, taken in different
    orders, fall on either side of a rounding boundary; plus the float32
    sums' own difference, which matters only for results near zero."""
    K = a.shape[1]
    atol = 1e-6 * K * float(a.abs().max()) * float(b.abs().max())
    return 2.0 ** -7, atol


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (256, 64, 64), (1000, 200, 72), (130, 2304, 128), (4099, 576, 64),
    (77, 33, 5), (512, 1152, 200), (16384, 100, 64)])
def test_matmul_matches_plain(dev, shape):
    """K5: int8 exactly, bf16 within one bfloat16 step, on aligned, ragged
    and path-like shapes.  Rows of A that are 16-byte aligned take the wgmma
    kernel; 1000 x 200 (int8), 77 x 33, 16384 x 100 and the odd-K row slices
    take the mma.sync kernel with its gathering loads."""
    from microbeseg_torch.ops.kernels.matmul import (
        matmul_bf16, matmul_bf16_plain, matmul_int8, matmul_int8_plain)

    M, K, N = shape
    rng = np.random.default_rng(M + K + N)
    a = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8)).to(dev)
    b = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8)).to(dev)
    got = matmul_int8(a, b)
    assert got.dtype == torch.int32 and got.shape == (M, N)
    torch.testing.assert_close(got, matmul_int8_plain(a, b), rtol=0, atol=0)
    # the extremes: every product +-127^2
    ones = torch.full_like(a, 127)
    torch.testing.assert_close(
        matmul_int8(ones, -torch.full_like(b, 127)),
        torch.full((M, N), -127 * 127 * K, dtype=torch.int32, device=dev),
        rtol=0, atol=0)
    # a row slice of A is not 16-byte aligned when K is odd
    torch.testing.assert_close(matmul_int8(a[1:], b),
                               matmul_int8_plain(a[1:], b), rtol=0, atol=0)

    af = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    bf = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    af, bf = af.to(dev, torch.bfloat16), bf.to(dev, torch.bfloat16)
    got = matmul_bf16(af, bf)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    rtol, atol = bf16_tolerance(af, bf)
    torch.testing.assert_close(got.float(), matmul_bf16_plain(af, bf).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(300, 256, 200), (300, 256, 100),
                                   (4099, 576, 64), (2048, 2048, 2048)])
def test_matmul_routes_agree(dev, shape):
    """Both kernels of K5 on a shape both take: the same int32 sums, and
    bf16 results each within one bfloat16 step of the plain version.  With
    N = 100 the rows of a bf16 B are not 16-byte aligned, so the wgmma
    kernel reads the transposed copy; with the other N it reads B as it is
    stored."""
    from microbeseg_torch.ops.kernels import matmul as mm

    M, K, N = shape
    rng = np.random.default_rng(M + K + N)
    a = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8)).to(dev)
    b = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8)).to(dev)
    assert mm._rows_aligned(a)
    ref = mm.matmul_int8_plain(a, b)
    for route in ("wgmma", "mma_sync"):
        torch.testing.assert_close(
            mm._launch("matmul_int8", a, b, torch.int32, route=route), ref,
            rtol=0, atol=0)
    af = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    bf = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    af, bf = af.to(dev, torch.bfloat16), bf.to(dev, torch.bfloat16)
    rtol, atol = bf16_tolerance(af, bf)
    ref = mm.matmul_bf16_plain(af, bf).float()
    for route in ("wgmma", "mma_sync"):
        torch.testing.assert_close(
            mm._launch("matmul_bf16", af, bf, torch.bfloat16,
                       route=route).float(), ref, rtol=rtol, atol=atol)
    with pytest.raises(ValueError):
        mm._launch("matmul_int8", a[:, :K - 3].contiguous(), b[:K - 3],
                   torch.int32, route="wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("width", [256, 512, 200])
@pytest.mark.parametrize("channels", [(64, 64), (128, 64), (64, 128),
                                      (256, 128), (16, 8), (8, 8),
                                      (192, 130), (64, 44)])
def test_conv3x3_int8_matches_plain(dev, channels, width):
    """K5's convolution entry against the 9-tap operand, the float64 product
    and the float32 dequantise in turn: exactly equal, float32 and bfloat16,
    scales per channel and per sample and channel.  C_in 64, 128, 192 and
    256 take the fused kernel (64, 128 and 256 columns a tile; weights
    resident in shared memory for 64 -> 64, 128 -> 64 and 64 -> 128,
    streamed for the rest; 44 and 130 output channels end inside a tile),
    C_in 16 and 8 the chain through ``matmul_int8``."""
    from microbeseg_torch.kernels import _build
    from microbeseg_torch.ops.kernels import matmul as mm

    C, O = channels
    n, H = 3, 9
    rng = np.random.default_rng(C + O + width)
    x_q = torch.from_numpy(
        rng.integers(-127, 128, (n, H, width, C), dtype=np.int8)).to(dev)
    w_q = torch.from_numpy(
        rng.integers(-127, 128, (9 * C, O), dtype=np.int8)).to(dev)
    bias = torch.from_numpy(rng.standard_normal(O).astype(np.float32)).to(dev)
    for scale_shape in ((O,), (n, 1, 1, O)):
        scale = torch.from_numpy(
            rng.uniform(1e-6, 1e-4, scale_shape).astype(np.float32)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            before = dict(_build.LAUNCHES)
            got = mm.conv3x3_int8(x_q, w_q, scale, bias, dtype)
            fused = C % 64 == 0
            assert (_build.LAUNCHES["conv3x3_int8"]
                    - before["conv3x3_int8"]) == int(fused)
            assert (_build.LAUNCHES["matmul_int8"]
                    - before["matmul_int8"]) == int(not fused)
            assert got.dtype == dtype and got.shape == (n, H, width, O)
            torch.testing.assert_close(
                got, mm.conv3x3_int8_plain(x_q, w_q, scale, bias, dtype),
                rtol=0, atol=0)
    # the extremes: every product +-127^2 inside, fewer taps at the border
    ones = torch.full_like(x_q, 127)
    got = mm.conv3x3_int8(ones, -torch.full_like(w_q, 127),
                          torch.ones((O,), device=dev),
                          torch.zeros((O,), device=dev), torch.float32)
    assert float(got[:, 1:-1, 1:-1].max()) == -127.0 * 127 * 9 * C
    assert float(got[:, 0, 0].min()) == -127.0 * 127 * 4 * C


def _epilogue_bn(C, gen, dev):
    """An eval BatchNorm2d on ``dev`` with non-trivial parameters: weights
    of both signs, non-zero shift and mean, variance away from 1."""
    from torch import nn

    bn = nn.BatchNorm2d(C, eps=1e-5).to(dev).eval()
    with torch.no_grad():
        sign = torch.where(torch.rand(C, generator=gen) < 0.3, -1.0, 1.0)
        bn.weight.copy_(sign * (0.5 + torch.rand(C, generator=gen)))
        bn.bias.copy_(torch.randn(C, generator=gen) * 0.5)
        bn.running_mean.copy_(torch.randn(C, generator=gen) * 0.3)
        bn.running_var.copy_(0.2 + 2 * torch.rand(C, generator=gen))
    return bn


def _ulp(x, dtype):
    """The spacing of ``dtype``'s values at |x|, in float32."""
    digits = 8 if dtype == torch.bfloat16 else 24
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - digits)


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [32, 64, 512, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", ["identity", "relu", "leakyrelu", "elu",
                                 "mish"])
def test_conv_epilogue_matches_plain(dev, act, dtype, channels):
    """The fused epilogue kernel against its plain version on the card,
    within one ulp of the output type, in place, one launch counted; on a
    ragged number of pixels (no whole pass of a block)."""
    from microbeseg_torch.kernels import _build
    from microbeseg_torch.ops.kernels.epilogue import (conv_epilogue,
                                                       conv_epilogue_plain)

    gen = torch.Generator().manual_seed(channels + len(act))
    bn = _epilogue_bn(channels, gen, dev)
    bias = (torch.randn(channels, generator=gen) * 0.5).to(dev)
    z = (3 * torch.randn(3, channels, 37, 41, generator=gen)).to(
        dev, dtype).contiguous(memory_format=torch.channels_last)
    want = conv_epilogue_plain(z, bias, bn, act)
    before = _build.LAUNCHES["conv_epilogue"]
    got = conv_epilogue(z.clone(memory_format=torch.channels_last), bias, bn,
                        act)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["conv_epilogue"] == before + 1
    assert got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    err = (got.float() - want.float()).abs()
    assert bool((err <= _ulp(want, dtype)).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["identity", "relu", "leakyrelu", "elu",
                                 "mish"])
def test_conv_epilogue_matches_the_module_chain(dev, act):
    """bf16 autocast, channels-last: the convolution without its bias and
    the epilogue against ``bn(act(conv(x)))`` of the modules, within two
    bf16 ulps of the terms (the chain rounds the bias, the sum, the
    activation and the normalised value; the epilogue rounds once)."""
    from torch import nn

    from microbeseg_torch.models.blocks import make_act
    from microbeseg_torch.ops.kernels.epilogue import conv_epilogue

    C = 64
    gen = torch.Generator().manual_seed(len(act))
    torch.manual_seed(len(act))
    if act == "identity":
        conv, act_mod = nn.ConvTranspose2d(128, C, 2, stride=2), None
    else:
        conv, act_mod = nn.Conv2d(128, C, 3, padding=1), make_act(act)
    conv = conv.to(dev).to(memory_format=torch.channels_last)
    with torch.no_grad():
        conv.bias.copy_(torch.randn(C, generator=gen) * 0.5)
    bn = _epilogue_bn(C, gen, dev)
    x = torch.randn(4, 128, 40, 48, generator=gen).to(dev).contiguous(
        memory_format=torch.channels_last)
    with torch.inference_mode(), torch.autocast("cuda", torch.bfloat16):
        z = conv(x)
        want = bn(z if act_mod is None else act_mod(z))
        if act_mod is None:
            zb = nn.functional.conv_transpose2d(x, conv.weight, None, 2)
        else:
            zb = conv._conv_forward(x, conv.weight, None)
        a = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
        scale = ((zb.float().abs() + conv.bias.abs().view(1, -1, 1, 1))
                 * a.abs().view(1, -1, 1, 1) + bn.bias.abs().view(1, -1, 1, 1)
                 + (bn.running_mean * a).abs().view(1, -1, 1, 1))
        got = conv_epilogue(zb, conv.bias, bn, act)
    # autocast runs mish's exp in float32, so that chain hands on float32
    # (rounded to bfloat16 by the next convolution); the epilogue writes
    # the convolution's type
    assert got.dtype == torch.bfloat16
    assert want.dtype == (torch.float32 if act == "mish" else torch.bfloat16)
    err = (got.float() - want.float()).abs()
    bf16_eps = torch.finfo(torch.bfloat16).eps
    assert bool((err <= 2 * bf16_eps * scale).all()), float(
        (err / scale).max())


def _random_dunet(normalization, dev, seed=0):
    """The full-width DUNet (64, 1024), relu, with non-trivial biases and
    BatchNorm statistics, channels-last on ``dev``, in eval mode."""
    from torch import nn

    from microbeseg_torch.config import ModelConfig
    from microbeseg_torch.models.unet import build_unet

    torch.manual_seed(seed)
    gen = torch.Generator().manual_seed(seed)
    model = build_unet(ModelConfig(normalization=normalization))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.load_state_dict(
                    _epilogue_bn(m.num_features, gen, "cpu").state_dict())
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.2)
    return model.to(dev).to(memory_format=torch.channels_last).eval()


@pytest.mark.cuda
def test_dunet_eval_forward_takes_the_fused_epilogue(dev):
    """A DUNet (64, 1024) eval forward under ``inference_mode`` and bf16
    autocast launches 38 epilogues (10 encoder convolutions, 4 pools, 2 x
    (4 upsamplings + 8 convolutions)) and no fallback; its fields agree with
    the module chain's (eval, grad on) within bf16 rounding.  Training mode
    and GroupNorm launch none."""
    from microbeseg_torch.kernels import _build

    model = _random_dunet("bn", dev)
    x = torch.rand(2, 128, 128, 1, generator=torch.Generator().manual_seed(
        1)).to(dev)
    with torch.autocast("cuda", torch.bfloat16):
        _build.reset_launches()
        want = model(x)
        assert _build.LAUNCHES["conv_epilogue"] == 0
        assert _build.LAUNCHES["conv_epilogue_fallback"] == 0
        with torch.inference_mode():
            got = model(x)
            assert _build.LAUNCHES["conv_epilogue"] == 38
            assert _build.LAUNCHES["conv_epilogue_fallback"] == 0
            got = model(x)
            assert _build.LAUNCHES["conv_epilogue"] == 76
        for g, w in zip(got, want):
            w = w.detach()
            rms = float(w.float().pow(2).mean().sqrt())
            assert rms > 0
            assert float((g - w).float().pow(2).mean().sqrt()) <= 0.01 * rms
        gn = _random_dunet("gn", dev)
        _build.reset_launches()
        with torch.inference_mode():
            gn(x)
        with torch.no_grad():
            model.train()(x)
        assert _build.LAUNCHES["conv_epilogue"] == 0
        assert _build.LAUNCHES["conv_epilogue_fallback"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape,niter", [((256, 256), 200), ((1000, 1400), 60),
                                         ((2048, 2048), 200), ((7, 300), 5)])
def test_follow_flows_kernel_matches_plain(dev, shape, niter):
    """``follow_flows_kernel`` against the plain ``grid_sample`` loop on
    the same points: a smooth random field's unit flows x 5 (some of them
    running off the frame, where the clamp holds them) over the upper half
    of the field.  The two round the same float32 expressions, not always
    in the same order, so a few end points in 1000 may differ."""
    from microbeseg_torch.kernels import _build
    from microbeseg_torch.ops import flows

    H, W = shape
    g = torch.Generator(device=dev).manual_seed(H + W)
    s = torch.randn(1, 1, H, W, generator=g, device=dev)
    k = torch.ones(1, 1, 5, 5, device=dev) / 25
    for _ in range(3):
        s = torch.nn.functional.conv2d(s, k, padding=2)
    s = s[0, 0]
    gy, gx = torch.gradient(s)
    dP = 5.0 * torch.stack([gy, gx]) / (torch.sqrt(gy * gy + gx * gx)
                                        + 1e-12)
    fg = s > s.median()
    idx = torch.nonzero(fg.reshape(-1)).squeeze(1)
    before = dict(_build.LAUNCHES)
    got = flows.follow_flows(dP, fg, idx, niter)
    want = flows.end_pixels(flows.follow_plain(
        flows._field(dP, fg), flows.start_points(idx, H, W), niter), H, W)
    assert _build.LAUNCHES["follow_flows"] == before["follow_flows"] + 1
    assert (_build.LAUNCHES["follow_flows_fallback"]
            == before["follow_flows_fallback"] + 1)
    differ = (got != want).any(dim=1)
    assert float(differ.float().mean()) <= 1e-3


def _rel_inputs(dev, B, heads, g, hd, rel_std, seed):
    """A qkv tensor in the projection's own layout, (B, g^2, 3 * heads *
    hd) bf16, and two (2g - 1, hd) float32 relative-position tables."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = (0.5 * torch.randn(B, g * g, 3 * heads * hd, generator=gen,
                             device=dev)).to(torch.bfloat16)
    tabs = [rel_std * torch.randn(2 * g - 1, hd, generator=gen, device=dev)
            for _ in range(2)]
    return qkv, tabs


def _rms(t):
    return float(t.float().pow(2).mean().sqrt())


# rel_attention_kernel against the plain path in float32 (the block's
# rel_pos_bias and an explicit softmax) from the same bf16 qkv.  The kernel
# rounds three things to bf16: the tables before the relative products (as
# the einsums under autocast do), the softmax weights before they multiply
# v (as cuDNN's flash kernel does) and the output; each moves the output
# by some 0.1-0.4% of its scale.  1% of the output's RMS for the RMS error
# and 3% of its largest magnitude for the worst element leave room for
# that and none for a wrong index, sign or shift.
REL_RMS_TOL, REL_MAX_TOL = 0.01, 0.03


def _check_rel_attention(got, want):
    err = (got.float() - want).abs()
    assert _rms(err) <= REL_RMS_TOL * _rms(want)
    assert float(err.max()) <= REL_MAX_TOL * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,heads,g,hd,rel_std", [
    (16, 16, 32, 64, 0.5),   # the cell's forward: 16 tiles of 1,024 tokens
    (16, 16, 32, 64, 0.05),
    (2, 4, 8, 16, 0.5),      # the families' tiny size
    (3, 2, 6, 64, 0.5),      # ragged grids: tiles of keys and queries cut
    (2, 3, 12, 64, 0.5),
    (2, 4, 12, 16, 0.5),
    (1, 2, 1, 64, 0.5),      # one token
    (1, 2, 64, 64, 0.2),     # the largest grid
    (50, 16, 14, 64, 0.5),   # muSAM's windowed blocks: 2 tiles x 25 windows
    (2, 16, 64, 64, 0.5),    # muSAM's global blocks: 2 tiles of 4,096
    (8, 16, 64, 64, 0.5),    # the muSAM cell's forward: 8 tiles of 4,096
    (2, 16, 64, 64, 2.0)])   # large relative terms: rel_h in the row maximum
def test_rel_attention_matches_plain(dev, B, heads, g, hd, rel_std):
    from microbeseg_torch.kernels import _build
    from microbeseg_torch.ops.kernels.rel_attention import (
        rel_attention, rel_attention_plain)

    qkv, (th, tw) = _rel_inputs(dev, B, heads, g, hd, rel_std, g * hd + B)
    before = _build.LAUNCHES["rel_attention"]
    got = rel_attention(qkv, th, tw, heads, g)
    assert _build.LAUNCHES["rel_attention"] == before + 1
    assert got.shape == (B, g * g, heads * hd) and got.dtype == torch.bfloat16
    want = rel_attention_plain(qkv.float(), th, tw, heads, g)
    _check_rel_attention(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [32, 64])
def test_rel_attention_is_at_least_as_exact_as_the_bias_and_sdpa(dev, g):
    """At the cells' grids (16 tiles of 1,024 tokens; 2 of 4,096), with
    relative terms of a few units: the kernel keeps rel_h and rel_w in
    float32, the path it replaces rounds each biased entry to bf16; against
    the float32 plain path the kernel's RMS error is no larger than that
    path's."""
    import torch.nn.functional as F

    from microbeseg_torch.models import vit_sam
    from microbeseg_torch.ops.kernels.rel_attention import (
        rel_attention, rel_attention_plain, split_heads)

    B, heads, hd = (16 if g == 32 else 2), 16, 64
    qkv, (th, tw) = _rel_inputs(dev, B, heads, g, hd, 0.5, 7)
    want = rel_attention_plain(qkv.float(), th, tw, heads, g)
    got = rel_attention(qkv, th, tw, heads, g)
    q, k, v = split_heads(qkv, heads)
    bias = vit_sam.rel_pos_bias(q, th, tw, g)
    old = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    old = old.transpose(1, 2).reshape(B, g * g, heads * hd)
    assert _rms(got.float() - want) <= _rms(old.float() - want)


@pytest.mark.cuda
@pytest.mark.parametrize("g,hd", [(32, 64), (8, 16), (12, 64), (64, 64)])
def test_rel_attention_zero_tables_give_plain_attention(dev, g, hd):
    """With both tables 0 the kernel is plain softmax attention: against
    PyTorch's math attention in float32."""
    import torch.nn.functional as F

    from microbeseg_torch.ops.kernels.rel_attention import (rel_attention,
                                                            split_heads)

    B, heads = 4, 4
    qkv, (th, _) = _rel_inputs(dev, B, heads, g, hd, 0.0, g + hd)
    got = rel_attention(qkv, th, th, heads, g)
    q, k, v = split_heads(qkv.float(), heads)
    want = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(
        B, g * g, heads * hd)
    _check_rel_attention(got, want)


@pytest.mark.cuda
def test_rel_attention_route_and_its_count(dev):
    """The kernel's own rule: ``wgmma`` at head 64 on grids of 32 and 64,
    ``mma.sync`` elsewhere.  The g = 32 instance keeps its 102,400 bytes
    of shared memory a block, and g = 64 fits twice in an H100's SM (228 KB,
    1 KB of it reserved a block).  ``attention_maps.wgmma`` counts a g = 64
    launch's B * heads maps and nothing of a g = 14 launch."""
    import ctypes

    from torch.profiler import ProfilerActivity, profile

    from microbeseg_torch.kernels import _build
    from microbeseg_torch.ops.kernels.rel_attention import (rel_attention,
                                                            route)
    from microbeseg_torch.utils import profiling

    assert [route(64, 32), route(64, 64)] == ["wgmma", "wgmma"]
    assert [route(64, 14), route(64, 12), route(16, 64)] == ["mma.sync"] * 3
    lib = _build.load("rel_attention")
    lib.rel_attention_shared_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    assert lib.rel_attention_shared_bytes(64, 32) == 102400
    assert 2 * (lib.rel_attention_shared_bytes(64, 64) + 1024) <= 228 * 1024
    heads = 4
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for B, g in ((3, 64), (5, 14)):
            qkv, (th, tw) = _rel_inputs(dev, B, heads, g, 64, 0.5, g)
            rel_attention(qkv, th, tw, heads, g)
    counters = profiling.summary()["counters"]
    profiling.reset()
    assert counters["attention_maps.wgmma"] == 3 * heads
    assert counters["attention_maps.g64"] == 3 * heads
    assert counters["attention_maps.g14"] == 5 * heads


@pytest.mark.cuda
def test_cellpose_sam_forward_takes_rel_attention(dev, monkeypatch):
    """A published-width forward of two 256^2 tiles under inference_mode
    and bf16 autocast launches rel_attention once a block (24) and never
    calls rel_pos_bias or scaled_dot_product_attention; its fields agree
    with the same forward whose attention is the float32 plain path
    within 1% of their RMS (the attention's bf16 roundings, through 24
    blocks)."""
    import torch.nn.functional as F

    from microbeseg_torch.config import CellposeSAMConfig
    from microbeseg_torch.kernels import _build
    from microbeseg_torch.models import vit_sam
    from microbeseg_torch.ops.kernels import rel_attention as ra

    torch.manual_seed(0)
    with torch.device(dev):
        model = vit_sam.build_cellpose_sam(CellposeSAMConfig()).eval()
        for blk in model.encoder.blocks:
            torch.nn.init.normal_(blk.attn.rel_pos_h, std=0.5)
            torch.nn.init.normal_(blk.attn.rel_pos_w, std=0.5)
        x = torch.rand(2, 3, 256, 256)

    def refused(*args, **kwargs):
        raise AssertionError("the card's forward called the CPU route")

    with torch.inference_mode(), torch.autocast("cuda", torch.bfloat16):
        with monkeypatch.context() as mp:
            mp.setattr(vit_sam, "rel_pos_bias", refused)
            mp.setattr(F, "scaled_dot_product_attention", refused)
            before = _build.LAUNCHES["rel_attention"]
            got = model(x)
            assert _build.LAUNCHES["rel_attention"] == before + 24
        monkeypatch.setattr(vit_sam, "rel_attention",
                            lambda qkv, *a: ra.rel_attention_plain(
                                qkv.float(), *a).to(qkv.dtype))
        want = model(x)
    assert _rms(got.float() - want.float()) <= 0.01 * _rms(want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["head_width", "float32", "grad", "grid",
                                  "strided"])
def test_rel_attention_refuses_what_it_does_not_take(dev, case):
    from microbeseg_torch.ops.kernels.rel_attention import rel_attention

    heads, g, hd = 2, 8, 64
    if case == "head_width":
        hd = 32
    if case == "grid":
        g = 65
    qkv, (th, tw) = _rel_inputs(dev, 1, heads, g, hd, 0.5, 0)
    if case == "float32":
        qkv = qkv.float()
    if case == "strided":   # rows of 3D + 8, the last 8 cut off
        qkv = torch.nn.functional.pad(qkv, (0, 8))[..., :-8]
    if case == "grad":
        th.requires_grad_(True)
    match = {"head_width": "head width 32", "float32": "bfloat16",
             "grad": "no backward", "grid": "1 to 64",
             "strided": "contiguous"}[case]
    with pytest.raises(ValueError, match=match):
        rel_attention(qkv, th, tw, heads, g)


@pytest.mark.cuda
@pytest.mark.parametrize("g,hd", [(32, 64), (64, 64)])
def test_rel_attention_on_every_device(dev, g, hd):
    """Each card raises the kernel's shared-memory limit for itself: the
    first card alone, then every card at once from a host thread of its
    own (as a mesh engine runs its shares), each against the plain path."""
    from concurrent.futures import ThreadPoolExecutor

    from microbeseg_torch.ops.kernels.rel_attention import (
        rel_attention, rel_attention_plain)

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    B, heads = 2, 4

    def run(i):
        d = torch.device("cuda", i)
        with torch.cuda.device(d):
            qkv, (th, tw) = _rel_inputs(d, B, heads, g, hd, 0.5, i)
            got = rel_attention(qkv, th, tw, heads, g)
            torch.cuda.synchronize(d)
        return got, rel_attention_plain(qkv.float(), th, tw, heads, g)

    _check_rel_attention(*run(0))
    with ThreadPoolExecutor(n) as pool:
        for got, want in pool.map(run, range(n)):
            _check_rel_attention(got, want)


@pytest.mark.cuda
def test_cellpose_sam_engine_on_a_mesh_of_every_device(dev, monkeypatch):
    """A published-width flows engine on a mesh of every card, each card's
    share forwarded from a host thread of its own: every card launches the
    kernel, 24 times a forward, and the stitched fields of the engine
    without a mesh hold within 1% of their RMS (other batch shares take
    other cuBLAS kernels, whose roundings differ).  Masks come back for
    every frame."""
    import threading

    from benchmark.families import cellpose_sam as fam
    from microbeseg_torch.config import CellposeSAMConfig, InferConfig
    from microbeseg_torch.inference.engine import InferenceEngine
    from microbeseg_torch.kernels import _build
    from microbeseg_torch.models import vit_sam
    from microbeseg_torch.parallel.mesh import get_mesh

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    with torch.device(dev):
        model = vit_sam.build_cellpose_sam(CellposeSAMConfig())
    model.load_state_dict(fam.make_weights(fam.PUBLISHED, 7, dev))
    cfg = InferConfig(batch_size=16, use_tiling=True, tile_size=256,
                      tile_overlap=56)
    frames = np.random.default_rng(5).normal(
        2500, 900, (2, 512, 512)).clip(0, 65535).astype(np.uint16)
    want = InferenceEngine(model, "flows", cfg=cfg,
                           device=dev).predict_raw(frames)[0]

    seen, lock, kernel = [], threading.Lock(), vit_sam.rel_attention

    def counted(qkv, *args):
        with lock:
            seen.append(qkv.device.index)
        return kernel(qkv, *args)

    monkeypatch.setattr(vit_sam, "rel_attention", counted)
    engine = InferenceEngine(model, "flows", cfg=cfg, mesh=get_mesh())
    before = _build.LAUNCHES["rel_attention"]
    got = engine.predict_raw(frames)[0]
    assert _build.LAUNCHES["rel_attention"] - before == len(seen)
    assert sorted(set(seen)) == list(range(n))
    assert all(seen.count(i) % 24 == 0 for i in range(n))
    err = np.sqrt(np.mean((got - want) ** 2))
    assert err <= 0.01 * np.sqrt(np.mean(want ** 2))
    masks = engine.segment(frames)
    assert masks.shape == frames.shape and masks.dtype == np.uint16


def _add_ln_inputs(dev, shape, d, seed):
    """A LayerNorm over ``d`` on ``dev`` with drawn affine parameters (eps
    1e-6, as the ViT's), a float32 stream of a few units off zero and a
    bf16 branch, both ``shape + (d,)``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    norm = torch.nn.LayerNorm(d, eps=1e-6).to(dev)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.3 * torch.randn(d, generator=gen, device=dev))
        norm.bias.copy_(0.2 * torch.randn(d, generator=gen, device=dev))
    x = 0.5 + 3 * torch.randn(shape + (d,), generator=gen, device=dev)
    h = torch.randn(shape + (d,), generator=gen, device=dev).to(
        torch.bfloat16)
    return norm, x, h


def _add_ln_close(got, want, x, norm):
    """``got`` and ``want``, the bf16 rows of two float32 LayerNorms of the
    stream ``x``, lie within one bf16 step of each other, plus 2^-16 of the
    terms' scale |w| rstd (|x| + |mean|) + |b|: the two sum the mean and the
    variance in another order, which moves a float32 value by a few of its
    own steps at that scale, and where w (x - mean) rstd and b nearly cancel
    that is more than one bf16 step of the small result."""
    mean = x.mean(-1, keepdim=True)
    rstd = torch.rsqrt(x.var(-1, unbiased=False, keepdim=True) + norm.eps)
    scale = (norm.weight.abs() * rstd * (x.abs() + mean.abs())
             + norm.bias.abs())
    err = (got.float() - want.float()).abs()
    step = _ulp(torch.maximum(got.float().abs(), want.float().abs()),
                torch.bfloat16)
    allowed = step + scale * 2.0 ** -16
    assert bool((err <= allowed).all()), float((err / allowed).max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,d", [
    ((16, 32, 32), 1024),   # the cell's forward: 16 tiles of 1,024 tokens
    ((7, 11, 13), 1024),    # 1,001 rows: no whole pass of a block's warps
    ((3, 37), 768),         # SAM's ViT-B
    ((5, 9), 72),           # fewer quads than a warp's lanes
    ((1, 3), 1016)])        # a lane's last quad cut
@pytest.mark.parametrize("with_h", [True, False], ids=["branch", "stream"])
def test_add_layernorm_matches_plain(dev, shape, d, with_h):
    """The kernel against its plain version: the stream bit-equal to
    ``x + h.float()`` (untouched without h), the bf16 rows within one bf16
    step of ``F.layer_norm``'s rounded once (``_add_ln_close``), one launch
    counted."""
    from microbeseg_torch.kernels import _build
    from microbeseg_torch.ops.kernels.add_layernorm import (
        add_layernorm, add_layernorm_plain)

    norm, x, h = _add_ln_inputs(dev, shape, d, d + len(shape))
    h = h if with_h else None
    with torch.inference_mode(), torch.autocast("cuda", torch.bfloat16):
        want_x = x + h.float() if with_h else x.clone()
        want = add_layernorm_plain(x.clone(), h, norm)
        before = _build.LAUNCHES["add_layernorm"]
        got = add_layernorm(x, h, norm)
        torch.cuda.synchronize()
    assert _build.LAUNCHES["add_layernorm"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.equal(x, want_x)
    _add_ln_close(got, want, x, norm)


@pytest.mark.cuda
def test_cellpose_sam_forward_takes_add_layernorm(dev):
    """A published-width forward of two 256^2 tiles under inference_mode
    and bf16 autocast launches add_layernorm twice a block (48); its fields
    agree with the module chain's (each block's ``forward``: the residual
    adds, LayerNorm and autocast's casts as PyTorch runs them) within the
    attention test's 1% of their RMS."""
    from microbeseg_torch.config import CellposeSAMConfig
    from microbeseg_torch.kernels import _build
    from microbeseg_torch.models import vit_sam

    torch.manual_seed(0)
    with torch.device(dev):
        model = vit_sam.build_cellpose_sam(CellposeSAMConfig()).eval()
        for blk in model.encoder.blocks:
            torch.nn.init.normal_(blk.attn.rel_pos_h, std=0.5)
            torch.nn.init.normal_(blk.attn.rel_pos_w, std=0.5)
            for norm in (blk.norm1, blk.norm2):
                torch.nn.init.normal_(norm.weight, 1.0, 0.2)
                torch.nn.init.normal_(norm.bias, 0.0, 0.1)
        x = torch.rand(2, 3, 256, 256)

    with torch.inference_mode(), torch.autocast("cuda", torch.bfloat16):
        before = dict(_build.LAUNCHES)
        got = model(x)
        assert _build.LAUNCHES["add_layernorm"] == before["add_layernorm"] + 48
        assert _build.LAUNCHES["rel_attention"] == before["rel_attention"] + 24
        enc = model.encoder
        t = (enc.patch_embed(x) + enc.pos_embed).contiguous()
        for blk in enc.blocks:
            t = blk(t)
        want = torch.nn.functional.pixel_shuffle(
            model.out(enc.neck(t.permute(0, 3, 1, 2))),
            model.cfg.patch_size)
    assert _build.LAUNCHES["add_layernorm"] == before["add_layernorm"] + 48
    assert _rms(got.float() - want.float()) <= 0.01 * _rms(want)


@pytest.mark.cuda
def test_micro_sam_forward_takes_both_kernels_at_both_grids(dev, monkeypatch):
    """muSAM's published-width forward of two 1024^2 tiles under
    inference_mode and bf16 autocast: rel_attention 24 times (20 at the
    window's grid of 14 over 25 windows a tile, 4 at the 64 x 64 grid),
    add_layernorm 48 times, never the CPU route; its fields agree with the
    same forward whose attention is the float32 plain path within the
    attention test's 1% of their RMS."""
    import torch.nn.functional as F

    from microbeseg_torch.config import MicroSAMConfig
    from microbeseg_torch.kernels import _build
    from microbeseg_torch.models import unetr, vit_sam
    from microbeseg_torch.ops.kernels import rel_attention as ra

    torch.manual_seed(0)
    with torch.device(dev):
        model = unetr.build_micro_sam_ais(MicroSAMConfig()).eval()
        for blk in model.image_encoder.blocks:
            torch.nn.init.normal_(blk.attn.rel_pos_h, std=0.5)
            torch.nn.init.normal_(blk.attn.rel_pos_w, std=0.5)
        x = torch.randn(2, 3, 1024, 1024)
    grids = []
    kernel = vit_sam.rel_attention

    def counted(qkv, th, tw, heads, g):
        grids.append((g, qkv.shape[0]))
        return kernel(qkv, th, tw, heads, g)

    def refused(*args, **kwargs):
        raise AssertionError("the card's forward called the CPU route")

    with torch.inference_mode(), torch.autocast("cuda", torch.bfloat16):
        with monkeypatch.context() as mp:
            mp.setattr(vit_sam, "rel_pos_bias", refused)
            mp.setattr(F, "scaled_dot_product_attention", refused)
            mp.setattr(vit_sam, "rel_attention", counted)
            before = dict(_build.LAUNCHES)
            got = model(x)
            assert _build.LAUNCHES["rel_attention"] == \
                before["rel_attention"] + 24
            assert _build.LAUNCHES["add_layernorm"] == \
                before["add_layernorm"] + 48
        assert sorted(grids) == [(14, 50)] * 20 + [(64, 2)] * 4
        monkeypatch.setattr(vit_sam, "rel_attention",
                            lambda qkv, *a: ra.rel_attention_plain(
                                qkv.float(), *a).to(qkv.dtype))
        want = model(x)
    assert got.shape == (2, 3, 1024, 1024)
    assert _rms(got.float() - want.float()) <= 0.01 * _rms(want)
