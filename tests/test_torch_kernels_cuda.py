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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 800, 800), (2, 12, 900)])
def test_frame_flood_matches_plain(dev, shape):
    """K2 on frames with a side above 768, markers above 4095."""
    from microbeseg_torch.ops.kernels.flood import (
        flood_or_fallback, flood_tiled, flood_tiled_plain)

    cell, _ = _fields(sum(shape), *shape)
    v = torch.from_numpy(-cell).to(dev)
    mask = v < -0.1
    rank = cc.sequentialize_components(cc.connected_components(v < -0.6))
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
    and path-like shapes (K not a multiple of 16 takes the gathering
    loads)."""
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
