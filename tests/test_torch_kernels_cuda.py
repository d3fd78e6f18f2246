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
