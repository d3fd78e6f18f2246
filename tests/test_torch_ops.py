"""Port vs JAX: the flood (K1), connected components (K3), root-rank relabel
(K4, and ``ranked_components``, K4 for K3's ids), the gaussian and the 'flood' watershed on the same numpy inputs.

The port's wrappers run their plain PyTorch versions on CPU tensors; the
JAX side runs its CPU path, with the Pallas flood in interpret mode.  K1, K3
and K4 must agree bit for bit.  The CUDA kernels are held against the plain
versions on the card by ``chip_smoke.py`` and by
``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax.numpy as jnp

from microbeseg_torch.ops import cc as tcc
from microbeseg_torch.ops.filters import gaussian_filter
from microbeseg_torch.ops.kernels.flood import flood_packed, flood_or_fallback
from microbeseg_torch.ops.watershed import watershed


def _blob_field(rng, H, W, n_blobs):
    yy, xx = np.mgrid[0:H, 0:W]
    cell = np.zeros((H, W), np.float32)
    for _ in range(n_blobs):
        cy, cx = rng.integers(3, H - 3), rng.integers(3, W - 3)
        r = float(rng.uniform(3, 8))
        cell = np.maximum(cell, np.clip(
            1 - np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2) / r, 0, 1))
    cell = (cell + rng.normal(0, 0.02, (H, W))).astype(np.float32)
    seeds, _ = ndimage.label(cell > 0.6, structure=np.ones((3, 3)))
    return cell, seeds.astype(np.int32), cell > 0.1


def _batch_fields(seed, B, H, W, n_blobs=6):
    rng = np.random.default_rng(seed)
    fields = [_blob_field(rng, H, W, n_blobs) for _ in range(B)]
    return tuple(np.stack(f) for f in zip(*fields))


class TestFloodK1:
    @pytest.mark.parametrize("label_bits", [12, 24])
    def test_plain_matches_pallas_interpret(self, label_bits):
        """Odd 30x46 frames, a batch of 3 with their own quantisation."""
        from microbeseg_tpu.ops.pallas.flood import flood_pallas

        cell, seeds, mask = _batch_fields(5, 3, 30, 46)
        cell[1] *= 3.0          # per-image ranges differ
        cell[2] -= 0.5
        if label_bits == 24:    # ids above 12 bits must survive
            seeds = np.where(seeds > 0, seeds + 5000, 0).astype(np.int32)
        ref = np.asarray(flood_pallas(jnp.asarray(-cell), jnp.asarray(seeds),
                                      jnp.asarray(mask), n_levels=128,
                                      label_bits=label_bits, interpret=True))
        ours = flood_packed(torch.from_numpy(-cell), torch.from_numpy(seeds),
                            torch.from_numpy(mask), n_levels=128,
                            label_bits=label_bits).numpy()
        assert ours.shape == (3, 30, 46)
        np.testing.assert_array_equal(ours, ref)
        assert len(np.unique(ours)) > 3

    def test_routing_and_limits(self):
        cell, seeds, mask = _batch_fields(6, 1, 32, 32)
        args = (torch.from_numpy(-cell), torch.from_numpy(seeds),
                torch.from_numpy(mask))
        small = flood_or_fallback(*args, max_label=255)
        wide = flood_or_fallback(*args, max_label=70000)   # 24-bit keys
        np.testing.assert_array_equal(small.numpy(), wide.numpy())
        with pytest.raises(ValueError, match="packed key overflow"):
            flood_packed(*args, n_levels=1 << 20, label_bits=12)
        # a side above 768 routes to the frame flood (24 label bits)
        big = torch.zeros((1, 8, 800))
        big[0, 2:6, 100:700] = 1.0
        seed = torch.zeros((1, 8, 800), dtype=torch.int32)
        seed[0, 4, 400] = 5000
        out = flood_or_fallback(-big, seed, big > 0)
        assert out.shape == big.shape
        assert set(out.unique().tolist()) == {0, 5000}
        np.testing.assert_array_equal((out > 0).numpy(), (big > 0).numpy())

    @pytest.mark.parametrize("side,n_levels,label_bits,kernel", [
        (256, 128, 12, "block"), (256, 2, 12, "block"), (64, 1, 12, "block"),
        (768, 256, 12, "block"), (768, 128, 24, "block"), (1, 2, 24, "block"),
        (256, 257, 12, "cluster"), (768, 1 << 19, 12, "cluster")])
    def test_route_rule(self, side, n_levels, label_bits, kernel):
        """The kernel ``flood_packed`` takes on the card, by frame side,
        levels and label bits: one block per image up to 256 levels, the
        cluster kernel beyond."""
        from microbeseg_torch.ops.kernels.flood import flood_packed_route

        assert flood_packed_route(side, n_levels, label_bits) == kernel

    @pytest.mark.parametrize("side,n_levels,label_bits,match", [
        (769, 128, 12, "sides up to 768"), (256, 0, 12, "at least one"),
        (256, 256, 24, "packed key overflow"),
        (256, (1 << 19) + 1, 12, "packed key overflow")])
    def test_route_rule_refusals(self, side, n_levels, label_bits, match):
        from microbeseg_torch.ops.kernels.flood import flood_packed_route

        with pytest.raises(ValueError, match=match):
            flood_packed_route(side, n_levels, label_bits)

    def test_unpackable_labels_take_watershed_on_cpu_only(self, monkeypatch):
        """Labels the packed key cannot carry take the 'flood' watershed on
        the CPU, and on any other device the same route (as JAX takes its
        XLA flood there), counted as ``watershed_route``."""
        import microbeseg_torch.ops.watershed as ws
        from microbeseg_torch.kernels import _build

        cell, seeds, mask = _batch_fields(6, 1, 32, 32)
        args = [torch.from_numpy(a) for a in (-cell, seeds, mask)]
        before = _build.LAUNCHES["watershed_route"]
        got = flood_or_fallback(*args, max_label=1 << 24)
        np.testing.assert_array_equal(got.numpy(), watershed(*args).numpy())
        seen = []
        monkeypatch.setattr(ws, "watershed", lambda v, mk, m, n_levels: (
            seen.append((v.device.type, n_levels))
            or torch.zeros(v.shape, dtype=torch.int32, device=v.device)))
        meta = [a.to("meta") for a in args]
        out = flood_or_fallback(*meta, max_label=1 << 24)
        assert out.device.type == "meta" and out.shape == args[0].shape
        assert seen == [("meta", 128)]
        assert _build.LAUNCHES["watershed_route"] == before + 2


class TestWatershed:
    def test_plain_flood_matches_jax(self):
        from microbeseg_tpu.ops.watershed import watershed as jws

        cell, seeds, mask = _batch_fields(7, 2, 40, 36)
        ours = watershed(torch.from_numpy(-cell), torch.from_numpy(seeds),
                         torch.from_numpy(mask)).numpy()
        for i in range(2):
            ref = np.asarray(jws(jnp.asarray(-cell[i]),
                                 jnp.asarray(seeds[i]), jnp.asarray(mask[i])))
            np.testing.assert_array_equal(ours[i], ref)

    @pytest.mark.parametrize("connectivity", [1, 2])
    @pytest.mark.parametrize("levels", [(8, 1), (128, 2)])
    def test_options_match_jax(self, connectivity, levels):
        """``watershed`` and ``watershed_fast`` with 4- and 8-connected
        steps (``connectivity=2``), B = 2 against JAX per frame, bit for
        bit, at 8 levels of one step and at the default 128 of two.  The
        seeds of id 2 are removed, so that the cleanup sweep has pixels
        left to label."""
        from microbeseg_tpu.ops.watershed import watershed as jws
        from microbeseg_tpu.ops.watershed import watershed_fast as jfast
        from microbeseg_torch.ops.watershed import watershed_fast

        cell, seeds, mask = _batch_fields(9, 2, 40, 36)
        seeds = np.where(seeds == 2, 0, seeds)
        args = [torch.from_numpy(a) for a in (-cell, seeds, mask)]
        flood = dict(n_levels=levels[0], inner_steps=levels[1])
        ours = watershed(*args, **flood, connectivity=connectivity).numpy()
        fast = watershed_fast(*args, connectivity).numpy()
        for i in range(2):
            j = [jnp.asarray(a[i]) for a in (-cell, seeds, mask)]
            np.testing.assert_array_equal(ours[i], np.asarray(jws(
                *j, **flood, connectivity=connectivity)))
            np.testing.assert_array_equal(fast[i], np.asarray(jfast(
                *j, connectivity=connectivity)))


def _seed_masks(rng, H=48, W=64):
    """Blobs, 1-px speckle, diagonal-only contacts and one snaking
    component that crosses the frame several times."""
    m = rng.random((H, W)) < 0.08
    for _ in range(6):
        cy, cx = rng.integers(3, H - 3), rng.integers(3, W - 3)
        r = int(rng.integers(1, 4))
        m[cy - r:cy + r + 1, cx - r:cx + r + 1] = True
    snake = np.zeros((H, W), bool)
    for k, y in enumerate(range(2, H - 2, 4)):
        snake[y, 2:W - 2] = True
        x = W - 3 if k % 2 == 0 else 2
        snake[y:y + 4, x] = True
    return m | snake


class TestConnectedComponentsK3K4:
    @pytest.mark.parametrize("connectivity", [1, 2])
    def test_cc_matches_jax(self, connectivity):
        from microbeseg_tpu.ops.cc import connected_components as jcc

        rng = np.random.default_rng(11 + connectivity)
        masks = np.stack([_seed_masks(rng) for _ in range(3)])
        ours = tcc.connected_components(torch.from_numpy(masks),
                                        connectivity=connectivity).numpy()
        for i in range(3):
            ref = np.asarray(jcc(jnp.asarray(masks[i]),
                                 connectivity=connectivity))
            np.testing.assert_array_equal(ours[i], ref)

    @pytest.mark.parametrize("connectivity", [1, 2])
    def test_sequentialize_matches_jax(self, connectivity):
        """connectivity 1 ids touch diagonally: the JAX call then needs
        isolated_components=False, and the port must agree with it."""
        from microbeseg_tpu.ops.cc import (
            connected_components as jcc, sequentialize_components as jseq)

        rng = np.random.default_rng(21 + connectivity)
        masks = np.stack([_seed_masks(rng) for _ in range(2)])
        labels = np.stack([np.asarray(jcc(jnp.asarray(m),
                                          connectivity=connectivity))
                           for m in masks])
        ours = tcc.sequentialize_components(torch.from_numpy(labels)).numpy()
        for i in range(2):
            ref = np.asarray(jseq(jnp.asarray(labels[i]),
                                  isolated_components=connectivity == 2))
            np.testing.assert_array_equal(ours[i], ref)
            assert ours[i].max() == len(np.unique(ours[i])) - 1

    def test_sequentialize_arbitrary_ids(self):
        """Ids that are not CC output: split regions, missing roots."""
        from microbeseg_tpu.ops.cc import sequentialize_components as jseq

        rng = np.random.default_rng(3)
        labels = rng.integers(0, 5, (24, 24)).astype(np.int32)
        labels[5, 5] = 5 * 24 + 5 + 1   # a root
        labels[5, 6] = labels[5, 5]
        labels[20, 20] = labels[5, 5]   # same id, not connected to it
        ref = np.asarray(jseq(jnp.asarray(labels),
                              isolated_components=False))
        ours = tcc.sequentialize_components(torch.from_numpy(labels)).numpy()
        np.testing.assert_array_equal(ours, ref)


def _speckled_blobs(rng, H=64, W=80):
    """Blobs plus 600 single-pixel speckles."""
    m = _blob_field(rng, H, W, 8)[0] > 0.6
    m.flat[rng.choice(H * W, size=600, replace=False)] = True
    return m


class TestRankedComponents:
    """``ranked_components(m, c)`` is JAX's
    ``sequentialize_components(connected_components(m, c))``, exactly."""

    @staticmethod
    def _jax(mask, connectivity):
        from microbeseg_tpu.ops.cc import (
            connected_components as jcc, sequentialize_components as jseq)

        labels = jcc(jnp.asarray(mask), connectivity=connectivity)
        return np.asarray(jseq(labels,
                               isolated_components=connectivity == 2))

    @pytest.mark.parametrize("connectivity", [1, 2])
    @pytest.mark.parametrize("case", ["speckled_blobs", "empty", "full"])
    def test_matches_jax(self, case, connectivity):
        rng = np.random.default_rng(31 + connectivity)
        if case == "speckled_blobs":
            masks = np.stack([_speckled_blobs(rng) for _ in range(2)])
        else:
            masks = np.full((2, 24, 40), case == "full")
        ours = tcc.ranked_components(torch.from_numpy(masks),
                                     connectivity=connectivity)
        assert ours.dtype == torch.int32 and ours.shape == masks.shape
        for i in range(2):
            np.testing.assert_array_equal(
                ours[i].numpy(), self._jax(masks[i], connectivity))
        n = int(ours.max())
        assert n == {"speckled_blobs": n, "empty": 0, "full": 1}[case]
        if case == "speckled_blobs":
            assert n > 100 and len(np.unique(ours[0].numpy())) - 1 == int(
                ours[0].max())

    def test_is_the_two_port_functions_in_turn(self):
        rng = np.random.default_rng(41)
        mask = torch.from_numpy(_seed_masks(rng))
        for connectivity in (1, 2):
            np.testing.assert_array_equal(
                tcc.ranked_components(mask, connectivity).numpy(),
                tcc.sequentialize_components(
                    tcc.connected_components(mask, connectivity)).numpy())
        assert tcc.ranked_components(mask).ndim == 2
        with pytest.raises(RuntimeError, match="unsupported device"):
            tcc.ranked_components(mask.to("meta"))


class TestGaussian:
    def test_matches_jax(self):
        """The port sums the taps in the JAX order with the FMAs XLA's CPU
        backend forms; XLA recomputes some fused intermediates in another
        order, so a few pixels differ by one ulp (ROADMAP Queue 3)."""
        from microbeseg_tpu.ops.filters import gaussian_filter as jg

        rng = np.random.default_rng(0)
        x = rng.standard_normal((3, 30, 46)).astype(np.float32)
        ref = np.asarray(jg(jnp.asarray(x), 0.5))
        ours = gaussian_filter(torch.from_numpy(x), 0.5).numpy()
        ulps = np.abs(ours.view(np.int32).astype(np.int64)
                      - ref.view(np.int32).astype(np.int64))
        assert ulps.max() <= 1
        assert (ulps == 0).mean() >= 0.995
        np.testing.assert_array_equal(
            gaussian_filter(torch.from_numpy(x), 0.0).numpy(), x)
