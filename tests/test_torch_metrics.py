"""Port vs JAX package: the evaluation metrics and ``remap_label``.

``microbeseg_torch/evaluation/metrics.py`` is a copy of the JAX package's
host module (the port imports nothing of it), so every score must come out
as the same float on seeded pairs of label images with touching, missing,
split, merged and spurious instances.
"""

import numpy as np
import pytest

import microbeseg_tpu.evaluation.metrics as jm
from microbeseg_torch.evaluation import metrics as tm

N_PAIRS = 24


def _touching_blobs(rng, shape=(64, 64), n=9):
    """Disks grown from random centres: later disks take only free pixels,
    so neighbours touch."""
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    mask = np.zeros(shape, np.int32)
    for k in range(1, n + 1):
        r = int(rng.integers(4, 11))
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        mask[((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r) & (mask == 0)] = k
    return mask


def _prediction(rng, gt):
    """Perturb the ground truth: drop instances, split one along a line,
    merge two, shift the frame by a pixel, add a spurious blob, and
    renumber the ids sparsely."""
    pred = gt.copy()
    ids = [i for i in np.unique(gt) if i > 0]
    if not ids:
        return pred
    for i in rng.choice(ids, size=min(2, len(ids)), replace=False):
        if rng.random() < 0.5:
            pred[pred == i] = 0                             # missing
    split = int(rng.choice(ids))
    ys, xs = np.nonzero(pred == split)
    if len(ys):
        half = (pred == split) & (np.arange(gt.shape[1])[None, :]
                                  > xs.mean())
        pred[half] = gt.max() + 1                           # split
    if len(ids) > 2 and rng.random() < 0.5:
        a, b = rng.choice(ids, size=2, replace=False)
        pred[pred == b] = a                                 # merged
    pred = np.roll(pred, int(rng.integers(-1, 2)), axis=int(rng.integers(2)))
    yy, xx = np.mgrid[0:gt.shape[0], 0:gt.shape[1]]
    cy, cx = rng.integers(0, gt.shape[0]), rng.integers(0, gt.shape[1])
    spurious = ((yy - cy) ** 2 + (xx - cx) ** 2 <= 9) & (pred == 0)
    pred[spurious] = 500
    return np.where(pred > 0, pred * 7 + 3, 0).astype(np.int32)


def _pairs():
    rng = np.random.default_rng(2024)
    pairs = []
    for k in range(N_PAIRS):
        gt = _touching_blobs(rng, n=int(rng.integers(3, 12)))
        pairs.append((gt, _prediction(rng, gt)))
    # the edge cases: both empty, empty prediction, empty ground truth
    z = np.zeros((32, 32), np.int32)
    one = z.copy()
    one[4:12, 4:12] = 3
    pairs += [(z, z), (one, z), (z, one)]
    return pairs


PAIRS = _pairs()


@pytest.mark.parametrize("k", range(len(PAIRS)))
def test_metrics_equal_jax(k):
    gt, pred = PAIRS[k]
    t, p = tm.remap_label(gt), tm.remap_label(pred)
    for fn in ("get_fast_aji_plus", "get_fast_aji", "get_dice_1",
               "get_fast_dice_2"):
        ours = getattr(tm, fn)(t, p)
        ref = getattr(jm, fn)(t, p)
        assert type(ours) is float and ours == ref, fn
    for match_iou in (0.5, 0.3):
        (dq, sq, pq), (rows, cols) = tm.get_fast_pq(t, p, match_iou)
        (rdq, rsq, rpq), (rrows, rcols) = jm.get_fast_pq(t, p, match_iou)
        assert (dq, sq, pq) == (rdq, rsq, rpq)
        np.testing.assert_array_equal(rows, rrows)
        np.testing.assert_array_equal(cols, rcols)
    if k < N_PAIRS:   # the perturbed pairs hold instances of both kinds
        assert 0.0 < tm.get_fast_aji_plus(t, p) < 1.0


@pytest.mark.parametrize("by_size", [False, True])
def test_remap_label_equals_jax(by_size):
    rng = np.random.default_rng(7)
    for gt, pred in PAIRS:
        for lab in (gt, pred, gt.astype(np.uint16)):
            ours = tm.remap_label(lab, by_size=by_size)
            ref = jm.remap_label(lab, by_size=by_size)
            assert ours.dtype == ref.dtype
            np.testing.assert_array_equal(ours, ref)
    # negative ids are background; huge sparse int64 ids take the
    # searchsorted branch (max id far above 4 * size)
    lab = rng.integers(-3, 6, (40, 50)).astype(np.int64)
    sparse = np.where(lab > 0, lab * (1 << 40) + 11, lab)
    for x in (lab, sparse, sparse.astype(np.int64)[::-1]):
        ours = tm.remap_label(x, by_size=by_size)
        np.testing.assert_array_equal(ours, jm.remap_label(x, by_size=by_size))
        assert ours.max() == len(np.unique(x[x > 0]))


def test_pair_coordinates_equals_jax():
    rng = np.random.default_rng(3)
    for _ in range(5):
        a = rng.random((int(rng.integers(1, 12)), 2)) * 50
        b = rng.random((int(rng.integers(1, 12)), 2)) * 50
        for radius in (3.0, 12.0):
            for x, y in zip(tm.pair_coordinates(a, b, radius),
                            jm.pair_coordinates(a, b, radius)):
                np.testing.assert_array_equal(x, y)
