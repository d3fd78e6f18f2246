"""The generators are the same under one seed and differ under another,
and every seed draws the same amount of work."""

import numpy as np
import pytest
import torch

from benchmark.harness import augdraw, gen, weights
from benchmark.harness.common import model_config, sub_seed
from conftest import tiny


@pytest.mark.parametrize("name", ["dunet-crops256", "dunet-tiled2048"])
def test_frames_follow_the_seed(name):
    mix = tiny(name).traffic
    a = gen.frames(mix, 2147483999, 4, "cpu")
    b = gen.frames(mix, 2147483999, 4, "cpu")
    c = gen.frames(mix, 2147484000, 4, "cpu")
    assert a.dtype == np.uint16 and a.shape == (4, mix["frame"], mix["frame"])
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_every_seed_draws_the_same_counts():
    mix = {"objects": [8, 214]}
    counts = [np.sort(gen.object_counts(mix, 64, gen.generator(s, 1, "cpu")))
              for s in (1, 2, 3 << 40)]
    assert all(np.array_equal(counts[0], c) for c in counts[1:])
    assert counts[0][0] == 8 and counts[0][-1] == 214


def test_training_fields_follow_the_seed():
    mix = tiny("dunet-mish-gn-train-b4").traffic
    img, planes = gen.frames(mix, 5, 3, "cpu", fields=True)
    img2, planes2 = gen.frames(mix, 5, 3, "cpu", fields=True)
    assert torch.equal(img, img2) and torch.equal(planes["cell"],
                                                  planes2["cell"])
    cell = planes["cell"]
    assert float(cell.max()) <= 1.0 and float(cell.min()) >= 0.0
    # the cones peak inside the bright ellipses
    assert float(img[cell > 0.5].float().mean()) > 20000


def test_augmentation_draw_follows_the_seed():
    def draw(seed):
        return augdraw.draw(torch.Generator().manual_seed(seed), 4, 32)
    a, b, c = draw(1), draw(1), draw(2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a if a[k].shape ==
                   c[k].shape)


@pytest.mark.parametrize("kind", ["averaging", "lecun"])
def test_weights_follow_the_seed(kind):
    cfg = model_config(tiny("dunet-crops256").config)
    a = weights.make(cfg, 3, "cpu", kind)
    b = weights.make(cfg, 3, "cpu", kind)
    c = weights.make(cfg, 4, "cpu", kind)
    name = "encoderConv.1.conv.0.weight"
    assert torch.equal(a[name], b[name]) and not torch.equal(a[name],
                                                             c[name])
    if kind == "averaging":
        w = a[name]
        assert float(w.min()) >= 0
        assert torch.allclose(w.sum(dim=(1, 2, 3)), torch.ones(w.shape[0]))


def test_large_seeds():
    assert 0 <= sub_seed(2 ** 40 + 17, 3) < 2 ** 63
    assert sub_seed(2 ** 31 + 5, 1) != sub_seed(2 ** 31 + 6, 1)
