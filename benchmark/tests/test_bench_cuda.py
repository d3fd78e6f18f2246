"""The controls on the card, at the cells' own sizes: the lower-precision
control in the program's place comes out not correct, and a sound run
correct.  ``python -m pytest benchmark/tests -q -m cuda`` on the card."""

import time

import pytest
import torch

from conftest import cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dunet-crops256", "dunet-tiled2048"])
def test_int8_control_is_not_correct(card, name):
    from benchmark.harness.core import run
    c = cell(name)
    sound = run(c, 2147483800, 2.0, False, card, time.perf_counter())
    assert sound["correct"] is True, sound["checks"]
    ctl = run(c, 2147483800, 2.0, False, card, time.perf_counter(),
              control=True)
    assert ctl["correct"] is False
    c = ctl["checks"]["field_err"]
    assert c["value"] > c["limit"]


@pytest.mark.cuda
def test_fp8_control_is_not_correct(card):
    from benchmark.entries.train import Driver as TrainDriver
    from benchmark.reference.lowp import fp8
    drv = TrainDriver(cell("dunet-mish-gn-train-b4"), 2147483801, card)
    drv.setup()
    drv.free()
    sound = drv.check()
    assert all(c["value"] <= c["limit"] for c in sound), sound
    ctl = drv.numbers(drv.reference(quant=fp8), drv.reference())
    assert any(c["value"] > c["limit"] for c in ctl), ctl
