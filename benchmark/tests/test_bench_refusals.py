"""A configuration or traffic mix is run as it says or refused: every key
is read by the entry's driver, and a value that the driver or the
reference cannot run stops the run before set-up.  The reference's Ranger
follows the port's over the steps the training check compares."""

import time

import pytest
import torch

from benchmark.harness import drivers
from conftest import cell, tiny


def _driver(name, config=None, traffic=None):
    c = cell(name)
    c.config = dict(c.config, **(config or {}))
    c.traffic = dict(c.traffic, **(traffic or {}))
    return drivers.load(c.traffic["entry"])(c, 1, "cpu")


@pytest.mark.parametrize("name,config,traffic", [
    ("dunet-crops256", {"tta": True}, None),
    ("dunet-crops256", None, {"clients": 4}),
    ("dunet-crops256", {"precision": "float32"}, None),
    ("dunet-crops256", {"label_type": "boundary"}, None),
    ("dunet-crops256", {"loss": "smooth_l1"}, None),
    ("dunet-crops256", {"family": "toy"}, None),
    ("dunet-tiled2048", None, {"infer": {"tta": True, "th_cell": 0.15}}),
    ("dunet-mish-gn-train-b4", {"optimizer": "adam"}, None),
    ("dunet-mish-gn-train-b4", {"loss": "ce"}, None),
    ("dunet-mish-gn-train-b4", {"precision": "float32"}, None),
    ("dunet-mish-gn-train-b4", None, {"label_type": "distance"}),
    ("dunet-mish-gn-train-b4", {"family": "toy"}, None),
])
def test_a_key_not_read_or_a_value_not_run_is_refused(name, config, traffic):
    with pytest.raises(ValueError):
        _driver(name, config, traffic)


def test_a_missing_key_is_refused():
    c = cell("dunet-mish-gn-train-b4")
    c.config = {k: v for k, v in c.config.items() if k != "learning_rate"}
    with pytest.raises(ValueError, match="learning_rate"):
        drivers.load("train")(c, 1, "cpu")


def test_an_unknown_entry_is_refused():
    with pytest.raises(ModuleNotFoundError):
        drivers.load("nothing_here")
    with pytest.raises(ValueError):
        drivers.load("../run")


def test_an_unknown_family_is_refused():
    from benchmark import families
    with pytest.raises(ModuleNotFoundError):
        families.load("nothing_here")
    with pytest.raises(ValueError):
        families.load("../run")


def test_the_reference_refuses_what_it_does_not_train():
    from benchmark.reference.train import run_steps
    conf = dict(cell("dunet-mish-gn-train-b4").config, optimizer="adam")
    with pytest.raises(ValueError, match="optimizer"):
        run_steps(conf, {}, [])


def test_the_learning_rate_reaches_both_sides():
    """A run at another learning rate still compares equal: the port and
    the reference both take it from the configuration."""
    from benchmark.harness.core import run
    c = tiny("dunet-mish-gn-train-b4")
    c.config = dict(c.config, learning_rate=0.02)
    out = run(c, 2147483700, 0.5, False, "cpu", time.perf_counter(),
              log=lambda *a: None)
    assert out["correct"] is True, out["checks"]


def test_reference_ranger_follows_the_port_over_eight_steps():
    """Steps 1-5 take the momentum, 6 is the first rectified step and the
    first Lookahead sync, 7-8 start from the synced weights."""
    from microbeseg_torch.training.optimizers import Ranger as PortRanger
    from benchmark.reference.train import Ranger
    g = torch.Generator().manual_seed(3)
    shapes = {"conv.weight": (6, 4, 3, 3), "up.0.weight": (4, 6, 2, 2),
              "conv.bias": (6,)}
    init = {n: torch.randn(s, generator=g) for n, s in shapes.items()}
    grads = [{n: torch.randn(s, generator=g) * (1 + k)
              for n, s in shapes.items()} for k in range(8)]
    ref_p = {n: v.clone() for n, v in init.items()}
    ref = Ranger(ref_p, 6e-3, ["up.0.weight"])
    port_p = [torch.nn.Parameter(v.clone()) for v in init.values()]
    port = PortRanger(port_p, 6e-3, gc_dims=[(1, 2, 3), (0, 2, 3), None])
    for k, gr in enumerate(grads):
        ref.step(gr)
        for p, v in zip(port_p, gr.values()):
            p.grad = v.clone()
        port.step()
        for (n, r), p in zip(ref_p.items(), port_p):
            torch.testing.assert_close(p.detach(), r, rtol=2e-6, atol=2e-7,
                                       msg=f"step {k + 1}, {n}")
