"""``MICROBESEG_NO_NATIVE=1`` in both packages' native loaders.

With the variable set, the port's ``client/native.get_lib`` returns None
before it builds anything, as the JAX package's does, and the port's store
inference (the Python contour loops) leaves the ROI strings and files that
JAX's leaves.
"""

import pytest

from microbeseg_tpu.client import native as jnative
from microbeseg_tpu.client import workers as jworkers
from microbeseg_torch.client import native as tnative
from microbeseg_torch.client import workers as tworkers
from tests.test_torch_client import StubEngine, _tree, both  # noqa: F401


@pytest.fixture
def no_native(monkeypatch):
    """The variable set, and each loader's memo cleared (an earlier test in
    the process may have loaded the library)."""
    monkeypatch.setenv("MICROBESEG_NO_NATIVE", "1")
    for mod in (jnative, tnative):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", False)


def test_no_native_loaders_return_none(no_native, monkeypatch):
    built = []
    monkeypatch.setattr(tnative, "_build",
                        lambda target: built.append(target) or False)
    assert tnative.get_lib() is None
    assert jnative.get_lib() is None
    assert built == []   # refused before any build


def test_no_native_store_inference_matches_jax(no_native, both, tmp_path):  # noqa: F811
    """Store inference on the Python routes: equal store states (the ROI
    strings) and mask files, and neither loader loaded its library."""
    for name, wk in (("jax", jworkers), ("torch", tworkers)):
        store, _, ids = both[name]
        wk.infer_dataset(store, ids, StubEngine(), "stub_01",
                         result_dir=tmp_path / f"masks_{name}")
    assert tnative._lib is None and jnative._lib is None
    js, ts = both["jax"][0], both["torch"][0]
    ids = both["torch"][2]
    assert all(len(ts.get_polygons(i)) > 0 for i in ids)
    assert ([p.points for p in ts.get_polygons(ids[-1])]
            == [p.points for p in js.get_polygons(ids[-1])])
    assert _tree(ts.root) == _tree(js.root)
    assert _tree(tmp_path / "masks_torch") == _tree(tmp_path / "masks_jax")
