"""``rel_attention_roofline``'s least time by hand: the two products of the
attention over the tensor cores' bf16 rate, or q, k, v and the output over
the HBM bandwidth, whichever is longer; and its reader silent where the
trace holds no launch of the kernel."""

import importlib.util

import pytest

from benchmark.harness.common import BENCH, HBM_BYTES_PER_S


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rel_attention_bounds_by_hand():
    m = _metric("rel_attention_roofline")
    # the cell's block-forward: 16 tiles x 16 heads, 1,024 tokens, head 64:
    # 256 x 4 x 1024^2 x 64 = 68,719,476,736 operations, 69.5 us
    assert m.least_s(256, 1024, 64) == pytest.approx(
        68_719_476_736 / 989e12)
    assert m.least_s(256, 1024, 64) == pytest.approx(6.9484e-5, rel=1e-4)
    # one token a map: the bytes bound it
    assert m.least_s(10, 1, 64) == pytest.approx(
        10 * 8 * 64 / HBM_BYTES_PER_S)


@pytest.mark.parametrize("kernels", [{}, {"cudnn_sdpa_fprop": 1.0}])
def test_rel_attention_reader_is_silent_without_the_kernel(kernels):
    """A trace of the parent's attention (cuDNN's, no rel_attention_kernel)
    or none at all gives no value."""
    m = _metric("rel_attention_roofline")

    class Trace:
        kernel_s = dict(kernels)
        kernel_n = {k: 1 for k in kernels}

    assert m.read({"trace": None}) is None
    assert m.read({"trace": Trace()}) is None
