"""The trace reduction on a hand-made Chrome trace."""

import pytest

from benchmark.harness.trace import WINDOW_SPAN, Summary


def _x(cat, name, ts, dur, **kw):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=1,
                tid=kw.pop("tid", 1), args=kw)


def test_busy_idle_and_operators():
    ev = [
        _x("user_annotation", WINDOW_SPAN, 0.0, 1000.0),
        _x("cpu_op", "aten::convolution", 10.0, 30.0),
        _x("cuda_runtime", "cudaLaunchKernel", 15.0, 5.0, correlation=1),
        _x("kernel", "conv_kernel", 100.0, 200.0, correlation=1, tid=7),
        _x("cuda_runtime", "cudaLaunchKernel", 50.0, 5.0, correlation=2),
        _x("kernel", "other_kernel", 250.0, 150.0, correlation=2, tid=7),
        _x("cpu_op", "aten::item", 500.0, 400.0),
        _x("cuda_runtime", "cudaStreamSynchronize", 520.0, 300.0),
    ]
    s = Summary(ev)
    assert s.window_s == pytest.approx(1e-3)
    # kernels cover 100-400 us of the 1000 us window
    assert s.busy_s == pytest.approx(300e-6)
    assert s.operator_s == {"aten::convolution": pytest.approx(200e-6)}
    assert s.kernel_n == {"conv_kernel": 1, "other_kernel": 1}
    # the gap 400-1000 us has its middle inside the synchronise
    assert s.idle["cudaStreamSynchronize"] == pytest.approx(600e-6)
    b = s.breakdown()
    assert b["device_ops"][0] == ["conv_kernel", pytest.approx(200e-6)]
    assert len(b["idle_gaps"]) <= 10
