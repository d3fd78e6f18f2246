"""The port's spans and counters (``microbeseg_torch/utils/profiling.py``):
nothing recorded or kept without a profiler; nested spans with parent and
self times, on the profiler's timeline; the engine's and the trainer's
stages; the flood step counter's resolution; ``device_trace``'s two files;
the benchmark's readers of them.  CPU only: device seconds need the card
(``tests/test_torch_kernels_cuda.py`` holds the flood counter there)."""

import json
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from microbeseg_torch.config import InferConfig, ModelConfig, TrainConfig
from microbeseg_torch.inference.engine import InferenceEngine
from microbeseg_torch.models.unet import build_unet
from microbeseg_torch.ops.augment import draw_params
from microbeseg_torch.training.optimizers import build_optimizer
from microbeseg_torch.training.trainer import Trainer
from microbeseg_torch.utils import profiling

STAGES = ("mseg.segment.upload", "mseg.segment.forward",
          "mseg.segment.postprocess", "mseg.segment.download")
TRAIN_STAGES = ("mseg.train.augment", "mseg.train.forward",
                "mseg.train.backward", "mseg.train.optimizer")


@pytest.fixture(autouse=True)
def _clean_recorder():
    """Each test starts and ends with an empty recorder, on 2 threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    profiling.reset()
    yield
    profiling.reset()
    torch.set_num_threads(n)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_records_nothing_and_allocates_nothing():
    """With no profiler: one shared no-op context, no span and no step
    count kept, and no allocation per span."""
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("a") is profiling.span("b") is profiling._OFF
    with profiling.span("mseg.segment"):
        with profiling.span("mseg.segment.forward"):
            pass
    steps = torch.tensor([3, 9], dtype=torch.int32)
    profiling.count_steps("flood_packed", steps, "max")
    assert profiling._STEPS == {} and profiling._SPANS == {}
    assert profiling.summary() == {"spans": {}, "counters": {}}
    span = profiling.span
    for _ in range(100):      # warm: the loop's own first allocations
        with span("x"):
            pass
    before = sys.getallocatedblocks()
    for _ in range(10000):
        with span("x"):
            pass
    assert sys.getallocatedblocks() - before < 50


def test_nested_spans_give_parent_and_self_times_in_the_trace(tmp_path):
    """Under ``torch.profiler``: a parent's self time is its time less its
    children's, a span opened on another thread is recorded with no
    parent, and the spans of the profiled thread are ``user_annotation``
    events of the exported trace (the profiler follows the thread that
    started it)."""
    def other():
        with profiling.span("mseg.other"):
            time.sleep(0.01)

    with _cpu_profile() as prof:
        with profiling.span("mseg.outer"):
            time.sleep(0.02)
            for _ in range(2):
                with profiling.span("mseg.inner"):
                    torch.ones(16).sum()
                    time.sleep(0.01)
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    s = profiling.summary()["spans"]
    outer, inner, oth = s["mseg.outer"], s["mseg.inner"], s["mseg.other"]
    assert (outer["count"], inner["count"], oth["count"]) == (1, 2, 1)
    assert inner["host_s"] >= 0.02 and outer["host_s"] >= 0.04
    assert outer["self_s"] == pytest.approx(
        outer["host_s"] - inner["host_s"], abs=1e-9)
    assert inner["self_s"] == pytest.approx(inner["host_s"], abs=1e-9)
    # the other thread's span is not a child of the outer one
    assert outer["self_s"] >= 0.02 + oth["host_s"] - 1e-3
    assert outer["device_s"] is None    # no CUDA in use
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"mseg.outer", "mseg.inner"} <= names


def test_flood_steps_resolve_to_max_and_sum_per_route():
    """``count_steps`` keeps the tensors while a profiler records and
    ``summary`` reads them: 'max' takes a launch's largest count, 'sum'
    adds a launch's counts, each route on its own."""
    with _cpu_profile():
        a = torch.tensor([4, 17, 9], dtype=torch.int32)
        profiling.count_steps("flood_packed", a, "max")
        profiling.count_steps("flood_packed",
                              torch.tensor([2], dtype=torch.int32), "max")
        profiling.count_steps("flood_tiled",
                              torch.tensor([200, 5], dtype=torch.int32),
                              "sum")
        a[1] = 30       # read at summary, not at the launch
    want = {"flood_packed": 32, "flood_tiled": 205}
    assert profiling.summary()["counters"] == {"flood_steps": want}
    # resolved once: a second read gives the same counts
    assert profiling.summary()["counters"] == {"flood_steps": want}
    profiling.reset()
    assert profiling.summary() == {"spans": {}, "counters": {}}


def _engine(tiled: bool) -> InferenceEngine:
    torch.manual_seed(0)
    model = build_unet(ModelConfig(filters=(8, 16)))
    cfg = (InferConfig(batch_size=2, use_tiling=True, tile_size=32,
                       tile_overlap=8) if tiled
           else InferConfig(batch_size=2))
    return InferenceEngine(model, "distance", cfg=cfg, device="cpu")


@pytest.mark.parametrize("tiled", [False, True], ids=["bucket", "tiled"])
def test_segment_records_each_stage_once_a_batch(tiled):
    """Two ``segment`` calls of 3 frames: the root once a call, the upload
    once, the forward (bucket: once a device batch of 2; tiled: once a
    chunk of frames), post-processing and download once a post-processing
    batch, stitching only on the tiled path; the stages lie inside the
    root's host time.  Tracing leaves the masks as they were."""
    eng = _engine(tiled)
    frames = (np.random.default_rng(1).random((3, 64, 64))
              * 60000).astype(np.uint16)
    want = eng.segment(frames)
    with _cpu_profile():
        for _ in range(2):
            got = eng.segment(frames)
    np.testing.assert_array_equal(got, want)
    s = profiling.summary()["spans"]
    assert s["mseg.segment"]["count"] == 2
    assert s["mseg.segment.upload"]["count"] == 2
    assert s["mseg.segment.postprocess"]["count"] == 4
    assert s["mseg.segment.download"]["count"] == 4
    if tiled:
        # one forward and one stitch a chunk, one stitch (the resize) a call
        chunks = s["mseg.segment.forward"]["count"] // 2
        assert chunks >= 1
        assert s["mseg.segment.stitch"]["count"] == 2 * (chunks + 1)
    else:
        assert s["mseg.segment.forward"]["count"] == 4
        assert "mseg.segment.stitch" not in s
    stages = sum(v["host_s"] for k, v in s.items() if k != "mseg.segment")
    root = s["mseg.segment"]
    assert stages <= root["host_s"]
    assert root["self_s"] == pytest.approx(root["host_s"] - stages,
                                           abs=1e-6)


def test_train_step_records_its_stages_once_a_step(tmp_path):
    """Three ``Trainer.train_step`` calls: the root and each of its four
    stages once a step; forward and backward are children of the root."""
    cfg = TrainConfig(model=ModelConfig(filters=(8, 16)), batch_size=2,
                      compute_dtype="float32")
    tr = Trainer(cfg, tmp_path, device="cpu")
    tr.optimizer, _ = build_optimizer(cfg, tr.model)
    g = torch.Generator().manual_seed(0)
    images = torch.rand((2, 64, 64, 1), generator=g) * 60000
    labels = {"border_label": torch.rand((2, 64, 64, 1), generator=g),
              "cell_label": torch.rand((2, 64, 64, 1), generator=g)}
    weights = torch.ones(2)
    with _cpu_profile():
        for _ in range(3):
            loss = tr.train_step(images, labels, weights,
                                 draw_params(g, 2, 64))
    assert torch.isfinite(loss)
    s = profiling.summary()["spans"]
    assert {k: v["count"] for k, v in s.items()} == {
        "mseg.train_step": 3, **{k: 3 for k in TRAIN_STAGES}}
    root = s["mseg.train_step"]
    assert root["self_s"] == pytest.approx(
        root["host_s"] - sum(s[k]["host_s"] for k in TRAIN_STAGES), abs=1e-6)


def test_device_trace_writes_the_trace_and_the_span_table(tmp_path):
    """``device_trace`` forgets what was recorded before it, writes the
    Chrome trace and ``spans.json`` (the summary of the block), and every
    span of the table is a ``user_annotation`` of the trace."""
    eng = _engine(False)
    frames = np.random.default_rng(2).random((2, 64, 64)).astype(np.float32)
    with _cpu_profile():
        with profiling.span("mseg.before"):
            pass
    with profiling.device_trace(str(tmp_path / "t")):
        eng.segment(frames)
    table = json.loads((tmp_path / "t" / "spans.json").read_text())
    assert set(table["spans"]) == {"mseg.segment", *STAGES}
    assert table["spans"]["mseg.segment"]["count"] == 1
    assert set(table["spans"]["mseg.segment"]) == {"count", "host_s",
                                                   "self_s", "device_s"}
    events = json.loads((tmp_path / "t" / "trace.json").read_text())
    names = {e["name"] for e in events["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert set(table["spans"]) <= names


def _reader(name):
    from benchmark.harness.core import reader
    return reader(name)


NEW_METRICS = ("forward_ms_per_mpx.segment", "post_ms_per_mpx.segment",
               "stitch_ms_per_mpx.segment", "flood_us_per_step.segment",
               "port_python_idle_pct.segment", "host_ms_per_step.train")


def test_benchmark_readers_of_the_spans(monkeypatch):
    """The benchmark's readers of the port's spans and counter: nothing
    where the recorder holds nothing (an untraced run) or where the
    program has no recorder; else the recorded numbers over the traced
    sub-window's pixels, steps or seconds."""
    trace = types.SimpleNamespace(
        window_s=2.0, idle={"mseg.segment": 0.1, "mseg.segment.forward":
                            0.05, "bench.segment": 0.3, "aten::mul": 0.2},
        kernel_s={"flood_block_kernel(float const*, int)": 0.002,
                  "flood_front_kernel(int const*)": 0.001,
                  "other_kernel": 1.0})
    ctx = {"trace": trace, "traced": {"pixels": 4_000_000, "steps": 4}}
    for name in NEW_METRICS:
        assert _reader(name)(ctx) is None, name
    recorded = {"spans": {
        "mseg.segment.forward": {"count": 4, "host_s": 0.1, "self_s": 0.1,
                                 "device_s": 0.04},
        "mseg.segment.postprocess": {"count": 4, "host_s": 0.1,
                                     "self_s": 0.1, "device_s": 0.008},
        "mseg.train_step": {"count": 4, "host_s": 0.2, "self_s": 0.01,
                            "device_s": 0.3}},
        "counters": {"flood_steps": {"flood_packed": 1000,
                                     "flood_tiled": 500}}}
    monkeypatch.setattr(profiling, "summary", lambda: recorded)
    got = {name: _reader(name)(ctx) for name in NEW_METRICS}
    assert got == pytest.approx({
        "forward_ms_per_mpx.segment": 10.0, "post_ms_per_mpx.segment": 2.0,
        "stitch_ms_per_mpx.segment": None, "flood_us_per_step.segment": 2.0,
        "port_python_idle_pct.segment": 7.5, "host_ms_per_step.train": 50.0})
    # a program whose profiling module has no recorder (the parent's)
    monkeypatch.delattr(profiling, "summary")
    for name in NEW_METRICS:
        assert _reader(name)(ctx) is None, name
