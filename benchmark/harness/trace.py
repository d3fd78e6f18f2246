"""A ``torch.profiler`` trace of a short steady sub-window, reduced to what
the per-layer metrics and the ``breakdown`` read.

The trace is exported as a Chrome trace into a temporary file, read and
deleted.  Device activity is every kernel, memcpy and memset.  A kernel
is attributed to an ATen operator when the host call that launched it
(linked by its correlation id) lies inside that operator on the same
host thread; autograd's backward runs on a thread of its own, and its
operators are found there too.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
SPAN_CATS = ("user_annotation",)
WINDOW_SPAN = "bench.traced_window"
SHORT_GAP_US = 10.0
# the operators whose kernels some metric reads
OPERATORS = ("aten::convolution", "aten::convolution_backward")


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Summary:
    """What one traced sub-window showed, in seconds."""

    def __init__(self, events: List[dict]):
        win = [e for e in events if e.get("name") == WINDOW_SPAN
               and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the traced window's span is not in the trace")
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        self.window_s = (w1 - w0) * 1e-6
        dev = [e for e in events if e.get("cat") in DEVICE_CATS
               and e.get("ph") == "X"]
        spans = [(max(float(e["ts"]), w0),
                  min(float(e["ts"]) + float(e["dur"]), w1)) for e in dev]
        busy = _union([(s, e) for s, e in spans if e > s])
        self.busy_s = sum(e - s for s, e in busy) * 1e-6
        self.kernel_s: Dict[str, float] = defaultdict(float)
        self.kernel_n: Dict[str, int] = defaultdict(int)
        for e in dev:
            self.kernel_s[e["name"]] += float(e["dur"]) * 1e-6
            self.kernel_n[e["name"]] += 1
        self.operator_s = self._by_operator(events, dev)
        self.idle = self._idle(events, busy, w0, w1)

    @staticmethod
    def _by_operator(events, dev) -> Dict[str, float]:
        launch = {}
        for e in events:
            if e.get("cat") in ("cuda_runtime", "cuda_driver"):
                c = e.get("args", {}).get("correlation")
                if c is not None:
                    launch[c] = e
        ops: Dict[tuple, List[Tuple[float, float]]] = defaultdict(list)
        for e in events:
            if e.get("cat") == "cpu_op" and e.get("name") in OPERATORS:
                ops[(e["name"], e.get("pid"), e.get("tid"))].append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        starts = {k: ([s for s, _ in sorted(v)], sorted(v))
                  for k, v in ops.items()}
        out: Dict[str, float] = defaultdict(float)
        for k in dev:
            r = launch.get(k.get("args", {}).get("correlation"))
            if r is None:
                continue
            t = float(r["ts"])
            for (name, pid, tid), (st, iv) in starts.items():
                if pid != r.get("pid") or tid != r.get("tid"):
                    continue
                i = bisect.bisect_right(st, t) - 1
                # operators of one name do not nest: the last one that
                # started before the launch is the only candidate
                if i >= 0 and iv[i][1] >= t:
                    out[name] += float(k["dur"]) * 1e-6
                    break
        return dict(out)

    @staticmethod
    def _idle(events, busy, w0, w1) -> Dict[str, float]:
        """Idle seconds of the window by what the host was doing in the
        middle of each gap: the shortest host event that covers it (an
        operator or a runtime call among the last few thousand to start,
        or one of the benchmark's spans)."""
        gaps, t = [], w0
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if w1 > t:
            gaps.append((t, w1))

        def spans(cats):
            return sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                            e["name"]) for e in events
                           if e.get("cat") in cats and e.get("ph") == "X"
                           and e.get("name") != WINDOW_SPAN),
                          key=lambda h: h[0])

        host, marks = spans(HOST_CATS), spans(SPAN_CATS)
        starts = [h[0] for h in host]
        out: Dict[str, float] = defaultdict(float)
        for s, e in gaps:
            if e - s < SHORT_GAP_US:
                out["(gaps under 10 us)"] += (e - s) * 1e-6
                continue
            mid = 0.5 * (s + e)
            i = bisect.bisect_right(starts, mid)
            cands = [h for h in host[max(0, i - 4000):i] + marks
                     if h[0] <= mid <= h[1]]
            best = min(cands, key=lambda h: h[1] - h[0], default=None)
            out[best[2][:80] if best else "(no host event)"] += (e - s) * 1e-6
        return dict(out)

    def breakdown(self) -> dict:
        """The 10 device operations that took most time (names cut to 80
        characters, those that share the cut summed) and the 10 largest
        idle shares by host activity."""
        by: Dict[str, float] = defaultdict(float)
        for k, v in self.kernel_s.items():
            by[k[:80]] += v
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def span():
    """The traced window's span: a driver's ``traced_window`` opens it
    around the interval it measures."""
    return torch.profiler.record_function(WINDOW_SPAN)


def traced(fn: Callable[[], dict]) -> Tuple[dict, Summary]:
    """Run ``fn`` under the profiler -> (its result, the summary of the
    window it marked with ``span``)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        t0 = time.perf_counter()
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
        summary = Summary(events)
        summary.read_s = time.perf_counter() - t0
    finally:
        os.unlink(path)
    return out, summary
