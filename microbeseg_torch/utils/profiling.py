"""The port's spans and counters, and its trace exporter.

The port of ``microbeseg_tpu/utils/profiling.py``.  The reference's only
instrumentation is wall-clock training time (reference:
src/training/train.py:432,448,552-557).  Here the port records, while a
``torch.profiler`` session is recording and only then:

- ``span(name)``: a ``torch.profiler.record_function`` span, so the span
  lies in the Chrome trace on the device trace's clock, and, kept in
  memory per name, its count, its host seconds, its host self seconds
  (less its child spans' on the same thread) and the device seconds
  between its edges on the current CUDA stream (two CUDA events, resolved
  when ``summary`` is read);
- ``count_steps``: the dependent steps of each marker-flood launch, per
  kernel route (the names of ``kernels/_build.LAUNCHES``), read from the
  kernel's own step counts when ``summary`` is read;
- ``count``: a plain tally known on the host, summed per name (the flows
  post-processing's ``flow_points``, the points its Euler steps follow,
  and ``qc_iterations``, the diffusion steps of its flow check;
  ``attention_maps`` and ``attention_maps.g{g}``, the maps of the ViT's
  attention kernel by grid, and ``attention_maps.wgmma``, those of its
  launches on the ``wgmma`` path).

With no profiler recording, ``span`` returns one shared no-op context after
a single flag check and ``count_steps`` and ``count`` return at once:
nothing is allocated or kept.  ``device_trace`` records a block into
``trace.json`` (``chrome://tracing``, Perfetto) and the summary into
``spans.json``.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List

import torch
from torch.autograd import profiler as _profiler

# what span() returns with no profiler recording
_OFF = contextlib.nullcontext()

_LOCK = threading.Lock()
# the open spans of each thread (an engine on a mesh launches from one
# host thread per device)
_LOCAL = threading.local()
# name -> [count, host_s, self_s, device_s or None, [(start, end) events]]
_SPANS: Dict[str, list] = {}
# kernel route -> [steps, [(steps_out, how)]]
_STEPS: Dict[str, list] = {}
# tally name -> sum
_COUNTS: Dict[str, int] = {}


class _Span:
    __slots__ = ("name", "rf", "t0", "children", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        stack.append(self)
        self.children = 0.0
        self.start = None
        if torch.cuda.is_initialized():
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host = time.perf_counter() - self.t0
        end = None
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        stack = _LOCAL.stack
        stack.pop()
        if stack:
            stack[-1].children += host
        with _LOCK:
            rec = _SPANS.setdefault(self.name, [0, 0.0, 0.0, None, []])
            rec[0] += 1
            rec[1] += host
            rec[2] += host - self.children
            if end is not None:
                rec[4].append((self.start, end))
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context that records the block as span ``name`` while a
    ``torch.profiler`` session is recording; otherwise the shared no-op
    context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def count_steps(kernel: str, steps_out: torch.Tensor, how: str) -> None:
    """Keep the (B,) int32 step counts one launch of a flood kernel wrote,
    while a profiler is recording: ``how`` 'max' where the images run side
    by side (the slowest sets the launch's time), 'sum' where the kernel
    floods them one after the other.  Read, with no sync of its own, by
    ``summary``."""
    if not _profiler._is_profiler_enabled:
        return
    with _LOCK:
        _STEPS.setdefault(kernel, [0, []])[1].append((steps_out, how))


def count(name: str, n: int) -> None:
    """Add ``n`` to the tally ``name`` while a profiler is recording."""
    if not _profiler._is_profiler_enabled:
        return
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + int(n)


def _resolve() -> None:
    """Fold the pending events and step counts into numbers (the caller
    holds ``_LOCK``)."""
    for rec in _SPANS.values():
        for start, end in rec[4]:
            end.synchronize()
            rec[3] = (rec[3] or 0.0) + start.elapsed_time(end) * 1e-3
        rec[4] = []
    for rec in _STEPS.values():
        for steps, how in rec[1]:
            vals = steps.cpu().tolist()
            rec[0] += max(vals, default=0) if how == "max" else sum(vals)
        rec[1] = []


def summary() -> Dict[str, dict]:
    """``{"spans": {name: {count, host_s, self_s, device_s}}, "counters":
    {"flood_steps": {route: steps}, tally: sum}}`` of everything recorded
    since the last ``reset``; ``device_s`` is None where no CUDA event was
    recorded (CUDA not in use)."""
    with _LOCK:
        _resolve()
        spans = {name: {"count": r[0], "host_s": r[1], "self_s": r[2],
                        "device_s": r[3]} for name, r in _SPANS.items()}
        steps = {kernel: r[0] for kernel, r in _STEPS.items()}
        counters = dict(_COUNTS)
    if steps:
        counters["flood_steps"] = steps
    return {"spans": spans, "counters": counters}


def reset() -> None:
    """Forget every span and counter recorded."""
    with _LOCK:
        _SPANS.clear()
        _STEPS.clear()
        _COUNTS.clear()


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Record a ``torch.profiler`` trace of the block (host calls, the
    port's spans, and the card's kernels where CUDA is available) into
    ``log_dir/trace.json``, and the port's span and counter summary of the
    block into ``log_dir/spans.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities: List = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
    (out / "spans.json").write_text(json.dumps(summary(), indent=1))
