#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``microbeseg_torch``) on one GPU.

    python3 chip_smoke.py [--out results.json] [--profile-eval]
                          [--train-quality] [--flows-only]

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels from ``microbeseg_torch/csrc`` (one nvcc per
   source, in parallel).
3. Holds each kernel exactly against its plain PyTorch version on the card,
   at the shapes the main paths give it, and times kernel, plain version
   and, where one PyTorch call computes the same function, that call, with
   CUDA events: K1 flood on both of its kernels (one block per image, the
   route ``flood_packed`` takes for up to 256 levels, and the 8-block
   cluster per image), with equal step and work counts, at 16 x 256^2 (12-
   and 24-bit keys) and at 16 images of each other pad bucket up to 768
   (64, 128, 320, 512, 768); K3 connected components, K4 rank relabel and
   ``ranked_components`` (K4 for K3's ids: ranks straight from a mask, the
   entry the main paths call) at 16 x 256^2 on seeded blob fields, a speckle
   field, an empty and a full mask.  K3 is the one-launch tiled kernel; the
   first port's three-pass route, kept for timing, is held beside it and
   timed in turns with it (16 x 256^2, one 320^2 mask, 2048^2, 4096^2), and
   ``torch.profiler`` must see exactly one device kernel in one
   ``connected_components`` call (three for the three-pass route).  K2, the
   frame flood, on both of its
   kernels (the front kernel that ``flood_tiled`` launches, and the first
   port's whole-frame sweep), with equal step
   and work counts and markers above 4095, on 2 x 1024^2 (also 2 levels),
   1000 x 1400 (also 2 levels), one 4096^2 and one 2048^2 field, timed in
   turns, with the front kernel's set-up and an empty mask's step timed
   apart; K3, K4 and ``ranked_components`` again on one 2048^2 field (K3
   also on a one-pixel serpentine through every tile) and a 48 x 816 strip,
   and K3 on the 4096^2 field's seeds.
   K4's yardstick is the same function in PyTorch calls (root ranks, then a
   gather), with the bare gather beside it; ``ranked_components`` is timed in
   turns with K3 alone and with K3 followed by that library route.  K5, the
   tensor-core matrix product, at 2048^3, at every shape the 9-tap operand
   of the int8 paths has (M = 2^20 on 16 crops, 2^21 and 2^19 on 8 tiles of
   512^2; K = 576, 1152 or 2304; N = 64 or 128) and at the ragged 1000 x
   200 x 72: int8 exactly equal to its plain version, bf16 within one
   bfloat16 step of it, on both of its kernels (``wgmma`` fed by TMA for
   16-byte-aligned rows, ``mma.sync`` for the rest), each timed beside
   ``torch._int_mm`` / ``torch.matmul``.  K5's convolution entry,
   ``conv3x3_int8``, exactly equal to the 9-tap operand, the plain product
   and the float32 dequantise in turn, at every layer shape of the int8
   paths, timed beside ``F.conv2d`` in bfloat16.  The fused convolution
   epilogue (``conv_epilogue``, relu, bfloat16) within one bfloat16 step of
   its plain version at 8 x 64 x 512^2, timed beside the three passes it
   replaces (bias add, ReLU, eval BatchNorm), one by one and as a chain.
4. Crop path: builds the full-width distance DUNet (filters 64 -> 1024, bn,
   relu, conv pooling) with numpy-seeded weights and runs
   ``InferenceEngine.segment`` on 48 uint16 frames of 256^2 (3 batches of
   16), with every launch counter set to 0 just before and read just after.
   Checks that K1's one-block kernel and ``ranked_components`` launched and
   K1's cluster kernel, the first port's K2 sweep and the general K4 did
   not, that no out-of-memory fallback was taken, that the masks hold
   instances, that the plain post-processing on the card gives the same
   masks from the same predictions, that post-processing with K3 followed by
   the general K4 as its labelling function gives them too (counters set to
   0 before, read after), and that the
   bf16 forward on the card agrees with a float32 CPU forward of the same
   weights on a small input.  Times ``segment`` (crops/s) and its forward
   and post-processing parts.
5. Large-frame path: the same model through ``segment`` with
   ``InferConfig(use_tiling=True)`` (tile 512, overlap 64: 25 tiles a
   frame, 8 a forward call) on 3 uint16 frames of 2048^2 with ~900 blobs
   each, counters set to 0 before and read after.  Checks that K2's front
   kernel and ``ranked_components`` launched (and not the first port's K2
   sweep), no out-of-memory fallback, instances and ids above 255,
   and that kernel post-processing equals plain post-processing on one
   whole stitched 2048^2 frame.  Times ``segment`` (frames/s, Mpx/s) and its
   forward, stitching and post-processing parts.
6. Smaller checks: ``segment_grid`` with 8 threshold pairs equals 8
   ``segment`` calls; a 3-class boundary U-Net (seeded weights, output head
   calibrated on held-out frames) gives masks with instances and its kernel
   post-processing equals the plain one; ``scale_factor=0.5`` and
   ``apply_clahe=True`` give finite predictions that agree with the same
   engine on the CPU at the bf16 tolerance.

7. int8 path: the same model and the same 48 crops through ``segment`` with
   ``InferConfig(quantize=True)``.  Checks that calibration ran once (5
   layers with a positive maximum), that ``conv3x3_int8`` launched 5 times
   per batch of 16 (the calibration pass's launches counted apart) and the
   9-tap operand's product never, that the predictions equal, bit for bit,
   those of the same engine on the plain version, and that a second
   ``segment`` call returns the same masks.  Times one int8 layer stage by
   stage, ``segment`` and the forward beside the bf16 engine's, and reports
   how far the int8 fields and masks are from the bf16 ones (numbers, not
   gates: the weights are random).  Then one 2048^2 frame, tiled, with
   ``quantize=True``: tile calibration, 11 K5 launches per tile call, and
   stitched predictions equal to those on the plain version.  Then a narrow
   model (filters 24 -> 384) whose int8 layers no 64 channels divide: 5
   ``matmul_int8`` launches per batch through the 9-tap operand, predictions
   equal to the plain version's.
8. The inference CLI: ``microbeseg_torch.cli.infer_local --quantize`` on a
   folder of two TIFFs, from a checkpoint of the seeded model that
   ``save_model`` wrote; its masks equal the engine's on the same files,
   and it launched K1's one-block kernel once per file.
9. Evaluation: ``Evaluator`` (on the card) from a checkpoint of the seeded
   model on ``data/real_glutamicum`` frames 40-49 and on
   ``data/real_wt/test`` (two frames of other shapes), with a 4 x 2
   threshold grid taken from the model's own fields, one refine round, the
   extra metrics and the raw maps saved; a boundary U-Net on the second set;
   ``cli.evaluate`` once.  Checks that K1's one-block kernel and
   ``ranked_components`` launched, that not every mask is empty, that every
   mask written equals the plain post-processing of the raw maps saved
   beside it, that every slot of the 8-pair grid batch, run again with the
   kernels on each saved raw map, equals the plain post-processing of that
   slot alone, and that ``scores.csv`` equals the port's metrics recomputed
   on the written masks.  Times each evaluation (ms a frame, a frame and
   grid point) and prints scipy's version; with ``--profile-eval`` it runs
   the first evaluation once more under cProfile for host seconds by stage.
10. Label generation: ``create_labels(path, "distance")`` on the card over
   the 50 masks of ``data/real_glutamicum`` (train 0-39, val 40-49), then
   every label type on 4 masks, each card result against the CPU's
   (integer types exactly, float types within 1e-5).  Checks that K3
   (``connected_components``, the gap step) launched.  Times label
   generation a mask, and K3 alone on the gap mask the path gives it
   (1 x 256^2), 4- and 8-connected exactly equal to the plain version,
   timed in turns with the three-pass route, with the host's enqueue
   against the device time of one call of each, beside its plain version,
   its bound and the launch floor (one empty kernel, plain and cooperative,
   through the same ``ctypes`` route); these become K3's times in the
   kernel line (the 16 x 256^2 ones stay under ``*_b16``).

11. Training: ``create_labels`` on the glutamicum split of
   scripts/real_data_eval.py (train 0-34, val 35-39, test 40-49, polarity
   inverted), then ``run_training`` as ``cli.train`` runs it (the flagship
   DUNet, Ranger, mish, gn, batch 4, bf16 autocast) for up to 12 + 1
   epochs (cut from 20 + 2 to keep the phase near 40 s).  Checks that the best validation loss fell below epoch 1's,
   that the ``.ckpt`` and sidecar load through ``models/io.load_model`` and
   the engine segments the test frames with them, that K3 launched in the
   label step, and one step of the path's model and batch (full width,
   batch 4 of 256^2) with fixed augmentation, leaf by leaf: in float64 the
   card's update within 1e-9 of the CPU's (norm of the difference over the
   norm of the CPU's), in float32 the card's no further from the float64
   step than twice the CPU's float32 step plus 1e-6, the loss within 1e-5.  Times a step in
   turns (whole, augmentation, forward + backward, optimizer), the host's
   enqueue time of a step against its kernels' device time, the two
   ``up_impl`` variants in turns, ms an epoch, s for the fit, peak memory,
   and the step's share of 989 TFLOP/s from the convolutions' FLOPs.  With
   ``--train-quality`` it also trains the protocol's model (batch 8, 60
   epochs) and scores AJI+ on frames 40-49 with the ``Evaluator``.

12. Serving: ``cli.serve`` (``build_parser``, ``engine_from_args``,
   ``serve``) on a checkpoint of the flagship that ``save_model`` wrote,
   batch 16, on 127.0.0.1:0, with counters set to 0 before the requests and
   read after: 3 sequential ``.npy`` requests of 16 fresh 256^2 crops, the
   glutamicum frames 40-49 as one multi-page TIFF (``format=tif``, their
   own thresholds as query parameters), 4 concurrent clients x 2 requests,
   ``/healthz``, one 400 and one 413.  Checks that every response equals
   ``segment`` of its frames on the same engine bit for bit and its
   ``X-Instances``, that K1's one-block kernel and ``ranked_components``
   launched (and not the cluster kernel, the K2 sweep, the general K4 or
   the watershed route), and that no out-of-memory fallback was taken.
   Times ``segment`` alone (and a fresh thread's first call), then median
   and p90 request latency and crops/s with 1 client (20 requests) and with
   4 (5 each), the clients processes of their own.
13. The store: a ``LocalStore`` with frames 40-49 as 10 images and one
   2D+t image of the same 10 frames; ``cli.infer_store --local_store
   --dataset -m -r`` (counters from 0).  Checks that every image has ROIs
   and ``inference_model``, that the written masks equal ``segment``'s,
   that the rasterised ROIs agree with them on more than 0.97 of a frame
   (the bar of ``tests/test_client.py``), that a serial ``infer_dataset``
   leaves the same ROI strings, that the native contour library loaded,
   that ``analyze_dataset`` on the card counts the ROIs of each frame and
   its floats are within 1e-5 of the CPU's, that ``export_results`` writes
   5 files an image, and that ``CropGenerator``'s pre-labels (counters
   from 0) are those of ``segment`` on the crops.  Times ms a frame by
   stage on a fresh store: planes, ``segment``, tracing + upload, analysis.
14. The watershed route: ``distance_postprocessing(max_seeds=2**24)`` on 16
   crops' predictions and ``flood_or_fallback`` at 768^2 with labels above
   4095 and 200 levels, each on the card, counted once as
   ``watershed_route``, each equal to the CPU's ``watershed`` on the same
   inputs; timed beside the packed route.  The route must be 0 on every
   main path.
15. Data parallelism on the one card: ``InferenceEngine(mesh=get_mesh(1))``
   against the engine without a mesh on 16 crops of 256^2 and on one 2048^2
   frame, tiled (counters from 0): predictions and masks bit for bit, K1,
   K2 and ``ranked_components`` launched, ``segment`` timed in turns with
   and without the mesh.  Then the trainer in a process group at full width
   with 'bn': one float32 step under a world-1 NCCL group (DDP and the
   cross-replica BatchNorm) against the plain ``Trainer``'s, gradient leaf
   by leaf at step 11's float32 bar; two ranks on the card over gloo
   (spawned, NCCL refuses two ranks on one device), one step each, against
   the plain step at the CPU test's tolerances; the DDP step and the plain
   step in bf16 timed in turns (device ms, the host's enqueue ms, the
   kernels' device ms).  Then ``run_training`` with ``num_devices=1`` and
   ``None`` on glutamicum 0-3 / 35-36 for 2 epochs: equal checkpoints.
16. The GUI: ``gui.app`` on ``tests/fake_qt.py`` (loaded by file path) on a
   ``LocalStore`` of glutamicum frames 40-49, the window's device the
   card: its inference action (counters from 0; K1 and
   ``ranked_components`` launched) stores the masks ``segment`` gives with
   the window's settings; its crop review once, pre-labelled, one crop
   accepted with key 1.
17. Rematerialisation (``build_unet(remat_policy=)``; counters from 0, no
   kernel on this path): the flagship at full width as ``run_training``
   builds it (mish, gn) and as ``ModelConfig()`` builds it (relu, bn),
   through ``Trainer.forward_backward``.  In float32 with cuDNN
   deterministic, a step with 'dots' and with 'nothing' equals the plain
   step bit for bit (outputs, gradients, BatchNorm buffers), also for 'bn'
   under a world-1 NCCL group; 'dots' runs no convolution again in the
   backward pass, 'nothing' two a ConvBlock.  Under bf16 autocast: the
   operators with 'conv' in their name are ``aten.convolution`` and its
   backward, every convolution's input is bf16 (autocast reaches the
   recomputation), and the gradients' largest relative difference from the
   plain step stands beside that of two plain steps.  Times a bf16 step
   (forward + backward + Ranger) at batch 4 and 16 of 256^2 with the three
   policies in turns, with the peak memory of one step of each.
18. Cellpose-SAM: F, ``follow_flows_kernel`` (``csrc/follow.cu``), alone at
   2048^2 on a smooth random field's unit flows x 5 over half the frame
   (~2.1M points, 200 steps), its end points against the plain
   ``grid_sample`` loop's (held with step 3's kernels), timed beside that
   loop and against its bound (operations: 44 float32 a point's step over
   67 TFLOP/s); then the published widths through ``segment`` with
   ``label_type="flows"`` on 4 frames of the benchmark's
   ``cpsam_tiled2048`` mix with its seeded weights: ``follow_flows`` and
   K3 launched, no fallback, the same masks on a second call, the masks
   found against the cells drawn, and the device seconds of each span.
   ``--flows-only`` builds ``follow.cu``, ``cc.cu`` and
   ``rel_attention.cu`` and runs only this and step 19.
19. Cellpose-SAM's attention: A, ``rel_attention_kernel``
   (``csrc/rel_attention.cu``), at the cell's shape (16 tiles of 1,024
   tokens, 16 heads of 64) from a qkv tensor in the projection's layout,
   against the plain path in float32 (the block's ``rel_pos_bias`` and an
   explicit softmax) and against the path it replaced (the bias built by
   ``rel_pos_bias`` in bf16, then ``scaled_dot_product_attention``), each
   timed beside its bound (operations: the two products over 989
   TFLOP/s).  The flows path of step 18 must launch it, 24 times a forward.

The next-to-last line of stdout is a JSON object with one entry per kernel.
Its ``launches`` are those of the full-width paths' own runs (steps 4, 5, 7
without the narrow model, 8, 9, 10, 11, 12, 13, 15, 16, 17 and 18's
``segment``); what the side
runs launched (K3 and the general K4 as the labelling function in step 4, the
narrow model in step 7, step 14) stands apart as ``side_run_launches``.  Each wrapper's host enqueue time and
the device time of every kernel it launches (``torch.profiler``) stand under
``host_ms`` and ``device_us``.  The last line is ``{"ok": true, "device":
{...}}``.  Any failure raises and
exits non-zero before the result lines.  Without CUDA it exits 1 at once.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

B, SIDE, N_FRAMES = 16, 256, 48
BIG, N_BIG, BIG_BLOBS = 2048, 3, 900
BIG4, BIG4_BLOBS = 4096, 3600   # K2's largest check: 4x the 2048^2 field
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
# H100 SXM int32 rate: 132 SMs x 64 results per clock for 32-bit integer
# add, compare, min and max (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0) x 1.98 GHz boost clock
INT_OPS_PER_S = 132 * 64 * 1.98e9
# H100 SXM dense tensor-core peaks (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
# K1's two kernels (the one-block kernel that flood_packed picks for up to
# 256 levels, and the 8-block cluster kernel), and the pad buckets up to
# 768 beside the crops' 256
K1_ROUTES = ("block", "cluster")
K1_SIDES = (64, 128, 320, 512, 768)
# K5's shapes (M, K, N): the probe's; every shape the int8 layers give it
# on 16 crops of 256^2 (level 0: enc0.conv1 and the decoders' conv1, K = 576;
# the decoders' conv0, K = 1152) and on 8 tiles of 512^2 (level 0 at 512^2,
# level 1 at 256^2 with K up to 2304); and a ragged one
MATMUL_CROP_SHAPE = (B * SIDE * SIDE, 576, 64)
MATMUL_SHAPES = ((2048, 2048, 2048), MATMUL_CROP_SHAPE,
                 (B * SIDE * SIDE, 1152, 64),
                 (8 * 512 * 512, 576, 64), (8 * 512 * 512, 1152, 64),
                 (8 * 256 * 256, 576, 128), (8 * 256 * 256, 1152, 128),
                 (8 * 256 * 256, 2304, 128), (1000, 200, 72))
# the convolution entry's shapes (samples, H, W, C_in, C_out): the int8
# layers on 16 crops of 256^2 and on 8 tiles of 512^2 (levels 0 and 1), and
# a small one whose width no tile of 128 pixels divides
CONV_SHAPES = ((B, SIDE, SIDE, 64, 64), (B, SIDE, SIDE, 128, 64),
               (8, 512, 512, 64, 64), (8, 512, 512, 128, 64),
               (8, 256, 256, 128, 128), (8, 256, 256, 256, 128),
               (2, 40, 200, 192, 72))
# the fused convolution epilogue's timed shape (N, C, H, W): the cells'
# largest activation, level 0 of a forward of 8 tiles of 512^2
EPILOGUE_SHAPE = (8, 64, 512, 512)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_and_device(fn, reps: int = 50) -> dict:
    """Where one wrapper call's time goes: ``host_ms``, the host time to
    enqueue it (a loop of calls with no synchronisation), and ``device_us``,
    the device time of every kernel it launches, by name, from
    ``torch.profiler``.  A wrapper whose event time equals its enqueue time
    is bound by the host."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device_us = {}
    for ev in prof.key_averages():
        if (ev.device_time_total > 0 and not ev.key.startswith("aten::")
                and not ev.key.startswith("Activity Buffer")):  # profiler's
            # per call; kernels whose names share 80 characters add up
            device_us[ev.key[:80]] = (device_us.get(ev.key[:80], 0.0)
                                      + ev.device_time_total / reps)
    return dict(host_ms=host_ms, device_us=device_us)


def step_host_and_device_ms(fn, enqueues: int = 10, profiled: int = 5):
    """Where one training step's time goes: the host's time to enqueue it
    (median of ``enqueues`` calls, the queue drained before each) and the
    device time of its kernels (``torch.profiler``, mean of ``profiled``
    calls), both in ms.  A step whose event time equals its enqueue time
    is bound by the host."""
    from torch.profiler import ProfilerActivity, profile

    enq = []
    for _ in range(enqueues):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        enq.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            fn()
        torch.cuda.synchronize()
    device = sum(ev.device_time_total for ev in prof.key_averages()
                 if ev.device_time_total > 0 and not ev.key.startswith(
                     ("aten::", "Activity Buffer"))) / profiled / 1e3
    return statistics.median(enq), device


def stream_handle_us(dev, reps: int = 20000) -> dict:
    """Host microseconds to fetch the current stream's handle for a launch:
    the raw call that ``_build.stream_ptr`` makes, beside the public route
    through a ``torch.cuda.Stream`` object (same handle)."""
    from microbeseg_torch.kernels import _build

    probe = torch.empty((1,), device=dev)
    routes = dict(
        raw=lambda: _build.stream_ptr(probe),
        stream_object=lambda: torch.cuda.current_stream(
            probe.device).cuda_stream)
    if routes["raw"]() != routes["stream_object"]():
        raise AssertionError("stream_ptr is not the current stream's handle")
    out = {}
    for name, fn in routes.items():
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = (time.perf_counter() - t0) / reps * 1e6
    return out


def device_kernels(fn) -> list:
    """Names of the device activities (kernels, copies, sets) of one call
    of ``fn``, from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [ev.name for ev in prof.events()
            if ev.device_type == DeviceType.CUDA
            and not ev.name.startswith("Activity Buffer")]


def ptxas_report(log: str, kernel: str) -> list:
    """The ``-Xptxas -v`` lines of one kernel in a source's build log."""
    lines, inside = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            inside = kernel in ln
        if inside and ("Used" in ln or "spill" in ln):
            lines.append(ln.strip())
    return lines


def k3_snake(size, tile=64):
    """(1, size, size) bool: a one-pixel serpentine on the last row of every
    tile row, joined at alternating ends, one component that crosses every
    tile of the tiled K3 kernel (64^2 tiles at 2048^2)."""
    m = np.zeros((size, size), bool)
    rows = list(range(tile - 1, size, tile))
    for k, y in enumerate(rows):
        m[y] = True
        if k + 1 < len(rows):
            m[y:rows[k + 1] + 1, size - 1 if k % 2 == 0 else 0] = True
    return m[None]


def k3_turns(mask, reps, plain_reps):
    """K3 on ``mask``: the tiled kernel (``ms``) and the first port's
    three-pass route (``threepass_ms``) in turns (tiled, three-pass,
    three-pass, tiled; the lesser of each two), and the plain version."""
    from microbeseg_torch.ops import cc

    routes = dict(ms=cc.connected_components,
                  threepass_ms=cc.connected_components_threepass)
    turns = {k: [] for k in routes}
    for k in ("ms", "threepass_ms", "threepass_ms", "ms"):
        turns[k].append(cuda_ms(lambda: routes[k](mask), reps))
    return dict(ms=min(turns["ms"]), threepass_ms=min(turns["threepass_ms"]),
                turns=turns,
                plain_ms=cuda_ms(lambda: cc.connected_components_plain(mask),
                                 plain_reps, warmup=1))


def k3_split(mask) -> dict:
    """Host enqueue against device time of one K3 call, tiled and
    three-pass (``host_and_device``)."""
    from microbeseg_torch.ops import cc

    new = host_and_device(lambda: cc.connected_components(mask), reps=200)
    old = host_and_device(
        lambda: cc.connected_components_threepass(mask), reps=200)
    return dict(host_ms=new["host_ms"], device_us=new["device_us"],
                threepass_host_ms=old["host_ms"],
                threepass_device_us=old["device_us"])


def launch_floor(dev) -> dict:
    """One empty kernel through the same ``ctypes`` route as the kernels
    (``csrc/cc.cu::cc_empty_launch``), a plain launch and a cooperative one:
    event ms a call in a loop, the host's enqueue ms and the device us."""
    from microbeseg_torch.kernels import _build

    probe = torch.empty((1,), device=dev)
    entry = _build.entry("cc", "cc_empty_launch", 0, 1)
    out = {}
    for name, coop in (("plain", 0), ("cooperative", 1)):
        def launch():
            _build.check(entry(coop, _build.stream_ptr(probe)),
                         "cc_empty_launch")
        split = host_and_device(launch, reps=500)
        out[name] = dict(ms=cuda_ms(launch, 500), host_ms=split["host_ms"],
                         device_us=sum(split["device_us"].values()))
    return out


def blob_fields(rng, n, size, n_blobs):
    """(n, size, size) float32 cell-like fields: cones of radius 5-14 plus
    noise, max 1 at the centres."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    out = np.zeros((n, size, size), np.float32)
    for i in range(n):
        for _ in range(n_blobs):
            cy, cx = rng.integers(8, size - 8, 2)
            r = rng.uniform(5, 14)
            d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2) / r
            np.maximum(out[i], np.clip(1 - d, 0, 1), out=out[i])
    out += rng.normal(0, 0.02, out.shape).astype(np.float32)
    return out


def blob_frames(rng, n, size, n_blobs=14):
    """uint16 microscopy-like frames: bright ellipses on a noisy
    background (the synthetic blobs of scripts/parity_gate.py)."""
    yy, xx = np.mgrid[0:size, 0:size]
    frames = np.empty((n, size, size), np.uint16)
    for i in range(n):
        fg = np.zeros((size, size), bool)
        for _ in range(n_blobs):
            cy, cx = rng.integers(8, size - 8, 2)
            ry, rx = rng.integers(4, 9, 2)
            fg |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        img = fg * 28000.0 + rng.normal(0, 900, (size, size)) + 2500.0
        frames[i] = np.clip(img, 0, 65535).astype(np.uint16)
    return frames


def big_blob_fields(rng, n, shape, n_blobs):
    """``blob_fields`` for large frames: each cone is drawn in its own small
    window, so the cost does not grow with the frame."""
    H, W = shape
    out = np.zeros((n, H, W), np.float32)
    for i in range(n):
        for _ in range(n_blobs):
            cy, cx = rng.integers(16, H - 16), rng.integers(16, W - 16)
            r = rng.uniform(5, 14)
            yy, xx = np.mgrid[cy - 15:cy + 16, cx - 15:cx + 16].astype(
                np.float32)
            d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2) / r
            win = out[i, cy - 15:cy + 16, cx - 15:cx + 16]
            np.maximum(win, np.clip(1 - d, 0, 1), out=win)
    out += rng.normal(0, 0.02, out.shape).astype(np.float32)
    return out


def big_blob_frames(rng, n, size, n_blobs):
    """``blob_frames`` for large frames, each ellipse drawn in its own
    window."""
    frames = np.empty((n, size, size), np.uint16)
    for i in range(n):
        fg = np.zeros((size, size), bool)
        for _ in range(n_blobs):
            cy, cx = rng.integers(10, size - 10, 2)
            ry, rx = rng.integers(4, 9, 2)
            yy, xx = np.mgrid[cy - 9:cy + 10, cx - 9:cx + 10]
            fg[cy - 9:cy + 10, cx - 9:cx + 10] |= (
                ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0)
        img = fg * 28000.0 + rng.normal(0, 900, (size, size)) + 2500.0
        frames[i] = np.clip(img, 0, 65535).astype(np.uint16)
    return frames


def seeded_model(seed: int, cfg=None):
    """Full-width model (the distance DUNet unless ``cfg`` says otherwise)
    with numpy-drawn weights.  Conv kernels are non-negative and sum to 1
    per output channel (weighted averages), so the fields follow the
    frames' blobs instead of turning into speckle; norm affines and running
    statistics are drawn around 1 and 0."""
    from microbeseg_torch.config import ModelConfig
    from microbeseg_torch.models.unet import build_unet

    rng = np.random.default_rng(seed)
    model = build_unet(cfg or ModelConfig())
    state = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("num_batches_tracked"):
            state[name] = t
            continue
        if name.endswith("weight") and len(shape) == 4:
            k = np.abs(rng.standard_normal(shape)).astype(np.float32)
            out_axis = 1 if ".up." in name else 0   # ConvTranspose: (I, O, .)
            axes = tuple(a for a in range(4) if a != out_axis)
            k /= k.sum(axis=axes, keepdims=True)
        elif name.endswith("running_var"):
            k = rng.uniform(0.5, 2.0, shape)
        elif name.endswith("weight"):
            k = rng.uniform(0.5, 1.5, shape)
        else:
            k = rng.standard_normal(shape) * 0.1
        state[name] = torch.from_numpy(np.asarray(k, np.float32))
    model.load_state_dict(state)
    n_params = sum(p.numel() for p in model.parameters())
    return model.eval(), n_params


def check_kernels(dev, report):
    """Phase 3: each kernel against its plain version, exact, and timed."""
    from microbeseg_torch.ops import cc
    from microbeseg_torch.ops.filters import gaussian_filter
    from microbeseg_torch.ops.kernels import flood

    rng = np.random.default_rng(1)
    cell = torch.from_numpy(blob_fields(rng, B, SIDE, 40)).to(dev)
    cell = gaussian_filter(cell, 0.5)
    speckle = torch.from_numpy(rng.random((B, SIDE, SIDE)) < 0.35).to(dev)
    px = B * SIDE * SIDE
    results = {}

    def exact(name, a, b):
        err = (a.to(torch.int64) - b.to(torch.int64)).abs().max().item()
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from plain, "
                                 f"max abs err {err}")
        return err

    # K3 connected components, the tiled kernel, and the first port's
    # three-pass route kept for timing: blob seeds, a speckle field, an
    # empty and a full mask
    seeds_bin = cell > 0.6
    for conn in (1, 2):
        for field in (seeds_bin, speckle, torch.zeros_like(speckle),
                      torch.ones_like(speckle)):
            want = cc.connected_components_plain(field, conn)
            exact("K3", cc.connected_components(field, conn), want)
            exact("K3 three-pass",
                  cc.connected_components_threepass(field, conn), want)
    # one call, one device kernel; the three-pass route shows three
    kernels = device_kernels(lambda: cc.connected_components(seeds_bin))
    if len(kernels) != 1 or "cc_tile_kernel" not in kernels[0]:
        raise AssertionError(f"connected_components launched {kernels}")
    old_kernels = device_kernels(
        lambda: cc.connected_components_threepass(seeds_bin))
    if len(old_kernels) != 3:
        raise AssertionError(f"three-pass route launched {old_kernels}")
    labels = cc.connected_components(seeds_bin)
    labels_speckle = cc.connected_components(speckle)
    k3 = k3_turns(seeds_bin, 50, 3)
    # the training crop's size, one mask
    crop320 = gaussian_filter(torch.from_numpy(blob_fields(
        np.random.default_rng(320), 1, 320, 60)).to(dev), 0.5) > 0.6
    exact("K3 320", cc.connected_components(crop320),
          cc.connected_components_plain(crop320))
    k3_320 = k3_turns(crop320, 50, 3)
    for name, ms in (("connected_components", "ms"),
                     ("connected_components_threepass", "threepass_ms")):
        results[name] = dict(
            source="microbeseg_torch/csrc/cc.cu",
            replaces="microbeseg_tpu/ops/pallas/propagate.py:133",
            max_abs_err=0, ms=k3[ms], plain_ms=k3["plain_ms"],
            library_ms=None, bytes=px * (1 + 4), ops=px * 8,
            ms_320=k3_320[ms], plain_ms_320=k3_320["plain_ms"],
            bytes_320=320 * 320 * 5, ops_320=320 * 320 * 8)
    results["connected_components"].update(
        device_kernels=kernels, threepass_device_kernels=old_kernels,
        turns=k3["turns"], turns_320=k3_320["turns"],
        ptxas=report["ptxas_k3"])

    # K4 rank relabel: CC ids of both fields, and 4-connected ids
    for lab in (labels, labels_speckle, cc.connected_components(speckle, 1)):
        exact("K4", cc.sequentialize_components(lab),
              cc.sequentialize_components_plain(lab))
    ranks = cc.sequentialize_components(labels)
    k4_ms = cuda_ms(lambda: cc.sequentialize_components(labels), 50)
    k4_plain = cuda_ms(lambda: cc.sequentialize_components_plain(labels), 3,
                       warmup=1)
    # the same function in PyTorch calls on CC ids: the root ranks (compare,
    # cumsum, where), then one gather of them at the ids; the bare gather is
    # timed beside it
    exact("K4 library route", library_ranks(labels), ranks)
    table, idx = rank_table(labels)
    results["sequentialize_components"] = dict(
        source="microbeseg_torch/csrc/cc.cu",
        replaces="microbeseg_tpu/ops/pallas/propagate.py:161",
        max_abs_err=0, ms=k4_ms, plain_ms=k4_plain,
        library_ms=cuda_ms(lambda: library_ranks(labels), 50),
        gather_ms=cuda_ms(lambda: torch.gather(table, 1, idx), 50),
        bytes=px * (4 + 4), ops=px * 8)

    # K4 for K3's ids, ranks straight from the mask: the main paths' entry
    for conn in (1, 2):
        for field in (seeds_bin, speckle, torch.zeros_like(speckle),
                      torch.ones_like(speckle)):
            exact("ranked_components", cc.ranked_components(field, conn),
                  cc.ranked_components_plain(field, conn))
    exact("ranked_components", cc.ranked_components(seeds_bin), ranks)
    results["ranked_components"] = dict(
        source="microbeseg_torch/csrc/cc.cu",
        replaces="microbeseg_tpu/ops/pallas/propagate.py:161",
        max_abs_err=0, library_ms=None,
        bytes=px * (1 + 4), ops=px * 8,
        **ranked_times(seeds_bin, labels, 50, 3),
        **host_and_device(lambda: cc.ranked_components(seeds_bin)))

    # K1 flood, both kernels: 12-bit keys as on the main path, and 24-bit
    # keys; then the counts, the times, and the other bucket sides
    mask = cell > 0.1
    for bits, offset in ((12, 0), (24, 5000)):
        markers = torch.where(ranks > 0, ranks + offset, 0)
        want = flood.flood_packed_plain(-cell, markers, mask, label_bits=bits)
        exact("K1", flood.flood_packed(-cell, markers, mask, label_bits=bits),
              want)
        for route in K1_ROUTES:
            exact(f"K1 {route}", flood._launch_packed(
                -cell, markers, mask, 128, 2, bits, route=route), want)
    k1 = k1_routes(flood, -cell, ranks, mask, 20, 2)
    split = k1_split((-cell).contiguous(), ranks.to(torch.int32).contiguous(),
                     mask.contiguous())
    for route in K1_ROUTES:
        name = "flood_packed" if route == "block" else "flood_packed_cluster"
        results[name] = dict(
            source="microbeseg_torch/csrc/flood.cu",
            replaces="microbeseg_tpu/ops/pallas/flood.py:171",
            max_abs_err=0, ms=k1[route + "_ms"], plain_ms=k1["plain_ms"],
            library_ms=None,
            **{k: v for k, v in k1.items()
               if k == "bound_ms" or not k.endswith("_ms")},
            us_per_step=k1[route + "_ms"] * 1e3 / k1["steps_per_image"],
            in_mask_share=float(mask.sum()) / px)
    # the other pad buckets flood_packed takes, 16 images each
    sides = {}
    for side in K1_SIDES:
        side_cell, side_ranks, side_mask = k1_fields(rng, dev, side)
        sides[side] = k1_routes(flood, -side_cell, side_ranks, side_mask,
                                5 if side > 320 else 20, 1)
    results["flood_packed"].update(sides=sides, **split)
    check_big_kernels(dev, rng, results, exact)
    check_matmul(dev, results)
    check_epilogue(dev, results)
    for r in results.values():
        for suffix in ("", "_320", "_2048", "_4096"):
            if "bytes" + suffix not in r:
                continue
            t_bytes = r.pop("bytes" + suffix) / HBM_BYTES_PER_S * 1e3
            t_ops = r.pop("ops" + suffix) / INT_OPS_PER_S * 1e3
            r["bound_ms" + suffix] = max(t_bytes, t_ops)
            r["bound_by" + suffix] = ("bytes" if t_bytes >= t_ops
                                      else "operations")
    report["kernels"] = results
    k1 = results["flood_packed"]
    print(f"kernels exact vs plain at {B}x{SIDE}^2 and on large frames; K1 "
          f"(both kernels) ran {k1['steps_per_image']:.1f} steps (at most "
          f"{k1['max_steps']}) and examined {k1['candidates_per_image']:.1f} "
          f"candidate pixels per image: {k1['us_per_step']:.4f} us a step "
          f"on the block kernel, "
          f"{results['flood_packed_cluster']['us_per_step']:.4f} on the "
          f"cluster kernel; block kernel set-up {k1['setup_ms']:.5f} ms, "
          f"set-up and level updates {k1['setup_and_levels_ms']:.5f} ms, a "
          f"step of an empty mask {k1['empty_step_us']:.4f} us", flush=True)
    for side, t in k1["sides"].items():
        print(f"K1 at {'x'.join(map(str, t['shape']))}: block {t['block_ms']:.5f} ms, cluster "
              f"{t['cluster_ms']:.5f} ms, plain {t['plain_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']}); "
              f"{t['steps_per_image']:.1f} steps, "
              f"{t['candidates_per_image']:.1f} candidates per image",
              flush=True)
    k2 = results["flood_tiled"]
    for size, t in k2["sizes"].items():
        print(f"K2 at {size}: front kernel {t['front_ms']:.5f} ms, first "
              f"port's sweep {t['grid_ms']:.5f} ms, plain {t['plain_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']}); {t['steps']:.1f} "
              f"steps, {t['front_ms'] * 1e3 / t['steps']:.4f} us a step "
              f"(sweep {t['grid_ms'] * 1e3 / t['steps']:.4f}), "
              f"{t['candidates']} candidates", flush=True)
    print(f"K2 at {BIG}^2: planes in PyTorch {k2['planes_ms']:.5f} ms; front "
          f"kernel set-up {k2['setup_ms']:.5f} ms, a step of an empty mask "
          f"{k2['empty_step_us']:.4f} us", flush=True)
    for name, r in results.items():
        print(f"{name}: {r['ms']:.5f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']})", flush=True)
        if "device_us" in r:
            print(f"{name}: host enqueue {r['host_ms']:.5f} ms a call; device "
                  f"us per kernel {r['device_us']}", flush=True)
        if "ms_2048" in r:
            print(f"{name} at {BIG}^2: {r['ms_2048']:.5f} ms, plain "
                  f"{r['plain_ms_2048']:.4f} ms, bound "
                  f"{r['bound_ms_2048']:.6f} ms", flush=True)
        for shape, by_type in r.get("shapes", {}).items():
            if name == "conv3x3_int8":
                by_type = {"conv3x3": by_type}
            for kind, t in by_type.items():
                lib = t["library_ms"]
                old = ("" if "mma_sync_ms" not in t or t["route"] == "mma_sync"
                       else f" (mma.sync kernel {t['mma_sync_ms']:.5f})")
                label = kind if name == "conv3x3_int8" else "matmul_" + kind
                print(f"{label} {shape}: {t['ms']:.5f} ms{old}, plain "
                      f"{t['plain_ms']:.4f} ms, library "
                      f"{'none' if lib is None else format(lib, '.5f')} ms, "
                      f"bound {t['bound_ms']:.6f} ms ({t['bound_by']}), max "
                      f"abs err {t['max_abs_err']:.4g}", flush=True)
                if "device_us" in t and name != "conv3x3_int8":
                    print(f"{label} {shape}: host enqueue {t['host_ms']:.5f} "
                          f"ms a call; device us per kernel {t['device_us']}"
                          + (f"; library host {t['library_host_ms']:.5f} ms, "
                             f"device us {t['library_device_us']}"
                             if "library_host_ms" in t else ""), flush=True)


def rank_table(labels):
    """(table, idx): the root ranks of CC ids ``labels`` (B, H, W) behind a
    leading 0, and the ids as gather indices."""
    from microbeseg_torch.ops import cc

    n = labels.shape[0]
    table = torch.cat([torch.zeros((n, 1), dtype=torch.int32,
                                   device=labels.device),
                       cc._root_ranks(labels).view(n, -1)], dim=1)
    return table, labels.view(n, -1).to(torch.int64)


def library_ranks(labels):
    """K4 on CC ids in plain PyTorch calls: root ranks, then one gather."""
    table, idx = rank_table(labels)
    return torch.gather(table, 1, idx).view(labels.shape)


def ranked_times(mask, labels, reps, plain_reps):
    """``ranked_components`` on ``mask`` in turns with K3 alone and with K3
    followed by the library route for the ranks (``labels`` = K3's ids)."""
    from microbeseg_torch.ops import cc

    ms, k3, lib = [], [], []
    for _ in range(2):
        ms.append(cuda_ms(lambda: cc.ranked_components(mask), reps))
        k3.append(cuda_ms(lambda: cc.connected_components(mask), reps))
        lib.append(cuda_ms(
            lambda: library_ranks(cc.connected_components(mask)), reps))
    return dict(
        ms=min(ms), k3_alone_ms=min(k3), k3_then_library_ranks_ms=min(lib),
        k3_then_k4_ms=cuda_ms(lambda: cc.sequentialize_components(
            cc.connected_components(mask)), reps),
        plain_ms=cuda_ms(lambda: cc.ranked_components_plain(mask),
                         plain_reps, warmup=1))


def k1_fields(rng, dev, side, n=B):
    """``n`` blob fields of ``side``^2 at the crop check's density of blobs
    (40 on 256^2), smoothed as the post-processing smooths; K4's ranks of
    their seeds; their mask."""
    from microbeseg_torch.ops import cc
    from microbeseg_torch.ops.filters import gaussian_filter

    n_blobs = max(2, round(40 * (side / SIDE) ** 2))
    cell = torch.from_numpy(big_blob_fields(rng, n, (side, side), n_blobs))
    cell = gaussian_filter(cell.to(dev), 0.5)
    return cell, cc.ranked_components(cell > 0.6), cell > 0.1


def k1_routes(flood, value, markers, mask, reps, plain_reps):
    """Both K1 kernels on one input: each exactly equal to the plain
    version, the same steps and work counts per image, and their times in
    turns (block, cluster, cluster, block; the lower of each pair)."""
    n = value.shape[0]
    want = flood.flood_packed_plain(value, markers, mask)
    counts = {}
    for route in K1_ROUTES:
        steps = torch.empty((n,), dtype=torch.int32, device=value.device)
        work = torch.zeros((n,), dtype=torch.int64, device=value.device)
        got = flood._launch_packed(value, markers, mask, 128, 2, 12, steps,
                                   work, route=route)
        if not torch.equal(got, want):
            raise AssertionError(
                f"K1 {route} differs from plain at {tuple(value.shape)} on "
                f"{int((got != want).sum())} px")
        counts[route] = steps.to(torch.int64), work
    (steps, work), (steps_c, work_c) = counts["block"], counts["cluster"]
    if not (torch.equal(steps, steps_c) and torch.equal(work, work_c)):
        raise AssertionError(
            f"K1 at {tuple(value.shape)}: block kernel steps "
            f"{steps.tolist()}, work {work.tolist()}; cluster kernel steps "
            f"{steps_c.tolist()}, work {work_c.tolist()}")
    in_mask = mask.view(n, -1).sum(dim=1).to(torch.int64)
    n_work = int(work.sum())
    if not 0 < n_work <= int((steps * in_mask).sum()):
        raise AssertionError(f"K1 work count {n_work} out of range")
    times = {route: [] for route in K1_ROUTES}
    for route in K1_ROUTES + K1_ROUTES[::-1]:
        times[route].append(cuda_ms(lambda: flood._launch_packed(
            value, markers, mask, 128, 2, 12, route=route), reps))
    # the function reads value, markers and mask and writes labels: 13 B a
    # pixel; per candidate pixel and step: 3 mins over the 4 neighbour keys,
    # 1 compare with the level's threshold, 1 and + 1 or to re-key
    return dict(
        shape=list(value.shape), block_ms=min(times["block"]),
        cluster_ms=min(times["cluster"]),
        plain_ms=cuda_ms(lambda: flood.flood_packed_plain(
            value, markers, mask), plain_reps, warmup=1),
        steps_per_image=float(steps.sum()) / n, max_steps=int(steps.max()),
        candidates_per_image=n_work / n,
        **bound(value.numel() * (4 + 4 + 1 + 4), n_work * 6, INT_OPS_PER_S))


def k1_split(value, markers, mask, reps=20):
    """Where the block kernel's time goes, from its C entry at 128 levels:
    the set-up alone (one level, no step), the set-up and the level updates
    (no step), and one step of an empty mask (every word idle: the fixed
    cost of a step).  ms, ms, us."""
    from microbeseg_torch.kernels import _build

    fn = _build.entry("flood", "flood_block_launch", 8, 7)
    n, H, W = value.shape
    out = torch.empty((n, H, W), dtype=torch.int32, device=value.device)
    scratch = torch.empty((2, n, H, W), dtype=torch.int32,
                          device=value.device)
    steps = torch.empty((n,), dtype=torch.int32, device=value.device)

    def run(m, n_levels, inner_steps, cleanup):
        _build.check(fn(value.data_ptr(), markers.data_ptr(), m.data_ptr(),
                        out.data_ptr(), scratch[0].data_ptr(),
                        scratch[1].data_ptr(), steps.data_ptr(), None, n, H,
                        W, n_levels, inner_steps, 12, cleanup,
                        _build.stream_ptr(value)), "flood_block")

    empty = torch.zeros_like(mask)
    empty_ms = cuda_ms(lambda: run(empty, 128, 2, H * W), reps)
    n_steps = int(steps.max())   # one a level and one of cleanup
    empty_setup_ms = cuda_ms(lambda: run(empty, 128, 0, 0), reps)
    setup_ms = cuda_ms(lambda: run(mask, 1, 0, 0), reps)
    return dict(
        setup_ms=setup_ms,
        setup_and_levels_ms=cuda_ms(lambda: run(mask, 128, 0, 0), reps),
        empty_step_us=(empty_ms - empty_setup_ms) * 1e3 / n_steps)


def check_big_kernels(dev, rng, results, exact):
    """K2 against its plain version, and K3 and K4 on one 2048^2 frame."""
    from microbeseg_torch.ops import cc
    from microbeseg_torch.ops.filters import gaussian_filter
    from microbeseg_torch.ops.kernels import flood

    def fields(n, shape, n_blobs):
        cell = torch.from_numpy(big_blob_fields(rng, n, shape, n_blobs))
        cell = gaussian_filter(cell.to(dev), 0.5)
        ranks = cc.ranked_components(cell > 0.6)
        exact("ranked_components", ranks,
              cc.ranked_components_plain(cell > 0.6))
        # ids above 4095, so the 24-bit label field is exercised
        return cell, torch.where(ranks > 0, ranks + 5000, 0), cell > 0.1

    # K2, both kernels: two frames per call, a size 32 does not divide, and 2 levels (the boundary
    # method's flood); then one 4096^2 and one 2048^2 field, all in turns
    sizes = {}
    for n, shape, n_blobs in ((2, (1024, 1024), 230), (1, (1000, 1400), 300)):
        cell, markers, mask = fields(n, shape, n_blobs)
        k2_forms(flood, -cell, markers, mask, 2, reps=0)
        sizes["x".join(map(str, (n, *shape)))] = k2_forms(
            flood, -cell, markers, mask, 128, reps=10)
    cell, markers, mask = fields(1, (BIG4, BIG4), BIG4_BLOBS)
    sizes[f"1x{BIG4}x{BIG4}"] = k4 = k2_forms(flood, -cell, markers, mask,
                                                128, reps=5)
    seeds4 = cell > 0.6   # K3 at 4096^2: more tiles than the card holds
    cell, markers, mask = fields(1, (BIG, BIG), BIG_BLOBS)
    sizes[f"1x{BIG}x{BIG}"] = k2 = k2_forms(flood, -cell, markers, mask,
                                              128, reps=10)
    if int(flood.flood_tiled(-cell, markers, mask).max()) <= 5000:
        raise AssertionError("K2: no label above 12 bits came through")
    px = BIG * BIG
    # the function reads value, markers and mask and writes labels: 13 B a
    # pixel; operations as for K1, 6 per candidate pixel and step
    for name, form in (("flood_tiled", "front_ms"),
                       ("flood_tiled_grid", "grid_ms")):
        results[name] = dict(
            source="microbeseg_torch/csrc/flood_frame.cu",
            replaces="microbeseg_tpu/ops/pallas/flood.py:264",
            max_abs_err=0, ms=k2[form], plain_ms=k2["plain_ms"],
            library_ms=None, bytes=px * 13, ops=k2["candidates"] * 6,
            shape=[1, BIG, BIG], steps=k2["steps"],
            candidates=k2["candidates"],
            us_per_step=k2[form] * 1e3 / k2["steps"],
            in_mask_share=k2["in_mask_share"],
            ms_4096=k4[form], plain_ms_4096=k4["plain_ms"],
            bytes_4096=BIG4 * BIG4 * 13, ops_4096=k4["candidates"] * 6,
            steps_4096=k4["steps"],
            us_per_step_4096=k4[form] * 1e3 / k4["steps"])
    results["flood_tiled"].update(
        sizes=sizes, **k2_split(flood, -cell, markers, mask))

    seeds_bin = cell > 0.6
    speckle = torch.from_numpy(rng.random((1, BIG, BIG)) < 0.35).to(dev)
    # K3: also a serpentine through every tile (one id carried across 1024
    # tiles) and, at 4096^2, the blob seeds
    snake = torch.from_numpy(k3_snake(BIG)).to(dev)
    for field in (seeds_bin, speckle & mask, snake):
        exact("K3 2048", cc.connected_components(field),
              cc.connected_components_plain(field))
    exact("K3 4096", cc.connected_components(seeds4),
          cc.connected_components_plain(seeds4))
    labels = cc.connected_components(seeds_bin)
    for lab in (labels, cc.connected_components(speckle & mask, 1)):
        exact("K4 2048", cc.sequentialize_components(lab),
              cc.sequentialize_components_plain(lab))
    exact("K4 library route 2048", library_ranks(labels),
          cc.sequentialize_components(labels))
    table, idx = rank_table(labels)
    for conn in (1, 2):
        for field in (seeds_bin, speckle & mask):
            exact("ranked_components 2048", cc.ranked_components(field, conn),
                  cc.ranked_components_plain(field, conn))
    # a strip: one block row of counts per line does not divide the width
    strip = speckle[:, :48, :816].contiguous()
    exact("ranked_components strip", cc.ranked_components(strip),
          cc.ranked_components_plain(strip))
    for conn in (1, 2):
        exact("K3 strip", cc.connected_components(strip, conn),
              cc.connected_components_plain(strip, conn))
    k3 = k3_turns(seeds_bin, 20, 1)
    k3_4096 = k3_turns(seeds4, 10, 1)
    for name, ms in (("connected_components", "ms"),
                     ("connected_components_threepass", "threepass_ms")):
        results[name].update(
            ms_2048=k3[ms], plain_ms_2048=k3["plain_ms"],
            bytes_2048=px * (1 + 4), ops_2048=px * 8,
            ms_4096=k3_4096[ms], plain_ms_4096=k3_4096["plain_ms"],
            bytes_4096=BIG4 * BIG4 * (1 + 4), ops_4096=BIG4 * BIG4 * 8)
    results["connected_components"].update(
        turns_2048=k3["turns"], turns_4096=k3_4096["turns"],
        **{k + "_2048": v for k, v in k3_split(seeds_bin).items()})
    results["sequentialize_components"].update(
        ms_2048=cuda_ms(lambda: cc.sequentialize_components(labels), 20),
        plain_ms_2048=cuda_ms(
            lambda: cc.sequentialize_components_plain(labels), 1, warmup=1),
        library_ms_2048=cuda_ms(lambda: library_ranks(labels), 20),
        gather_ms_2048=cuda_ms(lambda: torch.gather(table, 1, idx), 20),
        bytes_2048=px * (4 + 4), ops_2048=px * 8)
    results["ranked_components"].update(
        bytes_2048=px * (1 + 4), ops_2048=px * 8,
        **{k + "_2048": v
           for k, v in ranked_times(seeds_bin, labels, 20, 1).items()})


K2_ROUTES = ("front", "grid")


def k2_forms(flood, value, markers, mask, n_levels, reps):
    """K2 on one input: the front kernel and the first port's whole-frame
    sweep, each exactly equal to the plain version, with the same step and
    work counts per frame; with ``reps``, their times in turns (front,
    sweep, sweep, front; the lower of each pair) and the plain version's."""
    n = value.shape[0]
    want = flood.flood_tiled_plain(value, markers, mask, n_levels)
    counts = {}
    for route in K2_ROUTES:
        steps = torch.empty((n,), dtype=torch.int32, device=value.device)
        work = torch.zeros((n,), dtype=torch.int64, device=value.device)
        got = flood._launch_tiled(value, markers, mask, n_levels, steps,
                                  work, route=route)
        if not torch.equal(got, want):
            raise AssertionError(
                f"K2 {route} differs from plain at {tuple(value.shape)}, "
                f"{n_levels} levels, on {int((got != want).sum())} px")
        counts[route] = steps.tolist(), work.tolist()
    if counts["front"] != counts["grid"]:
        raise AssertionError(f"K2 counts differ at {tuple(value.shape)}: "
                             f"{counts}")
    steps, work = counts["front"]
    n_work, in_mask = sum(work), int(mask.sum())
    if not 0 < n_work <= max(steps) * in_mask:
        raise AssertionError(f"K2 work count {n_work} out of range")
    if not reps:
        return None
    times = {route: [] for route in K2_ROUTES}
    for route in K2_ROUTES + K2_ROUTES[::-1]:
        times[route].append(cuda_ms(lambda: flood._launch_tiled(
            value, markers, mask, n_levels, route=route), reps))
    return dict(
        shape=list(value.shape), front_ms=min(times["front"]),
        grid_ms=min(times["grid"]),
        plain_ms=cuda_ms(lambda: flood.flood_tiled_plain(
            value, markers, mask, n_levels), 1, warmup=1),
        steps=sum(steps) / n, candidates=n_work,
        in_mask_share=in_mask / value.numel(),
        **bound(value.numel() * 13, n_work * 6, INT_OPS_PER_S))


def k2_split(flood, value, markers, mask, reps=20):
    """Where a ``flood_tiled`` call's time goes on one frame at 128 levels:
    building its two planes in PyTorch (``packed_planes``), and, from the
    front kernel's C entry, the set-up alone (bitplanes, sort, one grid
    barrier, labels out; no step; the planes prebuilt) and one step of an
    empty mask (every word idle: the fixed cost of a barrier-separated
    step).  ms, ms, us."""
    from microbeseg_torch.kernels import _build

    fn = _build.entry("flood_frame", "flood_front_launch", 8, 6)
    n, H, W = value.shape
    words = H * ((W + 31) // 32)
    dev = value.device
    bitplanes = torch.empty((4, words), dtype=torch.int32, device=dev)
    order = torch.empty((words * 32,), dtype=torch.int32, device=dev)
    flags = torch.zeros((n, 3), dtype=torch.int32, device=dev)
    out = torch.empty((n, H, W), dtype=torch.int32, device=dev)
    steps = torch.empty((n,), dtype=torch.int32, device=dev)
    # no key changes in these runs: each seeded plane serves them all
    planes = {m: flood.packed_planes(value, markers, mask if m else
                                     torch.zeros_like(mask), 128)
              for m in (True, False)}

    def run(full, n_levels, inner_steps, cleanup):
        qs, key0 = planes[full]
        flags.zero_()
        _build.check(fn(qs.data_ptr(), key0.data_ptr(), out.data_ptr(),
                        bitplanes.data_ptr(), order.data_ptr(),
                        flags.data_ptr(), steps.data_ptr(), None, n, H, W,
                        n_levels, inner_steps, cleanup,
                        _build.stream_ptr(value)), "flood_front")

    empty_ms = cuda_ms(lambda: run(False, 128, 2, H * W), reps)
    n_steps = int(steps.max())   # one a level and one of cleanup
    empty_setup_ms = cuda_ms(lambda: run(False, 1, 0, 0), reps)
    return dict(planes_ms=cuda_ms(lambda: flood.packed_planes(
                    value, markers, mask, 128), reps),
                setup_ms=cuda_ms(lambda: run(True, 1, 0, 0), reps),
                empty_step_us=(empty_ms - empty_setup_ms) * 1e3 / n_steps)


def bound(n_bytes, n_ops, ops_per_s):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def route_times(mm, name, a, b, out_dtype, reps):
    """{route: ms} of one K5 entry on both of its kernels, in turns (wgmma,
    mma.sync, mma.sync, wgmma; the lower of each pair), and the route the
    wrapper's shape rule picks.  Rows of A that are not 16-byte aligned have
    the ``mma.sync`` kernel only."""
    routes = ("wgmma", "mma_sync") if mm._rows_aligned(a) else ("mma_sync",)
    times = {r: [] for r in routes}
    for r in routes + routes[::-1]:
        times[r].append(cuda_ms(
            lambda: mm._launch(name, a, b, out_dtype, route=r), reps))
    return {r + "_ms": min(t) for r, t in times.items()}, routes[0]


def check_matmul(dev, results):
    """K5 against its plain versions, on both of its kernels (the ``wgmma``
    one that the wrapper picks for 16-byte-aligned rows of A, and the
    ``mma.sync`` one): int8 exactly equal; bf16 within one bfloat16 step
    (2^-7 relative: both round a float32 sum to bfloat16, and the two sums,
    taken in different orders, may fall on either side of a rounding
    boundary) plus 1e-6 K max|a| max|b| for the float32 sums' own difference
    near zero.  Each is timed beside the one PyTorch call that computes the
    same product; ``ms`` is the wrapper's own route."""
    from microbeseg_torch.ops.kernels import matmul as mm

    gen = torch.Generator(device=dev).manual_seed(6)
    shapes = {}
    for M, K, N in MATMUL_SHAPES:
        reps = 10 if M * K > 1 << 26 else 50
        a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device=dev,
                          generator=gen)
        b = torch.randint(-127, 128, (K, N), dtype=torch.int8, device=dev,
                          generator=gen)
        got = mm.matmul_int8(a, b)
        ref = mm.matmul_int8_plain(a, b)
        if not torch.equal(got, ref):
            raise AssertionError(f"K5 int8 differs from plain at {M}x{K}x{N}")
        if not torch.equal(mm._launch("matmul_int8", a, b, torch.int32,
                                      route="mma_sync"), ref):
            raise AssertionError(f"K5 int8 (mma.sync) differs from plain at "
                                 f"{M}x{K}x{N}")
        has_lib = K % 8 == 0 and N % 8 == 0 and M > 16  # torch._int_mm's limits
        if has_lib and not torch.equal(got, torch._int_mm(a, b)):
            raise AssertionError(f"K5 int8 differs from torch._int_mm at "
                                 f"{M}x{K}x{N}")
        del got, ref
        by_route, route = route_times(mm, "matmul_int8", a, b, torch.int32,
                                      reps)
        int8 = dict(
            max_abs_err=0, route=route, ms=by_route[route + "_ms"],
            **by_route,
            plain_ms=cuda_ms(lambda: mm.matmul_int8_plain(a, b), 2, warmup=1),
            library_ms=(cuda_ms(lambda: torch._int_mm(a, b), reps)
                        if has_lib else None),
            **bound(M * K + K * N + 4 * M * N, 2 * M * K * N, INT8_OPS_PER_S))
        if (M, K, N) == MATMUL_SHAPES[0]:
            int8.update(host_and_device(lambda: mm.matmul_int8(a, b)))
        del a, b

        a = torch.randn((M, K), dtype=torch.bfloat16, device=dev,
                        generator=gen)
        b = torch.randn((K, N), dtype=torch.bfloat16, device=dev,
                        generator=gen)
        ref = mm.matmul_bf16_plain(a, b).float()
        atol = 1e-6 * K * float(a.abs().max()) * float(b.abs().max())
        for route in (None, "mma_sync"):
            got = mm._launch("matmul_bf16", a, b, torch.bfloat16,
                             route=route).float()
            err = (got - ref).abs()
            if not bool((err <= 2.0 ** -7 * ref.abs() + atol).all()):
                raise AssertionError(
                    f"K5 bf16 (route {route or 'by shape'}) beyond one "
                    f"bfloat16 step of plain at {M}x{K}x{N}: max abs err "
                    f"{err.max()}")
            if route is None:
                bf16 = dict(
                    max_abs_err=float(err.max()), rtol=2.0 ** -7, atol=atol,
                    share_differing=float((err > 0).float().mean()))
        del got, ref, err
        by_route, route = route_times(mm, "matmul_bf16", a, b,
                                      torch.bfloat16, reps)
        bf16.update(
            route=route, ms=by_route[route + "_ms"], **by_route,
            plain_ms=cuda_ms(lambda: mm.matmul_bf16_plain(a, b), 2, warmup=1),
            library_ms=cuda_ms(lambda: torch.matmul(a, b), reps),
            **bound(2 * (M * K + K * N + M * N), 2 * M * K * N,
                    BF16_FLOPS_PER_S))
        if (M, K, N) == MATMUL_SHAPES[0]:
            bf16.update(host_and_device(lambda: mm.matmul_bf16(a, b)))
            lib = host_and_device(lambda: torch.matmul(a, b))
            bf16.update(library_host_ms=lib["host_ms"],
                        library_device_us=lib["device_us"])
        del a, b
        shapes[f"{M}x{K}x{N}"] = dict(int8=int8, bf16=bf16)
    torch.cuda.empty_cache()
    # the entry's own numbers are the int8 product at the crop path's shape
    crop = shapes["x".join(map(str, MATMUL_CROP_SHAPE))]["int8"]
    results["matmul_int8"] = dict(
        source="microbeseg_torch/csrc/matmul.cu",
        replaces="scripts/bench_pallas_int8_dot.py:46",
        shape=list(MATMUL_CROP_SHAPE), shapes=shapes, **crop)
    check_conv(dev, results)


def check_conv(dev, results):
    """K5's convolution entry against its plain version (the 9-tap operand,
    the float64 product, the float32 dequantise): exactly equal, bfloat16
    and float32 results, at every layer shape the int8 paths give it (16
    crops of 256^2; 8 tiles of 512^2 at levels 0 and 1), with scales per
    sample and channel, and at a width that no tile divides.  The PyTorch
    call beside it is the layer it stands for: ``F.conv2d`` in bfloat16,
    channels-last, on activations of the same shape."""
    import torch.nn.functional as F

    from microbeseg_torch.ops.kernels import matmul as mm

    gen = torch.Generator(device=dev).manual_seed(10)
    shapes = {}
    for n, H, W, C, O in CONV_SHAPES:
        x_q = torch.randint(-127, 128, (n, H, W, C), dtype=torch.int8,
                            device=dev, generator=gen)
        w_q = torch.randint(-127, 128, (9 * C, O), dtype=torch.int8,
                            device=dev, generator=gen)
        scale = torch.rand((n, O), device=dev, generator=gen) * 1e-4 + 1e-6
        bias = torch.randn((O,), device=dev, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            got = mm.conv3x3_int8(x_q, w_q, scale, bias, dtype)
            if not torch.equal(got, mm.conv3x3_int8_plain(x_q, w_q, scale,
                                                          bias, dtype)):
                raise AssertionError(f"K5 conv3x3_int8 differs from plain at "
                                     f"{(n, H, W, C, O)}, {dtype}")
        del got
        if n * H * W < 1 << 19:
            continue   # the ragged case is checked, not timed
        x = torch.randn((n, C, H, W), device=dev, dtype=torch.bfloat16,
                        generator=gen).contiguous(
                            memory_format=torch.channels_last)
        w = torch.randn((O, C, 3, 3), device=dev, dtype=torch.bfloat16,
                        generator=gen).contiguous(
                            memory_format=torch.channels_last)
        bias16 = bias.to(torch.bfloat16)
        px = n * H * W
        shapes[f"{n}x{H}x{W}x{C}->{O}"] = dict(
            max_abs_err=0,
            ms=cuda_ms(lambda: mm.conv3x3_int8(x_q, w_q, scale, bias,
                                               torch.bfloat16), 20),
            float32_ms=cuda_ms(lambda: mm.conv3x3_int8(
                x_q, w_q, scale, bias, torch.float32), 20),
            plain_ms=cuda_ms(lambda: mm.conv3x3_int8_plain(
                x_q, w_q, scale, bias, torch.bfloat16), 2, warmup=1),
            library_ms=cuda_ms(lambda: F.conv2d(x, w, bias16, padding=1), 20),
            **bound(px * C + 9 * C * O + 4 * (n + 1) * O + 2 * px * O,
                    2 * px * 9 * C * O, INT8_OPS_PER_S))
        if (n, H, W, C, O) == CONV_SHAPES[0]:
            shapes[f"{n}x{H}x{W}x{C}->{O}"].update(host_and_device(
                lambda: mm.conv3x3_int8(x_q, w_q, scale, bias,
                                        torch.bfloat16)))
        del x_q, x, w
    torch.cuda.empty_cache()
    first = "x".join(map(str, CONV_SHAPES[0][:4])) + f"->{CONV_SHAPES[0][4]}"
    results["conv3x3_int8"] = dict(
        source="microbeseg_torch/csrc/matmul.cu",
        replaces="scripts/bench_pallas_int8_dot.py:46",
        shape=list(CONV_SHAPES[0]), shapes=shapes, **shapes[first])


def check_epilogue(dev, results):
    """The fused convolution epilogue (``conv_epilogue``, relu, bfloat16,
    channels-last) at ``EPILOGUE_SHAPE`` against its plain version, within
    one bfloat16 step, and timed: the kernel, the plain version, and the
    three passes it replaces one by one (the convolution's broadcast bias
    add in place, ReLU, eval BatchNorm) and as a chain (``library_ms``).
    BatchNorm's scales lie in (0.5, 0.9) in size, so the values stay finite
    under repeated in-place launches."""
    import torch.nn.functional as F

    from microbeseg_torch.ops.kernels.epilogue import (conv_epilogue,
                                                       conv_epilogue_plain)

    N, C, H, W = EPILOGUE_SHAPE
    gen = torch.Generator(device=dev).manual_seed(11)
    bn = torch.nn.BatchNorm2d(C).to(dev).eval()
    with torch.no_grad():
        sign = torch.where(torch.rand(C, device=dev, generator=gen) < 0.3,
                           -1.0, 1.0)
        bn.weight.copy_(sign * (0.5 + 0.4 * torch.rand(
            C, device=dev, generator=gen)))
        bn.bias.copy_(torch.randn(C, device=dev, generator=gen) * 0.5)
        bn.running_mean.copy_(torch.randn(C, device=dev, generator=gen) * 0.3)
        bn.running_var.copy_(0.9 + 0.2 * torch.rand(C, device=dev,
                                                    generator=gen))
    bias = torch.randn(C, device=dev, generator=gen) * 0.5
    z = (3 * torch.randn((N, C, H, W), device=dev, generator=gen)).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    want = conv_epilogue_plain(z, bias, bn, "relu")
    got = conv_epilogue(z.clone(memory_format=torch.channels_last), bias, bn,
                        "relu")
    err = (got.float() - want.float()).abs()
    _, e = torch.frexp(want.float())
    if bool((err > torch.ldexp(torch.ones_like(err), e - 8)).any()):
        raise AssertionError("conv_epilogue differs from plain by more than "
                             f"one bfloat16 step: {float(err.max())}")
    del got, want
    bias16 = bias.to(torch.bfloat16).view(1, -1, 1, 1)
    rm, rv, w, b = bn.running_mean, bn.running_var, bn.weight, bn.bias

    def chain():
        return F.batch_norm(F.relu(z + bias16), rm, rv, w, b, False, 0.1,
                            bn.eps)

    with torch.inference_mode():
        unfused = dict(
            bias_add_ms=cuda_ms(lambda: z.add_(bias16), 20),
            relu_ms=cuda_ms(lambda: F.relu(z), 20),
            batch_norm_ms=cuda_ms(lambda: F.batch_norm(
                z, rm, rv, w, b, False, 0.1, bn.eps), 20))
        r = dict(ms=cuda_ms(lambda: conv_epilogue(z, bias, bn, "relu"), 50),
                 plain_ms=cuda_ms(lambda: conv_epilogue_plain(
                     z, bias, bn, "relu"), 5),
                 library_ms=cuda_ms(chain, 20),
                 **bound(4 * z.numel(), 0, 1.0))
    r.update(unfused_ms=unfused, unfused_sum_ms=sum(unfused.values()),
             roofline=r["bound_ms"] / r["ms"], shape=list(EPILOGUE_SHAPE),
             max_abs_err=float(err.max()),
             source="microbeseg_torch/csrc/epilogue.cu", replaces="none",
             **host_and_device(lambda: conv_epilogue(z, bias, bn, "relu")))
    results["conv_epilogue"] = r
    del z
    torch.cuda.empty_cache()


def plain_flood(value, markers, mask, n_levels, max_label):
    """``flood_or_fallback``'s routing onto the plain versions."""
    from microbeseg_torch.ops.kernels import flood

    side = max(value.shape[-2:])
    if side > flood.MAX_SIDE:
        return flood.flood_tiled_plain(value, markers, mask,
                                       n_levels=n_levels)
    bits = flood.packed_label_bits(side, n_levels, max_label)
    return flood.flood_packed_plain(value, markers, mask, n_levels=n_levels,
                                    label_bits=bits)


def plain_kernels():
    """The plain versions, as arguments of the post-processing functions."""
    from microbeseg_torch.ops import cc

    return dict(label_fn=cc.ranked_components_plain, flood_fn=plain_flood)


def field_levels(engine, frames, cell_fracs, seed_fracs):
    """Threshold levels from the fields of ``frames``: random weights have
    no trained scale.  The background is one flat level (the median) and
    the blobs rise above it; each fraction f gives the level f of the way
    up that rise, of the cell field and of the seed field (cell minus
    borders) -> (cell levels, seed levels)."""
    border_w, cell_w = engine.predict_raw(frames)
    if not (np.isfinite(border_w).all() and np.isfinite(cell_w).all()):
        raise AssertionError("non-finite predictions")
    borders = np.tan(np.clip(border_w, 0, 1) ** 2)
    borders = np.clip(np.where(borders < 0.05, 0, borders), 0, 1)

    def level(field, frac):
        bg, top = np.median(field), np.quantile(field, 0.995)
        return float(bg + frac * (top - bg))

    return ([level(cell_w, f) for f in cell_fracs],
            [level(cell_w - borders, f) for f in seed_fracs])


def field_thresholds(engine, warm):
    """(th_cell, th_seed) from held-out frames: the mask takes the top 80%
    of the cell field's rise, the seeds the top 50% of the seed field's."""
    (th_cell,), (th_seed,) = field_levels(engine, warm, (0.2,), (0.5,))
    return th_cell, th_seed


def driven_segment(engine, frames, th_cell, th_seed, must_launch):
    """One ``segment`` call with the launch counters set to 0 just before
    and read just after -> (masks, seconds, launches, instances per
    frame).  Raises if a kernel
    of ``must_launch`` did not launch, on an out-of-memory fallback, or on
    masks of the wrong shape or without instances."""
    from microbeseg_torch.kernels import _build

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    masks = engine.segment(frames, th_cell, th_seed)
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    for name in must_launch:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{frames.shape[1]}^2 path")
    if launches["sequentialize_components"]:
        raise AssertionError("the general rank relabel ran on the "
                             f"{frames.shape[1]}^2 path")
    if launches["flood_packed_cluster"]:
        raise AssertionError("the cluster kernel of K1 ran on the "
                             f"{frames.shape[1]}^2 path")
    if launches["flood_tiled_grid"]:
        raise AssertionError("the first port's K2 sweep ran on the "
                             f"{frames.shape[1]}^2 path")
    if launches["watershed_route"]:
        raise AssertionError("the watershed route ran on the "
                             f"{frames.shape[1]}^2 path")
    if engine.oom_count:
        raise AssertionError(f"{engine.oom_count} out-of-memory fallbacks")
    if masks.shape != frames.shape or masks.dtype != np.uint16:
        raise AssertionError(f"masks {masks.shape} {masks.dtype}")
    n_inst = [len(np.unique(m)) - 1 for m in masks]
    if min(n_inst) < 1:
        raise AssertionError(f"frames without instances: {n_inst}")
    return masks, seconds, launches, n_inst


def timed_segment(engine, frames, th_cell, th_seed, reps=3):
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        engine.segment(frames, th_cell, th_seed)
        out.append(time.perf_counter() - t0)
    return out


def main_path(dev, report, model, cpu_model, n_params):
    """Phase 4: the full-width engine through segment on 256^2 crops."""
    from microbeseg_torch.config import InferConfig
    from microbeseg_torch.inference.engine import InferenceEngine
    from microbeseg_torch.ops.postprocessing import (
        _distance_postprocessing, distance_postprocessing)

    engine = InferenceEngine(model, "distance", cfg=InferConfig(),
                             device=dev)
    rng = np.random.default_rng(2)
    frames = blob_frames(rng, N_FRAMES, SIDE)
    warm = blob_frames(rng, B, SIDE)
    th_cell, th_seed = field_thresholds(engine, warm)
    engine.segment(warm, th_cell, th_seed)   # warm-up (cuDNN, kernels)
    torch.cuda.reset_peak_memory_stats()
    masks, first_s, launches, n_inst = driven_segment(
        engine, frames, th_cell, th_seed,
        ("flood_packed", "ranked_components"))

    # same predictions -> kernel post-processing == plain post-processing
    border, cell = engine._predict_raw_dev(frames)
    if not (torch.isfinite(border).all() and torch.isfinite(cell).all()):
        raise AssertionError("non-finite predictions")
    kern = engine.postprocess((border, cell), th_cell, th_seed)
    plain = np.concatenate([
        _distance_postprocessing(
            border[s:s + B], cell[s:s + B], th_seed, th_cell, max_seeds=256,
            **plain_kernels()).cpu().numpy()
        for s in range(0, N_FRAMES, B)])
    if not np.array_equal(kern, plain):
        raise AssertionError("post-processing: kernels differ from plain "
                             f"on {(kern != plain).sum()} px")
    same_as_segment = float((kern == masks).mean())

    # the two general kernels, K3 then K4 on its ids, in ranked_components'
    # place: the same masks again, with the counters set to 0 before
    from microbeseg_torch.kernels import _build
    from microbeseg_torch.ops import cc

    torch.cuda.synchronize()
    _build.reset_launches()
    two_step = np.concatenate([
        _distance_postprocessing(
            border[s:s + B], cell[s:s + B], th_seed, th_cell, max_seeds=256,
            label_fn=lambda m: cc.sequentialize_components(
                cc.connected_components(m))).cpu().numpy()
        for s in range(0, N_FRAMES, B)])
    general = dict(_build.LAUNCHES)
    n_batches = N_FRAMES // B
    if (not np.array_equal(two_step, kern)
            or general["connected_components"] != n_batches
            or general["sequentialize_components"] != n_batches
            or general["ranked_components"]):
        raise AssertionError(
            "post-processing on K3 and the general K4: masks differ from "
            f"ranked_components' on {(two_step != kern).sum()} px, launches "
            f"{general}")

    # bf16 forward on the card vs float32 forward on the CPU, small input
    small = blob_frames(rng, 2, 64)
    rel = card_vs_cpu(engine, InferenceEngine(cpu_model, "distance",
                                              device="cpu"), small)

    # timing: segment end to end, and its two device stages per batch
    seg_s = timed_segment(engine, frames, th_cell, th_seed)
    chunk = frames[:B]
    fwd_ms = cuda_ms(lambda: engine._predict_raw_dev(chunk), 10)
    b16, c16 = engine._predict_raw_dev(chunk)
    post_ms = cuda_ms(lambda: distance_postprocessing(
        b16, c16, th_seed, th_cell, max_seeds=256), 10)
    # the host's time to enqueue post-processing against the device time of
    # the kernels it launches: the larger bounds post_ms
    post = host_and_device(lambda: distance_postprocessing(
        b16, c16, th_seed, th_cell, max_seeds=256), reps=20)
    post_device_ms = sum(post["device_us"].values()) / 1e3
    seg_med = statistics.median(seg_s)
    report["main_path"] = dict(
        model="DUNet filters (64, 1024) bn relu conv, bf16 autocast",
        params=n_params, frames=[N_FRAMES, SIDE, SIDE], batch=B,
        launches=launches, general_kernels_launches=general,
        instances_per_frame=n_inst,
        segment_first_s=first_s, segment_s=seg_s,
        crops_per_s=N_FRAMES / seg_med, forward_ms_per_batch=fwd_ms,
        postprocess_ms_per_batch=post_ms,
        postprocess_host_ms=post["host_ms"],
        postprocess_device_ms=post_device_ms,
        postprocess_device_us=post["device_us"],
        kernel_masks_equal_segment_masks=same_as_segment,
        bf16_vs_f32_rel_err=rel, th_cell=th_cell, th_seed=th_seed,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"segment: {N_FRAMES} crops of {SIDE}^2 in {seg_med:.4f} s = "
          f"{N_FRAMES / seg_med:.1f} crops/s; forward {fwd_ms:.3f} ms and "
          f"post-processing {post_ms:.3f} ms per batch of {B} (host enqueue "
          f"{post['host_ms']:.3f} ms, kernels {post_device_ms:.3f} ms of "
          f"device time); "
          f"launches {launches}; instances/frame {min(n_inst)}-"
          f"{max(n_inst)}", flush=True)
    return launches, general, (th_cell, th_seed)


def card_vs_cpu(engine, ref_engine, frames, tol=0.05):
    """Largest difference between the card's bf16 predictions and the CPU's
    float32 ones, relative to the field's largest magnitude; raises above
    ``tol`` or on non-finite values."""
    got = engine.predict_raw(frames)
    ref = ref_engine.predict_raw(frames)
    if not all(np.isfinite(g).all() for g in got):
        raise AssertionError("non-finite predictions")
    rel = max(float(np.abs(g - r).max() / np.abs(r).max())
              for g, r in zip(got, ref))
    if not rel < tol:
        raise AssertionError(f"bf16 card forward vs f32 CPU: rel err {rel}")
    return rel


def big_path(dev, report, model):
    """Phase 5: 2048^2 frames through the tiled path of segment."""
    from microbeseg_torch.config import InferConfig
    from microbeseg_torch.inference.engine import InferenceEngine
    from microbeseg_torch.inference.tiling import (
        extract_tiles_device, stitch_tiles_device, tile_positions)
    from microbeseg_torch.ops.postprocessing import (
        _distance_postprocessing, distance_postprocessing)

    cfg = InferConfig(use_tiling=True)
    engine = InferenceEngine(model, "distance", cfg=cfg, device=dev)
    rng = np.random.default_rng(3)
    frames = big_blob_frames(rng, N_BIG, BIG, BIG_BLOBS)
    warm = big_blob_frames(rng, 1, BIG, BIG_BLOBS)
    th_cell, th_seed = field_thresholds(engine, warm)
    engine.segment(warm, th_cell, th_seed)   # warm-up
    torch.cuda.reset_peak_memory_stats()
    masks, first_s, launches, n_inst = driven_segment(
        engine, frames, th_cell, th_seed,
        ("flood_tiled", "ranked_components"))
    if launches["flood_packed"] or launches["flood_packed_cluster"]:
        raise AssertionError("the crop flood ran on 2048^2 frames")
    if int(masks.max()) <= 255:
        raise AssertionError(f"no instance id above 255: max {masks.max()}")

    # one whole stitched 2048^2 frame: kernel == plain post-processing
    border, cell = engine._predict_raw_dev(frames[:1])
    if not (torch.isfinite(border).all() and torch.isfinite(cell).all()):
        raise AssertionError("non-finite predictions")
    cap = engine._seeds_cap(BIG, BIG)
    kern = engine.postprocess((border, cell), th_cell, th_seed)
    plain = _distance_postprocessing(border, cell, th_seed, th_cell,
                                     max_seeds=cap,
                                     **plain_kernels()).cpu().numpy()
    if not np.array_equal(kern, plain):
        raise AssertionError("2048^2 post-processing: kernels differ from "
                             f"plain on {(kern != plain).sum()} px")
    same_as_segment = float((kern[0] == masks[0]).mean())

    # timing: segment end to end, and its device stages for one frame
    seg_s = timed_segment(engine, frames, th_cell, th_seed)
    tile, overlap = cfg.tile_size, cfg.tile_overlap
    pos = [(y, x) for y in tile_positions(BIG, tile, overlap)
           for x in tile_positions(BIG, tile, overlap)]
    bs_tile = engine._device_batch(tile, tile)
    raw = engine._upload(frames[:1])

    def forward():
        flat = extract_tiles_device(engine._prep(raw, BIG, BIG), tile,
                                    pos)[0]
        return [engine._forward(flat[s:s + bs_tile])
                for s in range(0, len(pos), bs_tile)]

    fwd_ms = cuda_ms(forward, 5)
    heads = [torch.cat([p[i] for p in forward()])[None] for i in range(2)]
    stitch_ms = cuda_ms(lambda: [stitch_tiles_device(h, pos, (BIG, BIG))
                                 for h in heads], 10)
    post_ms = cuda_ms(lambda: distance_postprocessing(
        border, cell, th_seed, th_cell, max_seeds=cap), 10)
    seg_med = statistics.median(seg_s)
    report["big_path"] = dict(
        model="DUNet filters (64, 1024) bn relu conv, bf16 autocast",
        frames=[N_BIG, BIG, BIG], tile=tile, overlap=overlap,
        tiles_per_frame=len(pos), tiles_per_forward=bs_tile, max_seeds=cap,
        launches=launches, instances_per_frame=n_inst,
        max_id=int(masks.max()), segment_first_s=first_s, segment_s=seg_s,
        frames_per_s=N_BIG / seg_med,
        mpx_per_s=N_BIG * BIG * BIG / seg_med / 1e6,
        forward_ms_per_frame=fwd_ms, stitch_ms_per_frame=stitch_ms,
        postprocess_ms_per_frame=post_ms,
        kernel_masks_equal_segment_masks=same_as_segment,
        th_cell=th_cell, th_seed=th_seed,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"segment: {N_BIG} frames of {BIG}^2 (tile {tile}, {len(pos)} "
          f"tiles) in {seg_med:.4f} s = {N_BIG / seg_med:.2f} frames/s, "
          f"{N_BIG * BIG * BIG / seg_med / 1e6:.1f} Mpx/s; per frame: "
          f"forward {fwd_ms:.2f} ms, stitching {stitch_ms:.3f} ms, "
          f"post-processing {post_ms:.3f} ms; launches {launches}; "
          f"instances/frame {min(n_inst)}-{max(n_inst)}", flush=True)
    return launches


def boundary_model(seed, dev, frames):
    """Full-width 3-class U-Net with seeded weights.  Its output head is set
    from the last feature map on held-out frames: random weights put no
    class above another, so cell and background logits are +-k (s - m) of
    one seeded mix s of the features, with m halfway up the blobs' rise and
    k scaling that rise to 8, and the boundary logit is a constant -2."""
    from microbeseg_torch.config import ModelConfig

    model, _ = seeded_model(seed, ModelConfig(unet_type="U", ch_out=3))
    model = model.to(dev).to(memory_format=torch.channels_last)
    head = model.decoderConv[-1]
    x = torch.from_numpy(frames.astype(np.float32)).to(dev)
    mn, mx = x.amin((1, 2), keepdim=True), x.amax((1, 2), keepdim=True)
    x = (2 * (x - mn) / (mx - mn) - 1)[..., None]
    with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
        s = model(x)[..., 1].float()
    bg, top = s.median().item(), s.quantile(0.995).item()
    k, m = 8.0 / (top - bg), (bg + top) / 2
    with torch.no_grad():
        w, b = head.weight[1].clone(), head.bias[1].clone()
        head.weight[1], head.bias[1] = k * w, k * (b - m)
        head.weight[0], head.bias[0] = -k * w, -k * (b - m)
        head.weight[2], head.bias[2] = 0.0, -2.0
    return model


def small_checks(dev, report, model, cpu_model, thresholds):
    """Phase 6: the threshold grid, a boundary model, scaling and CLAHE."""
    from microbeseg_torch.config import InferConfig
    from microbeseg_torch.inference.engine import InferenceEngine
    from microbeseg_torch.ops.postprocessing import _boundary_postprocessing

    rng = np.random.default_rng(4)
    th_cell, th_seed = thresholds
    out = {}

    # segment_grid with 8 pairs == 8 segment calls
    engine = InferenceEngine(model, "distance", device=dev)
    frame = blob_frames(rng, 1, SIDE)[0]
    gap = th_seed - th_cell
    pairs = [(th_cell + c * gap, th_seed + s * gap)
             for c in (0.0, 0.1, 0.2, 0.3) for s in (-0.1, 0.1)]
    grid = engine.segment_grid(frame, pairs)
    if grid.shape != (8, SIDE, SIDE) or grid.dtype != np.uint16:
        raise AssertionError(f"grid masks {grid.shape} {grid.dtype}")
    for (tc, ts), m in zip(pairs, grid):
        if not np.array_equal(m, engine.segment(frame, tc, ts)):
            raise AssertionError(f"segment_grid differs from segment at "
                                 f"thresholds {(tc, ts)}")
    if len({int((m > 0).sum()) for m in grid}) < 2 or grid.max() < 1:
        raise AssertionError("the threshold grid gave one mask 8 times")
    out["grid_instances"] = [len(np.unique(m)) - 1 for m in grid]

    # boundary model: instances, and kernel == plain post-processing
    frames = blob_frames(rng, B, SIDE)
    bengine = InferenceEngine(
        boundary_model(5, dev, blob_frames(rng, 4, SIDE)), "boundary",
        device=dev)
    masks = bengine.segment(frames)
    n_inst = [len(np.unique(m)) - 1 for m in masks]
    if masks.dtype != np.uint16 or min(n_inst) < 1:
        raise AssertionError(f"boundary masks: instances {n_inst}")
    (probs,) = bengine._predict_raw_dev(frames)
    kern = bengine.postprocess((probs,), 0.0, 0.0)
    plain = _boundary_postprocessing(probs, max_seeds=256,
                                     **plain_kernels()).cpu().numpy()
    if not np.array_equal(kern, plain):
        raise AssertionError("boundary post-processing: kernels differ from "
                             f"plain on {(kern != plain).sum()} px")
    out["boundary_instances"] = n_inst

    # scaling and CLAHE on the bucket path vs the same engine on the CPU
    small = blob_frames(rng, 2, 64)
    for name, cfg in (("scale_factor_0.5", InferConfig(scale_factor=0.5)),
                      ("apply_clahe", InferConfig(apply_clahe=True))):
        out[name + "_rel_err"] = card_vs_cpu(
            InferenceEngine(model, "distance", cfg=cfg, device=dev),
            InferenceEngine(cpu_model, "distance", cfg=cfg, device="cpu"),
            small)
    for eng in (engine, bengine):
        if eng.oom_count:
            raise AssertionError(f"{eng.oom_count} out-of-memory fallbacks")
    report["small_checks"] = out
    print(f"grid, boundary, scaling and CLAHE checks passed: {out}",
          flush=True)


def masks_iou(a, b):
    """Agreement of two instance masks: the area-weighted mean, over the
    instances of both, of each instance's best IoU with an instance of the
    other mask."""
    a, b = a.astype(np.int64).ravel(), b.astype(np.int64).ravel()
    na, nb = int(a.max()) + 1, int(b.max()) + 1
    joint = np.bincount(a * nb + b, minlength=na * nb).reshape(na, nb)
    area_a, area_b = joint.sum(1), joint.sum(0)
    union = area_a[:, None] + area_b[None, :] - joint
    iou = joint / np.maximum(union, 1)
    iou[0, :] = iou[:, 0] = 0.0
    weight = area_a[1:].sum() + area_b[1:].sum()
    if weight == 0:
        return 1.0
    return float(((iou.max(1) * area_a)[1:].sum()
                  + (iou.max(0) * area_b)[1:].sum()) / weight)


def equal_on_plain_product(engine, frames, what):
    """The engine's predictions for ``frames`` through K5 must equal, bit for
    bit, those of the same engine with ``conv3x3_int8_plain`` (the 9-tap
    operand, the float64 product and the float32 dequantise) in K5's place.
    Returns the predictions."""
    from microbeseg_torch.kernels import _build
    from microbeseg_torch.models import blocks
    from microbeseg_torch.ops.kernels.matmul import conv3x3_int8_plain

    preds = engine._predict_raw_dev(frames)
    kernel_fn = blocks.conv3x3_int8
    blocks.conv3x3_int8 = conv3x3_int8_plain
    try:
        _build.reset_launches()
        plain_preds = engine._predict_raw_dev(frames)
        if _build.LAUNCHES["conv3x3_int8"] or _build.LAUNCHES["matmul_int8"]:
            raise AssertionError(f"{what}: the plain run launched K5")
    finally:
        blocks.conv3x3_int8 = kernel_fn
    for got, want in zip(preds, plain_preds):
        if not torch.isfinite(got).all():
            raise AssertionError(f"{what}: non-finite int8 predictions")
        if not torch.equal(got, want):
            raise AssertionError(
                f"{what}: K5 differs from the plain product, max abs diff "
                f"{(got - want).abs().max().item()}")
    return preds


def int8_path(dev, report, model, thresholds):
    """Phase 7: ``InferConfig(quantize=True)`` on the crop path's frames, and
    on one tiled 2048^2 frame."""
    from microbeseg_torch.config import InferConfig
    from microbeseg_torch.inference.engine import InferenceEngine
    from microbeseg_torch.kernels import _build
    from microbeseg_torch.models import blocks

    th_cell, th_seed = thresholds
    rng = np.random.default_rng(2)   # the crop path's frames
    frames = blob_frames(rng, N_FRAMES, SIDE)
    warm = blob_frames(rng, B, SIDE)
    ref_engine = InferenceEngine(model, "distance", device=dev)
    engine = InferenceEngine(model, "distance", device=dev,
                             cfg=InferConfig(quantize=True))
    if engine._quant_calibrated:
        raise AssertionError("calibrated before the first frame")

    # the first call calibrates (one pass of 4 crops) and runs one batch
    _build.reset_launches()
    engine.segment(warm, th_cell, th_seed)
    layers = [m for m in engine.models[0].modules()
              if isinstance(m, blocks.QuantConv) and m.calibrated]
    amax = [float(m.act_amax) for m in layers]
    per_batch = 5
    calib_launches = _build.LAUNCHES["conv3x3_int8"] - per_batch
    if (engine._quant_shapes != {(SIDE, SIDE)} or len(layers) != per_batch
            or min(amax) <= 0 or calib_launches != per_batch):
        raise AssertionError(
            f"calibration: shapes {engine._quant_shapes}, maxima {amax}, "
            f"{calib_launches} K5 launches in the calibration pass")
    if any(getattr(m, "quantize", False) or getattr(m, "calibrated", False)
           for m in model.modules()):
        raise AssertionError("the int8 engine changed the caller's model")

    torch.cuda.reset_peak_memory_stats()
    masks, first_s, launches, n_inst = driven_segment(
        engine, frames, th_cell, th_seed,
        ("flood_packed", "ranked_components", "conv3x3_int8"))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    n_batches = N_FRAMES // B
    if (launches["conv3x3_int8"] != per_batch * n_batches
            or launches["matmul_int8"]):
        raise AssertionError(
            f"K5's convolution launched {launches['conv3x3_int8']} times on "
            f"{n_batches} batches, expected {per_batch * n_batches}, and the "
            f"9-tap operand's product {launches['matmul_int8']} times, "
            "expected 0")
    if [float(m.act_amax) for m in layers] != amax:
        raise AssertionError("a second calibration pass ran")
    if not np.array_equal(engine.segment(frames, th_cell, th_seed), masks):
        raise AssertionError("a second segment call gave other masks")

    # the same engine on the plain int8 product: identical predictions
    preds = equal_on_plain_product(engine, frames, "int8 crops")

    # where one int8 layer's time goes: enc0.conv1 (64 -> 64) on the
    # activations of one batch, stage by stage, beside the same layer on
    # cuDNN
    layer = engine.models[0].encoderConv[0].conv[3]
    x = torch.randn((B, layer.in_channels, SIDE, SIDE), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(8))
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
        w_q, w_scale = layer.quantized_weight()
        x_q, x_scale = layer.quantized_input(x)
        taps = layer.tap_operand(x_q)
        y = blocks.matmul_int8(taps, w_q).view(B, SIDE, SIDE, -1)
        scale, bias = x_scale * w_scale, layer.bias.detach().float()
        fused = blocks.conv3x3_int8(x_q, w_q, scale, bias, torch.bfloat16)
        if not torch.equal(fused.permute(0, 3, 1, 2),
                           layer.dequantize(y, x_scale, w_scale, x)):
            raise AssertionError("conv3x3_int8 differs from tap_operand, "
                                 "matmul_int8 and dequantize in turn")
        stages = dict(
            quantize_weight=cuda_ms(layer.quantized_weight, 20),
            quantize_input=cuda_ms(lambda: layer.quantized_input(x), 20),
            conv3x3_int8=cuda_ms(lambda: blocks.conv3x3_int8(
                x_q, w_q, scale, bias, torch.bfloat16), 20),
            whole_layer=cuda_ms(lambda: layer.forward_int8(x), 20),
            cudnn_bf16_layer=cuda_ms(lambda: layer(x), 20),
            # the three stages that conv3x3_int8 stands for
            tap_operand=cuda_ms(lambda: layer.tap_operand(x_q), 20),
            matmul_int8=cuda_ms(lambda: blocks.matmul_int8(taps, w_q), 20),
            dequantize=cuda_ms(
                lambda: layer.dequantize(y, x_scale, w_scale, x), 20))
    del x, x_q, taps, y, fused
    print("int8 layer 64 -> 64 on 16 x 256^2, ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()), flush=True)

    # against the bf16 engine: numbers, not gates (random weights)
    ref_preds = ref_engine._predict_raw_dev(frames)
    rel_rms = [float((g - r).square().mean().sqrt() / r.square().mean().sqrt())
               for g, r in zip(preds, ref_preds)]
    ref_masks = ref_engine.segment(frames, th_cell, th_seed)
    ious = [masks_iou(m, r) for m, r in zip(masks, ref_masks)]

    # timing, in turns: bf16, int8, int8, bf16
    chunk = frames[:B]
    seg_ref, seg_q, fwd_ref, fwd_q = [], [], [], []
    for eng, seg, fwd in ((ref_engine, seg_ref, fwd_ref),
                          (engine, seg_q, fwd_q), (engine, seg_q, fwd_q),
                          (ref_engine, seg_ref, fwd_ref)):
        seg.extend(timed_segment(eng, frames, th_cell, th_seed, reps=2))
        fwd.append(cuda_ms(lambda: eng._predict_raw_dev(chunk), 5))
    seg_med = statistics.median(seg_q)
    out = dict(
        frames=[N_FRAMES, SIDE, SIDE], batch=B, launches=launches,
        calibration_launches=calib_launches, act_amax=amax,
        instances_per_frame=n_inst, segment_first_s=first_s,
        segment_s=seg_q, crops_per_s=N_FRAMES / seg_med,
        forward_ms_per_batch=fwd_q, bf16_segment_s=seg_ref,
        bf16_crops_per_s=N_FRAMES / statistics.median(seg_ref),
        bf16_forward_ms_per_batch=fwd_ref,
        rel_rms_vs_bf16={"border": rel_rms[0], "cell": rel_rms[1]},
        mask_iou_vs_bf16=dict(min=min(ious), mean=statistics.mean(ious)),
        layer_stage_ms=stages, peak_mem_gib=peak_gib)
    print(f"int8 segment: {N_FRAMES} crops of {SIDE}^2 in {seg_med:.4f} s = "
          f"{out['crops_per_s']:.1f} crops/s (bf16 beside it "
          f"{out['bf16_crops_per_s']:.1f}); forward {min(fwd_q):.3f} ms per "
          f"batch (bf16 {min(fwd_ref):.3f}); K5 launches "
          f"{launches['conv3x3_int8']} + {calib_launches} calibrating; "
          f"predictions equal the plain product's; vs bf16: relative RMS "
          f"{rel_rms[0]:.4f} / {rel_rms[1]:.4f}, mask IoU min "
          f"{min(ious):.4f} mean {statistics.mean(ious):.4f}; peak "
          f"{peak_gib:.2f} GiB", flush=True)

    # one tiled 2048^2 frame: tile calibration, 11 launches per tile call
    cfg = InferConfig(use_tiling=True, quantize=True)
    tiled = InferenceEngine(model, "distance", cfg=cfg, device=dev)
    frame = big_blob_frames(np.random.default_rng(7), 1, BIG, BIG_BLOBS)
    th_big = report["big_path"]["th_cell"], report["big_path"]["th_seed"]
    torch.cuda.reset_peak_memory_stats()
    big_masks, big_s, big_launches, big_inst = driven_segment(
        tiled, frame, *th_big,
        ("flood_tiled", "ranked_components", "conv3x3_int8"))
    n_tiles = report["big_path"]["tiles_per_frame"]
    n_calls = -(-n_tiles // report["big_path"]["tiles_per_forward"])
    n_cal = sum(m.calibrated for m in tiled.models[0].modules()
                if isinstance(m, blocks.QuantConv))
    if (big_launches["conv3x3_int8"] != 11 * (1 + n_calls) or n_cal != 11
            or big_launches["matmul_int8"]
            or tiled._quant_shapes != {(cfg.tile_size, cfg.tile_size)}):
        raise AssertionError(
            f"tiled int8: {big_launches['conv3x3_int8']} K5 launches on 1 "
            f"calibration pass + {n_calls} tile calls, {n_cal} calibrated "
            f"layers, shapes {tiled._quant_shapes}")
    t0 = time.perf_counter()
    again = tiled.segment(frame, *th_big)
    again_s = time.perf_counter() - t0
    if not np.array_equal(again, big_masks):
        raise AssertionError("tiled int8: a second call gave other masks")
    out["tiled"] = dict(
        frames=[1, BIG, BIG], launches=big_launches, tile_calls=n_calls,
        calibrated_layers=n_cal, instances_per_frame=big_inst,
        segment_first_s=big_s, segment_s=again_s,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    # every tile call of the frame (level 0 at M = 2^21, level 1 at 2^19) on
    # the plain int8 product: identical stitched predictions
    equal_on_plain_product(tiled, frame, "int8 tiles")
    print(f"int8 tiled segment: one {BIG}^2 frame in {again_s:.4f} s; K5 "
          f"launches {big_launches['conv3x3_int8']} = 11 x (1 calibrating + "
          f"{n_calls} tile calls); predictions equal the plain product's; "
          f"instances {big_inst}; peak "
          f"{out['tiled']['peak_mem_gib']:.2f} GiB", flush=True)

    # a narrow model (filters 24 -> 384): its int8 layers have 24 or 48
    # input channels, no multiple of 64, so the wrapper's shape rule sends
    # them through tap_operand -> matmul_int8 -> the PyTorch dequantise
    from microbeseg_torch.config import ModelConfig

    narrow = InferenceEngine(
        seeded_model(11, ModelConfig(filters=(24, 384)))[0], "distance",
        device=dev, cfg=InferConfig(quantize=True))
    narrow_th = field_thresholds(narrow, warm)   # calibrates
    torch.cuda.synchronize()
    _build.reset_launches()
    narrow_masks = narrow.segment(frames[:B], *narrow_th)
    narrow_launches = dict(_build.LAUNCHES)
    if (narrow_launches["matmul_int8"] != per_batch
            or narrow_launches["conv3x3_int8"]
            or narrow_masks.shape != (B, SIDE, SIDE)):
        raise AssertionError(
            f"narrow int8 model: launches {narrow_launches}, expected "
            f"{per_batch} of matmul_int8 and none of conv3x3_int8")
    equal_on_plain_product(narrow, frames[:B], "narrow int8 model")
    out["narrow_model"] = dict(filters=[24, 384], launches=narrow_launches)
    print(f"narrow int8 model (24 -> 384): {narrow_launches['matmul_int8']} "
          f"matmul_int8 launches per batch, predictions equal the plain "
          f"product's", flush=True)
    report["int8_path"] = out
    return [launches, big_launches], narrow_launches


def cli_path(dev, report, model, thresholds):
    """Phase 8: the inference CLI with ``--quantize`` on a small folder, from
    a checkpoint of the seeded model written by ``save_model``."""
    import tempfile

    from microbeseg_torch.cli import infer_local
    from microbeseg_torch.config import InferConfig, ModelConfig, TrainConfig
    from microbeseg_torch.inference.engine import InferenceEngine
    from microbeseg_torch.kernels import _build
    from microbeseg_torch.models.io import save_model
    from microbeseg_torch.utils.tiff import imread, imwrite

    th_cell, th_seed = thresholds
    frames = blob_frames(np.random.default_rng(9), 3, SIDE)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ckpt = save_model(model, TrainConfig(model=ModelConfig(),
                                             run_name="smoke_01"),
                          tmp / "models")
        (tmp / "imgs").mkdir()
        imwrite(tmp / "imgs" / "a_single.tif", frames[0])
        imwrite(tmp / "imgs" / "b_stack.tif", frames[1:])
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        rc = infer_local.main([
            "-i", str(tmp / "imgs"), "-m", str(ckpt), "-r", str(tmp / "out"),
            "-t", repr(th_cell), repr(th_seed), "-b", str(B), "--quantize"])
        seconds = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        single = imread(tmp / "out" / "mask_a_single_channel0.tif")
        stack = imread(tmp / "out" / "mask_b_stack_channel0.tif")
    # one calibration pass on the first file, then one forward per file,
    # and one flood per file on the one-block K1
    if (rc != 0 or launches["conv3x3_int8"] != 5 * 3
            or launches["flood_packed"] != 2
            or launches["flood_packed_cluster"]):
        raise AssertionError(f"CLI: exit {rc}, launches {launches}, expected "
                             "15 of conv3x3_int8, 2 of flood_packed and none "
                             "of flood_packed_cluster")
    if (single.shape != (SIDE, SIDE) or stack.shape != (2, SIDE, SIDE)
            or single.dtype != np.uint16 or stack.dtype != np.uint16):
        raise AssertionError(f"CLI masks {single.shape} {stack.shape}")
    n_inst = [len(np.unique(m)) - 1 for m in (single, *stack)]
    if min(n_inst) < 1:
        raise AssertionError(f"CLI: frames without instances: {n_inst}")
    # the same masks as an engine given the same files in the same order
    engine = InferenceEngine(
        model, "distance", device=dev,
        cfg=InferConfig(th_cell=th_cell, th_seed=th_seed, batch_size=B,
                        quantize=True))
    if not (np.array_equal(engine.segment(frames[0]), single)
            and np.array_equal(engine.segment(frames[1:]), stack)):
        raise AssertionError("CLI masks differ from the engine's")
    report["cli_path"] = dict(launches=launches, seconds=seconds,
                              instances_per_frame=n_inst)
    print(f"cli infer_local --quantize: 2 files, 3 frames in {seconds:.2f} s "
          f"(checkpoint load included); K5 launches "
          f"{launches['conv3x3_int8']}; instances/frame {n_inst}", flush=True)
    return launches



REAL = Path(__file__).resolve().parent / "data"


# --- serving, the store and the watershed route (phases 12-14) ------------

GLUT_TEST = range(40, 50)


def glutamicum_test_frames():
    """Frames 40-49 of ``data/real_glutamicum`` as stored (as the
    evaluation phase reads them)."""
    from microbeseg_torch.utils.tiff import imread_page

    glut = REAL / "real_glutamicum"
    return np.stack([imread_page(glut / f"img_{i:02d}.tif", 0)
                     for i in GLUT_TEST]).astype(np.uint16)


def require_launches(launches, must, where):
    """Raise unless every kernel of ``must`` launched, and no kernel or route
    that the main paths never take did."""
    for name in must:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on {where}")
    for name in ("flood_packed_cluster", "flood_tiled_grid",
                 "sequentialize_components", "watershed_route"):
        if launches[name]:
            raise AssertionError(f"{name} ran on {where}: {launches}")


def npy_bytes(arr) -> bytes:
    import io

    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def tif_bytes(frames) -> bytes:
    import io

    from microbeseg_torch.utils.tiff import _pil

    pil = [_pil().fromarray(f) for f in frames]
    buf = io.BytesIO()
    pil[0].save(buf, format="TIFF", save_all=True, append_images=pil[1:])
    return buf.getvalue()


def http_call(addr, method, path, body=b"", headers=None):
    """One request on its own connection -> (status, headers, body, s)."""
    from http.client import HTTPConnection

    t0 = time.perf_counter()
    conn = HTTPConnection(*addr, timeout=300)
    try:
        conn.putrequest(method, path)
        hdrs = {"Content-Length": str(len(body))} if method == "POST" else {}
        hdrs.update(headers or {})
        for k, v in hdrs.items():
            conn.putheader(k, v)
        conn.endheaders()
        if body and "Content-Length" not in (headers or {}):
            conn.send(body)
        resp = conn.getresponse()
        out = (resp.status, dict(resp.getheaders()), resp.read())
    finally:
        conn.close()
    return out + (time.perf_counter() - t0,)


def response_masks(res):
    """uint16 masks of a 200 response, checked against its X-Instances."""
    import io

    status, headers, data, _ = res
    if status != 200:
        raise AssertionError(f"status {status}: {data[:200]!r}")
    if headers["Content-Type"] == "image/tiff":
        from microbeseg_torch.utils.tiff import _pil

        with _pil().open(io.BytesIO(data)) as im:
            frames = []
            for i in range(getattr(im, "n_frames", 1)):
                im.seek(i)
                frames.append(np.asarray(im))
        masks = np.stack(frames)
    else:
        masks = np.load(io.BytesIO(data), allow_pickle=False)
    counts = [int(c) for c in headers["X-Instances"].split(",")]
    if counts != [int(m.max()) for m in masks]:
        raise AssertionError(f"X-Instances {counts} against the masks")
    return masks


def concurrently(addr, payloads, path="/segment"):
    """One thread per client, each posting its payloads in turn ->
    ({(client, k): result}, wall seconds)."""
    import threading

    results = {}

    def client(i):
        for k, body in enumerate(payloads[i]):
            results[i, k] = http_call(addr, "POST", path, body)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(payloads))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            raise AssertionError("a serve client hung")
    return results, time.perf_counter() - t0


# a serving client: posts one body n times in turn, from a start time, and
# prints its latencies (stdlib only, so it starts in tens of milliseconds)
SERVE_CLIENT = r"""
import http.client, json, sys, time
host, port, path, n, go = sys.argv[1:6]
body = open(path, "rb").read()
while time.time() < float(go):
    time.sleep(0.001)
lat = []
for _ in range(int(n)):
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection(host, int(port), timeout=300)
    conn.request("POST", "/segment", body=body)
    resp = conn.getresponse()
    resp.read()
    conn.close()
    if resp.status != 200:
        sys.exit(f"status {resp.status}")
    lat.append(time.perf_counter() - t0)
print(json.dumps({"lat": lat, "end": time.time()}))
"""


def client_processes(addr, body_path, n_clients, n_requests):
    """Serving clients as processes of their own, so that they take no share
    of the daemon's interpreter: each posts ``body_path`` ``n_requests``
    times in turn, all from one start time -> (latencies s, wall s)."""
    go = time.time() + 2.0
    procs = [subprocess.Popen(
        [sys.executable, "-c", SERVE_CLIENT, addr[0], str(addr[1]),
         str(body_path), str(n_requests), repr(go)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(n_clients)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            if p.returncode != 0:
                raise AssertionError(f"serve client: {err[-500:]}")
            outs.append(json.loads(out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return ([x for o in outs for x in o["lat"]],
            max(o["end"] for o in outs) - go)


def timed_fn(into: list, fn):
    """``fn``, appending the seconds of each call to ``into``."""
    def call(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            into.append(time.perf_counter() - t0)
    return call


def timed_call(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def pct(values, q):
    return float(np.percentile(np.asarray(values), q))


def serve_path(dev, report, model):
    """Phase 12: ``cli.serve`` on the flagship checkpoint, batch 16, on
    127.0.0.1:0; requests over HTTP as clients send them."""
    import tempfile
    import threading

    from microbeseg_torch.cli import serve
    from microbeseg_torch.config import ModelConfig, TrainConfig
    from microbeseg_torch.inference.engine import InferenceEngine
    from microbeseg_torch.kernels import _build
    from microbeseg_torch.models.io import save_model

    phase_t0 = time.perf_counter()
    rng = np.random.default_rng(12)
    warm = blob_frames(rng, B, SIDE)
    seq = [blob_frames(rng, B, SIDE) for _ in range(3)]
    conc = [[blob_frames(rng, B, SIDE) for _ in range(2)] for _ in range(4)]
    glut = glutamicum_test_frames()
    probe = InferenceEngine(model, "distance", device=dev)
    th_cell, th_seed = field_thresholds(probe, warm)
    g_cell, g_seed = field_thresholds(probe, glut)
    glut_path = (f"/segment?format=tif&th_cell={g_cell!r}"
                 f"&th_seed={g_seed!r}")
    del probe
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_model(model, TrainConfig(model=ModelConfig(),
                                             run_name="serve_01"),
                          Path(tmp) / "models")
        args = serve.build_parser().parse_args([
            "--model", str(ckpt), "-b", str(B), "-t", repr(th_cell),
            repr(th_seed), "--port", "0"])
        engine = serve.engine_from_args(args)
        httpd = serve.serve(engine, {"model": [str(ckpt)],
                                     "label_type": engine.label_type},
                            "127.0.0.1", 0,
                            max_body_bytes=args.max_body_mb * 1024 * 1024)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            addr = httpd.server_address
            response_masks(http_call(addr, "POST", "/segment",
                                     npy_bytes(warm)))   # warm-up
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            seq_res = [http_call(addr, "POST", "/segment", npy_bytes(f))
                       for f in seq]
            glut_res = http_call(addr, "POST", glut_path, tif_bytes(glut))
            conc_res, _ = concurrently(
                addr, [[npy_bytes(f) for f in c] for c in conc])
            health = http_call(addr, "GET", "/healthz")
            bad = http_call(addr, "POST", "/segment", b"not an image")
            huge = http_call(addr, "POST", "/segment", b"", headers={
                "Content-Length": str(args.max_body_mb * 1024 * 1024 + 1)})
            driven_s = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
            require_launches(launches, ("flood_packed", "ranked_components"),
                             "the serve path")
            if engine.oom_count:
                raise AssertionError(f"serve: {engine.oom_count} "
                                     "out-of-memory fallbacks")
            if (health[0], bad[0], huge[0]) != (200, 400, 413) or json.loads(
                    health[2])["label_type"] != "distance":
                raise AssertionError(f"serve: /healthz {health[0]}, bad "
                                     f"payload {bad[0]}, oversized {huge[0]}")
            # every response against segment of its frames on this engine
            checked = [(r, f, th_cell, th_seed) for r, f in zip(seq_res, seq)]
            checked.append((glut_res, glut, g_cell, g_seed))
            checked += [(conc_res[i, k], conc[i][k], th_cell, th_seed)
                        for i in range(4) for k in range(2)]
            n_inst = []
            for res, frames, tc, ts in checked:
                got = response_masks(res)
                want = engine.segment(frames, th_cell=tc, th_seed=ts)
                if not np.array_equal(got, want):
                    raise AssertionError(
                        f"serve: a response differs from segment on "
                        f"{(got != want).sum()} px")
                n_inst += [int(m.max()) for m in got]
            if min(n_inst) < 1:
                raise AssertionError(f"serve: frames without instances: "
                                     f"{n_inst}")

            # times: segment alone, then 1 and 4 clients on the same crops
            body = npy_bytes(seq[0])
            seg_s = []
            for _ in range(10):
                t1 = time.perf_counter()
                engine.segment(seq[0])
                seg_s.append(time.perf_counter() - t1)
            # a fresh thread's first segment: why the daemon runs its
            # engine on one long-lived thread (cuDNN's per-thread caches)
            fresh_s = []
            for _ in range(3):
                worker = threading.Thread(target=lambda: fresh_s.append(
                    timed_call(lambda: engine.segment(seq[0]))))
                worker.start()
                worker.join()
            body_path = Path(tmp) / "crops.npy"
            body_path.write_bytes(body)
            # 1 client, with the daemon's side of each request timed: the
            # handler looks up these three at each call
            split = {"decode": [], "segment": [], "encode": []}
            plain = (serve.decode_payload, serve.encode_masks)
            serve.decode_payload = timed_fn(split["decode"], plain[0])
            serve.encode_masks = timed_fn(split["encode"], plain[1])
            engine.segment = timed_fn(split["segment"], engine.segment)
            try:
                one, _ = client_processes(addr, body_path, 1, 20)
            finally:
                serve.decode_payload, serve.encode_masks = plain
                del engine.segment
            lat4, wall4 = client_processes(addr, body_path, 4, 5)
            glut_s = [http_call(addr, "POST", glut_path, tif_bytes(glut))[3]
                      for _ in range(3)]
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=10)
    out = dict(
        launches=launches, driven_s=driven_s, requests=3 + 1 + 8 + 3,
        instances_per_frame=[min(n_inst), max(n_inst)],
        thresholds=dict(crops=[th_cell, th_seed], glutamicum=[g_cell, g_seed]),
        segment_ms=1e3 * statistics.median(seg_s),
        segment_crops_per_s=B / statistics.median(seg_s),
        segment_fresh_thread_ms=1e3 * statistics.median(fresh_s),
        one_client=dict(median_ms=1e3 * statistics.median(one),
                        p90_ms=1e3 * pct(one, 90),
                        crops_per_s=B * len(one) / sum(one),
                        daemon_median_ms={k: 1e3 * statistics.median(v)
                                          for k, v in split.items()}),
        four_clients=dict(median_ms=1e3 * statistics.median(lat4),
                          p90_ms=1e3 * pct(lat4, 90),
                          crops_per_s=B * len(lat4) / wall4),
        glutamicum_tif_ms=1e3 * statistics.median(glut_s),
        phase_s=time.perf_counter() - phase_t0)
    report["serve_path"] = out
    one, four = out["one_client"], out["four_clients"]
    daemon = {k: round(v, 3) for k, v in one["daemon_median_ms"].items()}
    print(f"serve: {out['requests']} requests (3 x 16 crops .npy, 10 "
          f"glutamicum frames as TIFF, 4 clients x 2, /healthz, a 400 and a "
          f"413) equal segment bit for bit; launches flood_packed "
          f"{launches['flood_packed']}, ranked_components "
          f"{launches['ranked_components']}; segment alone "
          f"{out['segment_ms']:.3f} ms = {out['segment_crops_per_s']:.1f} "
          f"crops/s (a fresh thread's first call "
          f"{out['segment_fresh_thread_ms']:.3f} ms); 1 client "
          f"{one['median_ms']:.3f} / p90 {one['p90_ms']:.3f} ms = "
          f"{one['crops_per_s']:.1f} crops/s (the daemon's medians {daemon} "
          f"ms); 4 clients {four['median_ms']:.3f} / p90 "
          f"{four['p90_ms']:.3f} ms = {four['crops_per_s']:.1f} crops/s; "
          f"glutamicum TIFF request {out['glutamicum_tif_ms']:.3f} ms; "
          f"phase {out['phase_s']:.1f} s", flush=True)
    return launches


def csv_rows(path):
    import csv

    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    return rows[0], rows[1:]


def store_path(dev, report, model):
    """Phase 13: the store-backed path: ``cli.infer_store`` on a LocalStore
    of glutamicum frames 40-49 (10 images and one 2D+t image of the same
    frames), then ``analyze_dataset`` on the card, ``export_results`` and
    ``CropGenerator``'s pre-labels."""
    import tempfile

    from microbeseg_torch.cli import infer_store
    from microbeseg_torch.cli.infer_local import build_engine
    from microbeseg_torch.client import native, workers
    from microbeseg_torch.client.store import LocalStore
    from microbeseg_torch.config import InferConfig, ModelConfig, TrainConfig
    from microbeseg_torch.inference.engine import InferenceEngine
    from microbeseg_torch.kernels import _build
    from microbeseg_torch.models.io import save_model
    from microbeseg_torch.utils.tiff import imread

    phase_t0 = time.perf_counter()
    glut = glutamicum_test_frames()
    th_cell, th_seed = field_thresholds(
        InferenceEngine(model, "distance", device=dev), glut)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ckpt = save_model(model, TrainConfig(model=ModelConfig(),
                                             run_name="store_01"),
                          tmp / "models")

        def fresh_store(name):
            store = LocalStore(tmp / name)
            did = store.create_dataset("glutamicum_40_49")
            for i, f in zip(GLUT_TEST, glut):
                store.upload_image(did, f"glut_{i}.tif", f)
            store.upload_image(did, "glut_series.tif", glut)
            return store, did

        store, did = fresh_store("store")
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        rc = infer_store.main([
            "--local_store", str(tmp / "store"), "--dataset", str(did),
            "-m", str(ckpt), "-r", str(tmp / "masks"),
            "-t", repr(th_cell), repr(th_seed)])
        cli_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        if rc != 0:
            raise AssertionError(f"cli.infer_store: exit {rc}")
        require_launches(launches, ("flood_packed", "ranked_components"),
                         "the store path")
        lib = native.get_lib()
        if lib is None:
            raise AssertionError("the native contour library did not load")

        engine = build_engine([ckpt], InferConfig(th_cell=th_cell,
                                                  th_seed=th_seed), device=dev)
        refs = store.list_images(did)
        ids = [r.image_id for r in refs]
        agree, n_rois, masks_by_id = [], {}, {}
        for ref in refs:
            meta = store.get_map_annotation(ref.image_id)
            polys = store.get_polygons(ref.image_id)
            if meta.get("inference_model") != "store_01" or not polys:
                raise AssertionError(f"store: image {ref.name} has "
                                     f"{len(polys)} ROIs, meta {meta}")
            planes = np.stack([store.get_plane(ref.image_id, 0, 0, t)
                               for t in range(ref.size_t)])
            masks = engine.segment(planes)
            written = imread(tmp / "masks" / (
                f"mask_{Path(ref.name).stem}_channel0.tif")).reshape(
                    masks.shape)
            if not np.array_equal(written, masks):
                raise AssertionError(f"store: {ref.name}: written masks "
                                     "differ from segment")
            masks_by_id[ref.image_id] = masks
            for t in range(ref.size_t):
                back = workers._rasterize_rois(polys, t, masks.shape[1:])
                agree.append(float(((back > 0) == (masks[t] > 0)).mean()))
                n_rois[ref.image_id, t] = sum(p.t == t for p in polys)
        if min(agree) <= 0.97:   # tests/test_client.py's roundtrip bar
            raise AssertionError(f"store: rasterised ROIs agree with the "
                                 f"masks on {min(agree):.4f} of a frame")
        # the serial run leaves the same ROI strings as the pipelined CLI
        serial, sdid = fresh_store("serial")
        workers.infer_dataset(serial, [r.image_id for r in
                                       serial.list_images(sdid)],
                              engine, "store_01", pipeline=False)
        for a, b in zip(ids, [r.image_id for r in serial.list_images(sdid)]):
            if ([p.points for p in store.get_polygons(a)]
                    != [p.points for p in serial.get_polygons(b)]):
                raise AssertionError("store: the serial run's ROIs differ "
                                     "from the pipelined run's")

        # analysis on the card against the port on the CPU
        card = workers.analyze_dataset(store, ids, tmp / "analysis_card")
        cpu = workers.analyze_dataset(store, ids, tmp / "analysis_cpu",
                                      device="cpu")
        worst, counts = 0.0, []
        for iid, a, b in zip(ids, card, cpu):
            head, rows_a = csv_rows(a)
            _, rows_b = csv_rows(b)
            for ra, rb in zip(rows_a, rows_b):
                t, n = int(ra[0]), int(ra[1])
                if ra[:2] != rb[:2] or n != n_rois[iid, t]:
                    raise AssertionError(
                        f"analysis of image {iid} frame {t}: count {n}, "
                        f"CPU {rb[1]}, ROIs {n_rois[iid, t]}")
                fa = np.array(ra[2:], float)
                fb = np.array(rb[2:], float)
                worst = max(worst, float(np.max(np.abs(fa - fb)
                                                / np.maximum(np.abs(fb),
                                                             1e-30))))
                counts.append(n)
        if worst > 1e-5:
            raise AssertionError(f"analysis: card vs CPU {worst:.3g} relative")

        workers.export_results(store, ids, tmp / "results")
        n_files = len(list((tmp / "results").iterdir()))
        if n_files != 5 * len(ids):
            raise AssertionError(f"export_results wrote {n_files} files")

        # CropGenerator's pre-labels, counted from 0
        gen = workers.CropGenerator(store, crop_size=128, engine=engine,
                                    seed=0)
        items = gen.crop_list(did)[:4]
        torch.cuda.synchronize()
        _build.reset_launches()
        crops = [c for it in items for c in gen.next_crops(*it)]
        crop_launches = dict(_build.LAUNCHES)
        require_launches(crop_launches, ("flood_packed", "ranked_components"),
                         "CropGenerator")
        for c in crops:
            want = [r.points for r in workers._mask_to_rois(
                engine.segment(c.img))]
            if not want or [r.points for r in c.rois] != want:
                raise AssertionError("CropGenerator: pre-labels differ from "
                                     "segment of the crop")

        # ms a frame by stage, on a fresh store, the card drained between
        timed, tdid = fresh_store("timed")
        stage = dict(planes=0.0, segment=0.0, trace_upload=0.0)
        n_frames = 0
        for ref in timed.list_images(tdid):
            t1 = time.perf_counter()
            planes = np.stack([timed.get_plane(ref.image_id, 0, 0, t)
                               for t in range(ref.size_t)])
            t2 = time.perf_counter()
            masks = engine.segment(planes)
            t3 = time.perf_counter()
            rois = [r for t in range(ref.size_t)
                    for r in workers._mask_to_rois(masks[t], t=t)]
            timed.add_polygons(ref.image_id, rois)
            timed.set_map_annotation(ref.image_id,
                                     {"inference_model": "store_01"})
            t4 = time.perf_counter()
            stage["planes"] += t2 - t1
            stage["segment"] += t3 - t2
            stage["trace_upload"] += t4 - t3
            n_frames += ref.size_t
        t5 = time.perf_counter()
        workers.analyze_dataset(timed, [r.image_id for r in
                                        timed.list_images(tdid)],
                                tmp / "analysis_timed")
        stage["analysis"] = time.perf_counter() - t5
    ms = {k: 1e3 * v / n_frames for k, v in stage.items()}
    ms_image = {k: 1e3 * v / len(ids) for k, v in stage.items()}
    out = dict(launches=launches, crop_generator_launches=crop_launches,
               cli_s=cli_s, cli_ms_per_frame=1e3 * cli_s / n_frames,
               frames=n_frames, images=len(ids), native_library=lib._name,
               roi_mask_agreement_min=min(agree),
               cells_per_frame=[min(counts), max(counts)],
               analysis_card_vs_cpu_rel=worst, crops=len(crops),
               ms_per_frame_by_stage=ms, ms_per_image_by_stage=ms_image,
               thresholds=[th_cell, th_seed],
               phase_s=time.perf_counter() - phase_t0)
    report["store_path"] = out
    print(f"store: cli.infer_store on {len(ids)} images ({n_frames} frames "
          f"of 256^2) in {cli_s:.2f} s with the checkpoint load; native "
          f"contour library loaded; masks equal segment; ROIs agree with "
          f"them on >= {min(agree):.4f} of a frame; serial ROIs equal the "
          f"pipelined; analysis on the card: counts equal the ROIs, floats "
          f"within {worst:.3g} of the CPU; export_results "
          f"{5 * len(ids)} files; {len(crops)} CropGenerator crops "
          f"pre-labelled as segment; ms a frame by stage "
          f"{ {k: round(v, 3) for k, v in ms.items()} }, an image "
          f"{ {k: round(v, 3) for k, v in ms_image.items()} }; launches "
          f"flood_packed {launches['flood_packed']}, ranked_components "
          f"{launches['ranked_components']}; phase {out['phase_s']:.1f} s",
          flush=True)
    return launches, crop_launches


def watershed_route_path(dev, report, model, thresholds):
    """Phase 14: labels beyond the packed key take the plain ``watershed``
    flood on the card, as JAX takes its XLA flood: once through
    ``distance_postprocessing(max_seeds=2**24)`` on crop predictions, once
    through ``flood_or_fallback`` at 768^2 with 24-bit labels and 200
    levels.  Each is held exactly against the CPU's ``watershed`` on the
    same inputs."""
    from microbeseg_torch.inference.engine import InferenceEngine
    from microbeseg_torch.kernels import _build
    from microbeseg_torch.ops import cc
    from microbeseg_torch.ops import postprocessing as pp
    from microbeseg_torch.ops.kernels import flood
    from microbeseg_torch.ops.watershed import watershed

    phase_t0 = time.perf_counter()
    th_cell, th_seed = thresholds
    rng = np.random.default_rng(14)
    engine = InferenceEngine(model, "distance", device=dev)
    border, cell = engine._predict_raw_dev(blob_frames(rng, B, SIDE))
    captured = []

    def recording(value, markers, mask, n_levels):
        captured.append((value, markers, mask, n_levels))
        return watershed(value, markers, mask, n_levels=n_levels)

    torch.cuda.synchronize()
    _build.reset_launches()
    pp.watershed = recording
    try:
        crops = pp.distance_postprocessing(border, cell, th_seed, th_cell,
                                           max_seeds=2 ** 24)
    finally:
        pp.watershed = watershed
    crop_launches = dict(_build.LAUNCHES)
    value, markers, mask, n_levels = captured[0]
    t0 = time.perf_counter()
    ref = watershed(value.cpu(), markers.cpu(), mask.cpu(),
                    n_levels=n_levels)
    crop_cpu_s = time.perf_counter() - t0
    crops = crops.to(torch.int32)
    if (crop_launches["watershed_route"] != 1
            or crop_launches["flood_packed"]
            or not torch.equal(crops.cpu(), ref)):
        raise AssertionError(f"watershed route on crops: launches "
                             f"{crop_launches}, labels differ from the CPU "
                             f"on {(crops.cpu() != ref).sum()} px")
    packed = pp.distance_postprocessing(border, cell, th_seed, th_cell,
                                        max_seeds=256)
    same_as_packed = float((packed.to(torch.int32) == crops).float().mean())
    crop_ms = cuda_ms(lambda: pp.distance_postprocessing(
        border, cell, th_seed, th_cell, max_seeds=2 ** 24), 3, warmup=1)
    packed_ms = cuda_ms(lambda: pp.distance_postprocessing(
        border, cell, th_seed, th_cell, max_seeds=256), 10)

    # 768^2, 200 levels, markers above 4095 (24-bit labels): no packed key
    side, levels, max_label = flood.MAX_SIDE, 200, (1 << 24) - 2
    field = torch.from_numpy(big_blob_fields(rng, 1, (side, side), 500)).to(dev)
    fmask = field > 0.15
    ranks = cc.ranked_components(field > 0.7)
    fmarkers = torch.where(ranks > 0, ranks + 5000, 0).to(torch.int32)
    torch.cuda.synchronize()
    _build.reset_launches()
    big = flood.flood_or_fallback(-field, fmarkers, fmask, n_levels=levels,
                                  max_label=max_label)
    big_launches = dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    big_ref = watershed(-field.cpu(), fmarkers.cpu(), fmask.cpu(),
                        n_levels=levels)
    big_cpu_s = time.perf_counter() - t0
    if (big_launches["watershed_route"] != 1 or big_launches["flood_packed"]
            or big_launches["flood_tiled"] or int(big.max()) <= 5000
            or not torch.equal(big.cpu(), big_ref)):
        raise AssertionError(f"watershed route at {side}^2: launches "
                             f"{big_launches}, max label {int(big.max())}, "
                             f"labels differ from the CPU on "
                             f"{(big.cpu() != big_ref).sum()} px")
    big_ms = cuda_ms(lambda: flood.flood_or_fallback(
        -field, fmarkers, fmask, n_levels=levels, max_label=max_label), 2,
        warmup=1)
    out = dict(crop_launches=crop_launches, frame_launches=big_launches,
               crop_ms=crop_ms, packed_crop_ms=packed_ms,
               crop_cpu_watershed_s=crop_cpu_s,
               crop_px_equal_to_packed_route=same_as_packed,
               frame_ms=big_ms, frame_cpu_watershed_s=big_cpu_s,
               frame_labels=int((big_ref.unique() > 0).sum()),
               phase_s=time.perf_counter() - phase_t0)
    report["watershed_route"] = out
    print(f"watershed route: distance_postprocessing(max_seeds=2**24) on "
          f"{B} x {SIDE}^2 on the card {crop_ms:.3f} ms (the packed route "
          f"{packed_ms:.3f} ms; {same_as_packed:.4f} of the pixels the same), "
          f"equal to the CPU's watershed ({crop_cpu_s:.2f} s there); "
          f"flood_or_fallback at {side}^2, {levels} levels, labels above "
          f"4095: {big_ms:.3f} ms, equal to the CPU's ({big_cpu_s:.2f} s); "
          f"counted once each; phase {out['phase_s']:.1f} s", flush=True)
    return crop_launches, big_launches


def test_set(root, src, ids):
    """``root/test`` with the images and masks ``src/img_XX.tif``,
    ``src/mask_XX.tif`` of ``ids``."""
    import shutil

    (root / "test").mkdir(parents=True)
    for i in ids:
        for kind in ("img", "mask"):
            shutil.copy(src / f"{kind}_{i:02d}.tif",
                        root / "test" / f"{kind}_{i:02d}.tif")
    return root


def held_against_plain(out_dir, label_type, th_cell=0.0, th_seed=0.0):
    """The masks an evaluation wrote equal the plain post-processing of the
    raw maps it saved beside them, and are not all empty; -> instances per
    frame."""
    from microbeseg_torch.ops.postprocessing import (
        _boundary_postprocessing, _distance_postprocessing)
    from microbeseg_torch.utils.tiff import imread

    n_inst = []
    for mask_path in sorted(out_dir.glob("mask*.tif")):
        raw = torch.from_numpy(imread(out_dir / mask_path.name.replace(
            "mask", "raw"))).cuda()
        if label_type == "distance":
            plain = _distance_postprocessing(
                raw[1], raw[0], th_seed, th_cell, max_seeds=256,
                **plain_kernels())
        else:
            plain = _boundary_postprocessing(raw.movedim(0, -1),
                                             max_seeds=256, **plain_kernels())
        mask = imread(mask_path)
        if not np.array_equal(mask, plain.cpu().numpy()):
            raise AssertionError(f"evaluation mask {mask_path.name} differs "
                                 "from the plain post-processing of its raw "
                                 "maps")
        n_inst.append(len(np.unique(mask)) - 1)
    if not n_inst or max(n_inst) < 1:
        raise AssertionError(f"{label_type} evaluation: every mask is empty")
    return n_inst


def scores_recomputed(out_dir, gt_dir, cfg):
    """``scores.csv`` equals the port's metrics on the written masks: the
    AJI+ column as it reads after one pass through pandas' float parser
    (the extra columns' rewrite), the extra columns as written."""
    import csv

    from microbeseg_torch.evaluation.evaluator import _pandas_float
    from microbeseg_torch.evaluation.metrics import (
        get_fast_aji, get_fast_aji_plus, get_fast_dice_2, get_fast_pq,
        remap_label)
    from microbeseg_torch.utils.image import border_correction
    from microbeseg_torch.utils.tiff import imread

    fns = {"aji": get_fast_aji, "dice": get_fast_dice_2,
           "pq": lambda t, p: get_fast_pq(t, p)[0][2]}
    with open(out_dir / "scores.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    for row in rows:
        name = row["test image"] + ".tif"
        t = remap_label(border_correction(imread(gt_dir / name),
                                          cfg.border_width))
        p = remap_label(border_correction(imread(out_dir / name),
                                          cfg.border_width))
        want = {"aji+": get_fast_aji_plus(t, p) if p.max() > 0 else 0.0}
        want.update({m: fns[m](t, p) if p.max() > 0 else 0.0
                     for m in cfg.extra_metrics})
        if cfg.extra_metrics:
            want["aji+"] = _pandas_float(repr(want["aji+"]))
        for col, v in want.items():
            if row[col] != repr(v):
                raise AssertionError(f"scores.csv {row['test image']} "
                                     f"{col}: {row[col]} != {v!r}")
    return len(rows)


def grid_held_against_plain(out_dir, th_pairs):
    """Every slot of ``distance_postprocessing_grid``'s batch, with the
    kernels, on each raw map saved in ``out_dir``, equals the plain
    post-processing of that slot's pair alone; -> frames checked."""
    from microbeseg_torch.ops.postprocessing import (
        _distance_postprocessing, distance_postprocessing_grid)
    from microbeseg_torch.utils.tiff import imread

    raws = sorted(out_dir.glob("raw*.tif"))
    for raw_path in raws:
        raw = torch.from_numpy(imread(raw_path)).cuda()
        masks = distance_postprocessing_grid(
            raw[1], raw[0], np.asarray(th_pairs, np.float32)).cpu().numpy()
        for (th_cell, th_seed), mask in zip(th_pairs, masks):
            plain = _distance_postprocessing(
                raw[1], raw[0], th_seed, th_cell, max_seeds=256,
                **plain_kernels())
            if not np.array_equal(mask, plain.cpu().numpy()):
                raise AssertionError(
                    f"grid slot ({th_cell}, {th_seed}) on {raw_path.name} "
                    "differs from the plain post-processing of that pair")
    return len(raws)


EVAL_STAGES = ("load_model", "_predict_raw_dev",
               "distance_postprocessing_grid", "imwrite", "imread",
               "get_fast_aji_plus", "_extra_scores", "_zip_test_set")


def stage_seconds(fn, names):
    """Host seconds spent inside each named function during one call of
    ``fn`` (cProfile's cumulative time, so nested stages overlap), and the
    call's wall seconds under the profiler."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(fn)
    wall = time.perf_counter() - t0
    out = dict.fromkeys(names, 0.0)
    for (_, _, func), (_, _, _, cum, _) in pstats.Stats(prof).stats.items():
        if func in out:
            out[func] += cum
    return dict(wall_s=wall, **out)

def eval_path(dev, report, model, profile=False):
    """Phase 9: the evaluator (``Evaluator``, ``cli.evaluate``) on the
    in-repo real test sets, from a checkpoint of the seeded model."""
    import scipy
    import tempfile

    from microbeseg_torch.cli import evaluate as cli_evaluate
    from microbeseg_torch.config import EvalConfig, ModelConfig, TrainConfig
    from microbeseg_torch.evaluation.evaluator import Evaluator
    from microbeseg_torch.inference.engine import InferenceEngine
    from microbeseg_torch.kernels import _build
    from microbeseg_torch.models.io import save_model
    from microbeseg_torch.utils.tiff import imread

    glut = REAL / "real_glutamicum"
    out = {"scipy": scipy.__version__}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        set1 = test_set(tmp / "glutamicum", glut, range(40, 50))
        set2 = test_set(tmp / "wt", REAL / "real_wt" / "test", (0, 1))
        ckpt = save_model(model, TrainConfig(model=ModelConfig(),
                                             run_name="eval_01"),
                          tmp / "models")
        bmodel = boundary_model(
            6, dev, np.stack([imread(glut / f"img_{i:02d}.tif")
                              for i in range(4)]))
        bckpt = save_model(bmodel, TrainConfig(
            model=ModelConfig(unet_type="U", ch_out=3), label_type="boundary",
            loss="ce", run_name="eval_bnd_01"), tmp / "models")
        frames1 = np.stack([imread(p) for p in sorted(
            (set1 / "test").glob("img*.tif"))])
        # a 4 x 2 grid from the model's own fields on the test frames,
        # rounded as the refine round rounds its points
        levels = field_levels(InferenceEngine(model, "distance", device=dev),
                              frames1, (0.1, 0.2, 0.3, 0.4), (0.4, 0.6))
        th_cells, th_seeds = (tuple(round(t, 4) for t in ts) for ts in levels)
        cfg = EvalConfig(th_cells=th_cells, th_seeds=th_seeds,
                         refine_steps=1, extra_metrics=("aji", "dice", "pq"),
                         save_raw_pred=True)
        bcfg = EvalConfig(save_raw_pred=True)
        runs = {}
        torch.cuda.synchronize()
        _build.reset_launches()
        for name, data, c, ck in (("glutamicum", set1, cfg, ckpt),
                                  ("wt", set2, cfg, ckpt),
                                  ("wt_boundary", set2, bcfg, bckpt)):
            said = []
            t0 = time.perf_counter()
            rows = Evaluator(c, text_output=said.append,
                             device=None).evaluate(
                data, tmp / "results" / name, [ck])
            seconds = time.perf_counter() - t0
            if rows is None or len(rows) != 1:
                raise AssertionError(f"evaluation {name}: {rows}")
            # the refine round names the points it adds
            refined = sum(int(re.search(r"testing (\d+) neighbors",
                                        m).group(1))
                          for m in said if m.startswith("Refine"))
            runs[name] = dict(seconds=seconds, refined_points=refined,
                              row=rows[0], data=data, cfg=c,
                              res=tmp / "results" / name
                              / f"models_{ck.stem}")
        argv = ["-d", str(set2), "-m", str(ckpt), "-r",
                str(tmp / "results" / "cli"),
                "--th_cells", *map(repr, th_cells[:2]),
                "--th_seeds", *map(repr, th_seeds), "--metrics", "pq"]
        t0 = time.perf_counter()
        rc = cli_evaluate.main(argv)
        cli_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        if rc != 0 or not (tmp / "results" / "cli.csv").is_file():
            raise AssertionError(f"cli.evaluate: exit {rc}")
        for name in ("flood_packed", "ranked_components"):
            if launches[name] == 0:
                raise AssertionError(f"kernel {name} was not launched on the "
                                     "evaluation path")
        for name in ("flood_packed_cluster", "flood_tiled_grid",
                     "sequentialize_components"):
            if launches[name]:
                raise AssertionError(f"{name} ran on the evaluation path")
        # where the time of the first run goes: the same run again, under
        # cProfile, after the launches were read
        stages = stage_seconds(lambda: Evaluator(cfg, device=None).evaluate(
            set1, tmp / "results" / "profiled", [ckpt]),
            EVAL_STAGES) if profile else None

        for name, r in runs.items():
            row, res = r["row"], r["res"]
            gt = r["data"] / "test"
            label_type = "boundary" if "boundary" in name else "distance"
            r["instances_per_frame"] = held_against_plain(
                res, label_type, row["th_cell"], row["th_seed"])
            r["scored_frames"] = scores_recomputed(res, gt, r["cfg"])
            if label_type == "distance":
                r["grid_frames_held"] = grid_held_against_plain(
                    res, list(itertools.product(th_cells, th_seeds)))
            n_frames = len(list(gt.glob("img*.tif")))
            r["ms_per_frame"] = r["seconds"] * 1e3 / n_frames
            r.update(best=[row["th_cell"], row["th_seed"]],
                     aji_plus=row["aji+ (mean)"])
            for k in ("row", "res", "data", "cfg"):
                del r[k]
    g = runs["glutamicum"]
    g["grid_points"] = len(th_cells) * len(th_seeds) + g["refined_points"]
    g["ms_per_frame_and_grid_point"] = g["ms_per_frame"] / g["grid_points"]
    out.update(runs=runs, cli_s=cli_s, launches=launches,
               th_cells=th_cells, th_seeds=th_seeds,
               glutamicum_stage_s=stages)
    report["eval_path"] = out
    print(f"evaluation: scipy {scipy.__version__}; glutamicum 40-49 (10 "
          f"frames of 256^2, {g['grid_points']} grid points with the refine "
          f"round's {g['refined_points']}) "
          f"{g['seconds']:.3f} s = {g['ms_per_frame']:.2f} ms a frame, "
          f"{g['ms_per_frame_and_grid_point']:.3f} ms a frame and grid "
          f"point; wt (2 frames, 320x318 and 240x198) "
          f"{runs['wt']['seconds']:.3f} s; boundary on wt "
          f"{runs['wt_boundary']['seconds']:.3f} s; cli.evaluate "
          f"{cli_s:.3f} s; best thresholds and AJI+ "
          f"{ {k: (v['best'], v['aji_plus']) for k, v in runs.items()} }; "
          f"instances/frame "
          f"{ {k: v['instances_per_frame'] for k, v in runs.items()} }; "
          + (f"the glutamicum run again under cProfile, host s by stage "
             f"(nested) { {k: round(v, 4) for k, v in stages.items()} }; "
             if stages else "") +
          f"launches flood_packed {launches['flood_packed']}, "
          f"ranked_components {launches['ranked_components']}; masks equal "
          "the plain post-processing of the saved raw maps, and so does "
          "each slot of the 8-pair grid batch on them; scores.csv equals "
          "the metrics recomputed", flush=True)
    return launches



LABEL_TYPES = ("boundary", "border", "j4", "adapted_border", "cell_dist",
               "cell_dist_clipped", "distance")


def labels_path(dev, report):
    """Phase 10: label generation (``create_labels``, ``get_label``) on the
    50 masks of ``data/real_glutamicum``; then K3 alone on the gap masks
    that path gives it."""
    import shutil
    import tempfile

    from microbeseg_torch.kernels import _build
    from microbeseg_torch.ops import cc, labelgen
    from microbeseg_torch.training.workers import create_labels
    from microbeseg_torch.utils.tiff import imread

    glut = REAL / "real_glutamicum"
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for split, ids in (("train", range(40)), ("val", range(40, 50))):
            (tmp / split).mkdir()
            for i in ids:
                shutil.copy(glut / f"mask_{i:02d}.tif", tmp / split)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        if not create_labels(tmp, "distance"):
            raise AssertionError("create_labels refused the tree")
        seconds = time.perf_counter() - t0
        n_files = len(list(tmp.rglob("*_dist_*.tif")))
        if n_files != 100:
            raise AssertionError(f"create_labels wrote {n_files} of 100 "
                                 "label files")
        label = imread(tmp / "val" / "neighbor_dist_40.tif")
        if label.dtype != np.float32 or not np.isfinite(label).all():
            raise AssertionError("neighbour-distance label not finite float32")

        # every label type on 4 masks: the card's result against the CPU's
        errs, masks = {}, [imread(glut / f"mask_{i:02d}.tif")
                           for i in (0, 17, 33, 45)]
        for t in LABEL_TYPES:
            errs[t] = 0.0
            for m in masks:
                mal = labelgen.max_major_axis_length(m)
                if mal != labelgen.max_major_axis_length(m, device="cpu"):
                    raise AssertionError("max_major_axis_length: card "
                                         "differs from the CPU")
                got = labelgen.get_label(m, t, max_mal=mal)
                want = labelgen.get_label(m, t, max_mal=mal, device="cpu")
                pairs = zip(got, want) if t == "distance" else [(got, want)]
                for a, b in pairs:
                    if a.dtype != b.dtype or a.shape != m.shape:
                        raise AssertionError(f"{t}: {a.dtype} {a.shape}")
                    err = float(np.abs(a.astype(np.float64) - b).max())
                    errs[t] = max(errs[t], err)
            tol = 0.0 if t in ("boundary", "border", "j4",
                               "adapted_border") else 1e-5
            if errs[t] > tol:
                raise AssertionError(f"{t} labels: card differs from the CPU "
                                     f"by {errs[t]} (tolerance {tol})")
        launches = dict(_build.LAUNCHES)
    if launches["connected_components"] == 0:
        raise AssertionError("kernel connected_components was not launched "
                             "on the label path")

    # one mask's distance labels: the host's time against the device time
    # of the kernels it launches
    m = masks[0]
    mal = labelgen.max_major_axis_length(m)
    split = host_and_device(
        lambda: labelgen.get_label(m, "distance", max_mal=mal), reps=5)
    split["device_ms"] = sum(split["device_us"].values()) / 1e3
    split["top_device_us"] = dict(sorted(
        split.pop("device_us").items(), key=lambda kv: -kv[1])[:5])

    # K3 alone on the gap masks of the path (the bottom hat of one mask)
    gaps = []
    real_cc = cc.connected_components

    def recording(mask, *args, **kwargs):
        gaps.append(mask.clone())
        return real_cc(mask, *args, **kwargs)

    cc.connected_components = recording
    try:
        labelgen.get_label(m, "distance", max_mal=mal)
    finally:
        cc.connected_components = real_cc
    gap = gaps[0][None]
    if tuple(gap.shape) != (1, SIDE, SIDE) or not gap.any():
        raise AssertionError(f"gap mask {tuple(gap.shape)}, "
                             f"{int(gap.sum())} px")
    for conn in (1, 2):
        want = cc.connected_components_plain(gap, conn)
        for route in (cc.connected_components,
                      cc.connected_components_threepass):
            err = (route(gap, conn).to(torch.int64) - want).abs().max().item()
            if err:
                raise AssertionError(f"K3 ({route.__name__}) on the gap "
                                     f"mask: max abs err {err}")
    px = gap.numel()
    t_bytes = px * (1 + 4) / HBM_BYTES_PER_S * 1e3
    t_ops = px * 8 / INT_OPS_PER_S * 1e3
    turns = k3_turns(gap, 200, 3)
    k3_host = k3_split(gap)
    floor = launch_floor(dev)
    for name, ms in (("connected_components", "ms"),
                     ("connected_components_threepass", "threepass_ms")):
        k3 = report["kernels"][name]
        for key in ("ms", "plain_ms", "bound_ms", "bound_by"):
            k3[key + "_b16"] = k3[key]
        k3.update(shape=[1, SIDE, SIDE], gap_px=int(gap.sum()),
                  ms=turns[ms], plain_ms=turns["plain_ms"],
                  bound_ms=max(t_bytes, t_ops),
                  bound_by="bytes" if t_bytes >= t_ops else "operations")
    k3 = report["kernels"]["connected_components"]
    k3.update(turns_gap=turns["turns"], launch_floor=floor, **k3_host)
    old = report["kernels"]["connected_components_threepass"]
    out.update(seconds=seconds, ms_per_mask=seconds * 1e3 / 50,
               card_vs_cpu_max_abs_err=errs, launches=launches,
               get_label_distance=split)
    report["labels_path"] = out
    print(f"labels: create_labels 'distance' on 50 masks of {SIDE}^2 in "
          f"{seconds:.3f} s = {out['ms_per_mask']:.2f} ms a mask; card vs "
          f"CPU max abs err {errs}; one mask's get_label 'distance': "
          f"{split['host_ms']:.3f} ms of host time, its kernels "
          f"{split['device_ms']:.3f} ms of device time (largest, us: "
          f"{split['top_device_us']}); launches connected_components "
          f"{launches['connected_components']}", flush=True)
    print(f"K3 on the path's gap mask (1 x {SIDE}^2, {k3['gap_px']} px set), "
          f"in turns: tiled kernel {k3['ms']:.5f} ms, three-pass route "
          f"{old['ms']:.5f} ms (turns {k3['turns_gap']}), plain "
          f"{k3['plain_ms']:.4f} ms, bound {k3['bound_ms']:.7f} ms "
          f"({k3['bound_by']}); host enqueue / device us: tiled "
          f"{k3['host_ms']:.5f} ms / {k3['device_us']}, three-pass "
          f"{k3['threepass_host_ms']:.5f} ms / {k3['threepass_device_us']}; "
          f"launch floor through ctypes (event ms, host ms, device us): "
          f"{floor}", flush=True)
    for key in ("b16", "320", "2048", "4096"):
        print(f"K3 at {key}: tiled {k3['ms_' + key]:.5f} ms, three-pass "
              f"{old['ms_' + key]:.5f} ms, plain "
              f"{k3['plain_ms_' + key]:.4f} ms, bound "
              f"{k3['bound_ms_' + key]:.6f} ms", flush=True)
    return launches


GLUT_SPLITS = {"train": range(0, 35), "val": range(35, 40),
               "test": range(40, 50)}
TRAIN_STEP_TOL64 = 1e-9      # one float64 step, card vs CPU: worst leaf's
#                              update error over the CPU update's norm
TRAIN_STEP_F32_FLOOR = 1e-6  # float32: card <= 2 x CPU's error + this
TRAIN_EPOCHS = 12       # the default phase's first run; the second takes 1


def stage_glutamicum(root: Path) -> Path:
    """``data/real_glutamicum`` in the trainset layout of
    scripts/real_data_eval.py: train 0-34, val 35-39, test 40-49, the
    images' polarity inverted (the cells bright, as the engine expects)."""
    from microbeseg_torch.utils.tiff import imread_page, imwrite

    glut = REAL / "real_glutamicum"
    for split, ids in GLUT_SPLITS.items():
        (root / split).mkdir(parents=True, exist_ok=True)
        for i in ids:
            img = imread_page(glut / f"img_{i:02d}.tif", 0)
            mask = imread_page(glut / f"mask_{i:02d}.tif", 0)
            imwrite(root / split / f"img_{i:02d}.tif",
                    (65535 - img).astype(np.uint16))
            imwrite(root / split / f"mask_{i:02d}.tif",
                    mask.astype(np.uint16))
    return root


def conv_flops(model, x) -> int:
    """Multiply-add FLOPs of every convolution of one forward on ``x``,
    from the layer shapes (2 per multiply-add)."""
    from torch import nn

    total = [0]

    def hook(m, inputs, out):
        k = m.kernel_size[0] * m.kernel_size[1]
        if isinstance(m, nn.ConvTranspose2d):
            i = inputs[0]
            total[0] += (2 * i.shape[0] * i.shape[2] * i.shape[3]
                         * m.in_channels * m.out_channels * k)
        else:
            total[0] += 2 * out.numel() * m.in_channels * k

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    try:
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            model(x)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def loss_history(path: Path):
    """(epoch, train, val) rows of each run's block of ``{run}_loss.txt``."""
    blocks, rows = [], []
    for line in path.read_text().splitlines():
        if line.startswith("#"):
            continue
        if not line.strip():
            if rows:
                blocks.append(rows)
            rows = []
            continue
        e, tr, va = (float(v) for v in line.split(","))
        rows.append((int(e), tr, va))
    if rows:
        blocks.append(rows)
    return blocks


def step_card_vs_cpu(data, tmp):
    """One training step of the path's model and batch (the full-width
    DUNet, batch 4 of the crop size) with fixed augmentation parameters, on
    the card and on the CPU from the same weights, held leaf by leaf: each
    parameter's update as the norm of its difference over the norm of the
    reference's update, the worst leaf reported.  (A first Ranger step is
    lr times the centred gradient, so each leaf's gradient is held on its
    own scale.)

    - The augmentation on the card against the CPU's.
    - float64 on both devices from the CPU's augmented batch: every leaf
      within ``TRAIN_STEP_TOL64`` of the CPU's.  This holds that the card
      computes the CPU's step.
    - float32 on both devices, each held against the float64 CPU step:
      every leaf of the card's within twice the CPU's own float32 error on
      that leaf plus ``TRAIN_STEP_F32_FLOOR``, and the loss within 1e-5 of
      the CPU's.  float32 is held against the exact step and not card
      against CPU alone: GroupNorm scales near 1.0 take first updates of a
      few float32 ulps of 1.0, so their stored updates are off the exact
      step by percents on either device."""
    from microbeseg_torch.config import ModelConfig, TrainConfig
    from microbeseg_torch.ops.augment import apply_params, draw_params
    from microbeseg_torch.training.optimizers import build_optimizer
    from microbeseg_torch.training.trainer import Trainer, init_like_flax

    cfg = TrainConfig(model=ModelConfig(act_fun="mish", normalization="gn"),
                      compute_dtype="float32", run_name="step_check")
    n, size = cfg.batch_size, data.crop_size
    images = torch.from_numpy(data.train.images[:n].copy())
    labels = {k: torch.from_numpy(v[:n].copy())
              for k, v in data.train.labels.items()}
    params = draw_params(torch.Generator().manual_seed(5), n, size)
    aug = {dev: apply_params(images.to(dev),
                             {k: v.to(dev) for k, v in labels.items()},
                             params, cfg.label_type)
           for dev in ("cpu", "cuda")}
    aug_err = max([float((aug["cuda"][0].cpu() - aug["cpu"][0]).abs().max())]
                  + [float((aug["cuda"][1][k].cpu() - v).abs().max())
                     for k, v in aug["cpu"][1].items()])
    if not aug_err <= 1e-6:
        raise AssertionError(f"the augmentation on the card vs the CPU's: "
                             f"max abs err {aug_err} (tolerance 1e-6)")

    steps, init, names = {}, None, None
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev, dt in itertools.product(("cpu", "cuda"),
                                         (torch.float64, torch.float32)):
            tr = Trainer(cfg, tmp / f"step_{dev}", device=dev)
            if init is None:
                init = {k: v.clone() for k, v in
                        init_like_flax(tr.model, 0).state_dict().items()}
            tr.model.to(dt)
            tr.model.load_state_dict(init)
            tr.optimizer = build_optimizer(cfg, tr.model)[0]
            names = [k for k, _ in tr.model.named_parameters()]
            before = [p.detach().cpu().double().clone()
                      for p in tr.model.parameters()]
            t0 = time.perf_counter()
            loss = float(tr.forward_backward(
                aug["cpu"][0].to(dev, dt),
                {k: v.to(dev, dt) for k, v in aug["cpu"][1].items()},
                torch.ones(n, device=dev, dtype=dt)))
            tr.optimizer.step()
            upd = [p.detach().cpu().double() - b for p, b in zip(
                tr.model.parameters(), before)]
            steps[dev, dt] = (loss, upd, time.perf_counter() - t0)
            del tr
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32

    ref_loss, ref, _ = steps["cpu", torch.float64]

    def leaf_err(upd):
        return [float((a - b).norm() / b.norm()) if float(b.norm()) > 0
                else (0.0 if float(a.norm()) == 0 else float("inf"))
                for a, b in zip(upd, ref)]

    def worst(errs):
        i = int(np.argmax(errs))
        return names[i], errs[i]

    e64 = leaf_err(steps["cuda", torch.float64][1])
    e32_card = leaf_err(steps["cuda", torch.float32][1])
    e32_cpu = leaf_err(steps["cpu", torch.float32][1])
    excess = [c - (2 * p + TRAIN_STEP_F32_FLOOR)
              for c, p in zip(e32_card, e32_cpu)]
    l64 = abs(steps["cuda", torch.float64][0] - ref_loss) / abs(ref_loss)
    l32 = (abs(steps["cuda", torch.float32][0] - steps["cpu", torch.float32][0])
           / abs(steps["cpu", torch.float32][0]))
    out = dict(
        batch=n, size=size, leaves=len(names), augmentation_max_abs_err=aug_err,
        f64_worst_leaf=worst(e64), f64_median_leaf=float(np.median(e64)),
        f64_loss_rel_err=l64, f64_tolerance=TRAIN_STEP_TOL64,
        f32_card_worst_leaf=worst(e32_card),
        f32_card_median_leaf=float(np.median(e32_card)),
        f32_cpu_worst_leaf=worst(e32_cpu),
        f32_cpu_median_leaf=float(np.median(e32_cpu)),
        f32_worst_excess=worst(excess), f32_floor=TRAIN_STEP_F32_FLOOR,
        f32_loss_card=steps["cuda", torch.float32][0],
        f32_loss_cpu=steps["cpu", torch.float32][0], f32_loss_rel_err=l32,
        step_s={f"{d}_{str(t)[6:]}": v[2] for (d, t), v in steps.items()})
    if not (max(e64) <= TRAIN_STEP_TOL64 and l64 <= 1e-12):
        raise AssertionError(f"one float64 step, card vs CPU: {out}")
    if not (max(excess) <= 0 and l32 <= 1e-5):
        raise AssertionError(f"one float32 step, card vs the float64 step: "
                             f"{out}")
    return out


def step_times(tr, data, reps=4):
    """A full-width bf16 training step (batch 4 of 256^2) timed in turns:
    whole step, augmentation, forward + backward, optimizer step (CUDA
    events); the host's enqueue time of a step beside the device time of
    its kernels (``torch.profiler``); both ``up_impl`` variants of the
    upsampling, in turns; the step's share of the bf16 peak."""
    from torch.profiler import ProfilerActivity, profile

    from microbeseg_torch.models.unet import build_unet
    from microbeseg_torch.ops.augment import apply_params, draw_params
    from microbeseg_torch.training.optimizers import build_optimizer

    cfg = tr.cfg
    gen = torch.Generator().manual_seed(11)
    cache = tr._device_cache(data.train)
    idx = np.arange(cfg.batch_size, dtype=np.int32)
    w = np.ones(cfg.batch_size, np.float32)
    images, labels, weights = tr._batch(cache, idx, w)
    size = data.crop_size

    def whole():
        tr.train_step(images, labels, weights,
                      draw_params(gen, cfg.batch_size, size))

    def aug():
        return apply_params(images, labels,
                            draw_params(gen, cfg.batch_size, size),
                            cfg.label_type)

    aug_out = aug()

    def fwd_bwd():
        tr.forward_backward(aug_out[0], aug_out[1], weights)

    def opt():
        tr.optimizer.step()

    parts = dict(step=whole, augment=aug, forward_backward=fwd_bwd,
                 optimizer=opt)
    times = {k: [] for k in parts}
    for _ in range(reps):
        for k, fn in parts.items():
            times[k].append(cuda_ms(fn, 5, warmup=1))
    ms = {k: statistics.median(v) for k, v in times.items()}

    # host enqueue of one step (queue drained before each) against the
    # device time of its kernels
    host = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whole()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            whole()
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():   # names that share 80 characters add up
        if ev.device_time_total > 0 and not ev.key.startswith(
                ("aten::", "Activity Buffer")):
            kernels[ev.key[:80]] = (kernels.get(ev.key[:80], 0.0)
                                    + ev.device_time_total / 5)
    device_ms = sum(kernels.values()) / 1e3
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:8])

    flops = 3 * conv_flops(tr.model, aug()[0])

    # up_impl: 'conv' (nn.ConvTranspose2d) against 'matmul' (_MatmulUp),
    # same weights, forward + backward + step timed in turns
    matmul = build_unet(cfg.model, up_impl="matmul").to(
        tr.device, memory_format=torch.channels_last)
    matmul.load_state_dict(tr.model.state_dict())
    variants = {"conv": (tr.model, tr.optimizer),
                "matmul": (matmul, build_optimizer(cfg, matmul)[0])}
    up_ms = {k: [] for k in variants}
    keep = tr.model, tr.optimizer
    try:
        for _ in range(reps):
            for impl, (m, o) in variants.items():
                tr.model, tr.optimizer = m, o
                up_ms[impl].append(cuda_ms(
                    lambda: (fwd_bwd(), opt()), 5, warmup=1))
    finally:
        tr.model, tr.optimizer = keep
    up = {k: statistics.median(v) for k, v in up_ms.items()}
    return dict(ms=ms, ms_all=times,
                host_enqueue_ms=statistics.median(host),
                device_ms=device_ms, top_device_us=top,
                n_kernel_names=len(kernels), conv_flops_per_step=flops,
                peak_share=flops / (ms["step"] * 1e-3) / BF16_FLOPS_PER_S,
                up_impl_ms=up, up_impl_ms_all=up_ms)


def train_path(dev, report, quality=False):
    """Phase 11: training.  ``create_labels`` on the glutamicum split, then
    ``run_training`` as ``cli.train`` runs it (the flagship DUNet, Ranger,
    mish, gn, batch 4, bf16) for up to 12 + 1 epochs; the best checkpoint
    segments the test frames in the engine.  Then one float32 step card vs
    CPU, the step timed by part, and with ``quality`` the protocol at 60
    epochs scored by the ``Evaluator`` (AJI+ on frames 40-49)."""
    import tempfile

    from microbeseg_torch.config import ModelConfig, TrainConfig
    from microbeseg_torch.inference.engine import InferenceEngine
    from microbeseg_torch.kernels import _build
    from microbeseg_torch.config import read_sidecar
    from microbeseg_torch.models.io import load_model
    from microbeseg_torch.training.data import TrainingData
    from microbeseg_torch.training.trainer import Trainer
    from microbeseg_torch.training.workers import create_labels, run_training
    from microbeseg_torch.utils.tiff import imread

    out = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        trainset = stage_glutamicum(tmp / "trainset_real")
        models = tmp / "models"
        said, stamps = [], []

        def record(msg):
            said.append(msg)
            stamps.append((time.perf_counter(), msg))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        if not create_labels(trainset, "distance", text_output=said.append):
            raise AssertionError("create_labels refused the glutamicum split")
        labels_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        if not run_training(trainset, models, "distance", 1, "ranger", 4,
                            text_output=record, max_epochs=TRAIN_EPOCHS):
            raise AssertionError(f"run_training failed: {said[-5:]}")
        fit_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        ckpt = models / "distance_model_01.ckpt"
        side = read_sidecar(models / "distance_model_01.json")
        blocks = loss_history(models / "distance_model_01_loss.txt")
        first = blocks[0]
        best_val = min(v for _, _, v in first)
        if not best_val < first[0][2]:
            raise AssertionError(f"validation loss never fell below epoch "
                                 f"1's {first[0][2]}: {first}")
        model, _ = load_model(ckpt)
        frames = np.stack([imread(p) for p in sorted(
            (trainset / "test").glob("img*.tif"))])
        masks = InferenceEngine(model, "distance").segment(frames)
        launches = dict(_build.LAUNCHES)
        n_inst = [len(np.unique(m)) - 1 for m in masks]
        if masks.shape != frames.shape or max(n_inst) == 0:
            raise AssertionError(f"the trained model's masks: {masks.shape}, "
                                 f"instances {n_inst}")
        if launches["connected_components"] == 0:
            raise AssertionError("kernel connected_components was not "
                                 "launched by the label step")

        data = TrainingData.from_directory(trainset, "distance")
        out["step_card_vs_cpu"] = step_card_vs_cpu(data, tmp)
        cfg = TrainConfig(model=ModelConfig(act_fun="mish",
                                            normalization="gn"),
                          batch_size=4, run_name="timing",
                          max_epochs=TRAIN_EPOCHS)
        tr = Trainer(cfg, tmp / "timing")
        tr.model.load_state_dict(model.state_dict())
        from microbeseg_torch.training.optimizers import build_optimizer
        tr.optimizer = build_optimizer(cfg, tr.model)[0]
        out["step"] = step_times(tr, data)
        del tr

        epochs = side["trained_epochs"] + side.get("trained_epochs_run2", 0)
        # wall s between the trainer's messages: each epoch, and the end of
        # each run (the checkpoint's write) after its last epoch
        marks = [(t, m) for t, m in stamps if "Loss train" in m
                 or m.startswith(("Training completed", "Train/validate",
                                  "Start 2nd run"))]
        gaps = [(round(b - a, 4), m) for (a, _), (b, m) in zip(marks,
                                                              marks[1:])]
        epoch_gaps = [g for (g, m), (_, prev) in zip(gaps, marks)
                      if "Loss train" in m and "Loss train" in prev]
        out["message_gaps_s"] = [g for g, _ in gaps]
        out.update(
            labels_s=labels_s, fit_s=fit_s, peak_mem_gib=peak_gib,
            trained_epochs=side["trained_epochs"],
            trained_epochs_run2=side.get("trained_epochs_run2"),
            training_time_s=side["training_time"],
            training_time_run_2_s=side.get("training_time_run_2"),
            ms_per_epoch=statistics.median(epoch_gaps) * 1e3,
            ms_per_epoch_with_setup_and_writes=(
                side["training_time"] + side.get("training_time_run_2", 0.0))
            * 1e3 / epochs,
            val_epoch1=first[0][2], val_best=best_val,
            loss_history=blocks, instances_per_test_frame=n_inst,
            launches=launches)
        out["phase_s"] = time.perf_counter() - t_phase
        if quality:
            out["quality"] = train_quality(trainset, tmp / "quality")
    report["train_path"] = out
    st = out["step"]
    print(f"training on {report['card']}: create_labels on the 40 "
          f"train/val masks "
          f"{labels_s:.3f} s; run_training (flagship DUNet, Ranger, mish, "
          f"gn, batch 4, bf16) {out['trained_epochs']} + "
          f"{out['trained_epochs_run2']} epochs in {fit_s:.3f} s "
          f"({out['ms_per_epoch']:.2f} ms between two epochs: 9 steps + val), peak "
          f"{peak_gib:.2f} GiB; val loss epoch 1 {out['val_epoch1']:.5f} -> "
          f"best {best_val:.5f}; test-frame instances {n_inst}; step ms "
          f"(median of turns) { {k: round(v, 4) for k, v in st['ms'].items()} }"
          f"; host enqueue {st['host_enqueue_ms']:.3f} ms vs device "
          f"{st['device_ms']:.3f} ms a step; "
          f"{st['conv_flops_per_step'] / 1e12:.4f} TFLOP a step = "
          f"{100 * st['peak_share']:.2f}% of 989 TFLOP/s; up_impl ms "
          f"{ {k: round(v, 4) for k, v in st['up_impl_ms'].items()} }; one "
          f"step card vs CPU (batch 4 of 256^2, leaf by leaf) "
          f"{out['step_card_vs_cpu']}; "
          f"launches connected_components {launches['connected_components']}"
          f"; the phase {out['phase_s']:.1f} s"
          + (f"; quality {out['quality']}" if quality else ""), flush=True)
    return launches


def train_quality(trainset: Path, tmp: Path) -> dict:
    """The protocol of scripts/real_data_eval.py on the port: the flagship
    (mish, gn, Ranger, batch 8) trained 60 epochs on frames 0-34 (val
    35-39), scored by the ``Evaluator`` on frames 40-49 with the extended
    seed grid."""
    from microbeseg_torch.config import EvalConfig, ModelConfig, TrainConfig
    from microbeseg_torch.evaluation.evaluator import Evaluator
    from microbeseg_torch.training.data import TrainingData
    from microbeseg_torch.training.trainer import Trainer

    cfg = TrainConfig(model=ModelConfig(act_fun="mish", normalization="gn"),
                      optimizer="ranger", batch_size=8,
                      run_name="real_model_01", max_epochs=60)
    models = tmp / "models" / "trainset_real"
    t0 = time.perf_counter()
    Trainer(cfg, models).fit(TrainingData.from_directory(trainset,
                                                         "distance"))
    fit_s = time.perf_counter() - t0
    ev = Evaluator(EvalConfig(th_seeds=(0.35, 0.45, 0.55, 0.65, 0.75)))
    rows = ev.evaluate(trainset, tmp / "eval", [models / cfg.run_name])
    if not rows:
        raise AssertionError("the evaluation of the trained model gave no "
                             "scores")
    best = max(rows, key=lambda r: r["aji+ (mean)"])
    return dict(fit_s=fit_s, aji_mean=best["aji+ (mean)"],
                aji_std=best["aji+ (std)"], th_cell=best["th_cell"],
                th_seed=best["th_seed"])


DP_RANK_TIMEOUT_S = 300.0


def dp_batch(rng, n=4, size=SIDE):
    """A training batch of the path's shape: blob frames as raw images,
    labels drawn around them, all weights 1, and one augmentation draw."""
    from microbeseg_torch.ops.augment import draw_params

    images = blob_frames(rng, n, size).astype(np.float32)[..., None]
    labels = {"border_label": rng.uniform(0, 0.5, images.shape).astype(
        np.float32),
        "cell_label": (images > 10000).astype(np.float32)}
    return (images, labels, np.ones(n, np.float32),
            draw_params(torch.Generator().manual_seed(7), n, size))


def dp_grad_step(trainer, images, labels, weights, params, state,
                 dtype=torch.float32):
    """One forward and backward of the global batch from ``state``: this
    rank's slice of it in a process group, the augmentation of the global
    draw applied to the slice.  -> (the global weighted mean loss, the
    gradients by name as float64 on the host, the BatchNorm running
    statistics)."""
    from microbeseg_torch.ops.augment import apply_params, take_params
    from microbeseg_torch.parallel import mesh
    from microbeseg_torch.training.optimizers import build_optimizer

    dev = trainer.device
    trainer.model.to(dtype)
    trainer.model.load_state_dict(state)
    trainer.optimizer = build_optimizer(trainer.cfg, trainer.model)[0]
    lo, hi = trainer._rank_slice(len(weights))
    img, lab = apply_params(
        torch.from_numpy(images[lo:hi].copy()).to(dev),
        {k: torch.from_numpy(v[lo:hi].copy()).to(dev)
         for k, v in labels.items()},
        take_params(params, lo, hi), trainer.cfg.label_type)
    loss_sum = trainer.forward_backward(
        img.to(dtype), {k: v.to(dtype) for k, v in lab.items()},
        torch.from_numpy(weights[lo:hi].copy()).to(dev, dtype))
    loss = float(mesh.all_reduce(loss_sum)) / max(float(weights.sum()), 1.0)
    grads = {n: p.grad.detach().double().cpu()
             for n, p in trainer.model.named_parameters()}
    stats = {n: b.detach().double().cpu()
             for n, b in trainer.model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    return loss, grads, stats


def dp_gloo_rank(rank, world, init_method, out, cfg, batch, state):
    """One of two ranks on the one card, joined over gloo (NCCL refuses two
    ranks on one device): ``dp_grad_step`` saved to ``{out}/rank{r}.pt``."""
    from microbeseg_torch.parallel import mesh
    from microbeseg_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    mesh.init_process_group(rank, world, init_method, dev, backend="gloo")
    try:
        tr = Trainer(cfg, Path(out) / "models", device=dev)
        if not tr.distributed:
            raise AssertionError("the gloo rank's trainer is not in its group")
        torch.save(dp_grad_step(tr, *batch, state),
                   Path(out) / f"rank{rank}.pt")
    finally:
        mesh.destroy_process_group()


def leaf_rel_err(got, ref):
    """Per leaf: the norm of the difference over the norm of ``ref``."""
    return {k: (float((got[k] - r).norm() / r.norm()) if float(r.norm()) > 0
                else float(got[k].norm())) for k, r in ref.items()}


def dp_training(dev, tmp):
    """The trainer under a process group on the card, at the flagship's
    full width with 'bn' (the cross-replica BatchNorm), batch 4 of 256^2:

    - world 1 over NCCL (DDP) against the plain ``Trainer``, float32, TF32
      off: each gradient leaf no further from the plain float64 step than
      twice the plain float32 step's error plus ``TRAIN_STEP_F32_FLOOR``
      (PR 9's bar), the loss within 1e-5;
    - two ranks on the card over gloo (spawned processes), one step each,
      against the plain float32 step at the CPU test's tolerances
      (gradients and statistics rtol 1e-3, atol 1e-5; loss rtol 1e-5);
    - the DDP step (world 1, NCCL) and the plain step in bf16, in turns:
      forward + backward + optimizer, device ms (CUDA events), the host's
      enqueue ms and the device time of the kernels (``torch.profiler``)."""
    from microbeseg_torch.config import ModelConfig, TrainConfig
    from microbeseg_torch.models.blocks import CrossReplicaBatchNorm2d
    from microbeseg_torch.models.unet import build_unet
    from microbeseg_torch.ops.augment import apply_params
    from microbeseg_torch.parallel import mesh
    from microbeseg_torch.training.optimizers import build_optimizer
    from microbeseg_torch.training.trainer import Trainer, init_like_flax

    cfg = TrainConfig(model=ModelConfig(act_fun="mish", normalization="bn"),
                      compute_dtype="float32", run_name="dp_check")
    batch = dp_batch(np.random.default_rng(41))
    state = init_like_flax(build_unet(cfg.model), 0).state_dict()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        steps = {}
        for dt in (torch.float64, torch.float32):
            steps[dt] = dp_grad_step(Trainer(cfg, tmp / "plain", device=dev),
                                     *batch, state, dtype=dt)
        (tmp / "nccl").mkdir()
        mesh.init_process_group(0, 1, mesh.file_init_method(tmp / "nccl"),
                                dev)
        try:
            tr = Trainer(cfg, tmp / "ddp", device=dev)
            if not (tr.distributed and isinstance(
                    tr.net, torch.nn.parallel.DistributedDataParallel)):
                raise AssertionError("the trainer did not wrap DDP")
            n_sync = sum(isinstance(m, CrossReplicaBatchNorm2d)
                         for m in tr.model.modules())
            if not n_sync:
                raise AssertionError("no cross-replica BatchNorm under DDP")
            ddp = dp_grad_step(tr, *batch, state)
            backend = torch.distributed.get_backend()
            del tr
        finally:
            mesh.destroy_process_group()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    ref64, plain32 = steps[torch.float64], steps[torch.float32]
    e_ddp = leaf_rel_err(ddp[1], ref64[1])
    e_plain = leaf_rel_err(plain32[1], ref64[1])
    excess = {k: e_ddp[k] - (2 * e_plain[k] + TRAIN_STEP_F32_FLOOR)
              for k in e_ddp}
    loss_rel = abs(ddp[0] - plain32[0]) / abs(plain32[0])
    worst = max(excess, key=excess.get)
    out = dict(backend=backend, cross_replica_bn_layers=n_sync,
               leaves=len(e_ddp), loss_ddp=ddp[0], loss_plain=plain32[0],
               loss_rel_err=loss_rel,
               ddp_worst_leaf=(worst, e_ddp[worst], e_plain[worst]),
               ddp_median_leaf=float(np.median(list(e_ddp.values()))),
               plain_median_leaf=float(np.median(list(e_plain.values()))),
               stats_max_abs_diff=max(float((ddp[2][k] - plain32[2][k])
                                            .abs().max()) for k in ddp[2]))
    if not (excess[worst] <= 0 and loss_rel <= 1e-5):
        raise AssertionError(f"the world-1 DDP step vs the plain step: {out}")

    # two ranks over gloo on the card
    gloo_dir = tmp / "gloo"
    gloo_dir.mkdir()
    t0 = time.perf_counter()
    mesh.spawn(dp_gloo_rank, (2, mesh.file_init_method(gloo_dir),
                              str(gloo_dir), cfg, batch, state), 2,
               timeout_s=DP_RANK_TIMEOUT_S)
    out["gloo_two_ranks_s"] = time.perf_counter() - t0
    gloo_err = []
    for r in range(2):
        loss, grads, stats = torch.load(gloo_dir / f"rank{r}.pt",
                                        weights_only=False)
        if not np.isclose(loss, plain32[0], rtol=1e-5):
            raise AssertionError(f"gloo rank {r}: loss {loss} vs "
                                 f"{plain32[0]}")
        for name, ref in [*((k, (grads[k], plain32[1][k])) for k in grads),
                          *((k, (stats[k], plain32[2][k])) for k in stats)]:
            got, want = ref
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3,
                                       atol=1e-5, err_msg=f"gloo rank {r}: "
                                       f"{name}")
            gloo_err.append(float((got - want).abs().max()))
    out["gloo_max_abs_err"] = max(gloo_err)

    # the DDP step against the plain step, bf16, in turns
    tcfg = TrainConfig(model=ModelConfig(act_fun="mish", normalization="bn"),
                       run_name="dp_timing")
    images, labels, weights, params = batch
    plain = Trainer(tcfg, tmp / "t_plain", device=dev)
    aug = apply_params(torch.from_numpy(images).to(dev),
                       {k: torch.from_numpy(v).to(dev)
                        for k, v in labels.items()}, params, tcfg.label_type)
    w = torch.from_numpy(weights).to(dev)
    (tmp / "nccl_t").mkdir()
    mesh.init_process_group(0, 1, mesh.file_init_method(tmp / "nccl_t"), dev)
    try:
        ddp_tr = Trainer(tcfg, tmp / "t_ddp", device=dev)
        variants = {}
        for name, tr in (("plain", plain), ("ddp", ddp_tr)):
            tr.model.load_state_dict(state)
            tr.optimizer = build_optimizer(tcfg, tr.model)[0]
            variants[name] = (lambda tr=tr: (tr.forward_backward(
                aug[0], aug[1], w), tr.optimizer.step()))
        times = {k: [] for k in variants}
        for _ in range(4):
            for k, fn in variants.items():
                times[k].append(cuda_ms(fn, 5, warmup=1))
        host, device = {}, {}
        for k, fn in variants.items():
            host[k], device[k] = step_host_and_device_ms(fn)
        del ddp_tr
    finally:
        mesh.destroy_process_group()
    out.update(step_ms={k: statistics.median(v) for k, v in times.items()},
               step_ms_all=times, host_enqueue_ms=host, device_ms=device)
    return out


def dp_path(dev, report, model):
    """Phase 15: data parallelism on the one card.  ``InferenceEngine(mesh=
    get_mesh(1))`` against the engine without a mesh on 16 crops of 256^2
    and on one 2048^2 frame, tiled (counters from 0 around the mesh engine's
    calls): the predictions and masks bit for bit; then ``segment`` timed
    in turns with and without the mesh; then ``dp_training``; then
    ``run_training`` with ``num_devices=1`` and ``None`` on a small
    glutamicum split (2 epochs, cuDNN deterministic): the same checkpoint."""
    import tempfile

    from microbeseg_torch.config import InferConfig
    from microbeseg_torch.inference.engine import InferenceEngine
    from microbeseg_torch.kernels import _build
    from microbeseg_torch.models.io import load_variables
    from microbeseg_torch.parallel import mesh
    from microbeseg_torch.training.workers import create_labels, run_training

    t_phase = time.perf_counter()
    out = {"mesh": [str(d) for d in mesh.get_mesh().devices]}
    m1 = mesh.get_mesh(1)
    rng = np.random.default_rng(31)
    launches = {k: 0 for k in _build.LAUNCHES}
    seg_ms = {}
    for name, cfg, frames, must in (
            ("crops", InferConfig(), blob_frames(rng, B, SIDE),
             ("flood_packed", "ranked_components")),
            ("frame", InferConfig(use_tiling=True),
             big_blob_frames(rng, 1, BIG, BIG_BLOBS),
             ("flood_tiled", "ranked_components"))):
        plain = InferenceEngine(model, "distance", cfg=cfg, device=dev)
        meshed = InferenceEngine(model, "distance", cfg=cfg, mesh=m1)
        if meshed._n_devices != 1 or meshed.device.type != "cuda":
            raise AssertionError(f"mesh engine on {meshed.device}")
        th_cell, th_seed = field_thresholds(plain, frames)
        want = plain.segment(frames, th_cell, th_seed)
        maps_plain = [p.cpu() for p in plain._predict_raw_dev(frames)]
        masks, _, got, _ = driven_segment(meshed, frames, th_cell, th_seed,
                                          must)
        for k in launches:
            launches[k] += got[k]
        maps_mesh = [p.cpu() for p in meshed._predict_raw_dev(frames)]
        if not all(torch.equal(a, b) for a, b in zip(maps_mesh, maps_plain)):
            raise AssertionError(f"dp {name}: mesh-1 predictions differ")
        if not np.array_equal(masks, want):
            raise AssertionError(f"dp {name}: mesh-1 masks differ on "
                                 f"{(masks != want).sum()} px")
        turns = {"plain": [], "mesh": []}
        for _ in range(3):
            for k, e in (("plain", plain), ("mesh", meshed)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e.segment(frames, th_cell, th_seed)
                turns[k].append((time.perf_counter() - t0) * 1e3)
        seg_ms[name] = {k: statistics.median(v) for k, v in turns.items()}
        seg_ms[name + "_all"] = turns
    out["segment_ms"] = seg_ms
    out["launches"] = launches

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        out["training"] = dp_training(dev, tmp)
        # run_training with num_devices 1 and None (every visible card)
        root = tmp / "small"
        full = stage_glutamicum(tmp / "full")
        for split, ids in (("train", range(0, 4)), ("val", range(35, 37))):
            (root / split).mkdir(parents=True)
            for i in ids:
                for kind in ("img", "mask"):
                    f = full / split / f"{kind}_{i:02d}.tif"
                    (root / split / f.name).write_bytes(f.read_bytes())
        if not create_labels(root, "distance"):
            raise AssertionError("create_labels refused the small split")
        det = (torch.backends.cudnn.deterministic,
               torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        ckpts = {}
        try:
            for n in (1, None):
                said = []
                if not run_training(root, tmp / f"m_{n}", "distance", 1,
                                    "ranger", 4, text_output=said.append,
                                    max_epochs=2, num_devices=n):
                    raise AssertionError(f"run_training(num_devices={n}): "
                                         f"{said[-3:]}")
                ckpts[n] = load_variables(tmp / f"m_{n}"
                                          / "distance_model_01.ckpt")
        finally:
            (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark) = det
        leaves_1 = tree_leaves(ckpts[1])
        leaves_n = tree_leaves(ckpts[None])
        diff = max(float(np.max(np.abs(a - b))) for a, b in
                   zip(leaves_1, leaves_n))
        if len(leaves_1) != len(leaves_n) or diff != 0.0:
            raise AssertionError(f"run_training num_devices=1 vs None: "
                                 f"checkpoints differ by {diff}")
        out["run_training_1_vs_none_max_abs_diff"] = diff
        out["run_training_leaves"] = len(leaves_1)
    out["phase_s"] = time.perf_counter() - t_phase
    report["dp_path"] = out
    tr = out["training"]
    print(f"dp on {report['card']}: mesh {out['mesh']}; mesh-1 engine bit "
          f"for bit equal to no mesh on {B} x 256^2 and 1 x 2048^2 tiled; "
          f"segment ms (median of 3 turns) "
          f"{ {k: v for k, v in seg_ms.items() if not k.endswith('_all')} }"
          f"; world-1 {tr['backend']} DDP step vs plain (float32, bn, "
          f"{tr['cross_replica_bn_layers']} cross-replica BN layers): worst "
          f"leaf {tr['ddp_worst_leaf']}, loss rel {tr['loss_rel_err']:.3g}; "
          f"2 gloo ranks on the card vs plain: max abs err "
          f"{tr['gloo_max_abs_err']:.3g} ({tr['gloo_two_ranks_s']:.1f} s); "
          f"bf16 step ms in turns {tr['step_ms']}, host enqueue ms "
          f"{tr['host_enqueue_ms']}, device ms {tr['device_ms']}; "
          f"run_training num_devices 1 vs None: equal checkpoints "
          f"({out['run_training_leaves']} leaves); launches flood_packed "
          f"{launches['flood_packed']}, flood_tiled {launches['flood_tiled']}"
          f", ranked_components {launches['ranked_components']}; phase "
          f"{out['phase_s']:.1f} s", flush=True)
    return launches


REMAT_POLICIES = (None, "dots", "nothing")
REMAT_BATCHES = (4, 16)
REMAT_TURNS = 3


def remat_models():
    """The flagship as ``run_training`` builds it (mish, gn) and as
    ``ModelConfig()`` builds it (relu, bn)."""
    from microbeseg_torch.config import ModelConfig

    return {"mish_gn": ModelConfig(act_fun="mish", normalization="gn"),
            "relu_bn": ModelConfig()}


def remat_trainer(cfg, path, dev, state, policy):
    """A ``Trainer`` whose model is built with ``remat_policy=policy``,
    loaded with ``state``, and its optimizer."""
    from microbeseg_torch.training.optimizers import build_optimizer
    from microbeseg_torch.training.trainer import Trainer

    with torch.device(dev):   # the parameters made on the card: no
        # initialisation on the host, which ``state`` overwrites anyway
        tr = Trainer(cfg, path, device=dev, remat_policy=policy)
    tr.model.load_state_dict(state)
    tr.optimizer = build_optimizer(cfg, tr.model)[0]
    return tr


def remat_steps(make, batch, policies=REMAT_POLICIES, ops=None):
    """One ``forward_backward`` of ``batch`` for each policy, on the
    trainer ``make(policy)`` returns: {policy: (outputs, gradients,
    buffers, the convolutions that ran)}.  ``ops``: a set that collects
    the names of the operators with 'conv' in them that the dispatcher
    presents, and the dtypes of the convolutions' inputs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Convolutions(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if "conv" in str(func) and ops is not None:
                ops.add(str(func))
            if func is torch.ops.aten.convolution.default:
                self.n += 1
                if ops is not None:
                    ops.add(f"input {args[0].dtype}")
            return func(*args, **(kwargs or {}))

    images, labels, weights = batch
    out = {}
    for policy in policies:
        tr = make(policy)
        preds = []
        tr.model.register_forward_hook(
            lambda m, i, o: preds.append([t.detach().clone() for t in o]))
        with Convolutions() as convs:
            tr.forward_backward(images, labels, weights)
        out[policy] = (preds[0], {n: p.grad.detach().clone() for n, p in
                                  tr.model.named_parameters()},
                       {n: b.detach().clone() for n, b in
                        tr.model.named_buffers()}, convs.n)
        del tr
    return out


def remat_bit_equal(steps, what):
    """Every policy's step equal to the plain step bit for bit: outputs,
    gradients, buffers (running statistics, ``num_batches_tracked``)."""
    ref = steps[None]
    for policy, got in steps.items():
        for part, a, b in (("output", dict(enumerate(got[0])),
                            dict(enumerate(ref[0]))),
                           ("gradient", got[1], ref[1]),
                           ("buffer", got[2], ref[2])):
            for k, y in b.items():
                x = a[k]
                if not torch.equal(x, y):
                    raise AssertionError(
                        f"remat {what}, {policy}: {part} {k} differs from "
                        f"the plain step by {float((x - y).abs().max())}")
        tracked = {int(v) for k, v in got[2].items()
                   if k.endswith("num_batches_tracked")}
        if tracked - {1}:
            raise AssertionError(f"remat {what}, {policy}: "
                                 f"num_batches_tracked {tracked}")


def remat_grad_rel(a, b):
    """The largest, over the gradient leaves, norm of the difference over
    the norm of ``b``'s leaf."""
    return max(float((a[k].double() - v.double()).norm()
                     / v.double().norm()) for k, v in b.items()
               if float(v.double().norm()) > 0)


def remat_path(dev, report):
    """Phase 17: ConvBlock-level rematerialisation (``remat_policy`` None,
    'dots', 'nothing') on the flagship at full width and depth, built as
    ``run_training`` builds it (mish, gn) and as ``ModelConfig()`` builds
    it (relu, bn), by ``Trainer(remat_policy=)``, through
    ``Trainer.forward_backward`` and Ranger:

    - float32, TF32 off, cuDNN deterministic: one step (batch 4 of 256^2)
      of each policy equals the plain step bit for bit (outputs, gradients,
      BatchNorm buffers, ``num_batches_tracked`` 1); 'dots' runs no
      convolution again, 'nothing' 2 a ConvBlock;
    - the same with 'bn' under a world-1 NCCL group (DDP, the cross-replica
      BatchNorm, whose all-reduce runs again in the recomputation);
    - bf16 autocast (the path's): the operators with 'conv' in their name
      that the dispatcher presents (the one the 'dots' policy must name),
      every convolution's input bf16 (autocast reaches the recomputation),
      again 0 and 2 a ConvBlock recomputed, and the largest relative
      gradient difference from the plain step beside that of two plain
      steps;
    - a bf16 step (forward + backward + Ranger) at batch 4 and 16 of
      256^2: the peak memory of one step of each policy, its trainer alone
      on the card (``max_memory_allocated`` after
      ``reset_peak_memory_stats``), beside what was allocated before it;
      the three policies' steps in turns (median of CUDA-event times);
      then each policy's host enqueue ms against its kernels' device ms
      (``step_host_and_device_ms``)."""
    import gc
    import tempfile

    from microbeseg_torch.config import TrainConfig
    from microbeseg_torch.kernels import _build
    from microbeseg_torch.models.blocks import ConvBlock
    from microbeseg_torch.models.unet import build_unet
    from microbeseg_torch.ops.augment import apply_params
    from microbeseg_torch.parallel import mesh
    from microbeseg_torch.training.trainer import init_like_flax

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    _build.reset_launches()
    rng = np.random.default_rng(53)
    batches = {}
    for n in REMAT_BATCHES:
        images, labels, weights, params = dp_batch(rng, n)
        img, lab = apply_params(torch.from_numpy(images).to(dev),
                                {k: torch.from_numpy(v).to(dev)
                                 for k, v in labels.items()}, params,
                                "distance")
        batches[n] = (img, lab, torch.from_numpy(weights).to(dev))
    out = {"card": report["card"]}
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name, mcfg in remat_models().items():
            res = out[name] = {}
            # float32: bit for bit, deterministic cuDNN
            f32 = TrainConfig(model=mcfg, compute_dtype="float32",
                              run_name="remat_f32")
            model = init_like_flax(build_unet(mcfg), 0)
            n_blocks = sum(isinstance(m, ConvBlock) for m in model.modules())
            state = {k: v.to(dev) for k, v in model.state_dict().items()}
            del model
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
            try:
                steps = remat_steps(lambda p: remat_trainer(
                    f32, tmp / f"{name}_f32", dev, state, p), batches[4])
                remat_bit_equal(steps, f"{name} float32")
                groups = []
                if name == "relu_bn":   # the cross-replica BatchNorm
                    (tmp / "nccl").mkdir()
                    mesh.init_process_group(
                        0, 1, mesh.file_init_method(tmp / "nccl"), dev)
                    try:
                        def make_ddp(p):
                            tr = remat_trainer(f32, tmp / "ddp", dev, state,
                                               p)
                            groups.append([
                                type(m).__name__ for m in tr.model.modules()
                                if isinstance(m, torch.nn.BatchNorm2d)])
                            return tr

                        dsteps = remat_steps(make_ddp, batches[4])
                        if {k for g in groups for k in g} != {
                                "CrossReplicaBatchNorm2d"}:
                            raise AssertionError(f"remat under NCCL: {groups}")
                        remat_bit_equal(dsteps, "relu_bn float32 NCCL")
                        res["nccl_backend"] = torch.distributed.get_backend()
                        del dsteps
                    finally:
                        mesh.destroy_process_group()
                    res["nccl_cross_replica_bn_layers"] = len(groups[0])
            finally:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32,
                 torch.backends.cudnn.deterministic,
                 torch.backends.cudnn.benchmark) = flags
            base = steps[None][3]
            res["f32_recomputed_convs"] = {str(p): steps[p][3] - base
                                           for p in REMAT_POLICIES}
            if res["f32_recomputed_convs"] != {
                    "None": 0, "dots": 0, "nothing": 2 * n_blocks}:
                raise AssertionError(f"remat {name}: recomputed convolutions "
                                     f"{res['f32_recomputed_convs']}")
            del steps

            # bf16 (the path's): operators, autocast in the recomputation,
            # gradients against two plain steps
            bf16 = TrainConfig(model=mcfg, run_name="remat_bf16")

            def make(p):
                return remat_trainer(bf16, tmp / f"{name}_bf16", dev, state,
                                     p)

            ops = set()
            steps = remat_steps(make, batches[4], ops=ops)
            again = remat_steps(make, batches[4], policies=(None,))
            conv_ops = sorted(o for o in ops if o.startswith("aten."))
            if set(conv_ops) != {"aten.convolution.default",
                                 "aten.convolution_backward.default"} or (
                    ops - set(conv_ops) != {"input torch.bfloat16"}):
                raise AssertionError(f"remat {name} bf16: operators {ops}")
            res["bf16_ops"] = sorted(ops)
            res["bf16_recomputed_convs"] = {
                str(p): steps[p][3] - steps[None][3] for p in REMAT_POLICIES}
            if res["bf16_recomputed_convs"] != res["f32_recomputed_convs"]:
                raise AssertionError(f"remat {name} bf16: recomputed "
                                     f"convolutions "
                                     f"{res['bf16_recomputed_convs']}")
            res["bf16_grad_rel"] = {
                "plain_vs_plain": remat_grad_rel(again[None][1],
                                                 steps[None][1]),
                **{p: remat_grad_rel(steps[p][1], steps[None][1])
                   for p in ("dots", "nothing")}}
            del steps, again

            for n in REMAT_BATCHES:
                images, labels, weights = batches[n]

                def stepper(tr):
                    def step():
                        tr.forward_backward(images, labels, weights)
                        tr.optimizer.step()
                    return step

                # peak memory: one policy's trainer alone, a warm-up step,
                # then the measured one
                peak = {}
                for p in REMAT_POLICIES:
                    gc.collect()
                    torch.cuda.empty_cache()
                    step = stepper(make(p))
                    step()
                    torch.cuda.synchronize()
                    held = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    step()
                    torch.cuda.synchronize()
                    peak[str(p)] = dict(
                        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                        held_gib=held / 2**30)
                    del step
                torch.cuda.empty_cache()
                # time: the three policies' trainers in turns, then each
                # step's host enqueue against its kernels' device time
                steps = {str(p): stepper(make(p)) for p in REMAT_POLICIES}
                turns = {k: [] for k in steps}
                for _ in range(REMAT_TURNS):
                    for k, step in steps.items():
                        turns[k].append(cuda_ms(step, 2, warmup=1))
                split = {}
                for k, step in steps.items():
                    host, device = step_host_and_device_ms(step, 5, 3)
                    split[k] = dict(host_enqueue_ms=host, device_ms=device)
                res[f"batch{n}"] = dict(
                    step_ms={k: statistics.median(v)
                             for k, v in turns.items()},
                    step_ms_all=turns, memory=peak, host_device=split)
                del steps
                torch.cuda.empty_cache()
    launches = dict(_build.LAUNCHES)
    out["phase_s"] = time.perf_counter() - t_phase
    report["remat_path"] = out
    for name in remat_models():
        res = out[name]
        print(f"remat {name}: float32 steps bit for bit equal across "
              f"{[str(p) for p in REMAT_POLICIES]} (recomputed convolutions "
              f"{res['f32_recomputed_convs']}"
              + (f"; also under a world-1 {res['nccl_backend']} group, "
                 f"{res['nccl_cross_replica_bn_layers']} cross-replica BN "
                 f"layers" if "nccl_backend" in res else "")
              + f"); bf16 operators {res['bf16_ops']}, recomputed "
              f"{res['bf16_recomputed_convs']}, largest relative gradient "
              f"difference {res['bf16_grad_rel']}", flush=True)
        for n in REMAT_BATCHES:
            b = res[f"batch{n}"]
            for p in REMAT_POLICIES:
                m = b["memory"][str(p)]
                hd = b["host_device"][str(p)]
                print(f"remat {name} batch {n} x 256^2 remat_policy={p}: "
                      f"step {b['step_ms'][str(p)]:.3f} ms (median of "
                      f"{REMAT_TURNS} turns, bf16, forward + backward + "
                      f"Ranger; host enqueue {hd['host_enqueue_ms']:.3f} ms, "
                      f"kernels' device time {hd['device_ms']:.3f} ms), peak "
                      f"{m['peak_gib']:.3f} GiB (held before the step "
                      f"{m['held_gib']:.3f}), on {report['card']}",
                      flush=True)
    print(f"remat phase {out['phase_s']:.1f} s", flush=True)
    return launches


def tree_leaves(tree):
    """The numpy leaves of a nested dict of arrays, in key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in
                tree_leaves(tree[k])]
    return [np.asarray(tree)]


def gui_path(dev, report, model):
    """Phase 16: the port's window (``gui.app`` on ``tests/fake_qt.py``,
    loaded by file path) on a ``LocalStore`` of glutamicum frames 40-49,
    on the card: its inference action with a checkpoint of the seeded
    flagship (counters from 0 around it), the stored masks equal to
    ``segment``'s with the window's settings; then its crop-review action
    once, with pre-labels, one crop accepted."""
    import importlib.util
    import tempfile

    from microbeseg_torch.client import workers
    from microbeseg_torch.config import ModelConfig, TrainConfig
    from microbeseg_torch.inference.engine import InferenceEngine
    from microbeseg_torch.kernels import _build
    from microbeseg_torch.models.io import save_model
    from microbeseg_torch.utils.tiff import imread

    t_phase = time.perf_counter()
    spec = importlib.util.spec_from_file_location(
        "fake_qt", Path(__file__).resolve().parent / "tests" / "fake_qt.py")
    fake_qt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fake_qt)
    fake_qt.install()
    from microbeseg_torch.client.store import LocalStore
    from microbeseg_torch.gui import app

    glut = glutamicum_test_frames()
    th_cell, th_seed = field_thresholds(
        InferenceEngine(model, "distance", device=dev), glut)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        store = LocalStore(tmp / "store")
        did = store.create_dataset("glutamicum_40_49")
        for i, f in zip(GLUT_TEST, glut):
            store.upload_image(did, f"glut_{i}.tif", f)
        tid = store.create_dataset("trainset")
        store.set_dataset_map_annotation(tid, {"crop_size": "128"})
        save_model(model, TrainConfig(model=ModelConfig(), run_name="gui_01"),
                   tmp / "models" / "trainset")
        fake_qt.QApplication([])
        win = app.MicrobeSegMainWindow(
            tmp / "store", tmp / "models", tmp / "training_dataset",
            tmp / "evaluation", tmp / "results", device=dev)
        win.dataset_box.setValue(did)
        win.trainset_box.setValue(tid)
        win.refresh_model_list()
        win.th_cell_box.setValue(round(th_cell, 3))
        win.th_seed_box.setValue(round(th_seed, 3))
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        win.buttons["Inference"].click()
        infer_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        log = win.log.toPlainText()
        if "Error" in log:
            raise AssertionError(f"gui inference: {log[-2000:]}")
        require_launches(launches, ("flood_packed", "ranked_components"),
                         "the GUI's inference")
        engine = InferenceEngine.from_checkpoint(
            tmp / "models" / "trainset" / "gui_01.ckpt",
            cfg=win._infer_config(), device=dev)
        n_inst = []
        for ref in store.list_images(did):
            if (store.get_map_annotation(ref.image_id)["inference_model"]
                    != "gui_01" or not store.get_polygons(ref.image_id)):
                raise AssertionError(f"gui: image {ref.name} not inferred")
            frame = store.get_plane(ref.image_id, 0, 0, 0)
            written = imread(tmp / "results" / (
                f"mask_{Path(ref.name).stem}_channel0.tif"))
            want = engine.segment(frame)
            if not np.array_equal(written.reshape(want.shape), want):
                raise AssertionError(f"gui: {ref.name}: stored masks differ "
                                     "from segment")
            n_inst.append(len(np.unique(want)) - 1)
        if min(n_inst) < 1:
            raise AssertionError(f"gui: frames without instances {n_inst}")

        # crop review: pre-labelled proposals, one accepted with key 1
        win.prelabel_checkbox.setChecked(True)
        before = len(store.list_images(tid))
        t0 = time.perf_counter()
        win.buttons["Create crops"].click()
        crops = list(win._crops)
        fake_qt.QShortcut.trigger("1")
        crop_s = time.perf_counter() - t0
        if not crops or len(store.list_images(tid)) != before + 1:
            raise AssertionError(f"gui crop review: {len(crops)} crops, "
                                 f"{len(store.list_images(tid)) - before} "
                                 "accepted")
        if "Crop accepted -> train" not in win.log.toPlainText():
            raise AssertionError(f"gui crop review: {win.log.toPlainText()}")
        if win._crop_gen.engine is None:
            raise AssertionError("gui crop review: no pre-label engine")
        pre = InferenceEngine.from_checkpoint(
            tmp / "models" / "trainset" / "gui_01.ckpt", device=dev)
        for c in crops:   # the GUI's pre-labels: the default thresholds
            want = [r.points for r in workers._mask_to_rois(
                pre.segment(c.img))]
            if [r.points for r in c.rois] != want:
                raise AssertionError("gui crop review: pre-labels differ "
                                     "from segment of the crop")
        win.closeEvent(None)
    out = dict(launches=launches, inference_s=infer_s, crop_review_s=crop_s,
               images=len(n_inst), instances=[min(n_inst), max(n_inst)],
               crops=len(crops), device_label=win.device_label.text(),
               thresholds=[win.th_cell_box.value(), win.th_seed_box.value()],
               phase_s=time.perf_counter() - t_phase)
    report["gui_path"] = out
    print(f"gui on {report['card']}: {out['device_label']}; inference action "
          f"on {len(n_inst)} glutamicum frames in {infer_s:.2f} s (the engine "
          f"built in the job), stored masks equal segment, instances "
          f"{out['instances']}; crop review: {len(crops)} pre-labelled "
          f"crops, one accepted, {crop_s:.2f} s; launches flood_packed "
          f"{launches['flood_packed']}, ranked_components "
          f"{launches['ranked_components']}; phase {out['phase_s']:.1f} s",
          flush=True)
    return launches


FP32_FLOPS_PER_S = 67e12    # H100 SXM, float32 outside the tensor cores
# follow_flows_kernel's float32 operations a point's step (as
# benchmark/metrics/follow_flows_roofline.py counts them)
FOLLOW_OPS_PER_STEP = 44


def check_follow(dev, report):
    """F: ``follow_flows_kernel`` alone at 2048^2, against the plain
    ``grid_sample`` loop (Cellpose's steps_interp) on the same points: a
    smooth random field's unit flows x 5 (as a network's dP) over the upper
    half of the field, some 2M points, 200 steps.  The end points (cast to
    integers) must agree on all but a few points: the kernel and grid_sample
    round the same float32 expressions, not always in the same order."""
    from microbeseg_torch.ops import flows

    side, niter = 2048, 200
    g = torch.Generator(device=dev).manual_seed(0)
    t = torch.arange(-18, 19, device=dev, dtype=torch.float32)
    k = torch.exp(-t * t / 72.0)
    k = k / k.sum()
    s = torch.randn(1, 1, side, side, generator=g, device=dev)
    s = torch.nn.functional.conv2d(s, k.view(1, 1, -1, 1), padding=(18, 0))
    s = torch.nn.functional.conv2d(s, k.view(1, 1, 1, -1), padding=(0, 18))
    s = s[0, 0]
    gy, gx = torch.gradient(s)
    mag = torch.sqrt(gy * gy + gx * gx) + 1e-12
    dP = 5.0 * torch.stack([gy, gx]) / mag
    fg = s > s.median()
    idx = torch.nonzero(fg.reshape(-1)).squeeze(1)
    n = idx.numel()
    field = flows._field(dP, fg)
    pts = flows.start_points(idx, side, side)
    got = flows.follow_flows(dP, fg, idx, niter)
    want = flows.end_pixels(flows.follow_plain(field, pts, niter), side, side)
    differ = (got != want).any(dim=1)
    max_err = int((got - want).abs().max())
    if float(differ.float().mean()) > 1e-3:
        raise AssertionError(f"follow_flows: {int(differ.sum())} of {n} end "
                             f"points differ from the plain loop")
    ms = cuda_ms(lambda: flows._follow_kernel(field, pts, niter), reps=10)
    call_ms = cuda_ms(lambda: flows.follow_flows(dP, fg, idx, niter), reps=5)
    plain_ms = cuda_ms(lambda: flows.follow_plain(field, pts, niter), reps=2,
                       warmup=1)
    b = bound(side * side * 8 + n * 16, n * niter * FOLLOW_OPS_PER_STEP,
              FP32_FLOPS_PER_S)
    r = dict(source="csrc/follow.cu: follow_flows_kernel",
             replaces="none (Cellpose's steps_interp: one grid_sample and "
             "two clamps a step)", max_abs_err=max_err, ms=ms,
             plain_ms=plain_ms, library_ms=plain_ms, call_ms=call_ms,
             points=n, steps=niter, points_differ=int(differ.sum()),
             roofline_pct=100.0 * b["bound_ms"] / ms, **b)
    report.setdefault("kernels", {})["follow_flows"] = r
    print(f"F follow_flows_kernel at {side}^2, {n} points x {niter} steps: "
          f"{ms:.3f} ms (whole call {call_ms:.3f} ms), plain grid_sample "
          f"loop {plain_ms:.2f} ms, bound {b['bound_ms']:.3f} ms "
          f"({b['bound_by']}), {r['roofline_pct']:.1f}% of it; end points "
          f"differing {r['points_differ']}, max {max_err} px", flush=True)


TENSOR_FLOPS_PER_S = 989e12   # H100 SXM, bf16 tensor cores, dense


def check_rel_attention(dev, report):
    """A: ``rel_attention_kernel`` at the cell's shape against the float32
    plain path and the path it replaced (``library_ms``: the bf16 bias of
    ``rel_pos_bias``, then ``scaled_dot_product_attention``, which the port
    no longer calls), each timed; the bound counts the two products
    (operations) and q, k, v and the output once (bytes)."""
    import torch.nn.functional as F

    from microbeseg_torch.kernels import _build
    from microbeseg_torch.models import vit_sam
    from microbeseg_torch.ops.kernels import rel_attention as ra

    B, heads, g, hd = 16, 16, 32, 64
    n = g * g
    gen = torch.Generator(device=dev).manual_seed(0)
    qkv = (0.5 * torch.randn(B, n, 3 * heads * hd, generator=gen,
                             device=dev)).to(torch.bfloat16)
    th, tw = (0.5 * torch.randn(2 * g - 1, hd, generator=gen, device=dev)
              for _ in range(2))
    q, k, v = ra.split_heads(qkv, heads)

    def replaced():
        bias = vit_sam.rel_pos_bias(q, th, tw, g)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        return out.transpose(1, 2).reshape(B, n, heads * hd)

    with torch.inference_mode():
        got = ra.rel_attention(qkv, th, tw, heads, g)
        want = ra.rel_attention_plain(qkv.float(), th, tw, heads, g)
        old = replaced()
        err = (got.float() - want).abs()
        old_err = (old.float() - want).abs()
        rms = float(want.pow(2).mean().sqrt())
        if float(err.pow(2).mean().sqrt()) > 0.01 * rms:
            raise AssertionError(f"rel_attention: RMS error "
                                 f"{float(err.pow(2).mean().sqrt())} of "
                                 f"RMS {rms}")
        times = {"ms": [], "library_ms": []}
        for name in ("ms", "library_ms", "library_ms", "ms"):
            fn = (lambda: ra.rel_attention(qkv, th, tw, heads, g)) \
                if name == "ms" else replaced
            times[name].append(cuda_ms(fn, reps=20))
        plain_ms = cuda_ms(lambda: ra.rel_attention_plain(
            qkv.float(), th, tw, heads, g), reps=3, warmup=1)
        bias = vit_sam.rel_pos_bias(q, th, tw, g)
        sdpa_alone_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=bias), reps=20)
    lib = _build.load("rel_attention")
    lib.rel_attention_shared_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    shared = lib.rel_attention_shared_bytes(hd, g)
    maps = B * heads
    b = bound(maps * 8 * n * hd, maps * 4 * n * n * hd, TENSOR_FLOPS_PER_S)
    ms, library_ms = min(times["ms"]), min(times["library_ms"])
    r = dict(source="csrc/rel_attention.cu: rel_attention_kernel",
             replaces="none (the JAX package has no vision transformer); "
             "the port's bias by rel_pos_bias and cuDNN's attention",
             shape=[B, heads, n, hd], max_abs_err=float(err.max()),
             rms_err=float(err.pow(2).mean().sqrt()), rms=rms,
             library_max_abs_err=float(old_err.max()),
             library_rms_err=float(old_err.pow(2).mean().sqrt()),
             ms=ms, turns=times, plain_ms=plain_ms, library_ms=library_ms,
             sdpa_alone_ms=sdpa_alone_ms,
             roofline_pct=100.0 * b["bound_ms"] / ms, shared_bytes=shared,
             ptxas=report.get("ptxas_rel_attention", []), **b)
    report.setdefault("kernels", {})["rel_attention"] = r
    print(f"A rel_attention_kernel at {B} x {heads} maps of {n} tokens, "
          f"head {hd}: {ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}), {r['roofline_pct']:.1f}% of it; the path it "
          f"replaced {library_ms:.4f} ms (bias + SDPA; SDPA alone "
          f"{sdpa_alone_ms:.4f}); plain {plain_ms:.3f} ms; RMS error "
          f"{r['rms_err']:.3g} against {r['library_rms_err']:.3g} of the "
          f"replaced path (output RMS {rms:.3g}); max {r['max_abs_err']:.3g}; "
          f"{shared} bytes of shared memory a block", flush=True)


def flows_path(dev, report):
    """Cellpose-SAM at its published widths through ``InferenceEngine.
    segment(label_type="flows")`` on 2048^2 frames of the benchmark's
    cpsam_tiled2048 mix (tiles of 256, overlap 56, 16 a forward), with the
    benchmark's seeded weights: the launches (follow_flows and K3, no
    fallback), the masks found against the cells drawn, a stack's seconds
    and the device seconds by stage of the port's spans."""
    from benchmark.families import cellpose_sam as fam
    from benchmark.harness import gen
    from microbeseg_torch.config import CellposeSAMConfig, InferConfig
    from microbeseg_torch.inference.engine import InferenceEngine
    from microbeseg_torch.kernels import _build
    from microbeseg_torch.models.vit_sam import build_cellpose_sam
    from microbeseg_torch.utils import profiling
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    mix = json.loads(Path("benchmark/traffic/cpsam_tiled2048.json")
                     .read_text())
    frames = gen.frames(mix, 7, 4, dev)
    cells = gen.object_counts(mix, 4, gen.generator(7, 1, dev)).tolist()
    with torch.device(dev):
        model = build_cellpose_sam(CellposeSAMConfig())
    model.load_state_dict(fam.make_weights(fam.PUBLISHED, 7, dev))
    engine = InferenceEngine(model, "flows", cfg=InferConfig(**mix["infer"]),
                             device=dev)
    engine.segment(frames[:1])
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    masks = engine.segment(frames)
    seg_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    require_launches(launches, ["follow_flows", "connected_components",
                                "rel_attention"], "the flows path")
    if launches["rel_attention"] % 24:
        raise AssertionError(f"flows path: rel_attention launched "
                             f"{launches['rel_attention']} times, not 24 a "
                             "forward")
    if launches["follow_flows_fallback"] or launches["flood_tiled"]:
        raise AssertionError(f"flows path launches: {launches}")
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        again = engine.segment(frames)
    spans = profiling.summary()
    if not np.array_equal(again, masks):
        raise AssertionError("flows path: a second call gave other masks")
    found = [int(m.max()) for m in masks]
    out = dict(launches={k: v for k, v in launches.items() if v},
               frames=len(frames), seconds=seg_s,
               mpx_per_s=masks.size / 1e6 / seg_s, cells_drawn=cells,
               masks_found=found,
               peak_bytes=torch.cuda.max_memory_allocated(dev),
               device_s={k: v["device_s"] for k, v in spans["spans"].items()},
               counters=spans["counters"],
               phase_s=time.perf_counter() - t_phase)
    report["flows_path"] = out
    print(f"flows path: {len(frames)} frames of 2048^2 in {seg_s:.2f} s "
          f"({out['mpx_per_s']:.1f} Mpx/s), masks {found} for cells drawn "
          f"{cells}; device s by span {out['device_s']}; counters "
          f"{out['counters']}; launches {out['launches']}; peak "
          f"{out['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the full report as JSON here")
    ap.add_argument("--profile-eval", action="store_true",
                    help="run the first evaluation again under cProfile "
                    "and report host seconds by stage")
    ap.add_argument("--train-quality", action="store_true",
                    help="also train the flagship 60 epochs on the "
                    "glutamicum split and score AJI+ on frames 40-49")
    ap.add_argument("--flows-only", action="store_true",
                    help="build follow.cu, cc.cu and rel_attention.cu and "
                    "run only F, A and the Cellpose-SAM flows path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from microbeseg_torch.kernels import _build

    dev = torch.device("cuda")
    card = card_line()
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    t0 = time.perf_counter()
    logs = _build.build_all(("follow", "cc", "rel_attention")
                            if args.flows_only else _build.SOURCES)
    report["build_s"] = time.perf_counter() - t0
    report["ptxas_follow"] = ptxas_report(logs.get("follow", ""),
                                          "follow_flows_kernel")
    print(f"ptxas, follow_flows_kernel: {report['ptxas_follow']}",
          flush=True)
    report["ptxas_rel_attention"] = ptxas_report(
        logs.get("rel_attention", ""), "rel_attention_kernel")
    print(f"ptxas, rel_attention_kernel: {report['ptxas_rel_attention']}",
          flush=True)
    if args.flows_only:
        check_follow(dev, report)
        check_rel_attention(dev, report)
        flows_path(dev, report)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(report, indent=1))
        print(json.dumps({"ok": True, "flows_only": True}))
        return 0
    report["ptxas"] = {k: [ln for ln in v.splitlines() if "Used" in ln]
                       for k, v in logs.items()}
    report["ptxas_k3"] = ptxas_report(logs.get("cc", ""), "cc_tile_kernel")
    print(f"ptxas, cc_tile_kernel: {report['ptxas_k3']}", flush=True)
    print(f"built {sorted(logs)} in {report['build_s']:.1f} s", flush=True)

    check_kernels(dev, report)
    check_follow(dev, report)
    check_rel_attention(dev, report)
    report["stream_handle_us"] = stream_handle_us(dev)
    print(f"stream handle for a launch, host us: "
          f"{report['stream_handle_us']}", flush=True)
    model, n_params = seeded_model(0)
    cpu_model = seeded_model(0)[0]
    crop_launches, general_launches, thresholds = main_path(
        dev, report, model, cpu_model, n_params)
    big_launches = big_path(dev, report, model)
    small_checks(dev, report, model, cpu_model, thresholds)
    int8_launches, narrow_launches = int8_path(dev, report, model, thresholds)
    cli_launches = cli_path(dev, report, model, thresholds)
    serve_launches = serve_path(dev, report, model)
    store_launches, crop_gen_launches = store_path(dev, report, model)
    ws_launches = watershed_route_path(dev, report, model, thresholds)
    eval_launches = eval_path(dev, report, model, args.profile_eval)
    label_launches = labels_path(dev, report)
    train_launches = train_path(dev, report, args.train_quality)
    dp_launches = dp_path(dev, report, model)
    gui_launches = gui_path(dev, report, model)
    remat_launches = remat_path(dev, report)
    flows_launches = flows_path(dev, report)
    report["total_s"] = time.perf_counter() - t0
    # launches: those of the full-width paths' own runs (crop, tiled frame,
    # int8 crop, int8 tiled frame, inference CLI, evaluation, labels), each
    # counted from 0.  The two side runs (K3 + the general K4 as label_fn,
    # the narrow int8 model) are kept apart under side_run_launches.
    driven = [crop_launches, big_launches, *int8_launches, cli_launches,
              serve_launches, store_launches, crop_gen_launches,
              eval_launches, label_launches, train_launches, dp_launches,
              gui_launches, remat_launches, flows_launches]
    launches = {k: sum(d[k] for d in driven) for k in _build.LAUNCHES}
    if launches["watershed_route"]:
        raise AssertionError("the watershed route ran on a main path")
    side = {k: general_launches[k] + narrow_launches[k]
            + sum(d[k] for d in ws_launches) for k in _build.LAUNCHES}
    report["launches_by_path"] = dict(zip(
        ("crops", "frames", "int8_crops", "int8_frame", "cli", "serve",
         "store", "crop_generator", "eval", "labels", "train", "dp",
         "gui", "remat", "flows"), driven))
    kernels = [dict(name=name, route="cuda", source=r["source"],
                    replaces=r["replaces"], launches=launches[name],
                    side_run_launches=side[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"],
                    **{k: v for k, v in r.items()
                       if k.endswith(("_320", "_2048", "_4096", "_b16"))
                       or k.startswith(("turns", "threepass_")) or k in (
                           "gap_px", "launch_floor", "device_kernels",
                           "ptxas",
                           "shape", "shapes", "host_ms", "device_us",
                           "steps_per_image", "us_per_step", "sides",
                           "setup_ms", "setup_and_levels_ms",
                           "empty_step_us", "steps", "sizes",
                           "planes_ms", "call_ms", "points",
                           "points_differ", "roofline_pct", "rms_err",
                           "library_rms_err", "sdpa_alone_ms",
                           "shared_bytes")})
               for name, r in report["kernels"].items()]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
