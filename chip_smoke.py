#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``microbeseg_torch``) on one GPU.

    python3 chip_smoke.py [--out results.json]

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels from ``microbeseg_torch/csrc`` (one nvcc per
   source, in parallel).
3. Holds each kernel (K1 flood, K3 connected components, K4 rank relabel)
   exactly against its plain PyTorch version on the card, at the main
   path's shapes (16 x 256^2) on seeded blob fields and a speckle field,
   and times kernel, plain version and, for K4, the one-call PyTorch gather
   that computes the same function, with CUDA events.
4. Builds the full-width distance DUNet (filters 64 -> 1024, bn, relu, conv
   pooling) with numpy-seeded weights and runs ``InferenceEngine.segment``
   on 48 uint16 frames of 256^2 (3 batches of 16), with every launch
   counter set to 0 just before and read just after.  Checks that each
   kernel launched, that no out-of-memory fallback was taken, that the
   masks hold instances, that the plain post-processing on the card gives
   the same masks from the same predictions, and that the bf16 forward on
   the card agrees with a float32 CPU forward of the same weights on a
   small input.
5. Times ``segment`` (crops/s) and its forward and post-processing parts.

The next-to-last line of stdout is a JSON object with one entry per kernel,
the last line ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero before the result lines.  Without CUDA it exits 1 at once.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

B, SIDE, N_FRAMES = 16, 256, 48
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
# H100 SXM int32 rate: 132 SMs x 64 results per clock for 32-bit integer
# add, compare, min and max (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0) x 1.98 GHz boost clock
INT_OPS_PER_S = 132 * 64 * 1.98e9


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


def seeded_model(seed: int):
    """Full-width distance DUNet with numpy-drawn weights.  Conv kernels are
    non-negative and sum to 1 per output channel (weighted averages), so the
    fields follow the frames' blobs instead of turning into speckle; norm
    affines and running statistics are drawn around 1 and 0."""
    from microbeseg_torch.config import ModelConfig
    from microbeseg_torch.models.unet import build_unet

    rng = np.random.default_rng(seed)
    model = build_unet(ModelConfig())
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

    # K3 connected components: blob seeds and a speckle field
    seeds_bin = cell > 0.6
    for conn in (1, 2):
        for field in (seeds_bin, speckle):
            exact("K3", cc.connected_components(field, conn),
                  cc.connected_components_plain(field, conn))
    labels = cc.connected_components(seeds_bin)
    labels_speckle = cc.connected_components(speckle)
    k3_ms = cuda_ms(lambda: cc.connected_components(seeds_bin), 50)
    k3_plain = cuda_ms(lambda: cc.connected_components_plain(seeds_bin), 3,
                       warmup=1)
    results["connected_components"] = dict(
        source="microbeseg_torch/csrc/cc.cu",
        replaces="microbeseg_tpu/ops/pallas/propagate.py:133",
        max_abs_err=0, ms=k3_ms, plain_ms=k3_plain, library_ms=None,
        bytes=px * (1 + 4), ops=px * 8)

    # K4 rank relabel: CC ids of both fields, and 4-connected ids
    for lab in (labels, labels_speckle, cc.connected_components(speckle, 1)):
        exact("K4", cc.sequentialize_components(lab),
              cc.sequentialize_components_plain(lab))
    ranks = cc.sequentialize_components(labels)
    k4_ms = cuda_ms(lambda: cc.sequentialize_components(labels), 50)
    k4_plain = cuda_ms(lambda: cc.sequentialize_components_plain(labels), 3,
                       warmup=1)
    # the same function as one PyTorch call on CC ids: gather the root ranks
    table = torch.cat([torch.zeros((B, 1), dtype=torch.int32, device=dev),
                       cc._root_ranks(labels).view(B, -1)], dim=1)
    idx = labels.view(B, -1).to(torch.int64)
    exact("K4 gather", torch.gather(table, 1, idx).view(B, SIDE, SIDE),
          ranks)
    lib_ms = cuda_ms(lambda: torch.gather(table, 1, idx), 50)
    results["sequentialize_components"] = dict(
        source="microbeseg_torch/csrc/cc.cu",
        replaces="microbeseg_tpu/ops/pallas/propagate.py:161",
        max_abs_err=0, ms=k4_ms, plain_ms=k4_plain, library_ms=lib_ms,
        bytes=px * (4 + 4), ops=px * 8)

    # K1 flood: 12-bit keys as on the main path, and 24-bit keys
    mask = cell > 0.1
    for bits, offset in ((12, 0), (24, 5000)):
        markers = torch.where(ranks > 0, ranks + offset, 0)
        exact("K1", flood.flood_packed(-cell, markers, mask, label_bits=bits),
              flood.flood_packed_plain(-cell, markers, mask,
                                       label_bits=bits))
    # the work this run's data needs: the candidate pixels (in the mask,
    # active at the level, still unlabelled) that the steps examined
    steps = torch.empty((B,), dtype=torch.int32, device=dev)
    work = torch.zeros((B,), dtype=torch.int64, device=dev)
    flood.flood_packed(-cell, ranks, mask, steps_out=steps, work_out=work)
    n_steps = int(steps.sum().item())
    n_work = int(work.sum().item())
    in_mask = mask.view(B, -1).sum(dim=1).to(torch.int64)
    if not 0 < n_work <= int((steps.to(torch.int64) * in_mask).sum()):
        raise AssertionError(f"K1 work count {n_work} out of range")
    k1_ms = cuda_ms(lambda: flood.flood_packed(-cell, ranks, mask), 20)
    k1_plain = cuda_ms(lambda: flood.flood_packed_plain(-cell, ranks, mask),
                       2, warmup=1)
    # per candidate pixel and step: 3 mins over the 4 neighbour keys, 1
    # compare with the level's threshold, 1 and + 1 or to re-key
    results["flood_packed"] = dict(
        source="microbeseg_torch/csrc/flood.cu",
        replaces="microbeseg_tpu/ops/pallas/flood.py:171",
        max_abs_err=0, ms=k1_ms, plain_ms=k1_plain, library_ms=None,
        bytes=px * (4 + 4 + 1 + 4), ops=n_work * 6,
        steps_per_image=n_steps / B, candidates_per_image=n_work / B,
        in_mask_share=float(in_mask.sum()) / px)
    for r in results.values():
        t_bytes = r.pop("bytes") / HBM_BYTES_PER_S * 1e3
        t_ops = r.pop("ops") / INT_OPS_PER_S * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    report["kernels"] = results
    print(f"kernels exact vs plain at {B}x{SIDE}^2; flood ran "
          f"{n_steps / B:.1f} steps and examined {n_work / B:.1f} candidate "
          f"pixels per image", flush=True)
    for name, r in results.items():
        print(f"{name}: {r['ms']:.5f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']})", flush=True)


def main_path(dev, report):
    """Phase 4 and 5: the full-width engine through segment."""
    from microbeseg_torch.config import InferConfig
    from microbeseg_torch.inference.engine import InferenceEngine
    from microbeseg_torch.kernels import _build
    from microbeseg_torch.ops import cc
    from microbeseg_torch.ops.kernels import flood
    from microbeseg_torch.ops.postprocessing import (
        _distance_postprocessing, distance_postprocessing)

    def plain_flood(value, markers, mask, n_levels, max_label):
        bits = flood.packed_label_bits(max(value.shape[-2:]), n_levels,
                                       max_label)
        return flood.flood_packed_plain(value, markers, mask,
                                        n_levels=n_levels, label_bits=bits)

    model, n_params = seeded_model(0)
    cpu_model = seeded_model(0)[0]
    engine = InferenceEngine(model, "distance", cfg=InferConfig(),
                             device=dev)
    rng = np.random.default_rng(2)
    frames = blob_frames(rng, N_FRAMES, SIDE)
    warm = blob_frames(rng, B, SIDE)

    # thresholds from the fields of held-out frames: random weights have no
    # trained scale.  The background is one flat level (the median) and
    # the blobs rise above it; the mask takes the top 80% of that rise,
    # the seeds the top 50% of the seed field's rise.
    border_w, cell_w = engine.predict_raw(warm)
    if not (np.isfinite(border_w).all() and np.isfinite(cell_w).all()):
        raise AssertionError("non-finite predictions")
    borders = np.tan(np.clip(border_w, 0, 1) ** 2)
    borders = np.clip(np.where(borders < 0.05, 0, borders), 0, 1)

    def level(field, frac):
        bg, top = np.median(field), np.quantile(field, 0.995)
        return float(bg + frac * (top - bg))

    th_cell = level(cell_w, 0.2)
    th_seed = level(cell_w - borders, 0.5)
    engine.segment(warm, th_cell, th_seed)   # warm-up (cuDNN, kernels)
    torch.cuda.synchronize()

    _build.reset_launches()
    t0 = time.perf_counter()
    masks = engine.segment(frames, th_cell, th_seed)
    first_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")
    if engine.oom_count:
        raise AssertionError(f"{engine.oom_count} out-of-memory fallbacks")
    if masks.shape != frames.shape or masks.dtype != np.uint16:
        raise AssertionError(f"masks {masks.shape} {masks.dtype}")
    n_inst = [len(np.unique(m)) - 1 for m in masks]
    if min(n_inst) < 1:
        raise AssertionError(f"frames without instances: {n_inst}")

    # same predictions -> kernel post-processing == plain post-processing
    border, cell = engine._predict_bucket(frames)
    if not (torch.isfinite(border).all() and torch.isfinite(cell).all()):
        raise AssertionError("non-finite predictions")
    kern = engine.postprocess(border, cell, th_cell, th_seed)
    plain = np.concatenate([
        _distance_postprocessing(
            border[s:s + B], cell[s:s + B], th_seed, th_cell, max_seeds=256,
            cc_fn=cc.connected_components_plain,
            rank_fn=cc.sequentialize_components_plain,
            flood_fn=plain_flood).cpu().numpy()
        for s in range(0, N_FRAMES, B)])
    if not np.array_equal(kern, plain):
        raise AssertionError("post-processing: kernels differ from plain "
                             f"on {(kern != plain).sum()} px")
    same_as_segment = float((kern == masks).mean())

    # bf16 forward on the card vs float32 forward on the CPU, small input
    small = blob_frames(rng, 2, 64)
    ref_eng = InferenceEngine(cpu_model, "distance", device="cpu")
    ref = ref_eng.predict_raw(small)
    got = engine.predict_raw(small)
    rel = max(float(np.abs(g - r).max() / np.abs(r).max())
              for g, r in zip(got, ref))
    if not rel < 0.05:
        raise AssertionError(f"bf16 card forward vs f32 CPU: rel err {rel}")

    # timing: segment end to end, and its two device stages per batch
    seg_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine.segment(frames, th_cell, th_seed)
        seg_s.append(time.perf_counter() - t0)
    chunk = frames[:B]
    fwd_ms = cuda_ms(lambda: engine._predict_bucket(chunk), 10)
    b16, c16 = engine._predict_bucket(chunk)
    post_ms = cuda_ms(lambda: distance_postprocessing(
        b16, c16, th_seed, th_cell, max_seeds=256), 10)
    seg_med = statistics.median(seg_s)
    report["main_path"] = dict(
        model="DUNet filters (64, 1024) bn relu conv, bf16 autocast",
        params=n_params, frames=[N_FRAMES, SIDE, SIDE], batch=B,
        launches=launches, instances_per_frame=n_inst,
        segment_first_s=first_s, segment_s=seg_s,
        crops_per_s=N_FRAMES / seg_med, forward_ms_per_batch=fwd_ms,
        postprocess_ms_per_batch=post_ms,
        kernel_masks_equal_segment_masks=same_as_segment,
        bf16_vs_f32_rel_err=rel, th_cell=th_cell, th_seed=th_seed,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"segment: {N_FRAMES} crops of {SIDE}^2 in {seg_med:.4f} s = "
          f"{N_FRAMES / seg_med:.1f} crops/s; forward {fwd_ms:.3f} ms and "
          f"post-processing {post_ms:.3f} ms per batch of {B}; "
          f"launches {launches}; instances/frame {min(n_inst)}-"
          f"{max(n_inst)}", flush=True)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the full report as JSON here")
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
    logs = _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    report["ptxas"] = {k: [ln for ln in v.splitlines() if "Used" in ln]
                       for k, v in logs.items()}
    print(f"built {sorted(logs)} in {report['build_s']:.1f} s", flush=True)

    check_kernels(dev, report)
    launches = main_path(dev, report)
    kernels = [dict(name=name, route="cuda", source=r["source"],
                    replaces=r["replaces"], launches=launches[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"])
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
