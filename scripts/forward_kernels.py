#!/usr/bin/env python3
"""The device kernels of one tiled ``InferenceEngine.segment`` call, by the
chain of ATen operators that launched each.

    python3 scripts/forward_kernels.py [--seed 1] [--out kernels.json]

Needs a CUDA card (exits 1 without one).  Runs what the benchmark's cell
``dunet-tiled2048`` runs: the configuration ``dunet_relu_bn`` with the
benchmark's seeded weights, an engine with the cell's settings (tiled, tile
512, overlap 64) and one stack of its 2048^2 frames
(``benchmark/harness``); warms the engine with one call and profiles the
next with ``torch.profiler``.  Each kernel, memcpy and memset is attributed
to the ATen operators open on the host thread that launched it (outermost
first, joined by " > "), or to "(no operator)" for a launch outside any,
such as a hand-written kernel's through ``ctypes``.  Prints the card, then one line a
(operator chain, kernel) pair, most device time first: seconds, launches,
the chain and the kernel's whole name; ``--out`` writes the same as JSON.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import subprocess
import sys
import tempfile
from collections import defaultdict
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def by_operator(events):
    """{(operator chain, kernel name): [seconds, launches]}."""
    launch = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launch[c] = e
    ops = defaultdict(list)
    for e in events:
        if e.get("cat") == "cpu_op" and e.get("ph") == "X" \
                and e.get("name", "").startswith("aten::"):
            ops[(e.get("pid"), e.get("tid"))].append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
    for v in ops.values():
        v.sort()
    starts = {k: [s for s, _, _ in v] for k, v in ops.items()}
    out = defaultdict(lambda: [0.0, 0])
    for k in events:
        if k.get("cat") not in DEVICE_CATS or k.get("ph") != "X":
            continue
        r = launch.get(k.get("args", {}).get("correlation"))
        chain = "(no operator)"
        if r is not None:
            key = (r.get("pid"), r.get("tid"))
            t = float(r["ts"])
            iv = ops.get(key, [])
            i = bisect.bisect_right(starts.get(key, []), t)
            # the operators open at t, among the last few hundred to start
            names = [n for s, e, n in iv[max(0, i - 400):i] if s <= t <= e]
            if names:
                chain = " > ".join(names)
        out[(chain, k["name"])][0] += float(k["dur"]) * 1e-6
        out[(chain, k["name"])][1] += 1
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("forward_kernels: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness import common, gen, weights
    from microbeseg_torch.config import InferConfig, ModelConfig
    from microbeseg_torch.inference.engine import InferenceEngine
    from microbeseg_torch.models.unet import build_unet

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    bench = Path(__file__).resolve().parents[1] / "benchmark"
    mcfg = common.model_config(common.load_json(
        bench / "configs" / "dunet_relu_bn.json"))
    mix = common.load_json(bench / "traffic" / "tiled2048.json")
    dev = torch.device("cuda")
    with torch.device(dev):
        model = build_unet(ModelConfig(**mcfg))
    model.load_state_dict(weights.make(mcfg, args.seed, dev, "averaging"))
    engine = InferenceEngine(model, "distance", cfg=InferConfig(
        **mix["infer"]), device=dev)
    frames = gen.frames(mix, args.seed, mix["stack"], dev)
    engine.segment(frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.segment(frames)
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    rows = sorted(([chain, name, s, n] for (chain, name), (s, n)
                   in by_operator(events).items()), key=lambda r: -r[2])
    print(card)
    for chain, name, s, n in rows:
        print(f"{s:9.5f} s {n:6d}  {chain}  |  {name}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "seed": args.seed, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
