"""Readings that the ``cpsam-tiled2048`` cell's limits are set from, on the
card: its compared numbers for a sound run, for the float8 control in the
port's place, and for faults planted in the port.

    python3 scripts/cpsam_readings.py --seeds 1 2 --variants sound control \
        drop_rel_pos skip_flow_check half_niter [--seconds 3]

- ``control``: the reference network with every layer's operands rounded to
  8-bit floats in the port's place (``benchmark/entries/segment_flows.py``);
- ``drop_rel_pos``: the port's attention without the decomposed
  relative-position term (the card's attention kernel,
  ``models/vit_sam.rel_attention``, is handed zero tables);
- ``skip_flow_check``: the port's post-processing without the flow check;
- ``half_niter``: the port's post-processing with half the Euler steps.

One JSON line a run (variant, seed, the compared numbers, the masks found
against the cells drawn); all in one process.
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CELL = "cpsam-tiled2048"


def plant(variant: str):
    """Patch the port for ``variant``; returns the undo."""
    import torch
    from microbeseg_torch.inference import engine
    from microbeseg_torch.models import vit_sam
    from microbeseg_torch.ops import flows

    if variant == "drop_rel_pos":
        owner, name = vit_sam, "rel_attention"
        orig_attention = vit_sam.rel_attention

        def patched(qkv, rel_pos_h, rel_pos_w, heads, g):
            return orig_attention(qkv, torch.zeros_like(rel_pos_h),
                                  torch.zeros_like(rel_pos_w), heads, g)
    elif variant == "skip_flow_check":
        owner, name = flows, "remove_bad_flow_masks"

        def patched(labels, dP, threshold):
            return labels
    elif variant == "half_niter":
        owner, name = engine, "flows_postprocessing"
        orig_post = flows.flows_postprocessing

        def patched(dP, cellprob, cfg):
            return orig_post(dP, cellprob,
                             dataclasses.replace(cfg, niter=cfg.niter // 2))
    elif variant in ("sound", "control"):
        return lambda: None
    else:
        raise ValueError(f"unknown variant {variant!r}")
    orig = getattr(owner, name)
    setattr(owner, name, patched)
    return lambda: setattr(owner, name, orig)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=["sound"])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch
    from benchmark.harness.common import Cell
    from benchmark.harness.core import run

    for variant in args.variants:
        for seed in args.seeds:
            undo = plant(variant)
            t0 = time.perf_counter()
            try:
                out = run(Cell(CELL), seed, args.seconds, False, "cuda", t0,
                          control=variant == "control",
                          log=lambda *a: None)
            finally:
                undo()
            print(json.dumps({
                "variant": variant, "seed": seed, "correct": out["correct"],
                "seconds": time.perf_counter() - t0,
                "checks": {k: v["value"] for k, v in out["checks"].items()},
                "readings": out["readings"]}), flush=True)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
