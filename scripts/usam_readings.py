"""Readings that the ``usam-vitl-tiled2048`` cell's limits are set from, on
the card: its compared numbers for a sound run, for the float8 control in
the port's place, and for faults planted in the port.

    python3 scripts/usam_readings.py --seeds 1 2 --variants sound control \
        drop_rel_pos edge_padding decoder_no_norm sampler_zeroed \
        [--seconds 3] [--mix PATH_MIX HEAD_MIX]

- ``control``: the reference network with every layer's operands rounded to
  8-bit floats in the port's place (``benchmark/entries/segment_ais.py``);
- ``drop_rel_pos``: the port's attention without the decomposed
  relative-position term (the card's attention kernel,
  ``models/vit_sam.rel_attention``, is handed zero tables);
- ``edge_padding``: the windowed blocks' pad filled with the map's last
  row and column of tokens instead of zeros (so the padded keys and
  values repeat real ones, not the qkv bias);
- ``decoder_no_norm``: the UNETR decoder's third level
  (``decoder.blocks.2``) without its second instance norm;
- ``sampler_zeroed``: the decoder's second sampler
  (``decoder.samplers.1``) giving zeros.

``--mix`` sets the seeded weights' ``PATH_MIX`` and ``HEAD_MIX``
(``benchmark/families/micro_sam.py``) for the whole run, port and
reference alike.  One JSON line a run (variant, seed, the compared numbers, the masks found
against the cells drawn); all in one process.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CELL = "usam-vitl-tiled2048"


def plant(variant: str):
    """Patch the port for ``variant``; returns the undo."""
    import torch
    from microbeseg_torch.models import unetr, vit_sam

    if variant in ("decoder_no_norm", "sampler_zeroed"):
        owner, name = unetr.MicroSAMAIS, "__init__"
        orig_init = unetr.MicroSAMAIS.__init__

        def patched(self, *args, **kwargs):
            orig_init(self, *args, **kwargs)
            if variant == "decoder_no_norm":
                self.decoder.blocks[2].block[3] = torch.nn.Identity()
            else:
                self.decoder.samplers[1].register_forward_hook(
                    lambda mod, a, out: torch.zeros_like(out))
    elif variant == "drop_rel_pos":
        owner, name = vit_sam, "rel_attention"
        orig_attention = vit_sam.rel_attention

        def patched(qkv, rel_pos_h, rel_pos_w, heads, g):
            return orig_attention(qkv, torch.zeros_like(rel_pos_h),
                                  torch.zeros_like(rel_pos_w), heads, g)
    elif variant == "edge_padding":
        owner, name = vit_sam, "window_partition"
        orig_partition = vit_sam.window_partition

        def patched(x, ws):
            g = x.shape[1]
            n = -(-g // ws)
            idx = torch.clamp(torch.arange(n * ws, device=x.device), max=g - 1)
            return orig_partition(x[:, idx][:, :, idx], ws)
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
    ap.add_argument("--mix", type=float, nargs=2, default=None,
                    metavar=("PATH_MIX", "HEAD_MIX"))
    args = ap.parse_args(argv)

    import torch
    from benchmark.families import micro_sam as fam
    if args.mix:
        fam.PATH_MIX, fam.HEAD_MIX = args.mix
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
                "variant": variant, "seed": seed,
                "mix": [fam.PATH_MIX, fam.HEAD_MIX],
                "correct": out["correct"],
                "seconds": time.perf_counter() - t0,
                "checks": {k: v["value"] for k, v in out["checks"].items()},
                "readings": out["readings"]}), flush=True)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
