"""Stacks of uint16 frames through ``InferenceEngine.segment`` with
Cellpose-SAM (``label_type="flows"``), closed loop, one caller."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from benchmark.entries import segment
from benchmark.entries.segment import launch_checks
from benchmark.harness import compare, drivers, gen
from benchmark.harness.common import sub_seed
from benchmark.harness.drivers import check
from benchmark.reference import strict_float32
from benchmark.reference.flows import INFER_KEYS, Segmenter
from benchmark.reference.lowp import fp8


class ReferenceModel(torch.nn.Module):
    """The reference network in the port's place, for the control: float32
    outside the engine's autocast, each layer's operands rounded to 8-bit
    floats (``reference/lowp.py``)."""

    def __init__(self, mcfg: dict, state: dict):
        super().__init__()
        from microbeseg_torch.config import CellposeSAMConfig
        from benchmark.reference.cellpose_sam import Net
        self.cfg = CellposeSAMConfig(**mcfg)
        self.net, self.state = Net(mcfg, quant=fp8), state

    def forward(self, x):
        with torch.autocast(x.device.type, enabled=False):
            return self.net(self.state, x.float())


class Driver(segment.Driver):
    """The segment entry's loop, window, traced window and launch counts,
    with Cellpose-SAM in the network's place and Cellpose's dynamics as
    the reference's post-processing."""

    RUNS = {"family": ("cellpose_sam",), "precision": ("bfloat16",),
            "label_type": ("flows",)}

    @classmethod
    def accept(cls, config: dict, traffic: dict) -> None:
        super(segment.Driver, cls).accept(config, traffic)
        extra = sorted(set(traffic["infer"]) - set(INFER_KEYS))
        if extra:
            raise ValueError(f"infer settings the reference does not run: "
                             f"{extra}")

    @classmethod
    def tiny(cls, mix: dict, limits: dict):
        """Small frames and stacks, tiles of the tiny network's 64 px, no
        kernel required to launch.  The CPU runs the port in float32, so
        its fields are held to float32's limit: the run's own readings of
        the tiny network are some 7e-6, and some 1.1e-4 without the
        relative-position term."""
        mix = dict(mix, frame=160, stack=4, pool=3, sample=2,
                   objects=[2, 8], traced_seconds=0.5, must_launch=[])
        mix["infer"] = dict(mix["infer"], tile_size=64, tile_overlap=14)
        return mix, dict(limits, frames_compared=1, field_err=3e-5)

    def setup(self) -> None:
        """As the segment entry's, with the family's seeded weights and one
        warm call: every call has the stack's shape, and the first builds
        follow.cu and cc.cu."""
        from microbeseg_torch.config import CellposeSAMConfig, InferConfig
        from microbeseg_torch.inference.engine import InferenceEngine
        from microbeseg_torch.kernels import _build
        from microbeseg_torch.models.vit_sam import build_cellpose_sam

        mix = self.mix
        self.mark("imports")
        self.state = self.family.make_weights(self.mcfg, self.seed, self.dev)
        self.mark("weights")
        n = mix["stack"] * mix["pool"]
        self.pool = gen.frames(mix, self.seed, n, self.dev).reshape(
            mix["pool"], mix["stack"], mix["frame"], mix["frame"])
        self.cells = gen.object_counts(
            mix, n, gen.generator(self.seed, 1, self.dev)).reshape(
            mix["pool"], mix["stack"])
        drivers.inputs_made(self.dev)
        self.mark("inputs")
        self.infer = dict(mix["infer"])
        if self.control:
            model = ReferenceModel(self.mcfg, self.state)
        else:
            with torch.device(self.dev):
                model = build_cellpose_sam(CellposeSAMConfig(**self.mcfg))
            model.load_state_dict(self.state)
        self.engine = InferenceEngine(model, self.cell.config["label_type"],
                                      cfg=InferConfig(**self.infer),
                                      device=self.dev)
        self.outs: list = []
        self.engine.models[0].register_forward_hook(
            lambda mod, args, out: self.outs.append(out))
        self.mark("engine")
        self.engine.segment(self.pool[0])
        self.mark("warm call")
        self._build = _build
        _build.reset_launches()
        self.sample = drivers.Reservoir(mix["sample"], sub_seed(self.seed, 5))

    def check(self) -> List[dict]:
        """Over the sampled calls (pool index, masks, the network's
        outputs): the kernel route and out-of-memory fallbacks (0 each);
        the worst frame's RMS error of the port's three stitched fields
        against the reference's, from the frames, over the reference's
        RMS; the share of pixels where the port's masks differ from the
        reference's dynamics applied to the port's own fields (pixels of
        either's masks outside the one-to-one pairs of masks with IoU
        above 0.5, whatever their numbers).  Fewer frames than the limit
        asks for count as masks that all differ.  Logged: the masks of
        each frame against the cells drawn, and against the reference's
        own masks."""
        strict_float32()
        seg = Segmenter(self.mcfg, self.state, self.infer)
        lim = self.cell.limits
        field_err, diff_px, px, e2e_got, e2e_ref = 0.0, 0, 0, [], []
        found = []
        for k, masks, outs in sorted(self.sample.items, key=lambda t: t[0]):
            T, H, W = masks.shape
            got = seg.from_outputs(outs, T, H, W)
            ref = seg.fields_of(self.pool[k], self.dev)
            for c in range(3):
                field_err = max(field_err,
                                compare.field_error(got[:, c], ref[:, c]))
            for i, (post, m) in enumerate(zip(seg.masks(got), masks)):
                u, matched = compare.mask_counts(m, post)
                diff_px += u - matched
                px += m.size
                found.append((int(self.cells[k, i]), int(m.max())))
            e2e_got.append(masks)
            e2e_ref.append(np.stack(seg.masks(ref)))
        frames = px // max(1, self.mix["frame"] ** 2)
        post_mismatch = diff_px / px if px else 1.0
        if frames < lim["frames_compared"]:
            self.log(f"{frames} frames compared, fewer than "
                     f"{lim['frames_compared']}")
            field_err, post_mismatch = float("inf"), 1.0
        checks, bad = launch_checks(self.mix, self.launches)
        if bad:
            self.log(f"kernel route: {bad}")
        self.log(f"masks found against cells drawn, by frame: {found}")
        e2e = compare.mask_mismatch(e2e_got, e2e_ref)
        self.log(f"masks against the reference's own (logged, not "
                 f"compared): {e2e}")
        self.readings = {"cells_drawn": [c for c, _ in found],
                         "masks_found": [m for _, m in found],
                         "e2e_mask_mismatch": e2e["mask_mismatch"]}
        return checks + [
            check("oom_fallbacks", self.oom, 0.0),
            check("field_err", field_err, lim["field_err"]),
            check("post_mismatch", post_mismatch, lim["post_mismatch"]),
        ]
