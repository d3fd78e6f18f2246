"""Stacks of uint16 frames through ``InferenceEngine.segment``, closed
loop, one caller."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from benchmark.harness import compare, drivers, gen, trace, weights
from benchmark.harness.common import sub_seed
from benchmark.harness.drivers import check
from benchmark.reference import strict_float32
from benchmark.reference.infer import INFER_KEYS, Segmenter


def launch_checks(mix: dict, launches):
    """The kernels the mix must take and must not take: 1 where that does
    not hold, against the limit 0."""
    bad = [k for k in mix["must_launch"] if not launches.get(k)]
    bad += [k for k in mix["must_not_launch"] if launches.get(k)]
    return [check("kernel_route", 1.0 if bad else 0.0, 0.0)], bad


class Driver(drivers.Driver):
    """A forward hook on the engine's network keeps what each forward call
    returned during the current ``segment`` call (references, no copy),
    so that a sampled call's fields can be judged apart from its masks."""

    # the engine runs bf16 autocast on the card, and nothing else
    CONFIG_KEYS = ("precision", "label_type")
    RUNS = {"family": ("unet",), "precision": ("bfloat16",),
            "label_type": ("distance",)}
    TRAFFIC_KEYS = ("entry", "frame", "stack", "pool", "objects", "radius",
                    "intensity", "infer", "must_launch", "must_not_launch",
                    "sample", "traced_seconds")

    @classmethod
    def accept(cls, config: dict, traffic: dict) -> None:
        super().accept(config, traffic)
        extra = sorted(set(traffic["infer"]) - set(INFER_KEYS))
        if extra:
            raise ValueError(f"infer settings the reference does not run: "
                             f"{extra}")

    @classmethod
    def tiny(cls, mix: dict, limits: dict):
        """The mix and limits at a size the CPU runs in seconds: small
        frames, stacks and tiles, no kernel required to launch."""
        tiled = mix["infer"].get("use_tiling")
        mix = dict(mix, frame=160 if tiled else 64, stack=4, pool=3,
                   sample=2, objects=[2, 8], traced_seconds=0.5,
                   must_launch=[])
        if tiled:
            mix["infer"] = dict(mix["infer"], tile_size=64, tile_overlap=16)
        return mix, dict(limits, frames_compared=1)

    def setup(self) -> None:
        from microbeseg_torch.config import InferConfig, ModelConfig
        from microbeseg_torch.inference.engine import InferenceEngine
        from microbeseg_torch.kernels import _build
        from microbeseg_torch.models.unet import build_unet

        mix = self.mix
        self.mark("imports")
        self.state = weights.make(self.mcfg, self.seed, self.dev, "averaging",
                                  self.family)
        self.mark("weights")
        n = mix["stack"] * mix["pool"]
        self.pool = gen.frames(mix, self.seed, n, self.dev).reshape(
            mix["pool"], mix["stack"], mix["frame"], mix["frame"])
        drivers.inputs_made(self.dev)
        self.mark("inputs")
        infer = dict(mix["infer"])
        if self.control:
            infer["quantize"] = True
        self.infer = infer
        with torch.device(self.dev):
            model = build_unet(ModelConfig(**self.mcfg))
        model.load_state_dict(self.state)
        self.engine = InferenceEngine(model, self.cell.config["label_type"],
                                      cfg=InferConfig(**infer),
                                      device=self.dev)
        self.outs: list = []
        self.engine.models[0].register_forward_hook(
            lambda mod, args, out: self.outs.append(out))
        self.mark("engine")
        for i in range(min(2, mix["pool"])):
            self.engine.segment(self.pool[i])
        self.mark("warm calls")
        self._build = _build
        _build.reset_launches()
        self.sample = drivers.Reservoir(mix["sample"], sub_seed(self.seed, 5))

    def _call(self, i: int) -> None:
        k = i % len(self.pool)
        self.outs = []
        with torch.profiler.record_function("bench.segment"):
            masks = self.engine.segment(self.pool[k])
        self.sample.offer((k, masks, self.outs))

    def _frames(self, out: dict) -> dict:
        frames = out["calls"] * self.mix["stack"]
        out.update(frames=frames, pixels=frames * self.mix["frame"] ** 2)
        return out

    def window(self, seconds: float) -> dict:
        out = self._frames(self.loop(seconds, self._call))
        out.update(attempted=out["calls"], failed=0)
        return out

    def traced_window(self) -> dict:
        with trace.span():
            out = self.loop(self.mix["traced_seconds"], self._call)
        return self._frames(out)

    def free(self) -> None:
        self.launches = dict(self._build.LAUNCHES)
        self.oom = self.engine.oom_count
        del self.engine
        self.outs = []
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> List[dict]:
        """Over the sampled calls (pool index, masks, the network's
        outputs): the kernel route and out-of-memory fallbacks (0 each);
        the worst frame's error of the port's fields against the
        reference's, from the frames; the share of pixels where the port's
        masks differ from the reference's post-processing of the port's
        own fields (exact).  Fewer frames than the limit asks for count as
        masks that all differ.  End to end, masks against the reference's
        own masks are logged."""
        strict_float32()
        seg = Segmenter(self.mcfg, self.state, self.infer)
        lim = self.cell.limits
        field_err, diff_px, px, e2e_got, e2e_ref = 0.0, 0, 0, [], []
        for k, masks, outs in sorted(self.sample.items, key=lambda t: t[0]):
            T, H, W = masks.shape
            pb, pc = seg.from_outputs(outs, T, H, W)
            rb, rc = seg.fields_of(self.pool[k], self.dev)
            field_err = max(field_err, compare.field_error(pb, rb),
                            compare.field_error(pc, rc))
            post = seg.masks(pb, pc)
            diff_px += int(np.count_nonzero(post != masks))
            px += masks.size
            e2e_got.append(masks)
            e2e_ref.append(seg.masks(rb, rc))
        frames = px // max(1, self.mix["frame"] ** 2)
        post_mismatch = diff_px / px if px else 1.0
        if frames < lim["frames_compared"]:
            self.log(f"{frames} frames compared, fewer than "
                     f"{lim['frames_compared']}")
            field_err, post_mismatch = float("inf"), 1.0
        checks, bad = launch_checks(self.mix, self.launches)
        if bad:
            self.log(f"kernel route: {bad}")
        self.log(f"masks against the reference's own (logged, not "
                 f"compared): {compare.mask_mismatch(e2e_got, e2e_ref)}")
        return checks + [
            check("oom_fallbacks", self.oom, 0.0),
            check("field_err", field_err, lim["field_err"]),
            check("post_mismatch", post_mismatch, lim["post_mismatch"]),
        ]
