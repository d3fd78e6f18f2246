"""``Trainer.train_step`` on batches of seeded crops, the augmentation
drawn on the host for each step."""

from __future__ import annotations

import tempfile
from pathlib import Path
from typing import List

import torch

from benchmark.harness import augdraw, compare, drivers, gen, trace, weights
from benchmark.harness.common import sub_seed
from benchmark.harness.drivers import check
from benchmark.reference import strict_float32


class Driver(drivers.Driver):
    CONFIG_KEYS = ("precision", "label_type", "loss", "optimizer",
                   "learning_rate")
    # what the reference (``reference/train.py``) and the control follow
    RUNS = {"family": ("unet",), "precision": ("bfloat16",),
            "label_type": ("distance",), "loss": ("smooth_l1",),
            "optimizer": ("ranger",)}
    TRAFFIC_KEYS = ("entry", "frame", "batch", "pool", "objects", "radius",
                    "intensity", "checked_steps", "warm_steps",
                    "traced_seconds")

    @classmethod
    def tiny(cls, mix: dict, limits: dict):
        """The mix at a size the CPU runs in seconds: 64^2 crops, one warm
        step."""
        return dict(mix, frame=64, pool=16, objects=[2, 8],
                    warm_steps=1), limits

    def setup(self) -> None:
        from microbeseg_torch.config import ModelConfig, TrainConfig
        from microbeseg_torch.training.optimizers import build_optimizer
        from microbeseg_torch.training.trainer import Trainer

        mix, conf = self.mix, self.cell.config
        self.mark("imports")
        self.state = weights.make(self.mcfg, self.seed, self.dev, "lecun",
                                  self.family)
        self.mark("weights")
        imgs, planes = gen.frames(mix, self.seed, mix["pool"], self.dev,
                                  fields=True)
        self.images = imgs.to(torch.float32)[..., None]
        drivers.inputs_made(self.dev)
        self.labels = {"border_label": planes["border"][..., None],
                       "cell_label": planes["cell"][..., None]}
        g = gen.generator(self.seed, 3, self.dev)
        self.order = torch.randperm(mix["pool"], generator=g,
                                    device=self.dev).cpu().numpy()
        self.aug = torch.Generator().manual_seed(sub_seed(self.seed, 4))
        self.bs = mix["batch"]
        self.weights = torch.ones(self.bs, device=self.dev)
        self.mark("inputs")
        self.tcfg = TrainConfig(model=ModelConfig(**self.mcfg),
                                label_type=conf["label_type"],
                                loss=conf["loss"],
                                optimizer=conf["optimizer"],
                                ranger_lr=conf["learning_rate"],
                                batch_size=self.bs,
                                compute_dtype=conf["precision"])
        self._tmp = tempfile.TemporaryDirectory()
        # the model is made on the card: its own initialisation, which the
        # seeded weights replace, costs no host time
        with torch.device(self.dev):
            self.trainer = Trainer(self.tcfg, Path(self._tmp.name),
                                   device=self.dev)
        self.trainer.model.load_state_dict(self.state)
        self.trainer.optimizer, _ = build_optimizer(self.tcfg,
                                                    self.trainer.model)
        self.mark("trainer")
        names = [n for n, _ in self.trainer.model.named_parameters()]
        params = [p for _, p in self.trainer.model.named_parameters()]
        # the checked steps go through the window's own call and feed
        self.batches, self.losses = [], []
        for k in range(mix["checked_steps"]):
            loss = self._call(k, keep=True)
            self.losses.append(float(loss))
            if k == 0:
                b1 = self.trainer.optimizer.param_groups[0]["b1"]
                st = self.trainer.optimizer.state
                # a step that left no state has moved nothing
                self.first_grads = {
                    n: (st[p]["mu"] / (1.0 - b1) if "mu" in st[p]
                        else torch.zeros_like(p)).float().cpu()
                    for n, p in zip(names, params)}
        self.after = {n: p.detach().float().cpu().clone()
                      for n, p in zip(names, params)}
        self.mark("checked steps")
        self.step = mix["checked_steps"]
        for _ in range(mix["warm_steps"]):
            self._call(self.step)
            self.step += 1
        self.mark("warm steps")

    def _call(self, k: int, keep: bool = False):
        n = len(self.order)
        at = (k * self.bs) % n
        rows = torch.from_numpy(self.order[at:at + self.bs].copy()).to(
            self.dev)
        images = self.images[rows]
        labels = {key: v[rows] for key, v in self.labels.items()}
        with torch.profiler.record_function("bench.draw_augmentation"):
            params = augdraw.draw(self.aug, self.bs, self.mix["frame"])
        if keep:
            self.batches.append({"images": images.clone(), "weights":
                                 self.weights.clone(), "params": params,
                                 "labels": {key: v.clone() for key, v in
                                            labels.items()}})
        with torch.profiler.record_function("bench.train_step"):
            return self.trainer.train_step(images, labels, self.weights,
                                           params)

    def _steps(self, seconds: float) -> dict:
        def call(i):
            self._call(self.step)
            self.step += 1
        out = self.loop(seconds, call)
        out.update(steps=out["calls"], images=out["calls"] * self.bs)
        return out

    def window(self, seconds: float) -> dict:
        out = self._steps(seconds)
        out.update(attempted=out["calls"], failed=0)
        return out

    def traced_window(self) -> dict:
        with trace.span():
            return self._steps(self.mix["traced_seconds"])

    def free(self) -> None:
        del self.trainer
        self._tmp.cleanup()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, quant=None) -> dict:
        from benchmark.reference.train import run_steps
        strict_float32()
        params = {n: v for n, v in self.state.items()
                  if not n.endswith(("running_mean", "running_var",
                                     "num_batches_tracked"))}
        return run_steps(self.cell.config, params, self.batches, quant)

    def check(self) -> List[dict]:
        got = {"losses": self.losses, "first_grads": self.first_grads,
               "params": self.after}
        return self.numbers(got, self.reference())

    def numbers(self, got: dict, ref: dict) -> List[dict]:
        """``got``: the losses, the first gradient and the parameters after
        the checked steps, of the port or of what stands in its place (the
        control); ``ref``: the reference's."""
        lim = self.cell.limits
        p0 = {n: v.detach().float().cpu() for n, v in self.state.items()
              if n in ref["params"]}
        ref_g = {n: v.float().cpu() for n, v in ref["first_grads"].items()}
        leaves = compare.moving_leaves(ref_g)
        loss_gap = max(abs(a - b) / abs(b) for a, b in
                       zip(got["losses"], ref["losses"]))
        grad_gap, g_leaf, grad_med = compare.worst_and_median(
            compare.leaf_norm_gaps({n: v.float().cpu() for n, v in
                                    got["first_grads"].items()}, ref_g,
                                   leaves))
        d_got = {n: got["params"][n].float().cpu() - p0[n] for n in leaves}
        d_ref = {n: ref["params"][n].float().cpu() - p0[n] for n in leaves}
        change_gap, c_leaf, change_med = compare.worst_and_median(
            compare.leaf_norm_gaps(d_got, d_ref, leaves))
        self.log(f"losses {got['losses']} reference {ref['losses']}; "
                 f"gradient gap: worst leaf {grad_gap} ({g_leaf}), median "
                 f"leaf {grad_med}; change gap: worst leaf {change_gap} "
                 f"({c_leaf}), median leaf {change_med}; {len(leaves)} of "
                 f"{len(ref_g)} leaves compared")
        # logged, not compared: no fault or control separates them
        self.readings = {"grad_gap": grad_gap, "grad_gap_median": grad_med,
                         "change_gap_median": change_med}
        return [check("loss_gap", loss_gap, lim["loss_gap"]),
                check("change_gap", change_gap, lim["change_gap"])]
