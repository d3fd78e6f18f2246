"""Faults planted under the timed path, to show that the comparison
catches them: ``plant(name)`` patches the port and returns the undo.

- ``unchanged_state``: a training step computes its loss and returns the
  model and optimizer as they were;
- ``half_batch``: a training step takes the first half of its batch and
  the mean over it;
- ``altered_answer``: post-processing's masks come back shifted by one
  pixel along x.

The exchange between cards is not a fault any cell can have: every cell
runs on one card.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def plant(name: str) -> Callable[[], None]:
    if name in ("unchanged_state", "half_batch"):
        from microbeseg_torch.ops.augment import apply_params, take_params
        from microbeseg_torch.training.trainer import Trainer
        owner, attr = Trainer, "train_step"
        orig = Trainer.train_step
        if name == "unchanged_state":
            def patched(self, images, labels, weights, params):
                img, lab = apply_params(images, labels, params,
                                        self.cfg.label_type)
                with torch.no_grad(), self._autocast():
                    preds = self.model(img)
                return self.loss_fn(preds, lab, weights).detach()
        else:
            def patched(self, images, labels, weights, params):
                h = images.shape[0] // 2
                return orig(self, images[:h],
                            {k: v[:h] for k, v in labels.items()},
                            weights[:h], take_params(params, 0, h))
    elif name == "altered_answer":
        from microbeseg_torch.inference.engine import InferenceEngine
        owner, attr = InferenceEngine, "postprocess"
        orig = InferenceEngine.postprocess

        def patched(self, *args, **kwargs):
            return np.roll(orig(self, *args, **kwargs), 1, axis=-1)
    else:
        raise ValueError(f"unknown fault {name!r}")
    setattr(owner, attr, patched)
    return lambda: setattr(owner, attr, orig)
