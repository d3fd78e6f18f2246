"""Host-side learning-rate schedules: a copy of
``microbeseg_tpu/training/schedules.py``.

The torch schedulers the reference drives from its epoch loop (reference:
src/training/train.py:386-426, 529-533): ReduceLROnPlateau on the
validation loss, CosineAnnealingLR for the Ranger fine-tune run.  They run
on the host between epochs; the trainer writes the new lr into the
optimizer's ``param_groups``.
"""

from __future__ import annotations

import math


class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau semantics (mode='min',
    threshold=1e-4 relative, cooldown=0)."""

    def __init__(self, lr: float, factor: float = 0.25, patience: int = 10,
                 min_lr: float = 0.0, threshold: float = 1e-4):
        self.lr = float(lr)
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.best = float("inf")
        self.num_bad_epochs = 0

    def step(self, metric: float) -> float:
        """Feed the epoch's validation loss; returns the (possibly reduced) lr."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad_epochs = 0
        return self.lr


class CosineAnnealingLR:
    """torch CosineAnnealingLR: lr(t) = eta_min + (base - eta_min) *
    (1 + cos(pi * t / T_max)) / 2, stepped once per epoch."""

    def __init__(self, lr: float, t_max: int, eta_min: float = 0.0):
        self.base_lr = float(lr)
        self.t_max = max(int(t_max), 1)
        self.eta_min = eta_min
        self.t = 0
        self.lr = float(lr)

    def step(self, metric: float | None = None) -> float:
        self.t += 1
        cos = math.cos(math.pi * self.t / self.t_max)
        self.lr = self.eta_min + (self.base_lr - self.eta_min) * (1 + cos) / 2
        return self.lr
