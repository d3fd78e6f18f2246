"""Loss functions (reference: src/training/losses.py).

Port of ``microbeseg_tpu/training/losses.py``:

- distance method: per-head SmoothL1 / L1 / L2 on the (border, cell)
  regressions, summed (reference train.py:478-482);
- boundary method: cross-entropy, or CE + 0.5 * class-weighted dice
  (reference losses.py:71-96).

Tensors are channel-last, as the model returns them: (B, H, W, C).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def _smooth_l1_terms(pred, target, beta: float = 1.0):
    d = torch.abs(pred - target)
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def _l1_terms(pred, target):
    return torch.abs(pred - target)


def _l2_terms(pred, target):
    return (pred - target) ** 2


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0) -> torch.Tensor:
    """torch.nn.SmoothL1Loss (mean reduction, beta 1), written out as the
    JAX package writes it."""
    return torch.mean(_smooth_l1_terms(pred, target, beta))


def l1(pred, target):
    return torch.mean(_l1_terms(pred, target))


def l2(pred, target):
    return torch.mean(_l2_terms(pred, target))


_TERMS = {"smooth_l1": _smooth_l1_terms, "l1": _l1_terms, "l2": _l2_terms}


def _one_hot(labels: torch.Tensor, num_classes: int,
             dtype: torch.dtype) -> torch.Tensor:
    return F.one_hot(labels.to(torch.int64), num_classes).to(dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """CE over channel-last logits (..., H, W, C) against int labels
    (..., H, W)."""
    logp = torch.log_softmax(logits, dim=-1)
    onehot = _one_hot(labels, logits.shape[-1], logp.dtype)
    return -torch.mean(torch.sum(onehot * logp, dim=-1))


def dice_loss(probs: torch.Tensor, target: torch.Tensor,
              smooth: float = 1.0) -> torch.Tensor:
    """Dice on probabilities (reference losses.py:40-68, use_sigmoid=False),
    over the flattened inputs."""
    p = probs.reshape(-1)
    t = target.reshape(-1)
    inter = torch.sum(p * t)
    return 1.0 - (2.0 * inter + smooth) / (torch.sum(t * t)
                                           + torch.sum(p * p) + smooth)


def ce_dice(logits: torch.Tensor, labels: torch.Tensor,
            num_classes: int = 3) -> torch.Tensor:
    """CE + 0.5 * sum_c c * dice_c over the classes 1..C-1."""
    ce = cross_entropy(logits, labels)
    probs = torch.softmax(logits, dim=-1)
    onehot = _one_hot(labels, num_classes, probs.dtype)
    dice = 0.0
    for c in range(1, num_classes):
        dice = dice + c * dice_loss(probs[..., c], onehot[..., c])
    return ce + 0.5 * dice


def _cross_entropy_per_sample(logits: torch.Tensor,
                              labels: torch.Tensor) -> torch.Tensor:
    """``cross_entropy`` of each sample of a batch: (B,)."""
    logp = torch.log_softmax(logits, dim=-1)
    onehot = _one_hot(labels, logits.shape[-1], logp.dtype)
    return -torch.mean(torch.sum(onehot * logp, dim=-1), dim=(1, 2))


def _squeeze(lab: torch.Tensor) -> torch.Tensor:
    """Labels arrive (..., H, W, 1) from the data pipeline."""
    return lab[..., 0] if lab.shape[-1] == 1 else lab


def get_loss(loss_function: str, label_type: str) -> Callable:
    """loss(pred, batch) -> scalar over a batch of one or more samples.

    distance: ``pred`` = (border_pred, cell_pred), ``batch`` holds
    'border_label' and 'cell_label'.  boundary: ``pred`` = logits
    (..., H, W, 3), ``batch`` holds 'label'."""
    if label_type == "boundary":
        if loss_function == "ce_dice":
            return lambda logits, batch: ce_dice(logits,
                                                 _squeeze(batch["label"]))
        if loss_function == "ce":
            return lambda logits, batch: cross_entropy(
                logits, _squeeze(batch["label"]))
        raise ValueError(f"Loss unknown: {loss_function!r}")
    if label_type == "distance":
        base = {"l1": l1, "l2": l2, "smooth_l1": smooth_l1}.get(loss_function)
        if base is None:
            raise ValueError(f"Loss unknown: {loss_function!r}")

        def distance_loss(pred, batch):
            border_pred, cell_pred = pred
            return (base(border_pred, batch["border_label"])
                    + base(cell_pred, batch["cell_label"]))

        return distance_loss
    raise ValueError(f"Label type unknown: {label_type!r}")


def get_batch_loss(loss_function: str, label_type: str) -> Callable:
    """loss(pred, batch, weights) -> the weighted loss SUM over the real
    samples of a batch: the reference's batch loss times the number of real
    samples, matching its ``running_loss += loss.item() * batch_size``
    accounting (train.py:493-495).

    ``weights`` are 1 for real samples and 0 for padding slots.  The dice
    term of ce_dice is taken over the flattened WHOLE batch (reference
    losses.py:40-68 flattens batch tensors), with padded slots zeroed out of
    all three dice sums."""
    if label_type == "boundary" and loss_function == "ce_dice":
        def batch_ce_dice(logits, batch, weights, num_classes: int = 3):
            labels = _squeeze(batch["label"])
            ce_per = _cross_entropy_per_sample(logits, labels)
            n_real = torch.sum(weights)
            probs = torch.softmax(logits, dim=-1)
            onehot = _one_hot(labels, num_classes, probs.dtype)
            w = weights.view(-1, 1, 1)
            dice = 0.0
            for c in range(1, num_classes):
                dice = dice + c * dice_loss(probs[..., c] * w,
                                            onehot[..., c] * w)
            return torch.sum(ce_per * weights) + 0.5 * dice * n_real
        return batch_ce_dice

    if label_type == "boundary":
        if loss_function != "ce":
            raise ValueError(f"Loss unknown: {loss_function!r}")
        return lambda logits, batch, weights: torch.sum(
            _cross_entropy_per_sample(logits, _squeeze(batch["label"]))
            * weights)
    get_loss(loss_function, label_type)      # validates the names
    terms = _TERMS[loss_function]

    def per_sample(pred, target):
        return terms(pred, target).mean(dim=tuple(range(1, pred.ndim)))

    def batch_loss(pred, batch, weights):
        border_pred, cell_pred = pred
        per = (per_sample(border_pred, batch["border_label"])
               + per_sample(cell_pred, batch["cell_label"]))
        return torch.sum(per * weights)

    return batch_loss
