"""Training steps of microbeSEG as plain operations: the augmented batch,
the network in training mode, the smooth-L1 loss of both heads and the
Ranger optimizer.

Loss (hip-satomi/microbeSEG ``train.py``): per sample, the mean smooth-L1
(beta 1) of the border head plus that of the cell head; the step minimises
the weighted sum over the batch divided by the weight sum.  Ranger
(``ranger2020.py``, as optax computes it): gradient centralisation (the
mean over every axis but the output channel's subtracted from each conv
weight's gradient), RAdam with b1 0.95, b2 0.999, eps 1e-6 and threshold
5 (below it the bias-corrected momentum is the update), the learning rate,
and Lookahead (k 6, alpha 0.5).

RAdam's rho_t is computed in float32, as optax computes it: the sum
cancels, so float32 reads rho_5 4.961, rho_6 5.975, rho_7 6.962 where
float64 reads 4.996, 5.994, 6.992.  Both put step 6 as the first
rectified step (and the first Lookahead sync); the rectification r_6
differs by 0.7% between the two.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import augment
from benchmark.reference.unet import Net


def smooth_l1_sum(pred, target, weights) -> torch.Tensor:
    """pred, target (B, H, W); weights (B,) -> sum_b w_b mean(smooth-L1)."""
    per = F.smooth_l1_loss(pred, target, reduction="none", beta=1.0)
    return torch.sum(per.mean(dim=(1, 2)) * weights)


def batch_loss(net: Net, p, images, labels, weights) -> torch.Tensor:
    border, cell = net(p, images.permute(0, 3, 1, 2), train=True)
    return (smooth_l1_sum(border, labels["border_label"][..., 0], weights)
            + smooth_l1_sum(cell, labels["cell_label"][..., 0], weights))


class Ranger:
    """Over a dict of parameters; ``transposed`` names the leaves whose
    output channel is dim 1."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 transposed: Sequence[str], b1=0.95, b2=0.999, eps=1e-6,
                 threshold=5.0, alpha=0.5, k=6):
        self.p = params
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.threshold, self.alpha, self.k = threshold, alpha, k
        self.transposed = set(transposed)
        self.mu = {n: torch.zeros_like(v) for n, v in params.items()}
        self.nu = {n: torch.zeros_like(v) for n, v in params.items()}
        self.slow = {n: v.detach().clone() for n, v in params.items()}
        self.t = 0
        self.first_grads = None

    def centralised(self, name, g):
        if g.ndim <= 1:
            return g
        dims = ((0, 2, 3) if name in self.transposed
                else tuple(range(1, g.ndim)))
        return g - g.mean(dim=dims, keepdim=True)

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        t, b1, b2 = self.t, self.b1, self.b2
        rho_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = np.float32(b2) ** np.float32(t)
        rho = float(np.float32(rho_inf)
                    - np.float32(2 * t) * b2t / (np.float32(1.0) - b2t))
        gc = {n: self.centralised(n, g) for n, g in grads.items()}
        if t == 1:
            self.first_grads = {n: g.clone() for n, g in gc.items()}
        for n, v in self.p.items():
            g = gc[n]
            self.mu[n] = b1 * self.mu[n] + (1 - b1) * g
            self.nu[n] = b2 * self.nu[n] + (1 - b2) * g * g
            upd = self.mu[n] / (1 - b1 ** t)
            if rho >= self.threshold:
                r = ((rho - 4) * (rho - 2) * rho_inf
                     / ((rho_inf - 4) * (rho_inf - 2) * rho)) ** 0.5
                upd = r * upd / (torch.sqrt(self.nu[n] / (1 - b2 ** t))
                                 + self.eps)
            new = v - self.lr * upd
            if t % self.k == 0:
                new = self.slow[n] + self.alpha * (new - self.slow[n])
                self.slow[n] = new.clone()
            v.copy_(new)


# what ``run_steps`` follows; any other value of these keys is refused
FOLLOWS = {"label_type": "distance", "loss": "smooth_l1",
           "optimizer": "ranger"}


def run_steps(cfg: dict, params: Dict[str, torch.Tensor],
              batches: List[dict], quant=None) -> dict:
    """Follow ``batches`` (each: images (B, H, W, 1) raw, labels, weights,
    the drawn augmentation parameters) from ``params`` (copied, float32)
    with the configuration ``cfg`` (the network's keys, ``label_type``,
    ``loss``, ``optimizer``, ``learning_rate``):
    -> {"losses": [...], "first_grads": {...}, "params": {...}}."""
    for key, value in FOLLOWS.items():
        if cfg[key] != value:
            raise ValueError(f"the reference trains {key} {value!r}, not "
                             f"{cfg[key]!r}")
    net = Net(cfg, quant)
    p = {n: v.detach().to(torch.float32).clone().requires_grad_(True)
         for n, v in params.items()}
    transposed = [n for n in p if "Upconv" in n and n.endswith(
        "up.0.weight")]
    opt = Ranger(p, float(cfg["learning_rate"]), transposed)
    losses = []
    for b in batches:
        img, lab = augment.apply(b["images"], b["labels"], b["params"])
        loss_sum = batch_loss(net, p, img, lab, b["weights"])
        loss = loss_sum / torch.clamp(b["weights"].sum(), min=1.0)
        grads = torch.autograd.grad(loss, list(p.values()))
        opt.step(dict(zip(p.keys(), grads)))
        losses.append(float(loss_sum.detach()))
    return {"losses": losses, "first_grads": opt.first_grads,
            "params": {n: v.detach() for n, v in p.items()}}
