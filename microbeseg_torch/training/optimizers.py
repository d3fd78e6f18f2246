"""Ranger and AMSGrad as ``torch.optim.Optimizer``s that compute what the
JAX package's optax chains compute (``microbeseg_tpu/training/
optimizers.py``).

Ranger (reference: src/training/ranger2020.py:43-206, train.py:394-426) is
gradient centralisation -> optax's ``scale_by_radam`` -> the learning rate
-> Lookahead; AMSGrad is optax's ``amsgrad`` (train.py:379-385).  Where
they differ from torch's own optimizers:

- RAdam divides by ``sqrt(v_hat) + eps`` with the bias-corrected
  ``v_hat`` (``torch.optim.RAdam`` adds eps before the correction), and
  below the threshold (rho < 5) its update is the bias-corrected momentum,
  not zero.  rho_t is computed in float32 as optax computes it inside the
  jitted train step: ``rho_inf - 2 t b2^t / (1 - b2^t)`` cancels, so one
  ulp of ``b2^t`` moves rho by ~0.02.  Jitted, optax reads rho_6 = 5.97473
  (op by op XLA rounds 0.999^6 one ulp higher and reads 5.95483; float64
  reads 5.99416), and the rectification follows.
- AMSGrad takes the maximum over the bias-corrected ``v_hat``
  (``torch.optim.Adam(amsgrad=True)`` takes it over the raw ``v``).
- Gradient centralisation subtracts the mean over every axis but the
  output channel's: dims (1, 2, 3) of a ``Conv2d`` weight (O, I, kh, kw),
  dims (0, 2, 3) of a ``ConvTranspose2d`` weight (I, O, kh, kw).
- Lookahead is the last transform: every k-th step the parameters land on
  ``slow + alpha * (p + u - slow)`` and the slow copy follows.

The step count and the scalars that follow from it (bias corrections, rho,
the rectification) live on the host, so a step needs no device sync.  The
learning rate is each param group's ``lr``; the schedules set it between
epochs (``set_learning_rate``).  Every elementwise pass is one
``torch._foreach_*`` call over all parameters.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from microbeseg_torch.config import TrainConfig


def _pow32(base: float, t: int) -> np.float32:
    """``base ** t`` in float32, as optax's ``decay ** count`` computes it."""
    return np.float32(torch.pow(torch.tensor(base, dtype=torch.float32),
                                torch.tensor(float(t))).item())


def _bias_correction(decay: float, t: int) -> float:
    return float(np.float32(1.0) - _pow32(decay, t))


def radam_rho(t: int, b2: float = 0.999) -> Tuple[np.float32, np.float32]:
    """(rho_t, the rectification r_t) in float32, optax's arithmetic."""
    ro_inf_py = 2.0 / (1.0 - b2) - 1.0
    ro_inf = np.float32(ro_inf_py)
    b2t = _pow32(b2, t)
    ro = ro_inf - np.float32(2 * t) * b2t / (np.float32(1.0) - b2t)
    den = np.float32((ro_inf_py - 4.0) * (ro_inf_py - 2.0))
    with np.errstate(invalid="ignore"):    # nan below rho = 4, unused there
        r = np.sqrt((ro - np.float32(4.0)) * (ro - np.float32(2.0)) * ro_inf
                    / (den * ro))
    return ro, np.float32(r)


def centralization_dims(model: nn.Module) -> List[Optional[Tuple[int, ...]]]:
    """Per parameter of ``model`` (in ``parameters()`` order): the dims whose
    mean gradient centralisation subtracts, or None for 1-d tensors."""
    transposed = {id(m.weight) for m in model.modules()
                  if isinstance(m, nn.ConvTranspose2d)}
    out = []
    for p in model.parameters():
        if p.ndim <= 1:
            out.append(None)
        elif id(p) in transposed:
            out.append((0,) + tuple(range(2, p.ndim)))
        else:
            out.append(tuple(range(1, p.ndim)))
    return out


class _HostStep(torch.optim.Optimizer):
    """Common part: one param group, per-parameter state, the step count
    kept in every parameter's state as a host int."""

    def _state_lists(self, group, names):
        params = group["params"]
        for p in params:
            st = self.state[p]
            if not st:
                st["step"] = 0
                for n in names:
                    st[n] = (p.detach().clone() if n == "slow"
                             else torch.zeros_like(p,
                                                   memory_format=torch.preserve_format))
        t = self.state[params[0]]["step"] + 1
        for p in params:
            self.state[p]["step"] = t
        return t, [[self.state[p][n] for p in params] for n in names]

    @staticmethod
    def _moments(grads, mus, nus, b1, b2):
        """mu = (1 - b1) g + b1 mu and nu = (1 - b2) g^2 + b2 nu, each
        product rounded before the sum, as optax writes them."""
        g1 = torch._foreach_mul(grads, 1.0 - b1)
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, g1)
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1.0 - b2)
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, g2)


class Ranger(_HostStep):
    """Gradient centralisation + optax's RAdam + lr + Lookahead."""

    def __init__(self, params, lr: float, b1: float = 0.95,
                 b2: float = 0.999, eps: float = 1e-6,
                 threshold: float = 5.0, alpha: float = 0.5, k: int = 6,
                 gc_dims: Optional[List[Optional[Tuple[int, ...]]]] = None):
        """``gc_dims``: one entry per parameter (``centralization_dims``),
        or None for no centralisation."""
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      threshold=threshold, alpha=alpha, k=k,
                                      gc_dims=gc_dims))
        if len(self.param_groups) != 1:
            raise ValueError("Ranger takes one parameter group")

    @torch.no_grad()
    def step(self, closure=None):
        group = self.param_groups[0]
        params = group["params"]
        grads = [p.grad for p in params]
        if group["gc_dims"] is not None:
            grads = [g if d is None else g - g.mean(dim=d, keepdim=True)
                     for g, d in zip(grads, group["gc_dims"])]
        t, (mus, nus, slows) = self._state_lists(group, ("mu", "nu", "slow"))
        b1, b2 = group["b1"], group["b2"]
        self._moments(grads, mus, nus, b1, b2)
        upd = torch._foreach_div(mus, _bias_correction(b1, t))
        ro, r = radam_rho(t, b2)
        if ro >= group["threshold"]:
            den = torch._foreach_div(nus, _bias_correction(b2, t))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            torch._foreach_mul_(upd, float(r))
            torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -group["lr"])
        if t % group["k"] == 0:
            # u' = slow + alpha (p + u - slow) - p; p + u'; slow follows
            new_slow = torch._foreach_add(params, upd)
            torch._foreach_sub_(new_slow, slows)
            torch._foreach_mul_(new_slow, group["alpha"])
            torch._foreach_add_(new_slow, slows)
            upd = torch._foreach_sub(new_slow, params)
            torch._foreach_copy_(slows, new_slow)
        torch._foreach_add_(params, upd)


class AMSGrad(_HostStep):
    """optax's ``amsgrad``: the maximum over the bias-corrected second
    moment, then lr."""

    def __init__(self, params, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))
        if len(self.param_groups) != 1:
            raise ValueError("AMSGrad takes one parameter group")

    @torch.no_grad()
    def step(self, closure=None):
        group = self.param_groups[0]
        params = group["params"]
        grads = [p.grad for p in params]
        t, (mus, nus, nu_max) = self._state_lists(group,
                                                  ("mu", "nu", "nu_max"))
        b1, b2 = group["b1"], group["b2"]
        self._moments(grads, mus, nus, b1, b2)
        upd = torch._foreach_div(mus, _bias_correction(b1, t))
        nu_hat = torch._foreach_div(nus, _bias_correction(b2, t))
        torch._foreach_maximum_(nu_max, nu_hat)
        den = torch._foreach_sqrt(nu_max)
        torch._foreach_add_(den, group["eps"])
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -group["lr"])
        torch._foreach_add_(params, upd)


def build_optimizer(cfg: TrainConfig, model: nn.Module,
                    second_run: bool = False):
    """(optimizer over ``model``'s parameters, initial lr)."""
    if cfg.optimizer == "adam":
        lr = cfg.adam_lr
        return AMSGrad(model.parameters(), lr), lr
    if cfg.optimizer == "ranger":
        lr = cfg.ranger_lr * (cfg.ranger_finetune_factor if second_run
                              else 1.0)
        return Ranger(model.parameters(), lr, alpha=cfg.lookahead_alpha,
                      k=cfg.lookahead_k,
                      gc_dims=centralization_dims(model)), lr
    raise ValueError(f"Optimizer not known: {cfg.optimizer!r}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
