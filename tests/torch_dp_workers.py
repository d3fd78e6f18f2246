"""Rank functions of the data-parallel tests (``tests/test_torch_parallel.py``).

A spawned rank imports this module, so it imports torch and the port and
nothing else: no JAX, no test module.  Each function is one rank of a gloo
group on the CPU, joined through a ``file://`` rendezvous, and writes what
it computed to ``{out}/rank{r}.pt`` for the test to read.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from microbeseg_torch.ops.augment import apply_params, take_params
from microbeseg_torch.parallel import mesh
from microbeseg_torch.training.optimizers import build_optimizer
from microbeseg_torch.training.trainer import Trainer


def _join(rank, world, init_method):
    torch.set_num_threads(2)
    if world > 1:
        mesh.init_process_group(rank, world, init_method,
                                torch.device("cpu"))


def grad_step(trainer: Trainer, images, labels, weights, state, params=None,
              label_type="distance"):
    """One forward and backward of the global batch (``images`` (N, H, W,
    1), ``labels``, ``weights`` numpy) from ``state``, this rank's slice of
    it in a group: (the global weighted mean loss, the gradients by
    parameter name, the BatchNorm running statistics).  ``params``: drawn
    augmentation of the global batch, applied to the slice; without it the
    batch is taken as augmented already."""
    trainer.model.load_state_dict(state)
    trainer.optimizer = build_optimizer(trainer.cfg, trainer.model)[0]
    lo, hi = trainer._rank_slice(len(weights))
    img = torch.from_numpy(np.ascontiguousarray(images[lo:hi]))
    lab = {k: torch.from_numpy(np.ascontiguousarray(v[lo:hi]))
           for k, v in labels.items()}
    w = torch.from_numpy(np.ascontiguousarray(weights[lo:hi]))
    if params is not None:
        img, lab = apply_params(img, lab, take_params(params, lo, hi),
                                label_type)
    loss_sum = trainer.forward_backward(img, lab, w)
    loss = (mesh.all_reduce(loss_sum)
            / max(float(weights.sum()), 1.0))
    grads = {n: p.grad.detach().clone()
             for n, p in trainer.model.named_parameters()}
    stats = {n: b.detach().clone() for n, b in trainer.model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    return float(loss), grads, stats


def grad_rank(rank, world, init_method, out, cases, train=None):
    """One rank of ``grad_step`` for each case, {name: (cfg, images,
    labels, weights, state, params)}, one trainer a case; then, with
    ``train`` = (cfg, data), ``Trainer.train`` and its messages under
    'train'."""
    _join(rank, world, init_method)
    try:
        results = {}
        for name, (cfg, *args) in cases.items():
            trainer = Trainer(cfg, Path(out) / "models", device="cpu")
            results[name] = grad_step(trainer, *args, cfg.label_type)
        if train is not None:
            cfg, data = train
            results["train"] = []
            Trainer(cfg, Path(out) / "train", device="cpu",
                    text_output=results["train"].append).train(data)
        torch.save(results, Path(out) / f"rank{rank}.pt")
    finally:
        mesh.destroy_process_group()


def remat_rank(rank, world, init_method, out, cases):
    """One rank of ``grad_step`` for each case, {name: (cfg, remat_policy,
    images, labels, weights, state, params)}: the trainer builds its model
    with the policy and wraps it in DDP.  Saves each
    step with the BatchNorm layers' ``num_batches_tracked`` and the names
    of their classes."""
    _join(rank, world, init_method)
    try:
        results = {}
        for name, (cfg, policy, *args) in cases.items():
            trainer = Trainer(cfg, Path(out) / "models", device="cpu",
                              remat_policy=policy)
            step = grad_step(trainer, *args, cfg.label_type)
            tracked = {n: int(b) for n, b in trainer.model.named_buffers()
                       if n.endswith("num_batches_tracked")}
            kinds = {type(m).__name__ for m in trainer.model.modules()
                     if isinstance(m, torch.nn.BatchNorm2d)}
            results[name] = (*step, tracked, kinds)
        torch.save(results, Path(out) / f"rank{rank}.pt")
    finally:
        mesh.destroy_process_group()
