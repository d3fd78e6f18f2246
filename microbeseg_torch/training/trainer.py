"""Training loop: the reference training protocol on the card.

Port of ``microbeseg_tpu/training/trainer.py`` (reference TrainWorker,
src/training/train.py:115-576):

- one train step = index gather of the batch -> augmentation
  (``ops/augment``, parameters drawn on the host) -> forward and backward
  through autograd on cuDNN, under bf16 autocast when
  ``TrainConfig.compute_dtype`` says so -> optimizer step (Ranger or
  AMSGrad as optax computes them);
- weighted ragged batches reproduce running_loss / len(dataset)
  (reference :493-495); the loss sums stay on the device, one host sync an
  epoch;
- best-validation checkpointing (:502-516) held on the device and flushed
  to disk at most every ``_FLUSH_SECS`` and at the end, the plateau break
  (:546-550), ReduceLROnPlateau / cosine schedules stepped per epoch on the
  host (:386-426, 529-533), the loss history ``{run}_loss.txt``
  (:558-569), the Ranger second run from the best weights with lr x 0.09
  (:229-252), the sidecar with training times (utils.py:94-107);
- precise BN for 'bn' models: before every validation the running
  statistics are replaced by the moments pooled over the non-augmented
  train images;
- resumable snapshots (``TrainConfig.train_state_every``) with the JAX
  package's fingerprint check;
- data parallelism when the trainer is built inside a process group
  (``parallel.mesh.init_process_group``, one process per device): the
  model is wrapped in ``DistributedDataParallel``, 'bn' reduces its
  statistics over the group, and the step batch is
  ``pad_batch_to_devices(batch_size, world)`` of which each rank takes its
  contiguous slice.  Every rank draws the global batch's order and
  augmentation from the same seeds, so the step is the one-device step.
  Only rank 0 writes checkpoints, snapshots and the loss history.

The training set lives on the device when it fits (4 GiB).  Weights are
initialised as flax initialises them (truncated-normal LeCun kernels, zero
biases), from a generator seeded with ``TrainConfig.seed`` on the CPU, so
the card and the CPU start from the same weights.
"""

from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from microbeseg_torch.config import TrainConfig, get_max_epochs
from microbeseg_torch.models.convert import state_dict_from_variables
from microbeseg_torch.models.io import (
    load_train_state,
    load_variables,
    peek_train_state,
    save_checkpoint,
    save_train_state,
    write_sidecar,
)
from microbeseg_torch.models.unet import build_unet
from microbeseg_torch.ops.augment import (apply_params, draw_params,
                                          normalize_val, take_params)
from microbeseg_torch.parallel.mesh import (agree, all_reduce, is_distributed,
                                            pad_batch_to_devices, rank,
                                            world_size)
from microbeseg_torch.training.data import SplitArrays, TrainingData, epoch_batches
from microbeseg_torch.training.losses import get_batch_loss
from microbeseg_torch.training.optimizers import build_optimizer, set_learning_rate
from microbeseg_torch.training.schedules import CosineAnnealingLR, ReduceLROnPlateau
from microbeseg_torch.utils.device import resolve_device, upload


def _noop(*a, **k):
    pass


def _truncated_normal(shape, gen: torch.Generator) -> torch.Tensor:
    """Standard normal draws cut at +-2 by redrawing those outside."""
    x = torch.randn(shape, generator=gen)
    out = x.abs() > 2.0
    while out.any():
        x[out] = torch.randn(int(out.sum()), generator=gen)
        out = x.abs() > 2.0
    return x


def init_like_flax(model: nn.Module, seed: int) -> nn.Module:
    """flax's default initialisation, drawn on the CPU from ``seed``: conv
    and transposed-conv kernels truncated normal (+-2 sigma) with variance
    1 / fan_in (LeCun, flax's truncation correction), biases 0, norm
    scales 1 and offsets 0."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                fan_in = (w.shape[0] if isinstance(m, nn.ConvTranspose2d)
                          else w.shape[1]) * w.shape[2] * w.shape[3]
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                w.copy_(_truncated_normal(w.shape, gen) * std)
                nn.init.zeros_(m.bias)
            elif isinstance(m, (nn.GroupNorm, nn.BatchNorm2d)):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
                if isinstance(m, nn.BatchNorm2d):
                    m.reset_running_stats()
    return model


class Trainer:
    """Headless trainer; callbacks replace the reference's Qt signals.
    Runs on the CUDA card unless ``device`` says otherwise.  Built inside a
    process group, it is one rank of a data-parallel run on ``device``."""

    _DEVICE_CACHE_MAX_BYTES = 4 << 30   # larger training sets stay on the host
    _FLUSH_SECS = 120.0                 # max staleness of the best checkpoint

    def __init__(self, cfg: TrainConfig, path_models: Path,
                 text_output: Callable[[str], None] = _noop,
                 progress: Callable[[int], None] = _noop,
                 should_stop: Callable[[], bool] = lambda: False,
                 device=None):
        self.cfg = cfg
        self.path_models = Path(path_models)
        self.path_models.mkdir(parents=True, exist_ok=True)
        self.text_output = text_output
        self.progress = progress
        self.should_stop = should_stop
        self.device = resolve_device(device)
        self.model = build_unet(cfg.model).to(
            self.device, memory_format=torch.channels_last)
        self.rank, self.world = rank(), world_size()
        self.distributed = is_distributed()
        # in a process group DDP runs the training forward and averages
        # the gradients over the ranks in backward
        self._ddp = None
        if self.distributed:
            self._ddp = nn.parallel.DistributedDataParallel(
                self.model,
                device_ids=([torch.cuda.current_device()
                             if self.device.index is None
                             else self.device.index]
                            if self.device.type == "cuda" else None),
                broadcast_buffers=False)
        self.loss_fn = get_batch_loss(cfg.loss, cfg.label_type)
        self.stopped = False
        self._dev_memo: Dict[int, tuple] = {}
        self._last_best = None
        self._timing: Dict = {}

    @property
    def net(self) -> nn.Module:
        """The module that runs the training forward: ``self.model``, or
        its DDP wrapper in a process group."""
        return self.model if self._ddp is None else self._ddp

    # ------------------------------------------------------------------
    # one step
    # ------------------------------------------------------------------

    def _autocast(self):
        return torch.autocast(self.device.type, dtype=torch.bfloat16,
                              enabled=self.cfg.compute_dtype == "bfloat16")

    def forward_backward(self, images, labels, weights) -> torch.Tensor:
        """Loss and gradients of one augmented batch; returns the weighted
        loss sum (on the device).  In a process group the batch is this
        rank's slice: its loss sum over the global weight sum, times the
        world size, so that DDP's mean over the ranks is the gradient of
        the global weighted mean (padded slots weigh 0)."""
        self.model.train()
        with self._autocast():
            preds = self.net(images)
        loss_sum = self.loss_fn(preds, labels, weights)
        w_sum = all_reduce(torch.sum(weights).detach())
        loss = loss_sum / torch.clamp(w_sum, min=1.0) * self.world
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        return loss_sum.detach()

    def train_step(self, images, labels, weights, params) -> torch.Tensor:
        aug_img, aug_labels = apply_params(images, labels, params,
                                           self.cfg.label_type)
        loss_sum = self.forward_backward(aug_img, aug_labels, weights)
        self.optimizer.step()
        return loss_sum

    @torch.no_grad()
    def eval_step(self, images, labels, weights) -> torch.Tensor:
        self.model.eval()
        with self._autocast():
            preds = self.model(normalize_val(images))
        return self.loss_fn(preds, labels, weights)

    # ------------------------------------------------------------------
    # device residency
    # ------------------------------------------------------------------

    def _device_cache(self, split: SplitArrays):
        """(images, labels) as tensors on the device when the split fits in
        ``_DEVICE_CACHE_MAX_BYTES`` (a batch is then a gather there), else
        on the host.  Kept per split, so the second run reuses them."""
        hit = self._dev_memo.get(id(split))
        if hit is not None and hit[0] is split:
            return hit[1]
        nbytes = split.images.nbytes + sum(v.nbytes
                                           for v in split.labels.values())
        dev = (self.device if nbytes <= self._DEVICE_CACHE_MAX_BYTES
               else torch.device("cpu"))
        out = (torch.from_numpy(split.images).to(dev),
               {k: torch.from_numpy(v).to(dev)
                for k, v in split.labels.items()})
        self._dev_memo[id(split)] = (split, out)
        return out

    def _batch(self, cached, idx: np.ndarray, w: Optional[np.ndarray] = None):
        """Rows ``idx`` of cached (images, labels) on the device (and the
        weights ``w``), queued without a host sync."""
        images, labels = cached
        rows = upload(torch.from_numpy(idx.astype(np.int64)), images.device)
        out = [upload(images[rows], self.device),
               {k: upload(v[rows], self.device) for k, v in labels.items()}]
        if w is not None:
            out.append(upload(torch.from_numpy(w), self.device))
        return out

    # ------------------------------------------------------------------
    # the reference train() protocol (train.py:316-576)
    # ------------------------------------------------------------------

    def _initial_state(self, second_run: bool, init_state) -> None:
        if init_state is not None:
            self.model.load_state_dict(init_state)
        elif second_run:     # from the best checkpoint (reference :240-242)
            self.model.load_state_dict(state_dict_from_variables(
                load_variables(self.path_models
                               / f"{self.cfg.run_name}.ckpt")))
        else:
            init_like_flax(self.model, self.cfg.seed)

    def train(self, data: TrainingData, best_loss: float = 1e4,
              print_output: bool = False, resume: bool = False,
              init_state: Optional[Dict[str, torch.Tensor]] = None) -> float:
        cfg = self.cfg
        second_run = best_loss < 1e3
        max_epochs = cfg.max_epochs or get_max_epochs(len(data),
                                                      data.crop_size)
        if second_run:
            self.text_output("Start 2nd run with cosine annealing")
        else:
            self.text_output("-" * 10)
            self.text_output(cfg.run_name)
            self.text_output("-" * 10)
            self.text_output(
                f"Train/validate on {len(data.train)}/{len(data.val)} images")

        self._initial_state(second_run, init_state)
        self.optimizer, lr0 = build_optimizer(cfg, self.model, second_run)

        # schedules + break condition (reference :386-426)
        if cfg.optimizer == "adam":
            scheduler = ReduceLROnPlateau(lr0, factor=0.25,
                                          patience=max_epochs // 20,
                                          min_lr=3e-6)
            break_condition = 2 * max_epochs // 20 + 5
            run_epochs = max_epochs
        elif second_run:
            scheduler = CosineAnnealingLR(lr0, t_max=max_epochs // 10,
                                          eta_min=3e-5)
            break_condition = max_epochs // 10 + 1
            run_epochs = max_epochs // 10
        else:
            scheduler = ReduceLROnPlateau(lr0, factor=0.25,
                                          patience=max_epochs // 10,
                                          min_lr=0.075 * lr0)
            break_condition = 2 * max_epochs // 10 + 5
            run_epochs = max_epochs

        np_rng = np.random.default_rng(cfg.seed + (1000 if second_run else 0))
        aug_rng = torch.Generator().manual_seed(
            cfg.seed + (2 if second_run else 3))

        epochs_wo_improvement = 0
        train_hist, val_hist = [], []
        start_epoch = 0
        state_stem = self.path_models / f"{cfg.run_name}_state"
        if resume:
            # fingerprint check before reading the arrays: a snapshot of
            # another optimizer / width / schedule cannot be loaded
            host_meta = peek_train_state(state_stem)
            loaded = None
            if host_meta is not None:
                mismatched = self._snapshot_mismatch(host_meta)
                if mismatched:
                    self.text_output(
                        "Training snapshot found but rejected "
                        f"({', '.join(mismatched)} differ) — "
                        "starting from scratch")
                else:
                    loaded = load_train_state(state_stem)
            if loaded is not None and loaded[1].get("second_run") != second_run:
                self.text_output(
                    "Training snapshot belongs to the "
                    f"{'fine-tune' if loaded[1].get('second_run') else 'main'}"
                    " run — starting this phase from scratch")
            if loaded is not None and loaded[1].get("second_run") == second_run:
                arrays, host = loaded
                self.model.load_state_dict(arrays["model"])
                self.optimizer.load_state_dict(arrays["optimizer"])
                aug_rng.set_state(arrays["aug_rng"])
                np_rng.bit_generator.state = host["np_rng"]
                for k, v in host["sched"].items():
                    setattr(scheduler, k, v)
                start_epoch = host["epoch"] + 1
                best_loss = host["best_loss"]
                epochs_wo_improvement = host["epochs_wo_improvement"]
                train_hist = list(host["train_hist"])
                val_hist = list(host["val_hist"])
                self.text_output(
                    f"Resume training from epoch {start_epoch + 1}")
            elif host_meta is None:
                self.text_output("No training snapshot found — "
                                 "starting from scratch")
        since = time.time()
        epoch = start_epoch - 1
        best_state = None         # device copy of the best weights
        best_dirty = False        # newer than the disk checkpoint
        last_flush = time.time()

        def flush_best():
            nonlocal best_dirty, last_flush
            if best_dirty:
                if self.rank == 0:
                    save_checkpoint(best_state,
                                    self.path_models / cfg.run_name)
                best_dirty = False
                last_flush = time.time()

        train_cache = self._device_cache(data.train)
        val_cache = self._device_cache(data.val)
        size = data.crop_size
        # the step batch divides over the ranks; ragged and rounded-up
        # slots weigh 0, so the weighted loss stays exact
        step_bs = pad_batch_to_devices(cfg.batch_size, self.world)
        lo, hi = self._rank_slice(step_bs)

        for epoch in range(start_epoch, run_epochs):
            if agree(self.should_stop(), self.device):
                self.text_output("Stop training due to user interaction.")
                if self.rank == 0:
                    try:
                        (self.path_models / f"{cfg.run_name}.ckpt").unlink()
                    except FileNotFoundError:
                        pass
                self.stopped = True
                break

            # train phase: the loss sums stay on the device, one host sync;
            # every rank draws the global batch and takes its slice
            running = []
            for idx, w in epoch_batches(len(data.train), cfg.batch_size,
                                        np_rng, shuffle=True,
                                        step_size=step_bs):
                params = take_params(draw_params(aug_rng, len(idx), size),
                                     lo, hi)
                idx, w = idx[lo:hi], w[lo:hi]
                images, labels, weights = self._batch(train_cache, idx, w)
                running.append(self.train_step(images, labels, weights,
                                               params))
            train_loss = float(all_reduce(torch.stack(running).sum())
                               ) / len(data.train)
            train_hist.append(train_loss)

            if self._bn_layers():
                self._precise_stats(data.train, step_bs)

            # val phase
            running = []
            for idx, w in epoch_batches(len(data.val), cfg.batch_size,
                                        np_rng, shuffle=False,
                                        step_size=step_bs):
                idx, w = idx[lo:hi], w[lo:hi]
                images, labels, weights = self._batch(val_cache, idx, w)
                running.append(self.eval_step(images, labels, weights))
            val_loss = float(all_reduce(torch.stack(running).sum())
                             ) / len(data.val)
            val_hist.append(val_loss)

            msg = (f"{epoch + 1} / {run_epochs}: Loss train / val: "
                   f"{train_loss:.4f} / {val_loss:.4f}")
            if val_loss < best_loss:
                best_loss = val_loss
                msg += " --> save"
                best_state = {k: v.detach().clone()
                              for k, v in self.model.state_dict().items()}
                best_dirty = True
                epochs_wo_improvement = 0
            else:
                epochs_wo_improvement += 1
            self.text_output(msg)
            if print_output:
                print(msg)

            # outside the improvement branch: staleness stays bounded
            # through a plateau after an unflushed improvement
            if best_dirty and time.time() - last_flush > self._FLUSH_SECS:
                flush_best()

            set_learning_rate(self.optimizer, scheduler.step(val_loss))

            if (cfg.train_state_every > 0
                    and (epoch + 1) % cfg.train_state_every == 0):
                # the snapshot records best_loss; the checkpoint on disk
                # must hold the matching weights
                flush_best()
                if self.rank == 0:
                    save_train_state(
                        {"model": self.model.state_dict(),
                         "optimizer": self.optimizer.state_dict(),
                         "aug_rng": aug_rng.get_state()},
                        {"epoch": epoch, "best_loss": float(best_loss),
                         "epochs_wo_improvement": epochs_wo_improvement,
                         "train_hist": train_hist, "val_hist": val_hist,
                         "np_rng": np_rng.bit_generator.state,
                         "sched": {k: v for k, v in scheduler.__dict__.items()
                                   if not k.startswith("_")},
                         "second_run": second_run,
                         "cfg": self._snapshot_fingerprint()},
                        state_stem)

            self.progress(int(100 * (epoch + 1) / run_epochs))

            # >= not ==: a resume under another schedule may land past it
            if epochs_wo_improvement >= break_condition:
                self.text_output(
                    f"{epochs_wo_improvement} epochs without val loss "
                    "improvement --> break")
                break

        if not self.stopped:
            flush_best()
        if self.distributed:   # rank 0's files are on disk for every rank
            torch.distributed.barrier()
        # the best weights, still on the device, for the second run and
        # the recalibration
        self._last_best = best_state if not self.stopped else None

        if not self.stopped and epoch >= 0:
            elapsed = time.time() - since
            self.text_output(
                f"Training completed in {elapsed // 60:.0f}min "
                f"{elapsed % 60:.0f}s")
            if self.rank == 0:
                self._write_loss_history(train_hist, val_hist, second_run)
            self._timing = {"training_time": elapsed,
                            "trained_epochs": epoch + 1,
                            "second_run": second_run}
        return best_loss

    # ------------------------------------------------------------------
    # BatchNorm statistics re-estimation ("precise BN")
    # ------------------------------------------------------------------

    def _bn_layers(self):
        return [m for m in self.model.modules()
                if isinstance(m, nn.BatchNorm2d)]

    @torch.no_grad()
    def pooled_bn_moments(self, images: torch.Tensor, step_bs: int):
        """Per BatchNorm layer, (mean, var) pooled over ``images`` (N, H, W,
        1) raw intensities, on any device, in
        batches of ``step_bs`` (the ragged tail wraps around): each batch's
        mean and biased variance of the layer's input, taken by a forward
        hook in train mode, then mean* = E_b[mean_b] and var* = E_b[var_b]
        + Var_b[mean_b].  ``nn.BatchNorm2d`` keeps the unbiased variance in
        its running buffer and flax the biased one, so the moments are not
        read back from the buffers.  In a process group each rank runs its
        slice of every batch and the hook's moments are those of the whole
        batch (summed over the ranks), as the JAX package's sharded
        ``stat_step`` takes them."""
        layers = self._bn_layers()
        sums = {id(m): [0.0, 0.0, 0.0] for m in layers}

        def hook(m, inputs):
            x = inputs[0].float()
            if self.distributed:   # the global batch's moments
                n = all_reduce(torch.full((1,), x.numel() / x.shape[1],
                                          device=x.device))
                mean = all_reduce(x.sum(dim=(0, 2, 3))) / n
                var = all_reduce(((x - mean.view(1, -1, 1, 1)) ** 2).sum(
                    dim=(0, 2, 3))) / n
            else:
                mean = x.mean(dim=(0, 2, 3))
                var = x.var(dim=(0, 2, 3), unbiased=False)
            s = sums[id(m)]
            s[0], s[1], s[2] = s[0] + mean, s[1] + mean * mean, s[2] + var

        handles = [m.register_forward_pre_hook(hook) for m in layers]
        n = images.shape[0]
        order = np.arange(n)
        n_batches = 0
        lo, hi = self._rank_slice(step_bs)
        self.model.train()
        try:
            for start in range(0, n, step_bs):
                idx = np.resize(order[start:] if start + step_bs > n
                                else order[start:start + step_bs], step_bs)
                batch = self._batch((images, {}), idx[lo:hi])[0]
                with self._autocast():
                    self.model(normalize_val(batch))
                n_batches += 1
        finally:
            for h in handles:
                h.remove()
        out = {}
        for m in layers:
            s_mean, s_msq, s_var = (v / n_batches for v in sums[id(m)])
            out[m] = (s_mean, s_var + torch.clamp(s_msq - s_mean * s_mean,
                                                  min=0.0))
        return out

    def _precise_stats(self, split: SplitArrays, step_bs: int) -> None:
        images = self._device_cache(split)[0]
        for m, (mean, var) in self.pooled_bn_moments(images, step_bs).items():
            m.running_mean.copy_(mean)
            m.running_var.copy_(var)

    def recalibrate_batch_stats(self, data: TrainingData,
                                state: Optional[Dict[str, torch.Tensor]] = None
                                ) -> None:
        """Re-estimate the BatchNorm running statistics over the train set
        and rewrite the best checkpoint.  ``state``: the best weights if the
        caller holds them, else the checkpoint is read.  Models without
        BatchNorm ('gn', 'in') are left as they are."""
        if not self._bn_layers():
            return
        ckpt_path = self.path_models / f"{self.cfg.run_name}.ckpt"
        if state is None:
            state = state_dict_from_variables(load_variables(ckpt_path))
        self.model.load_state_dict(state)
        n = len(data.train)
        self._precise_stats(data.train, pad_batch_to_devices(
            min(self.cfg.batch_size, n), self.world))
        if self.rank == 0:
            save_checkpoint(self.model, ckpt_path)
        self.text_output(
            f"Recalibrated BatchNorm statistics over {n} train images")

    def _rank_slice(self, step_bs: int):
        """This rank's contiguous slots [lo, hi) of a step batch."""
        per = step_bs // self.world
        return self.rank * per, (self.rank + 1) * per

    # ------------------------------------------------------------------
    # snapshots and artefacts
    # ------------------------------------------------------------------

    def _snapshot_fingerprint(self) -> dict:
        """Config fields that shape the optimizer state and the schedule;
        a snapshot resumes only when they all match."""
        cfg = self.cfg
        return {"optimizer": cfg.optimizer, "batch_size": cfg.batch_size,
                "filters": list(cfg.model.filters),
                "normalization": cfg.model.normalization,
                "label_type": cfg.label_type, "loss": cfg.loss,
                "unet_type": cfg.model.unet_type,
                "act_fun": cfg.model.act_fun,
                "max_epochs": cfg.max_epochs}

    def _snapshot_mismatch(self, host: dict) -> list:
        """Fingerprint keys on which the snapshot differs from this run
        (a snapshot without a fingerprint is accepted)."""
        saved = host.get("cfg")
        if saved is None:
            return []
        current = self._snapshot_fingerprint()
        return [k for k, v in current.items() if saved.get(k) != v]

    def _write_loss_history(self, train_hist, val_hist, second_run):
        stats = np.transpose(np.array(
            [list(range(1, len(train_hist) + 1)), train_hist, val_hist]))
        path = self.path_models / f"{self.cfg.run_name}_loss.txt"
        if second_run:
            with open(path, "a") as f:
                f.write("\n")
                np.savetxt(f, X=stats, fmt=["%3i", "%2.5f", "%2.5f"],
                           delimiter=",")
        else:
            np.savetxt(fname=str(path), X=stats,
                       fmt=["%3i", "%2.5f", "%2.5f"],
                       header="Epoch, training loss, validation loss",
                       delimiter=",")

    # ------------------------------------------------------------------
    # the full protocol: main run (+ Ranger fine-tune), sidecar
    # ------------------------------------------------------------------

    def fit(self, data: TrainingData, print_output: bool = False,
            resume: bool = False, init_from: Optional[Path] = None) -> float:
        """The two-phase schedule.  ``init_from`` warm-starts the first run
        from a checkpoint stem (fine-tuning); it is ignored, with a message,
        when ``resume`` continues an accepted snapshot."""
        try:
            return self._fit(data, print_output, resume, init_from)
        finally:
            # a failed or finished trainer keeps no training set or weight
            # copies on the device
            self._dev_memo.clear()
            self._last_best = None

    def _fit(self, data: TrainingData, print_output: bool, resume: bool,
             init_from: Optional[Path]) -> float:
        if self.cfg.max_epochs is None:
            self.cfg = dataclasses.replace(
                self.cfg, max_epochs=get_max_epochs(len(data), data.crop_size))
        cfg = self.cfg

        host = None
        accepted = False
        if resume:
            host = peek_train_state(self.path_models
                                    / f"{cfg.run_name}_state")
            accepted = host is not None and not self._snapshot_mismatch(host)
        if accepted and host.get("second_run"):
            best = self.train(data, best_loss=host["best_loss"],
                              print_output=print_output, resume=True)
            extra: Dict = {}
            if self._timing.get("second_run"):
                extra["training_time_run_2"] = self._timing["training_time"]
                extra["trained_epochs_run2"] = self._timing["trained_epochs"]
            if not self.stopped:
                self.recalibrate_batch_stats(data, self._last_best)
                self._finish(extra)
            return best

        warm = None
        if init_from is not None:
            if accepted:
                self.text_output("Resuming a training snapshot: the "
                                 f"warm start from {init_from} is not used")
            else:
                warm = state_dict_from_variables(load_variables(
                    Path(init_from).with_suffix(".ckpt")))
        best = self.train(data, print_output=print_output, resume=resume,
                          init_state=warm)
        extra = dict(self._timing)
        overall = self._last_best
        if cfg.optimizer == "ranger" and not self.stopped:
            best = self.train(data, best_loss=best, print_output=print_output,
                              init_state=overall)
            if self._timing.get("second_run"):
                extra["training_time_run_2"] = self._timing["training_time"]
                extra["trained_epochs_run2"] = self._timing["trained_epochs"]
            # the second run may not improve on the first's best
            overall = self._last_best or overall
        if not self.stopped:
            self.recalibrate_batch_stats(data, overall)
            self._finish(extra)
        return best

    def _finish(self, extra: Dict) -> None:
        """The sidecar, on rank 0; a finished run leaves no snapshot for a
        later --resume."""
        if self.rank == 0:
            write_sidecar(self.cfg, self.path_models, extra)
            self._drop_train_state()
        if self.distributed:
            torch.distributed.barrier()

    def _drop_train_state(self) -> None:
        stem = self.path_models / f"{self.cfg.run_name}_state"
        for suffix in (".train_state", ".train_state.json"):
            try:
                stem.with_suffix(suffix).unlink()
            except FileNotFoundError:
                pass
