"""Headless workers: label creation and multi-iteration training.

Port of ``microbeseg_tpu/training/workers.py`` (the reference's
CreateLabelsWorker and TrainWorker, src/training/train.py:26-104,
:115-306, without Qt: callbacks replace signals).  The out-of-memory
ladder (batch 16 -> 8 -> 4, then filters (64, 1024) -> (32, 512) ->
(32, 256); reference :276-297) catches ``torch.OutOfMemoryError`` and
errors whose text says the memory ran out.

``run_training(num_devices=)`` trains data-parallel over that many
devices: one spawned process per device in a process group
(``parallel.mesh``), rank 0's messages and progress relayed to the
callbacks, ``should_stop`` relayed to every rank.  A rank that fails fails
the run with its error text, so the ladder sees an out-of-memory rank too.
"""

from __future__ import annotations

import os
import queue as queue_mod
import tempfile
import zipfile
from pathlib import Path
from typing import Callable, Optional

import torch

from microbeseg_torch.config import ModelConfig, TrainConfig, read_sidecar
from microbeseg_torch.ops.labelgen import get_label, max_major_axis_length
from microbeseg_torch.parallel.mesh import (destroy_process_group,
                                            file_init_method, get_mesh,
                                            init_process_group, rank_device,
                                            spawn)
from microbeseg_torch.training.data import TrainingData
from microbeseg_torch.training.trainer import Trainer
from microbeseg_torch.utils.device import resolve_device
from microbeseg_torch.utils.image import unique_path
from microbeseg_torch.utils.tiff import imread, imwrite


def _noop(*a, **k):
    pass


def create_labels(path: Path, label_type: str,
                  text_output: Callable[[str], None] = _noop,
                  progress: Callable[[int], None] = _noop,
                  should_stop: Callable[[], bool] = lambda: False,
                  device=None) -> bool:
    """Generate label TIFFs next to the mask TIFFs in {path}/{train,val}.
    Runs on the CUDA card unless ``device`` says otherwise."""
    path = Path(path)
    dev = resolve_device(device)
    mask_ids_train = sorted((path / "train").glob("mask*.tif"))
    mask_ids_val = sorted((path / "val").glob("mask*.tif"))
    if len(mask_ids_val) < 2 or len(mask_ids_train) < 2:
        text_output("The training and the validation set should each contain "
                    "at least two annotated images! Stop")
        return False
    text_output("Create labels")
    mask_ids = mask_ids_train + mask_ids_val
    for i, mask_id in enumerate(mask_ids):
        if should_stop():
            text_output("Stop label creation due to user interaction.")
            return False
        mask = imread(mask_id)
        # every radius-windowed label type needs the measured major axis
        # (reference train.py:74-84); max_mal=0 would shrink the EDT window
        # to nothing and emit all-zero labels
        max_mal = (max_major_axis_length(mask, device=dev)
                   if label_type in ("distance", "cell_dist",
                                     "cell_dist_clipped") else 0)
        label = get_label(mask=mask, label_type=label_type, max_mal=max_mal,
                          device=dev)
        fname = mask_id.name.split("mask_")[-1]
        if label_type == "distance":
            imwrite(mask_id.parent / f"cell_dist_{fname}", label[0])
            imwrite(mask_id.parent / f"neighbor_dist_{fname}", label[1])
        else:
            imwrite(mask_id.parent / f"{label_type}_{fname}", label)
        progress(int(100 * (i + 1) / len(mask_ids)))
    return True


_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory", "OOM")


def _is_oom(exc: Exception) -> bool:
    return (isinstance(exc, torch.OutOfMemoryError)
            or any(m in str(exc) for m in _OOM_MARKERS))


def _pretrained_filters(pretrained: Optional[Path]):
    """The filters of a warm-start checkpoint, from its sidecar."""
    if pretrained is None:
        return None
    stem = Path(pretrained).with_suffix("")
    return tuple(read_sidecar(stem.parent / f"{stem.name}.json")
                 ["architecture"][4])


def run_training(path_data: Path, path_models: Path, label_type: str,
                 iterations: int, optimizer: str, batch_size: int,
                 text_output: Callable[[str], None] = _noop,
                 progress: Callable[[int], None] = _noop,
                 should_stop: Callable[[], bool] = lambda: False,
                 print_output: bool = False,
                 seed: int = 0,
                 normalization: str = "gn",
                 max_epochs: Optional[int] = None,
                 train_state_every: int = 0,
                 resume: bool = False,
                 pretrained: Optional[Path] = None,
                 device=None,
                 num_devices: Optional[int] = None) -> bool:
    """Train ``iterations`` models (reference TrainWorker.start_training,
    train.py:124-306): a new run name per iteration, the activation tied
    to the optimizer (mish with ranger, relu with adam; reference :174),
    the flagship DUNet with strided-conv pooling, and the out-of-memory
    ladder.  Runs on the CUDA card unless ``device`` says otherwise.

    normalization: 'gn' by default, the JAX package's deviation from the
    reference's 'bn' (train.py:187): BatchNorm running statistics drift
    from the batch statistics under small batches and heavy augmentation.
    pretrained: checkpoint stem to warm-start each iteration's first run
    from.  Its architecture must match the model; when the ladder would
    narrow the model below it, training stops with a message.
    num_devices: data-parallel devices (None: every visible card; with
    ``device="cpu"``, that many CPU ranks, one when None).  At 1 the model
    trains in this process."""
    path_data, path_models = Path(path_data), Path(path_models)
    resolve_device(device)
    n_ranks = get_mesh(num_devices, device).size
    if (len(list((path_data / "train").glob("mask*"))) < 2
            or len(list((path_data / "val").glob("mask*"))) < 2):
        text_output("Not enough annotated images. Stop")
        return False
    if label_type not in ("boundary", "distance"):
        text_output(f"Unsupported label type for training: {label_type}")
        return False
    warm_filters = _pretrained_filters(pretrained)

    text_output("Start training")
    # the ranks of a data-parallel run read the set themselves
    data = (TrainingData.from_directory(path_data, label_type=label_type)
            if n_ranks == 1 else None)

    for i in range(iterations):
        if should_stop():
            text_output("Stop training due to user interaction.")
            return False
        run_name = unique_path(path_models,
                               label_type + "_model_{:02d}.ckpt").stem
        if resume and i == 0:
            # continue the most recent interrupted run
            snaps = sorted(path_models.glob(
                f"{label_type}_model_*_state.train_state"))
            if snaps:
                run_name = snaps[-1].name[:-len("_state.train_state")]
                text_output(f"Resuming {run_name}")
        act_fun = "mish" if optimizer == "ranger" else "relu"
        filters = (64, 1024)
        bs = batch_size

        while True:
            if warm_filters is not None and warm_filters != filters:
                text_output(f"The pretrained checkpoint has filters "
                            f"{warm_filters}; the model to train has "
                            f"{filters}. Stop")
                return False
            cfg = TrainConfig(
                model=ModelConfig(
                    unet_type="DU" if label_type == "distance" else "U",
                    act_fun=act_fun, pool_method="conv",
                    normalization=normalization,
                    ch_out=1 if label_type == "distance" else 3,
                    filters=filters),
                label_type=label_type,
                loss="smooth_l1" if label_type == "distance" else "ce_dice",
                optimizer=optimizer, batch_size=bs, run_name=run_name,
                seed=seed + i, max_epochs=max_epochs,
                train_state_every=train_state_every)
            trainer = None
            step_progress = (lambda p, i=i: progress(
                int((p + 100 * i) / iterations)))
            try:
                if n_ranks > 1:
                    stopped = _fit_ranks(
                        n_ranks, cfg, path_data, path_models, label_type,
                        device, text_output, step_progress, should_stop,
                        print_output, resume and i == 0, pretrained)
                    break
                trainer = Trainer(cfg, path_models, text_output=text_output,
                                  should_stop=should_stop,
                                  progress=step_progress, device=device)
                trainer.fit(data, print_output=print_output,
                            resume=resume and i == 0, init_from=pretrained)
                stopped = trainer.stopped
                break
            except Exception as exc:  # out-of-memory ladder (reference :276-297)
                if not _is_oom(exc):
                    raise
                del trainer
                if torch.cuda.is_available():
                    torch.cuda.empty_cache()
                if bs > 8:
                    text_output(f"Model does not fit on RAM/VRAM. Reduce "
                                f"batch size from {bs} to 8")
                    bs = 8
                elif bs > 4:
                    text_output(f"Model does not fit on RAM/VRAM. Reduce "
                                f"batch size from {bs} to 4")
                    bs = 4
                elif filters[0] > 32:
                    text_output("Model does not fit on RAM/VRAM. Reduce "
                                "number of kernels")
                    filters = (32, 512)
                elif filters[-1] == 512:
                    text_output("Model does not fit on RAM/VRAM. Reduce "
                                "model depth")
                    filters = (32, 256)
                else:
                    text_output("Please, try again with smaller batch size or "
                                "reduce the crop size")
                    return False
        if stopped:
            return False
        _zip_trainset(path_data, path_models / f"{run_name}_trainset.zip")
        progress(int(100 * (i + 1) / iterations))
    return True


def _fit_ranks(n_ranks: int, cfg: TrainConfig, path_data: Path,
               path_models: Path, label_type: str, device,
               text_output: Callable[[str], None],
               progress: Callable[[int], None],
               should_stop: Callable[[], bool], print_output: bool,
               resume: bool, init_from: Optional[Path]) -> bool:
    """``Trainer.fit`` on ``n_ranks`` spawned processes; returns whether the
    run was stopped.  Rank 0's messages and progress come back through a
    queue; ``should_stop`` is polled here and relayed as an event."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    messages, stop = ctx.Queue(), ctx.Event()
    stopped = [False]

    def poll():
        if should_stop():
            stop.set()
        while True:
            try:
                kind, value = messages.get_nowait()
            except queue_mod.Empty:
                return
            if kind == "text":
                text_output(value)
            elif kind == "progress":
                progress(value)
            else:
                stopped[0] = value

    with tempfile.TemporaryDirectory() as rendezvous:
        spawn(_train_rank,
              (n_ranks, file_init_method(rendezvous), cfg, path_data,
               path_models, label_type,
               None if device is None else str(device), messages, stop,
               print_output, resume, init_from, torch.get_num_threads()),
              n_ranks, timeout_s=float("inf"), poll=poll)
    return stopped[0]


def _train_rank(rank: int, world: int, init_method: str, cfg: TrainConfig,
                path_data: Path, path_models: Path, label_type: str,
                device: Optional[str], messages, stop, print_output: bool,
                resume: bool, init_from: Optional[Path],
                n_threads: int) -> None:
    """One rank of ``_fit_ranks`` (a spawned process)."""
    torch.set_num_threads(n_threads)
    dev = rank_device(rank, device)
    init_process_group(rank, world, init_method, dev)
    try:
        def say(msg):
            messages.put(("text", msg))

        def step(p):
            messages.put(("progress", p))

        data = TrainingData.from_directory(path_data, label_type=label_type)
        trainer = Trainer(cfg, path_models,
                          text_output=say if rank == 0 else _noop,
                          progress=step if rank == 0 else _noop,
                          should_stop=stop.is_set, device=dev)
        trainer.fit(data, print_output=print_output and rank == 0,
                    resume=resume, init_from=init_from)
        if rank == 0:
            messages.put(("stopped", trainer.stopped))
    finally:
        destroy_process_group()


def _zip_trainset(path_data: Path, zip_path: Path) -> None:
    """Reproducibility snapshot: the training set (without its test split)
    packed next to the model (reference train.py:265-274)."""
    with zipfile.ZipFile(zip_path, "w") as z:
        for sub_dir in sorted(Path(path_data).iterdir()):
            if not sub_dir.is_dir() or sub_dir.stem == "test":
                continue
            for file in sorted(sub_dir.glob("*")):
                z.write(file,
                        arcname=os.path.join(path_data.stem, sub_dir.stem,
                                             file.name),
                        compress_type=zipfile.ZIP_DEFLATED)
