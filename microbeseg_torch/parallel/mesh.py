"""Device mesh, batch splitting and process groups for data parallelism.

Port of ``microbeseg_tpu/parallel/mesh.py``.  The JAX package shards a
jitted step's batch axis over a 'data' mesh and lets XLA insert the
gradient all-reduce and the cross-replica BatchNorm reductions.  The port
does the same work in two ways:

- inference (``InferenceEngine(mesh=)``, ``Evaluator(mesh=)``) runs in one
  process: ``get_mesh`` names the devices, ``replicated_sharding`` puts one
  replica of a module on each, ``batch_sharding`` cuts a batch into one
  contiguous share per device;
- training runs one process per device in a process group
  (``init_process_group``): the trainer wraps its model in
  ``DistributedDataParallel``, and ``all_reduce`` is the sum that autograd
  sees, for the cross-replica BatchNorm (``models/blocks.make_norm``) and
  the global loss weight.  NCCL joins CUDA ranks, gloo CPU ranks.
"""

from __future__ import annotations

import copy
import datetime
import os
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from microbeseg_torch.utils.device import resolve_device

@dataclass(frozen=True)
class Mesh:
    """The devices of a 'data' mesh, in shard order."""
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def get_mesh(num_devices: Optional[int] = None,
             device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """The visible CUDA devices, or the first ``num_devices`` of them.  With
    ``device="cpu"``: ``num_devices`` CPU replicas (one when None)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return Mesh((dev,) * (num_devices or 1))
    devices = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
    n = num_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    return Mesh(tuple(devices[:n]))


def batch_sharding(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """``x`` cut along its first axis into one contiguous share per device
    of the mesh (the first shares one larger when the batch is ragged),
    each moved to its device."""
    return [s.to(d) for s, d in zip(torch.tensor_split(x, mesh.size),
                                    mesh.devices)]


def replicated_sharding(mesh: Mesh, module: nn.Module) -> List[nn.Module]:
    """One replica of ``module`` on each device of the mesh: the module
    itself on the first, copies on the others."""
    replicas = [module.to(mesh.devices[0])]
    for d in mesh.devices[1:]:
        replicas.append(copy.deepcopy(module).to(d))
    return replicas


def pad_batch_to_devices(n: int, n_devices: int) -> int:
    """Smallest multiple of n_devices >= n (static batch padding)."""
    return ((n + n_devices - 1) // n_devices) * n_devices


# ----------------------------------------------------------------------
# process groups (training)
# ----------------------------------------------------------------------

def is_distributed() -> bool:
    return (torch.distributed.is_available()
            and torch.distributed.is_initialized())


def rank() -> int:
    return torch.distributed.get_rank() if is_distributed() else 0


def world_size() -> int:
    return torch.distributed.get_world_size() if is_distributed() else 1


def rank_device(rank_: int, device: Optional[Union[str, torch.device]] = None
                ) -> torch.device:
    """The device of a rank: ``cuda:<rank>`` for the CUDA card (or a
    device of its own when one is named with its index), else the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank_)
    return dev


def init_process_group(rank_: int, world: int, init_method: str,
                       device: torch.device,
                       backend: Optional[str] = None,
                       timeout_s: float = 600.0) -> None:
    """Join the group: NCCL when ``device`` is a CUDA device (without an
    index: ``cuda:<rank>``), gloo on the CPU, unless ``backend`` says
    otherwise.  ``init_method`` is a
    ``file://`` or ``tcp://localhost:<port>`` address."""
    if device.type == "cuda":
        torch.cuda.set_device(rank_ if device.index is None else device.index)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    torch.distributed.init_process_group(
        backend, init_method=init_method, rank=rank_, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))


def destroy_process_group() -> None:
    if is_distributed():
        torch.distributed.destroy_process_group()


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, as autograd sees it (the gradient of
    a sum is the gradient summed over the ranks); ``t`` itself outside a
    process group."""
    if not is_distributed():
        return t
    from torch.distributed.nn.functional import all_reduce as _all_reduce
    return _all_reduce(t)


def agree(flag: bool, device: torch.device) -> bool:
    """Whether any rank's ``flag`` is set (every rank gets the same
    answer, so all of them leave a loop at one epoch)."""
    if not is_distributed():
        return flag
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    torch.distributed.all_reduce(t)
    return bool(t.item() > 0)


def spawn(fn: Callable, args: Sequence, nprocs: int, timeout_s: float,
          poll: Callable[[], None] = lambda: None) -> None:
    """Start ``fn(rank, *args)`` in ``nprocs`` spawned processes and wait
    for them, calling ``poll`` about 10 times a second.  A process that
    fails raises here (its error text included); when ``timeout_s`` passes
    first, every process is terminated and this raises ``TimeoutError``.
    ``fn`` must live in a module that the child can import."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=tuple(args), nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=0.1):
            poll()
            if time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks did not finish in "
                                   f"{timeout_s:.0f} s")
        poll()
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(5)
            if p.is_alive():
                p.kill()


def file_init_method(directory: Union[str, os.PathLike]) -> str:
    """A ``file://`` rendezvous in ``directory`` (which must exist and not
    be shared with another group)."""
    return "file://" + os.path.join(os.fspath(directory), "rendezvous")
