"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA card; without one this raises rather than
    carrying on on the CPU.  CPU runs must ask for ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)


def upload(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device`` without waiting for the card: a plain
    ``.to()`` of a CPU tensor synchronises the stream after its copy.  The
    copy is queued instead; a pageable source is staged before the call
    returns, and large ones go through pinned memory."""
    if device.type != "cuda":
        return t.to(device)
    if t.device.type == "cpu" and t.numel() * t.element_size() > 1 << 16:
        t = t.pin_memory()
    return t.to(device, non_blocking=True)
