"""A ViT block's residual add, the LayerNorm that follows it and the cast
of that LayerNorm's output to bf16, in one pass, and its plain version.

``add_layernorm(x, h, norm)`` takes the float32 residual stream ``x`` (...,
D), the bf16 branch ``h`` of x's shape or None, and ``norm``, an
``nn.LayerNorm`` over D with float32 affine parameters.  It adds ``h`` to
``x`` in place, ``x + float(h)`` rounded once in float32 (PyTorch's own
add), and returns

    y = bf16(norm(x)),

LayerNorm in float32 rounded once to bf16 (nearest even), the rows autocast
hands the next linear layer.  It takes CUDA tensors only and runs the kernel
(``csrc/add_layernorm.cu``), one launch counted as ``add_layernorm`` and its
rows as the profiling tally ``add_layernorm_rows``.  ``refusal`` names what
the kernel does not take, and ``add_layernorm`` raises on it.
``add_layernorm_plain`` is the same contract in PyTorch (x updated in place,
``F.layer_norm``, one bf16 rounding): the tests' reference.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from microbeseg_torch.kernels import _build
from microbeseg_torch.utils.profiling import count

MAX_DIM = 1024   # a row in registers: 32 float32 values a lane of a warp


def refusal(x: torch.Tensor, h: Optional[torch.Tensor],
            norm: nn.Module) -> Optional[str]:
    """Why ``add_layernorm`` does not take these arguments, or None."""
    d = x.shape[-1] if x.ndim else 0
    if d < 8 or d % 8 or d > MAX_DIM:
        return f"D = {d}: a multiple of 8 up to {MAX_DIM} (a row in a " \
               "warp's registers)"
    if x.dtype != torch.float32 or not x.is_contiguous() \
            or x.data_ptr() % 16 or not 0 < x.numel() // d < 1 << 31:
        return f"x must be float32, contiguous, 16-byte aligned, 1 to " \
               f"2^31 - 1 rows, got {x.dtype} {tuple(x.shape)}"
    if h is not None and (h.shape != x.shape or h.dtype != torch.bfloat16
                          or h.device != x.device or not h.is_contiguous()
                          or h.data_ptr() % 16):
        return f"h must be bfloat16 of x's shape {tuple(x.shape)}, " \
               f"contiguous and 16-byte aligned on x's device, got " \
               f"{h.dtype} {tuple(h.shape)}"
    if not isinstance(norm, nn.LayerNorm) or norm.normalized_shape != (d,) \
            or norm.weight is None or norm.bias is None:
        return "norm must be a LayerNorm over D with affine weight and bias"
    for t in (norm.weight, norm.bias):
        if t.dtype != torch.float32 or t.device != x.device \
                or not t.is_contiguous() or t.data_ptr() % 16:
            return "the LayerNorm's weight and bias must be float32, " \
                   "contiguous and 16-byte aligned on x's device"
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, h, norm.weight, norm.bias)):
        return "no backward: call it where no tensor requires grad (under " \
               "torch.no_grad() or torch.inference_mode())"
    kind = x.device.type
    if not torch.is_autocast_enabled(kind) \
            or torch.get_autocast_dtype(kind) != torch.bfloat16:
        return "autocast off: the bf16 rows are for linear layers under " \
               "bf16 autocast"
    return None


def add_layernorm_plain(x: torch.Tensor, h: Optional[torch.Tensor],
                        norm: nn.Module) -> torch.Tensor:
    """``add_layernorm``'s contract in plain PyTorch: ``x += h`` in float32
    (one rounding), then ``F.layer_norm`` and one bf16 rounding."""
    if h is not None:
        x.add_(h)
    return F.layer_norm(x, norm.normalized_shape, norm.weight, norm.bias,
                        norm.eps).to(torch.bfloat16)


def add_layernorm(x: torch.Tensor, h: Optional[torch.Tensor],
                  norm: nn.Module) -> torch.Tensor:
    """``x += h`` in place and ``bf16(norm(x))`` through the kernel: CUDA
    tensors only."""
    if x.device.type != "cuda":
        raise ValueError(f"add_layernorm: CUDA tensors only, got {x.device}")
    why = refusal(x, h, norm)
    if why is not None:
        raise ValueError(f"add_layernorm: {why}")
    d = x.shape[-1]
    rows = x.numel() // d
    y = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    fn = _build.entry("add_layernorm", "add_layernorm_launch", 5, 2,
                      n_floats=1)
    with torch.cuda.device(x.device):
        err = fn(_build.ptr(x), None if h is None else _build.ptr(h),
                 _build.ptr(norm.weight), _build.ptr(norm.bias),
                 _build.ptr(y), rows, d, float(norm.eps),
                 _build.stream_ptr(x))
    _build.check(err, "add_layernorm")
    _build.count_launch("add_layernorm")
    count("add_layernorm_rows", rows)
    return y
