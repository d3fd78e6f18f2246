"""The attention of a Cellpose-SAM block with SAM's decomposed relative
positions in its logits, and its plain version.

``rel_attention(qkv, rel_pos_h, rel_pos_w, heads, g)`` takes the block's
qkv projection as it was written, (B, g * g, 3 * D) with q, k and v of head
h at columns h * hd, D + h * hd and 2D + h * hd (D = heads * hd), and
returns the heads' outputs merged, (B, g * g, D), the layout the block's
``proj`` reads:

    softmax_j(q_i . k_j / sqrt(hd) + rel_h[i, j // g] + rel_w[i, j % g]) v_j
    rel_h[i, kh] = q_i . rel_pos_h[i // g - kh + g - 1]
    rel_w[i, kw] = q_i . rel_pos_w[i % g - kw + g - 1]

It takes CUDA tensors only and runs the kernel (``csrc/rel_attention.cu``),
one launch counted as ``rel_attention`` and its B * heads maps as the
profiling tally ``attention_maps``.  ``refusal`` names what the kernel does
not take, and ``rel_attention`` raises on it.  ``rel_attention_plain`` is
the tests' reference; the block's CPU route is its own (bias, then SDPA).
"""

from __future__ import annotations

from typing import Optional

import torch

from microbeseg_torch.kernels import _build
from microbeseg_torch.utils.profiling import count

HEAD_WIDTHS = (16, 64)
MAX_GRID = 64


def refusal(qkv: torch.Tensor, rel_pos_h: torch.Tensor,
            rel_pos_w: torch.Tensor, heads: int, g: int) -> Optional[str]:
    """Why ``rel_attention`` does not take these arguments, or None."""
    if not 1 <= g <= MAX_GRID:
        return f"a grid of {g} tokens a side: 1 to {MAX_GRID}"
    if qkv.ndim != 3 or qkv.shape[1] != g * g or heads < 1 \
            or qkv.shape[2] % (3 * heads):
        return f"qkv {tuple(qkv.shape)} must be (B, {g * g}, 3 * {heads} " \
               "* head width)"
    hd = qkv.shape[2] // (3 * heads)
    if hd not in HEAD_WIDTHS:
        return f"head width {hd}: the kernel takes {HEAD_WIDTHS}"
    if qkv.dtype != torch.bfloat16 or not qkv.is_contiguous() \
            or qkv.data_ptr() % 16:
        return f"qkv must be bfloat16, contiguous and 16-byte aligned, got " \
               f"{qkv.dtype}"
    for t in (rel_pos_h, rel_pos_w):
        if t.shape != (2 * g - 1, hd) or t.dtype != torch.float32 \
                or t.device != qkv.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            return f"rel_pos_h and rel_pos_w must be ({2 * g - 1}, {hd}) " \
                   "float32, contiguous and 16-byte aligned on qkv's device"
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (qkv, rel_pos_h, rel_pos_w)):
        return "no backward: call it where no tensor requires grad (under " \
               "torch.no_grad() or torch.inference_mode())"
    return None


def split_heads(qkv: torch.Tensor, heads: int):
    """q, k, v as (B, heads, N, hd) views of (B, N, 3 * heads * hd)."""
    B, n, c = qkv.shape
    return qkv.reshape(B, n, 3, heads, c // (3 * heads)).permute(
        2, 0, 3, 1, 4).unbind(0)


def rel_attention_plain(qkv: torch.Tensor, rel_pos_h: torch.Tensor,
                        rel_pos_w: torch.Tensor, heads: int,
                        g: int) -> torch.Tensor:
    """``rel_attention`` in plain PyTorch, float32 throughout: the block's
    own relative term (``models/vit_sam.rel_pos_bias``), an explicit
    softmax, the heads merged; in qkv's type."""
    from microbeseg_torch.models import vit_sam

    q, k, v = split_heads(qkv.float(), heads)
    B, _, n, hd = q.shape
    bias = vit_sam.rel_pos_bias(q, rel_pos_h.float(), rel_pos_w.float(), g)
    logits = q @ k.transpose(-1, -2) * hd ** -0.5 + bias
    out = torch.softmax(logits, dim=-1) @ v
    return out.transpose(1, 2).reshape(B, n, heads * hd).to(qkv.dtype)


def rel_attention(qkv: torch.Tensor, rel_pos_h: torch.Tensor,
                  rel_pos_w: torch.Tensor, heads: int,
                  g: int) -> torch.Tensor:
    """The block's attention, (B, g * g, D), through the kernel: CUDA
    tensors only."""
    if qkv.device.type != "cuda":
        raise ValueError(f"rel_attention: CUDA tensors only, got "
                         f"{qkv.device}")
    why = refusal(qkv, rel_pos_h, rel_pos_w, heads, g)
    if why is not None:
        raise ValueError(f"rel_attention: {why}")
    B, n, c = qkv.shape
    out = torch.empty(B, n, c // 3, dtype=qkv.dtype, device=qkv.device)
    fn = _build.entry("rel_attention", "rel_attention_launch", 4, 4)
    with torch.cuda.device(qkv.device):
        err = fn(_build.ptr(qkv), _build.ptr(rel_pos_h),
                 _build.ptr(rel_pos_w), _build.ptr(out), B, heads,
                 c // (3 * heads), g, _build.stream_ptr(qkv))
    _build.check(err, "rel_attention")
    _build.count_launch("rel_attention")
    count("attention_maps", B * heads)
    return out
