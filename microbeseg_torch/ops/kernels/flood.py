"""Kernel K1: the packed-key marker flood, CUDA kernel and plain version.

``flood_packed`` is the port of ``microbeseg_tpu/ops/pallas/flood.py::
flood_pallas``: per image, the in-mask value is quantised into ``n_levels``
levels with the image's min and max, every pixel carries the packed key
``(level << label_bits) | label``, each level runs ``inner_steps``
synchronous 4-neighbour key-min steps over ``mask & level <= lvl`` (a grown
pixel re-keys at its own level), and full-mask steps then run to a fixed
point.  Within a level the packed order prefers the lower label id, where
the ``watershed`` flood prefers the lower value.

On a CUDA tensor the wrapper launches ``csrc/flood.cu`` (or raises); on a CPU
tensor it runs ``flood_packed_plain``, the same steps in PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from microbeseg_torch.kernels import _build

BIG_KEY = 0x7FFFFFFF
_BIG = 3.0e38

MAX_SIDE = 768  # largest side the whole-frame flood takes (K2 beyond)


def _check_packing(n_levels: int, label_bits: int) -> None:
    if label_bits + max(1, (n_levels - 1).bit_length()) > 31:
        raise ValueError(
            f"packed key overflow: {label_bits} label bits x {n_levels} levels")


def _as_batch(value, markers, mask):
    squeeze = value.ndim == 2
    if squeeze:
        value, markers, mask = value[None], markers[None], mask[None]
    return squeeze, value, markers, mask


def quantize_levels(value: torch.Tensor, mask: torch.Tensor,
                    n_levels: int) -> torch.Tensor:
    """Per-image flood level of each in-mask pixel, (B, H, W) int32, with the
    float32 operations of the TPU kernel: min and max over the mask,
    span = max(vmax - vmin, 1e-20), trunc((v - vmin) / span * (n - 1)),
    clipped to [0, n - 1].  Out-of-mask pixels get level 0."""
    big = torch.tensor(_BIG, dtype=torch.float32, device=value.device)
    vmin = torch.where(mask, value, big).amin(dim=(1, 2), keepdim=True)
    vmax = torch.where(mask, value, -big).amax(dim=(1, 2), keepdim=True)
    span = torch.clamp(vmax - vmin, min=1e-20)
    t = (value - vmin) / span * (n_levels - 1)
    t = torch.where(mask, t, torch.zeros_like(t))
    return torch.clamp(t.to(torch.int32), 0, n_levels - 1)


def _key_step(key, qshift, active, label_mask):
    """One packed step: unlabeled active pixels adopt the label of the
    minimum-key active neighbour and re-key at their own level."""
    big = torch.full_like(key, BIG_KEY)
    akey = torch.where(active, key, big)
    p = torch.nn.functional.pad(akey, (1, 1, 1, 1), value=BIG_KEY)
    H, W = key.shape[-2:]
    best = torch.minimum(
        torch.minimum(p[:, :H, 1:W + 1], p[:, 2:, 1:W + 1]),
        torch.minimum(p[:, 1:H + 1, :W], p[:, 1:H + 1, 2:]))
    grow = active & (key == BIG_KEY) & (best < BIG_KEY)
    return torch.where(grow, qshift | (best & label_mask), key)


def flood_packed_plain(value: torch.Tensor, markers: torch.Tensor,
                       mask: torch.Tensor, n_levels: int = 128,
                       inner_steps: int = 2,
                       label_bits: int = 12) -> torch.Tensor:
    """The flood in plain PyTorch: every level step and every cleanup step
    of the TPU kernel, batched over B.  (B, H, W) or (H, W) -> int32."""
    _check_packing(n_levels, label_bits)
    squeeze, value, markers, mask = _as_batch(value, markers, mask)
    value = value.to(torch.float32)
    mask = mask.to(torch.bool)
    markers = torch.where(mask, markers.to(torch.int32), 0)
    H, W = value.shape[-2:]
    label_mask = (1 << label_bits) - 1
    q = quantize_levels(value, mask, n_levels)
    qshift = q << label_bits
    key = torch.where(mask & (markers > 0), qshift | markers,
                      torch.full_like(qshift, BIG_KEY))
    for lvl in range(n_levels):
        active = mask & (q <= lvl)
        for _ in range(inner_steps):
            key = _key_step(key, qshift, active, label_mask)
    for _ in range(H * W):  # the geodesic bound; stops at the fixed point
        new = _key_step(key, qshift, mask, label_mask)
        if torch.equal(new, key):
            break
        key = new
    out = torch.where(key < BIG_KEY, key & label_mask, 0)
    return out[0] if squeeze else out


def flood_packed(value: torch.Tensor, markers: torch.Tensor,
                 mask: torch.Tensor, n_levels: int = 128,
                 inner_steps: int = 2, label_bits: int = 12,
                 steps_out: torch.Tensor = None,
                 work_out: torch.Tensor = None) -> torch.Tensor:
    """Batched packed-key flood: value (B, H, W) f32 (lower floods first),
    markers (B, H, W) int32 (< 2**label_bits), mask (B, H, W) bool ->
    (B, H, W) int32 labels.  CPU tensors run the plain version.

    Work counts of the kernel run, for bounds on its time: ``steps_out``, an
    optional (B,) int32 CUDA tensor, receives the number of steps run per
    image; to ``work_out``, an optional (B,) int64 CUDA tensor the caller
    zeroes, the kernel adds per image the candidate pixels its steps
    examined (in the mask, active at the level, still unlabelled)."""
    if value.device.type == "cpu":
        return flood_packed_plain(value, markers, mask, n_levels,
                                  inner_steps, label_bits)
    if value.device.type != "cuda":
        raise RuntimeError(f"flood_packed: unsupported device {value.device}")
    _check_packing(n_levels, label_bits)
    squeeze, value, markers, mask = _as_batch(value, markers, mask)
    B, H, W = value.shape
    if max(H, W) > MAX_SIDE:
        raise ValueError(f"flood_packed takes sides up to {MAX_SIDE}, got "
                         f"{H}x{W}")
    dev = value.device
    value = value.to(torch.float32).contiguous()
    markers = markers.to(dev, torch.int32).contiguous()
    mask = mask.to(dev, torch.bool).contiguous()
    out = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    scratch = torch.empty((3, B, H, W), dtype=torch.int32, device=dev)
    if steps_out is None:
        steps_out = torch.empty((B,), dtype=torch.int32, device=dev)
    if work_out is not None and (work_out.dtype != torch.int64
                                 or work_out.shape != (B,)
                                 or work_out.device != dev):
        raise ValueError("work_out must be a (B,) int64 tensor on the "
                         "value's device")
    lib = _build.load("flood")
    fn = lib.flood_packed_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    err = fn(_build.ptr(value), _build.ptr(markers), _build.ptr(mask),
             _build.ptr(out), _build.ptr(scratch[0]), _build.ptr(scratch[1]),
             _build.ptr(scratch[2]), _build.ptr(steps_out),
             None if work_out is None else _build.ptr(work_out), B, H, W,
             n_levels, inner_steps, label_bits, H * W,
             _build.stream_ptr(value))
    _build.check(err, "flood_packed")
    _build.LAUNCHES["flood_packed"] += 1
    return out[0] if squeeze else out


def packed_label_bits(side: int, n_levels: int, max_label: int):
    """Label bits of the packed key for frames whose larger side is
    ``side``: 12 when ``max_label < 4096``, else 24; None when the packed
    key cannot carry the labels.  Sides above 768 need the tiled flood
    (K2), which is not ported yet."""
    if side > MAX_SIDE:
        raise NotImplementedError(
            f"frames with a side above {MAX_SIDE} need the tiled flood (K2), "
            "ROADMAP Queue 1 item 6")
    if max_label < (1 << 12) and n_levels <= (1 << 19):
        return 12
    if max_label < (1 << 24) - 1 and n_levels <= 128:
        return 24
    return None


def flood_or_fallback(value, markers, mask, n_levels: int = 128,
                      max_label: int = 4095) -> torch.Tensor:
    """Route by frame side and label capacity, as the JAX package does:
    the packed flood with the bits of ``packed_label_bits``.  Labels the
    packed key cannot carry take the ``watershed`` flood on the CPU; on the
    card that flood has no kernel yet, so they raise."""
    bits = packed_label_bits(max(value.shape[-2:]), n_levels, max_label)
    if bits is not None:
        return flood_packed(value, markers, mask, n_levels=n_levels,
                            label_bits=bits)
    if value.device.type != "cpu":
        raise NotImplementedError(
            f"max_label {max_label} with {n_levels} levels does not fit the "
            "packed key; the card has no kernel for the watershed flood yet "
            "(ROADMAP Queue 1 item 13)")
    from microbeseg_torch.ops.watershed import watershed
    return watershed(value, markers, mask, n_levels=n_levels)
