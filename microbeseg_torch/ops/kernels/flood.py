"""Kernels K1 and K2: the packed-key marker floods and their plain versions.

``flood_packed`` is the port of ``microbeseg_tpu/ops/pallas/flood.py::
flood_pallas``: per image, the in-mask value is quantised into ``n_levels``
levels with the image's min and max, every pixel carries the packed key
``(level << label_bits) | label``, each level runs ``inner_steps``
synchronous 4-neighbour key-min steps over ``mask & level <= lvl`` (a grown
pixel re-keys at its own level), and full-mask steps then run to a fixed
point.  Within a level the packed order prefers the lower label id, where
the ``watershed`` flood prefers the lower value.

``flood_tiled`` is the port of ``flood_tiled`` / ``_flood_packed`` there, the
flood for frames with a side above 768: the same steps with 24 label bits on
two pre-built int32 planes (level and mask in one, seeded keys in the
other).  The JAX package floods (512 + 2 * 64)^2 windows and sweeps up what
crosses a halo; the port floods the whole frame as one window, which ends
at the fixed point over the whole mask and leaves nothing to sweep up.

On a CUDA tensor each wrapper launches its kernel (``csrc/flood.cu``,
``csrc/flood_frame.cu``) or raises; on a CPU tensor it runs the plain
version beside it, the same steps in PyTorch.  ``flood_packed`` has two
kernels, picked by ``flood_packed_route``: one block per image for up to 256
levels, and an 8-block cluster per image for more.  ``flood_tiled`` launches
the front kernel (bitplanes in L2, keys updated in place, one grid barrier a
step).
"""

from __future__ import annotations


import torch

from microbeseg_torch.kernels import _build
from microbeseg_torch.utils import profiling

BIG_KEY = 0x7FFFFFFF
_BIG = 3.0e38

MAX_SIDE = 768  # largest side flood_packed takes (flood_tiled beyond)
BLOCK_MAX_LEVELS = 256  # most levels the one-block kernel takes
TILED_LABEL_BITS = 24
_INNER_STEPS = 2  # key-min steps per level of the frame flood, as in JAX
_MAX_PIXELS = 1 << 30  # the frame kernels index padded pixels with int32


def _check_packing(n_levels: int, label_bits: int) -> None:
    if label_bits + max(1, (n_levels - 1).bit_length()) > 31:
        raise ValueError(
            f"packed key overflow: {label_bits} label bits x {n_levels} levels")


def _check_work_out(work_out, B: int, dev) -> None:
    if work_out is not None and (work_out.dtype != torch.int64
                                 or work_out.shape != (B,)
                                 or work_out.device != dev):
        raise ValueError("work_out must be a (B,) int64 tensor on the "
                         "value's device")


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


def flood_packed_route(side: int, n_levels: int, label_bits: int) -> str:
    """The kernel ``flood_packed`` launches on the card for frames whose
    larger side is ``side``: ``'block'``, one block per image with its
    bitplanes in shared memory, for up to ``BLOCK_MAX_LEVELS`` levels (the
    engine's 128, the boundary method's 2, the threshold grid); else
    ``'cluster'``, an 8-block cluster per image.  Raises ``ValueError`` for
    what neither takes: a side above ``MAX_SIDE``, fewer than one level, a
    key that overflows int32."""
    if n_levels < 1:
        raise ValueError(f"flood_packed needs at least one level, got "
                         f"{n_levels}")
    _check_packing(n_levels, label_bits)
    if side > MAX_SIDE:
        raise ValueError(f"flood_packed takes sides up to {MAX_SIDE}, got "
                         f"{side}")
    return "block" if n_levels <= BLOCK_MAX_LEVELS else "cluster"


def flood_packed(value: torch.Tensor, markers: torch.Tensor,
                 mask: torch.Tensor, n_levels: int = 128,
                 inner_steps: int = 2, label_bits: int = 12,
                 steps_out: torch.Tensor = None,
                 work_out: torch.Tensor = None) -> torch.Tensor:
    """Batched packed-key flood: value (B, H, W) f32 (lower floods first),
    markers (B, H, W) int32 (< 2**label_bits), mask (B, H, W) bool ->
    (B, H, W) int32 labels.  CPU tensors run the plain version; on the card
    ``flood_packed_route`` picks the kernel.

    Work counts of the kernel run, for bounds on its time: ``steps_out``, an
    optional (B,) int32 CUDA tensor, receives the number of steps run per
    image; to ``work_out``, an optional (B,) int64 CUDA tensor the caller
    zeroes, the kernel adds per image the candidate pixels its steps
    examined (in the mask, active at the level, still unlabelled).  Both
    kernels give the same counts."""
    if value.device.type == "cpu":
        return flood_packed_plain(value, markers, mask, n_levels,
                                  inner_steps, label_bits)
    return _launch_packed(value, markers, mask, n_levels, inner_steps,
                          label_bits, steps_out, work_out)


def _launch_packed(value, markers, mask, n_levels, inner_steps, label_bits,
                   steps_out=None, work_out=None, route: str = None):
    """Launch K1.  ``route`` is None everywhere in the package:
    ``flood_packed_route`` picks.  'block' or 'cluster' forces a kernel and
    exists only so that ``chip_smoke.py`` and the CUDA tests can hold and
    time both kernels at one shape; no library caller passes it."""
    if value.device.type != "cuda":
        raise RuntimeError(f"flood_packed: unsupported device {value.device}")
    squeeze, value, markers, mask = _as_batch(value, markers, mask)
    B, H, W = value.shape
    rule = flood_packed_route(max(H, W), n_levels, label_bits)
    route = route or rule
    if route == "block" and rule != "block":
        raise ValueError(f"the block kernel takes up to {BLOCK_MAX_LEVELS} "
                         f"levels, got {n_levels}")
    dev = value.device
    value = value.to(torch.float32).contiguous()
    markers = markers.to(dev, torch.int32).contiguous()
    mask = mask.to(dev, torch.bool).contiguous()
    out = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    if steps_out is None:
        steps_out = torch.empty((B,), dtype=torch.int32, device=dev)
    _check_work_out(work_out, B, dev)
    work = None if work_out is None else _build.ptr(work_out)
    if route == "block":
        # the key plane, and the in-mask pixels sorted by level
        scratch = torch.empty((2, B, H, W), dtype=torch.int32, device=dev)
        fn = _build.entry("flood", "flood_block_launch", 8, 7)
        args = (_build.ptr(scratch[0]), _build.ptr(scratch[1]))
        name = "flood_packed"
    elif route == "cluster":
        # the level plane and two key planes (ping-pong)
        scratch = torch.empty((3, B, H, W), dtype=torch.int32, device=dev)
        fn = _build.entry("flood", "flood_packed_launch", 9, 7)
        args = tuple(_build.ptr(scratch[i]) for i in range(3))
        name = "flood_packed_cluster"
    else:
        raise ValueError(f"flood_packed: unknown route {route!r}")
    with torch.cuda.device(dev):  # the block kernel sets its shared memory
        err = fn(_build.ptr(value), _build.ptr(markers), _build.ptr(mask),
                 _build.ptr(out), *args, _build.ptr(steps_out), work, B, H,
                 W, n_levels, inner_steps, label_bits, H * W,
                 _build.stream_ptr(value))
    _build.check(err, name)
    _build.count_launch(name)
    # the images run side by side: the slowest sets the launch's steps
    profiling.count_steps(name, steps_out, "max")
    return out[0] if squeeze else out


def packed_planes(value: torch.Tensor, markers: torch.Tensor,
                  mask: torch.Tensor, n_levels: int):
    """The two planes the frame flood works on, each (B, H, W) int32, built
    as ``microbeseg_tpu/ops/pallas/flood.py::flood_tiled`` builds them:
    ``qs`` = level << 24 inside the mask (levels from the frame's own min
    and max) and ``BIG_KEY`` outside, ``key0`` = ``qs | marker`` at the
    seeds and ``BIG_KEY`` elsewhere."""
    value = value.to(torch.float32)
    mask = mask.to(torch.bool)
    q = quantize_levels(value, mask, n_levels)
    big = torch.full_like(q, BIG_KEY)
    qs = torch.where(mask, q << TILED_LABEL_BITS, big)
    seeded = mask & (markers > 0)
    key0 = torch.where(seeded, qs | markers.to(torch.int32), big)
    return qs, key0


def flood_planes_plain(qs: torch.Tensor, key0: torch.Tensor, n_levels: int,
                       inner_steps: int = _INNER_STEPS) -> torch.Tensor:
    """The frame flood on its two planes in plain PyTorch: every level step
    and every cleanup step of the TPU kernel ``_packed_flood_kernel``.
    (B, H, W) int32 planes -> int32 labels.  Outside the frame a neighbour
    reads ``BIG_KEY`` (the TPU kernel wraps around and has its caller keep
    the outermost ring out of the mask)."""
    label_mask = (1 << TILED_LABEL_BITS) - 1
    H, W = qs.shape[-2:]
    key = key0
    for lvl in range(n_levels):
        active = qs <= (lvl << TILED_LABEL_BITS)
        for _ in range(inner_steps):
            key = _key_step(key, qs, active, label_mask)
    in_mask = qs < BIG_KEY
    for _ in range(H * W):  # the geodesic bound; stops at the fixed point
        new = _key_step(key, qs, in_mask, label_mask)
        if torch.equal(new, key):
            break
        key = new
    return torch.where(key < BIG_KEY, key & label_mask, 0)


def _check_tiled(n_levels: int) -> None:
    if n_levels > 128:
        raise ValueError(f"24 label bits leave 7 level bits: n_levels "
                         f"{n_levels} > 128 would overflow the int32 key")


def flood_tiled_plain(value: torch.Tensor, markers: torch.Tensor,
                      mask: torch.Tensor,
                      n_levels: int = 128) -> torch.Tensor:
    """``flood_tiled`` in plain PyTorch: the planes, then every step on the
    whole frame.  (B, H, W) or (H, W) -> int32."""
    _check_tiled(n_levels)
    squeeze, value, markers, mask = _as_batch(value, markers, mask)
    qs, key0 = packed_planes(value, markers, mask, n_levels)
    out = flood_planes_plain(qs, key0, n_levels)
    return out[0] if squeeze else out


def flood_tiled(value: torch.Tensor, markers: torch.Tensor,
                mask: torch.Tensor, n_levels: int = 128,
                steps_out: torch.Tensor = None,
                work_out: torch.Tensor = None) -> torch.Tensor:
    """Packed-key flood of whole frames of any size with 24 label bits:
    value (B, H, W) f32 (lower floods first), markers (B, H, W) int32
    (< 2**24 - 1), mask (B, H, W) bool -> (B, H, W) int32 labels; each frame
    is quantised with its own min and max.  CPU tensors run the plain
    version.  On the card the planes are built in PyTorch and the kernel
    floods the frames one after the other, each on the whole card.

    ``steps_out`` and ``work_out`` as in ``flood_packed``."""
    if value.device.type == "cpu":
        return flood_tiled_plain(value, markers, mask, n_levels)
    if value.device.type != "cuda":
        raise RuntimeError(f"flood_tiled: unsupported device {value.device}")
    _check_tiled(n_levels)
    if n_levels < 1:
        raise ValueError(f"flood_tiled needs at least one level, got "
                         f"{n_levels}")
    squeeze, value, markers, mask = _as_batch(value, markers, mask)
    B, H, W = value.shape
    words = H * ((W + 31) // 32)
    if words * 32 >= _MAX_PIXELS:
        raise ValueError(f"flood_tiled takes frames below {_MAX_PIXELS} "
                         f"pixels with rows padded to 32, got {H}x{W}")
    dev = value.device
    qs, key0 = packed_planes(value, markers.to(dev), mask.to(dev), n_levels)
    qs, key0 = qs.contiguous(), key0.contiguous()
    out = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    if steps_out is None:
        steps_out = torch.empty((B,), dtype=torch.int32, device=dev)
    _check_work_out(work_out, B, dev)
    work = None if work_out is None else _build.ptr(work_out)
    # U (two buffers) and A (two buffers) as bitplanes, the in-mask pixels
    # sorted by level, and each frame's rotating flag words
    planes = torch.empty((4, words), dtype=torch.int32, device=dev)
    order = torch.empty((words * 32,), dtype=torch.int32, device=dev)
    flags = torch.zeros((B, 3), dtype=torch.int32, device=dev)
    fn = _build.entry("flood_frame", "flood_front_launch", 8, 6)
    with torch.cuda.device(dev):  # the launch sizes its grid for this card
        err = fn(_build.ptr(qs), _build.ptr(key0), _build.ptr(out),
                 _build.ptr(planes), _build.ptr(order), _build.ptr(flags),
                 _build.ptr(steps_out), work, B, H, W, n_levels,
                 _INNER_STEPS, H * W, _build.stream_ptr(value))
    _build.check(err, "flood_tiled")
    _build.count_launch("flood_tiled")
    # one launch a frame, one after the other
    profiling.count_steps("flood_tiled", steps_out, "sum")
    return out[0] if squeeze else out


def packed_label_bits(side: int, n_levels: int, max_label: int):
    """Label bits of the packed key for frames whose larger side is
    ``side``: up to 768, 12 when ``max_label < 4096``, else 24; above 768
    always 24 (``flood_tiled``).  None when the packed key cannot carry the
    labels.  (127 << 24) | 0xFFFFFF equals ``BIG_KEY``, hence the - 1."""
    if (side <= MAX_SIDE and max_label < (1 << 12)
            and n_levels <= (1 << 19)):
        return 12
    if max_label < (1 << 24) - 1 and n_levels <= 128:
        return 24
    return None


def flood_or_fallback(value, markers, mask, n_levels: int = 128,
                      max_label: int = 4095) -> torch.Tensor:
    """Route by frame side and label capacity, as the JAX package does:
    sides up to 768 take ``flood_packed`` with the bits of
    ``packed_label_bits``, larger frames ``flood_tiled``.  Labels the packed
    key cannot carry take the ``watershed`` flood, plain PyTorch on every
    device (JAX's XLA flood there), counted as ``watershed_route``."""
    side = max(value.shape[-2:])
    bits = packed_label_bits(side, n_levels, max_label)
    if bits is not None and side > MAX_SIDE:
        return flood_tiled(value, markers, mask, n_levels=n_levels)
    if bits is not None:
        return flood_packed(value, markers, mask, n_levels=n_levels,
                            label_bits=bits)
    from microbeseg_torch.ops.watershed import watershed
    _build.count_launch("watershed_route")
    return watershed(value, markers, mask, n_levels=n_levels)
