"""Kernel K5: the tiled tensor-core matrix product and its plain versions.

``matmul_int8`` and ``matmul_bf16`` are the port of
``scripts/bench_pallas_int8_dot.py::make_matmul`` of the JAX package: C = A B
for A (M, K) and B (K, N), int8 operands with an exact int32 result, or
bfloat16 operands summed in float32 and rounded to bfloat16 once at the end.
Any M, K and N are taken (the TPU kernel needs each divisible by its block):
the kernel pads K with zeros and guards the edges of M and N.

``conv3x3_int8`` is the product inside ``models.blocks.QuantConv``, the int8
3x3 convolution of ``InferConfig.quantize``: A holds the 9 taps of the
quantised activations, (B * H * W, 9 * C_in), and B the quantised weights,
(9 * C_in, C_out).  Its kernel reads the taps straight from the activations,
so A is never written, and scales, adds the bias and casts in its epilogue.

On a CUDA tensor each wrapper launches its kernel (``csrc/matmul.cu``) or
raises; on a CPU tensor it runs the plain version beside it.  Which kernel a
CUDA tensor takes is a rule on its shape:

- ``matmul_int8`` / ``matmul_bf16``: the ``wgmma`` kernel fed by TMA when
  A's rows are 16-byte aligned (K * element size and A's address multiples
  of 16), else the ``mma.sync`` kernel, which gathers such rows by value.
  The ``wgmma`` kernel reads a bf16 B as it is stored when B's rows are
  16-byte aligned too, and a transposed copy otherwise (int8: always);
- ``conv3x3_int8``: the fused kernel when C_in is a multiple of 64 (a K
  slice of one tap is then a whole number of 64-byte swizzled rows) and
  C_out is at most 256 (one tile then holds every output channel), else
  ``tap_operand`` -> ``matmul_int8`` -> the dequantising arithmetic in
  PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from microbeseg_torch.kernels import _build

_TILE_BYTES = 64       # bytes of K per tile row of the mma.sync kernel
_SLICE_BYTES = 128     # bytes of K per tile row of the wgmma kernel
_CONV_CHANNELS = 64    # C_in must be a multiple of this for the fused kernel
_CONV_MAX_OUT = 256    # and C_out at most this: one tile holds every column
_PLAIN_ROWS = 1 << 18  # rows of A per float64 product of the int8 plain version


def _check(name: str, a: torch.Tensor, b: torch.Tensor, dtype) -> None:
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{name}: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)} do not multiply")
    if a.dtype != dtype or b.dtype != dtype:
        raise ValueError(f"{name}: operands must be {dtype}, got "
                         f"{a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"{name}: operands on {a.device} and {b.device}")
    if 0 in a.shape or 0 in b.shape:
        raise ValueError(f"{name}: empty operand {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")


def matmul_int8_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) x int8 (K, N) -> int32 (M, N) in plain PyTorch, exact on
    the CPU and on the card: the product runs in float64, which holds every
    partial sum of K * 127^2 exactly for K below 2^39, in blocks of rows so
    the float64 copy of A stays small."""
    _check("matmul_int8_plain", a, b, torch.int8)
    bd = b.double()
    return torch.cat([(a[s:s + _PLAIN_ROWS].double() @ bd).to(torch.int32)
                      for s in range(0, a.shape[0], _PLAIN_ROWS)])


def matmul_bf16_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 (M, K) x bf16 (K, N) -> bf16 (M, N) in plain PyTorch: a float32
    product of the exactly widened operands, rounded to bfloat16 once."""
    _check("matmul_bf16_plain", a, b, torch.bfloat16)
    return (a.float() @ b.float()).to(torch.bfloat16)


def _tile_width(n: int) -> int:
    """Columns of C per block of the wgmma kernel."""
    return 64 if n <= 64 else 128 if n <= 128 else 256


def _rows_aligned(a: torch.Tensor) -> bool:
    """TMA's condition on a contiguous matrix: 16-byte-aligned rows."""
    return (a.shape[1] * a.element_size()) % 16 == 0 and a.data_ptr() % 16 == 0


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it at an address that is a multiple of 16."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(name: str, a: torch.Tensor, b: torch.Tensor, out_dtype,
            route: str = None) -> torch.Tensor:
    """Launch one K5 kernel.  ``route`` is None everywhere in the package:
    the shape rule picks (``wgmma`` for 16-byte-aligned rows of A, else
    ``mma.sync``).  'wgmma' or 'mma_sync' forces a kernel and exists only so
    that ``chip_smoke.py`` and the CUDA tests can hold and time both kernels
    at one shape; no library caller passes it."""
    if a.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {a.device}")
    M, K = a.shape
    N = b.shape[1]
    if max(M, K, N) >= 1 << 31:
        raise ValueError(f"{name}: a dimension of {M} x {K} x {N} does not "
                         "fit the kernel's int32 sizes")
    a, b = a.contiguous(), b.contiguous()
    aligned = _rows_aligned(a)
    if route is None:
        route = "wgmma" if aligned else "mma_sync"
    if route == "wgmma":
        if not aligned:
            raise ValueError(f"{name}: rows of A {tuple(a.shape)} are not "
                             "16-byte aligned, as the wgmma kernel needs")
        entry, bk = f"{name}_tma_launch", _SLICE_BYTES // a.element_size()
        bn = _tile_width(N)
    elif route == "mma_sync":
        entry, bk = f"{name}_launch", _TILE_BYTES // a.element_size()
        bn = 64 if N <= 64 else 128
    else:
        raise ValueError(f"{name}: unknown route {route!r}")
    Kp = -(-K // bk) * bk
    Np = -(-N // bn) * bn
    # The kernels read B with K contiguous: scratch for B transposed and
    # zero-padded, written by a first kernel.  Only bf16 wgmma also reads B
    # as it is stored, when B's rows are 16-byte aligned like A's.
    bt = None
    if not (route == "wgmma" and a.dtype == torch.bfloat16
            and _rows_aligned(b)):
        bt = torch.empty((Np, Kp), dtype=a.dtype, device=a.device)
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    fn = _build.entry("matmul", entry, 4, 6)
    with torch.cuda.device(a.device):
        err = fn(_build.ptr(a), _build.ptr(b),
                 None if bt is None else _build.ptr(bt), _build.ptr(out), M,
                 K, N, Kp, Np, bn, _build.stream_ptr(a))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out


def matmul_int8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) x int8 (K, N) -> int32 (M, N), exact.  CUDA tensors go
    through the kernel, CPU tensors through the plain version."""
    _check("matmul_int8", a, b, torch.int8)
    if a.device.type == "cpu":
        return matmul_int8_plain(a, b)
    return _launch("matmul_int8", a, b, torch.int32)


def matmul_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 (M, K) x bf16 (K, N) -> bf16 (M, N) with float32 sums.  CUDA
    tensors go through the kernel, CPU tensors through the plain version."""
    _check("matmul_bf16", a, b, torch.bfloat16)
    if a.device.type == "cpu":
        return matmul_bf16_plain(a, b)
    return _launch("matmul_bf16", a, b, torch.bfloat16)


def tap_operand(x_q: torch.Tensor) -> torch.Tensor:
    """x_q (B, H, W, C) int8 -> (B * H * W, 9 * C) int8: the 3x3 windows of
    the zero-padded ``x_q`` in tap order (dy, dx, c).  The windows are a
    strided view that one copy makes contiguous; the copy moves a pixel's C
    bytes as the widest integers that divide them, not byte by byte.
    (``F.unfold`` has no int8 on the card.)"""
    B, H, W, C = x_q.shape
    word = next(dt for dt, n in ((torch.int64, 8), (torch.int32, 4),
                                 (torch.int16, 2), (torch.int8, 1))
                if C % n == 0)
    xp = F.pad(x_q.contiguous().view(word), (0, 0, 1, 1, 1, 1))
    taps = xp.unfold(1, 3, 1).unfold(2, 3, 1).permute(0, 1, 2, 4, 5, 3)
    return taps.reshape(B * H * W, -1).view(torch.int8)


def _check_conv(name, x_q, w_q, scale, bias, out_dtype):
    if x_q.ndim != 4 or w_q.ndim != 2 or w_q.shape[0] != 9 * x_q.shape[3]:
        raise ValueError(f"{name}: x_q {tuple(x_q.shape)} and w_q "
                         f"{tuple(w_q.shape)} are not (B, H, W, C) and "
                         "(9 * C, O)")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError(f"{name}: operands must be int8, got {x_q.dtype} "
                         f"and {w_q.dtype}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError(f"{name}: scale and bias must be float32, got "
                         f"{scale.dtype} and {bias.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: out_dtype must be float32 or bfloat16, "
                         f"got {out_dtype}")
    if 0 in x_q.shape or 0 in w_q.shape:
        raise ValueError(f"{name}: empty operand {tuple(x_q.shape)}, "
                         f"{tuple(w_q.shape)}")
    B, O = x_q.shape[0], w_q.shape[1]
    if bias.shape != (O,) or scale.numel() not in (O, B * O):
        raise ValueError(f"{name}: scale {tuple(scale.shape)} and bias "
                         f"{tuple(bias.shape)} do not fit {B} samples and "
                         f"{O} channels")
    # one row of scales per sample: (O,) and (B, 1, 1, O) both become (B, O)
    return scale.reshape(-1, O).expand(B, O)


def dequantize(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               out_dtype) -> torch.Tensor:
    """int32 sums (B, H, W, O) -> ``y * scale[b, o] + bias[o]``: a multiply
    and an add in float32, then one cast.  ``scale`` holds O values or, per
    sample, B * O."""
    scale = scale.reshape(-1, 1, 1, y.shape[-1])
    return (y.float() * scale + bias).to(out_dtype)


def conv3x3_int8_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                       scale: torch.Tensor, bias: torch.Tensor,
                       out_dtype=torch.float32) -> torch.Tensor:
    """``conv3x3_int8`` in plain PyTorch: the 9-tap operand, the exact
    float64 product and the dequantising arithmetic, one after the other."""
    scale = _check_conv("conv3x3_int8_plain", x_q, w_q, scale, bias,
                        out_dtype)
    y = matmul_int8_plain(tap_operand(x_q), w_q)
    return dequantize(y.view(*x_q.shape[:3], -1), scale, bias, out_dtype)


def conv3x3_int8(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """The int8 3x3 convolution with zero padding 1 and its dequantisation.

    x_q (B, H, W, C) int8, w_q (9 * C, O) int8 in tap order (dy, dx, c),
    scale float32 with O or B * O values (per channel, or per sample and
    channel), bias (O,) float32 -> (B, H, W, O) ``out_dtype`` (float32 or
    bfloat16): ``float(sum) * scale[b, o] + bias[o]``, the multiply and the
    add each rounded to float32, then one cast.  The int32 sums are exact.
    CUDA tensors go through a kernel, CPU tensors through the plain
    version."""
    if x_q.device.type == "cpu":
        return conv3x3_int8_plain(x_q, w_q, scale, bias, out_dtype)
    name = "conv3x3_int8"
    if x_q.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {x_q.device}")
    scale = _check_conv(name, x_q, w_q, scale, bias, out_dtype)
    B, H, W, C = x_q.shape
    O = w_q.shape[1]
    if C % _CONV_CHANNELS != 0 or O > _CONV_MAX_OUT:
        y = matmul_int8(tap_operand(x_q), w_q)
        return dequantize(y.view(B, H, W, O), scale, bias, out_dtype)
    if max(B * H * -(-W // 128), 9 * C) >= 1 << 31:
        raise ValueError(f"{name}: {tuple(x_q.shape)} does not fit the "
                         "kernel's int32 sizes")
    # TMA reads x_q from a 16-byte-aligned address; the epilogue loads
    # scales and biases in pairs
    x_q, w_q, scale, bias = (_aligned(t.contiguous())
                             for t in (x_q, w_q, scale, bias))
    bn = _tile_width(O)
    Np = -(-O // bn) * bn
    # scratch for w_q transposed and zero-padded, written by the first kernel
    bt = torch.empty((Np, 9 * C), dtype=torch.int8, device=x_q.device)
    out = torch.empty((B, H, W, O), dtype=out_dtype, device=x_q.device)
    fn = _build.entry("matmul", "conv3x3_int8_launch", 6, 8)
    with torch.cuda.device(x_q.device):
        err = fn(_build.ptr(x_q), _build.ptr(w_q), _build.ptr(bt),
                 _build.ptr(scale), _build.ptr(bias), _build.ptr(out), B, H,
                 W, C, O, Np, bn, int(out_dtype == torch.bfloat16),
                 _build.stream_ptr(x_q))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out
