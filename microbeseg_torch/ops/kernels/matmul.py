"""Kernel K5: the tiled tensor-core matrix product and its plain versions.

``matmul_int8`` and ``matmul_bf16`` are the port of
``scripts/bench_pallas_int8_dot.py::make_matmul`` of the JAX package: C = A B
for A (M, K) and B (K, N), int8 operands with an exact int32 result, or
bfloat16 operands summed in float32 and rounded to bfloat16 once at the end.
Any M, K and N are taken (the TPU kernel needs each divisible by its block):
the kernel pads K with zeros and guards the edges of M and N.

``matmul_int8`` is the product inside ``models.blocks.QuantConv``, the int8
3x3 convolution of ``InferConfig.quantize``: there A holds the 9 taps of the
quantised activations, (B * H * W, 9 * C_in), and B the quantised weights,
(9 * C_in, C_out).

On a CUDA tensor each wrapper launches its kernel (``csrc/matmul.cu``) or
raises; on a CPU tensor it runs the plain version beside it.
"""

from __future__ import annotations

import ctypes

import torch

from microbeseg_torch.kernels import _build

_TILE_BYTES = 64       # bytes of K per shared-memory tile row in the kernel
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


def _launch(name: str, a: torch.Tensor, b: torch.Tensor,
            out_dtype) -> torch.Tensor:
    if a.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {a.device}")
    M, K = a.shape
    N = b.shape[1]
    if max(M, K, N) >= 1 << 31:
        raise ValueError(f"{name}: a dimension of {M} x {K} x {N} does not "
                         "fit the kernel's int32 sizes")
    a, b = a.contiguous(), b.contiguous()
    bk = _TILE_BYTES // a.element_size()
    bn = 64 if N <= 64 else 128
    Kp = -(-K // bk) * bk
    Np = -(-N // bn) * bn
    # scratch for B transposed and zero-padded, written by the first kernel
    bt = torch.empty((Np, Kp), dtype=a.dtype, device=a.device)
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    fn = getattr(_build.load("matmul"), f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    with torch.cuda.device(a.device):
        err = fn(_build.ptr(a), _build.ptr(b), _build.ptr(bt),
                 _build.ptr(out), M, K, N, Kp, Np, bn, _build.stream_ptr(a))
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
