#!/usr/bin/env python3
"""Where K3's time goes on the card: each phase of ``cc_tile_kernel``.

    python3 scripts/k3_phase_times.py

Needs a CUDA card and nvcc (exits 1 without a card).  Copies
``microbeseg_torch/csrc/cc.cu``, has thread 0 of every block read the SM's
clock at the kernel's phase boundaries (entry; before and after each of the
two ``grid.sync()``; the end), builds the copy into ``build/kernels/``
beside the port's own libraries, and launches it once on each mask after a
warm-up.  For each mask it prints, over the blocks, the median and the most
microseconds a block spent in Phase A, waiting in the first barrier, in
Phase B, waiting in the second barrier and in Phase C; then the
microseconds a launch of the instrumented kernel takes back to back from C
(no Python between launches).  The ids are held against the plain version
after the first launches and after the loop.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STAMP = ('  if (threadIdx.x == 0) stamps[blockIdx.x * 8 + {k}] = '
         'clock64();\n')
# (text, stamps before it, stamps after it, the text that follows) in
# cc_tile_kernel
ANCHORS = (
    ("  const bool rebuild = n_tiles > (int)gridDim.x;\n", (), (0,), ""),
    ("  grid.sync();\n", (1,), (2,), "\n  // Phase B"),
    ("  grid.sync();\n", (3,), (4,), "\n  // Phase C"),
    ("    __syncthreads();\n  }\n", (), (5,), "}\n\n// The card's SMs"),
)
PHASES = ("A", "barrier 1", "B", "barrier 2", "C")
EXTRA = r'''
extern "C" int phase_stamps(void *host, int blocks) {
  return (int)cudaMemcpyFromSymbol(host, stamps, blocks * 8 * 8);
}
// the tile side cc_tile_launch takes for (B, H, W), and its grid's blocks
extern "C" int phase_grid(int B, int H, int W, int *tile, int *blocks) {
  CcCard c;
  cudaError_t e = cc_card(&c);
  if (e != cudaSuccess) return (int)e;
  long long tiles64 = (long long)B * ((H + 63) / 64) * ((W + 63) / 64);
  *tile = tiles64 < c.sms ? 32 : 64;
  long long tiles = (long long)B * ((H + *tile - 1) / *tile) *
                    ((W + *tile - 1) / *tile);
  int cap = *tile == 32 ? c.cap32 : c.cap64;
  *blocks = (int)(tiles < cap ? tiles : cap);
  return 0;
}
extern "C" int sm_clock_khz() {
  int khz = 0;
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  return khz;
}
extern "C" float loop_us(const void *mask, void *out, int B, int H, int W,
                         int n, void *stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a, s);
  for (int i = 0; i < n; ++i) cc_tile_launch(mask, out, B, H, W, 2, s);
  cudaEventRecord(b, s);
  cudaEventSynchronize(b);
  float ms = 0;
  cudaEventElapsedTime(&ms, a, b);
  return ms * 1e3f / n;
}
'''


def instrumented_source() -> str:
    src = (ROOT / "microbeseg_torch/csrc/cc.cu").read_text()
    head = "template <int TILE>\n__global__ void __launch_bounds__"
    if src.count(head) != 1:
        raise RuntimeError("cc.cu: cc_tile_kernel's declaration moved")
    src = src.replace(head, "__device__ long long stamps[8 * 8192];\n" + head)
    for text, before, after, follows in ANCHORS:
        if src.count(text + follows) != 1:
            raise RuntimeError(f"cc.cu: anchor not found: {text + follows!r}")
        src = src.replace(text + follows, "".join(
            STAMP.format(k=k) for k in before) + text + "".join(
            STAMP.format(k=k) for k in after) + follows)
    return src + EXTRA


def build() -> ctypes.CDLL:
    from microbeseg_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "cc_phase_times.cu"
    so = _build.BUILD_DIR / "libcc_phase_times.so"
    cu.write_text(instrumented_source())
    cmd = _build._nvcc_cmd("cc", so)
    cmd[-1] = str(cu)
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError("nvcc failed:\n" + r.stdout + r.stderr)
    lib = ctypes.CDLL(str(so))
    v, i = ctypes.c_void_p, ctypes.c_int
    lib.cc_tile_launch.argtypes = [v, v, i, i, i, i, v]
    lib.cc_tile_launch.restype = i
    lib.phase_stamps.argtypes = [v, i]
    lib.phase_grid.argtypes = [i, i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.loop_us.argtypes = [v, v, i, i, i, i, v]
    lib.loop_us.restype = ctypes.c_float
    return lib


def masks(dev) -> dict:
    import chip_smoke as cs
    from microbeseg_torch.ops.filters import gaussian_filter

    rng = np.random.default_rng(1)
    gaps = np.zeros((1, 256, 256), bool)
    for _ in range(30):   # thin segments, as the label path's gap masks
        y, x = rng.integers(0, 256, 2)
        dy, dx = ((0, 1), (1, 0), (1, 1), (1, -1))[rng.integers(0, 4)]
        for k in range(rng.integers(2, 6)):
            if 0 <= y + k * dy < 256 and 0 <= x + k * dx < 256:
                gaps[0, y + k * dy, x + k * dx] = True

    def seeds(fields):
        return gaussian_filter(torch.from_numpy(fields).to(dev), 0.5) > 0.6

    return {
        "gaps 1x256^2": torch.from_numpy(gaps).to(dev),
        "blobs 16x256^2": seeds(cs.blob_fields(rng, 16, 256, 40)),
        "speckle 16x256^2": torch.from_numpy(
            rng.random((16, 256, 256)) < 0.35).to(dev),
        "empty 16x256^2": torch.zeros((16, 256, 256), dtype=torch.bool,
                                      device=dev),
        "blobs 2048^2": seeds(cs.big_blob_fields(rng, 1, (2048, 2048), 900)),
        "blobs 4096^2": seeds(cs.big_blob_fields(rng, 1, (4096, 4096), 3600)),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_phase_times: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from microbeseg_torch.ops import cc

    dev = torch.device("cuda")
    lib = build()
    clock_khz = lib.sm_clock_khz()
    print(cs.card_line(), f"SM clock {clock_khz} kHz", flush=True)
    stream = torch._C._cuda_getCurrentRawStream(0)
    for name, m in masks(dev).items():
        B, H, W = m.shape
        tile, blocks = ctypes.c_int(), ctypes.c_int()
        if lib.phase_grid(B, H, W, ctypes.byref(tile), ctypes.byref(blocks)):
            raise RuntimeError("cc_card failed")
        tile, blocks = tile.value, blocks.value
        tiles = B * -(-H // tile) * -(-W // tile)
        out = torch.empty((B, H, W), dtype=torch.int32, device=dev)
        want = cc.connected_components_plain(m)
        for _ in range(3):
            if lib.cc_tile_launch(m.data_ptr(), out.data_ptr(), B, H, W, 2,
                                  stream):
                raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"{name}: ids differ from the plain version")
        st = np.zeros(blocks * 8, np.int64)
        lib.phase_stamps(st.ctypes.data, blocks)
        st = st.reshape(blocks, 8)[:, :6]
        us = np.diff(st, axis=1) / (clock_khz / 1e3)
        loop = lib.loop_us(m.data_ptr(), out.data_ptr(), B, H, W, 200, stream)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"{name}: ids differ after the loop")
        phases = ", ".join(
            f"{p} {np.median(us[:, i]):.2f}/{us[:, i].max():.2f}"
            for i, p in enumerate(PHASES))
        print(f"{name}: {tiles} tiles of {tile}^2 on {blocks} blocks; us a "
              f"block, median/most: {phases}; blocks' mean span "
              f"{us.sum(axis=1).mean():.2f}; launch back to back: "
              f"{loop:.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
