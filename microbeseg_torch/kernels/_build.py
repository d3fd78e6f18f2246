"""Build and load the hand-written CUDA kernels of ``microbeseg_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC --split-compile 0 \
         -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

into ``build/kernels/`` at the repository root (listed in ``.gitignore``),
then loaded with ``ctypes``.  No ``--use_fast_math``: the flood kernel must
reproduce float32 division exactly.  The file name carries a hash of the
source, so an edited source is rebuilt.  ``build_all()`` starts one ``nvcc``
per source, all at once.

The wrappers count their launches in ``LAUNCHES`` through ``count_launch``
(one per wrapper call that launches its kernels), so a run can show that it
went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("flood", "flood_frame", "cc", "matmul", "epilogue", "follow",
           "rel_attention", "add_layernorm")

# launches per kernel wrapper (plain integers; reset with reset_launches)
LAUNCHES: Dict[str, int] = {"flood_packed": 0, "flood_packed_cluster": 0,
                            "flood_tiled": 0, "connected_components": 0,
                            "sequentialize_components": 0,
                            "ranked_components": 0,
                            "matmul_int8": 0, "matmul_bf16": 0,
                            "conv3x3_int8": 0, "conv_epilogue": 0,
                            # not a kernel: an eval-mode, no-grad chain
                            # [conv -> act -> BatchNorm] on the card that
                            # ran as modules, not through conv_epilogue
                            "conv_epilogue_fallback": 0,
                            # not a kernel: the plain watershed flood taken
                            # for labels the packed key cannot carry
                            "watershed_route": 0,
                            # the flows post-processing's Euler steps
                            # (csrc/follow.cu), and its plain grid_sample
                            # loop where that ran on the card
                            "follow_flows": 0, "follow_flows_fallback": 0,
                            # Cellpose-SAM's attention with its relative
                            # terms (csrc/rel_attention.cu)
                            "rel_attention": 0,
                            # its residual add, LayerNorm and bf16 cast
                            # (csrc/add_layernorm.cu)
                            "add_layernorm": 0}

_LIBS: Dict[str, ctypes.CDLL] = {}
# an engine on a mesh launches from one host thread per device
_LAUNCH_LOCK = threading.Lock()
# and its threads' first launches would build one library at once
_LOAD_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(str(Path(root) / "bin" / "nvcc"))
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH, CUDA_HOME or /usr/local/cuda)")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _nvcc_cmd(name: str, out: Path) -> list:
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "--split-compile", "0", "-Xptxas", "-v", "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library in parallel (one nvcc per source).

    Returns each source's compiler output (``-Xptxas -v`` register and
    shared-memory report); raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.is_file():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                path = _lib_path(name)
                if not path.is_file():
                    build_all([name])
                lib = ctypes.CDLL(str(path))
                _LIBS[name] = lib
    return lib


_ENTRIES: Dict[tuple, object] = {}


def entry(lib: str, name: str, n_ptrs: int, n_ints: int,
          n_floats: int = 0):
    """The C entry ``name`` of ``csrc/<lib>.cu``: ``n_ptrs`` pointers, then
    ``n_ints`` ints, then ``n_floats`` floats, then the stream; returns the
    launches' ``cudaGetLastError()``.  Looked up and typed once."""
    fn = _ENTRIES.get((lib, name))
    if fn is None:
        fn = getattr(load(lib), name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
        _ENTRIES[(lib, name)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (its cudaGetLastError())."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(tensor) -> int:
    """PyTorch's current stream on the tensor's device, for a launch: the
    raw handle, as PyTorch's own generated launchers fetch it.  Building a
    ``torch.cuda.Stream`` for it (``torch.cuda.current_stream(dev)
    .cuda_stream``) costs several microseconds more on every launch;
    ``chip_smoke.py`` times both."""
    import torch
    index = tensor.device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def ptr(tensor) -> int:
    return tensor.data_ptr()
