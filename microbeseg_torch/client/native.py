"""ctypes loader for the native contour library (``native/contours.cpp``).

The port's copy of ``microbeseg_tpu/client/native.py``.  It compiles the
shared source as it is, with ``g++ -O2 -shared -fPIC``, on first use into
``build/native/libmbs_contours-<hash>.so`` at the repository root (git-ignored
through ``build/``; the hash of the source names the file, so an edited
source is rebuilt and the two packages never write one ``.so``).  Without a
compiler, or with ``MICROBESEG_NO_NATIVE=1`` in the environment, every
function here returns None and ``client/contours.py`` runs
its Python loops, which give the same output (the tests compare them).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "contours.cpp"
BUILD_DIR = _ROOT / "build" / "native"
_lib: Optional[ctypes.CDLL] = None
_tried = False
_guard = threading.Lock()


def _lib_path() -> Path:
    digest = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libmbs_contours-{digest}.so"


def _build(target: Path) -> bool:
    """Compile into a temporary name, then rename: processes that build at
    once never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", tmp,
                        str(_SRC)], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, target)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it once if needed; None when it cannot
    be built or loaded, or when ``MICROBESEG_NO_NATIVE=1`` asks for the
    Python loops."""
    global _lib, _tried
    with _guard:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("MICROBESEG_NO_NATIVE") == "1" or not _SRC.is_file():
            return None
        target = _lib_path()
        if not target.is_file() and not _build(target):
            return None
        try:
            _lib = _load_and_bind(target)
        except (OSError, AttributeError):
            return None
        return _lib


def _load_and_bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.mbs_trace_boundary.restype = ctypes.c_int
    lib.mbs_trace_boundary.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
    lib.mbs_rasterize_polygon.restype = None
    lib.mbs_rasterize_polygon.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int]
    lib.mbs_rasterize_rois.restype = None
    lib.mbs_rasterize_rois.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint16), ctypes.c_int,
        ctypes.c_int]
    lib.mbs_trace_all.restype = ctypes.c_int
    lib.mbs_trace_all.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int]
    lib.mbs_roi_strings.restype = ctypes.c_int64
    lib.mbs_roi_strings.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    return lib


def trace_boundary_native(labels: np.ndarray, inst_id: int) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    labels32 = np.ascontiguousarray(labels, dtype=np.int32)
    H, W = labels32.shape
    max_pts = 4 * (H + W) + 16
    while True:
        out = np.empty((max_pts, 2), dtype=np.int64)
        n = lib.mbs_trace_boundary(
            labels32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), H, W,
            int(inst_id), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            max_pts)
        if n >= 0:
            return out[:n]
        if n == -1:
            return np.zeros((0, 2), dtype=np.int64)
        if max_pts >= 4 * H * W + 16:  # should never truncate beyond this
            return out[:(-n - 1)]
        max_pts *= 4


def trace_all_native(labels: np.ndarray):
    """Batched whole-frame tracing: returns (xy, offsets, ids) with xy a
    concatenated (n_pts, 2) int64 (x, y) array, offsets (n_polys+1,) point
    offsets and ids (n_polys,) instance ids — polygon order identical to the
    Python per-instance/per-fragment loop.  None when no native library."""
    lib = get_lib()
    if lib is None:
        return None
    labels32 = np.ascontiguousarray(labels, dtype=np.int32)
    H, W = labels32.shape
    max_pts = max(1 << 16, 8 * (H + W))
    max_polys = 1 << 12
    while True:
        xy = np.empty((max_pts, 2), dtype=np.int64)
        offsets = np.empty(max_polys + 1, dtype=np.int64)
        ids = np.empty(max_polys, dtype=np.int32)
        n = lib.mbs_trace_all(
            labels32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), H, W,
            xy.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_pts,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_polys)
        if n >= 0:
            return xy[:offsets[n]], offsets[:n + 1], ids[:n]
        if n == -1:
            max_pts *= 4
        else:  # -2: polygon capacity
            max_polys *= 4


def roi_strings_native(xy: np.ndarray, offsets: np.ndarray):
    """OMERO points strings ("x,y x,y ...") for trace_all_native output.
    Returns a list of str (one per polygon) or None."""
    lib = get_lib()
    if lib is None:
        return None
    n_polys = len(offsets) - 1
    if n_polys <= 0:
        return []
    xy64 = np.ascontiguousarray(xy, dtype=np.int64)
    off64 = np.ascontiguousarray(offsets, dtype=np.int64)
    # worst case ~21 bytes per "x,y" token + separator
    cap = int(44 * max(off64[-1], 1) + 16)
    buf = ctypes.create_string_buffer(cap)
    str_offsets = np.empty(n_polys + 1, dtype=np.int64)
    total = lib.mbs_roi_strings(
        xy64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        off64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n_polys,
        buf, cap,
        str_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if total < 0:
        return None  # cannot happen with the bound above; fall back
    raw = buf.raw
    return [raw[str_offsets[p]:str_offsets[p + 1]].decode("ascii")
            for p in range(n_polys)]


def rasterize_polygon_native(poly_xy: np.ndarray,
                             shape) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    H, W = shape
    xy = np.ascontiguousarray(poly_xy, dtype=np.float64)
    out = np.zeros((H, W), dtype=np.uint8)
    lib.mbs_rasterize_polygon(
        xy.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), xy.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), H, W)
    return out.astype(bool)


def rasterize_rois_native(polys, shape) -> Optional[np.ndarray]:
    """polys: list of (n_i, 2) float arrays -> uint16 instance mask."""
    lib = get_lib()
    if lib is None:
        return None
    H, W = shape
    if not polys:
        return np.zeros((H, W), np.uint16)
    xy = np.ascontiguousarray(np.concatenate(polys, axis=0), dtype=np.float64)
    offsets = np.zeros(len(polys) + 1, dtype=np.int64)
    np.cumsum([len(p) for p in polys], out=offsets[1:])
    out = np.zeros((H, W), dtype=np.uint16)
    lib.mbs_rasterize_rois(
        xy.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(polys),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), H, W)
    return out
