"""Checkpoint loading and writing: the JSON sidecar plus the flax ``.ckpt``.

A ``.ckpt`` is flax's msgpack serialization of the variable tree
(``flax.serialization.to_bytes``).  Neither flax nor msgpack is needed here:
``read_msgpack`` decodes the subset flax writes — maps, arrays, strings,
ints, floats, bin, and the ext types 1 (ndarray) and 3 (numpy scalar), each
a nested msgpack of ``(shape, dtype name, row-major bytes)``.  Flax splits
arrays above 2**30 bytes into ``__msgpack_chunked_array__`` maps; the
largest DUNet kernel (3*3*1024*1024 f32, ~38 MB) stays far below that, so
chunked arrays are refused rather than supported.  ``write_msgpack`` encodes
the same subset, and ``save_model`` writes a ``.ckpt`` and sidecar that this
module and the JAX package both load.

Training snapshots (``save_train_state``) are this package's own format.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from microbeseg_torch.config import (
    AUGMENTATION_TRANSFORMS,
    TrainConfig,
    read_sidecar,
    train_config_from_sidecar,
)
from microbeseg_torch.models.convert import (
    state_dict_from_variables,
    variables_from_state_dict,
)
from microbeseg_torch.models.unet import UNet, build_unet
from microbeseg_torch.utils.device import resolve_device

CKPT_SUFFIX = ".ckpt"

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    """Sequential msgpack decoder over one bytes object."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        fixed = {
            0xC0: lambda: None, 0xC2: lambda: False, 0xC3: lambda: True,
            0xC4: lambda: bytes(self.take(self.unpack(">B"))),
            0xC5: lambda: bytes(self.take(self.unpack(">H"))),
            0xC6: lambda: bytes(self.take(self.unpack(">I"))),
            0xC7: lambda: self._ext(self.unpack(">B")),
            0xC8: lambda: self._ext(self.unpack(">H")),
            0xC9: lambda: self._ext(self.unpack(">I")),
            0xCA: lambda: self.unpack(">f"), 0xCB: lambda: self.unpack(">d"),
            0xCC: lambda: self.unpack(">B"), 0xCD: lambda: self.unpack(">H"),
            0xCE: lambda: self.unpack(">I"), 0xCF: lambda: self.unpack(">Q"),
            0xD0: lambda: self.unpack(">b"), 0xD1: lambda: self.unpack(">h"),
            0xD2: lambda: self.unpack(">i"), 0xD3: lambda: self.unpack(">q"),
            0xD4: lambda: self._ext(1), 0xD5: lambda: self._ext(2),
            0xD6: lambda: self._ext(4), 0xD7: lambda: self._ext(8),
            0xD8: lambda: self._ext(16),
            0xD9: lambda: self._str(self.unpack(">B")),
            0xDA: lambda: self._str(self.unpack(">H")),
            0xDB: lambda: self._str(self.unpack(">I")),
            0xDC: lambda: self._array(self.unpack(">H")),
            0xDD: lambda: self._array(self.unpack(">I")),
            0xDE: lambda: self._map(self.unpack(">H")),
            0xDF: lambda: self._map(self.unpack(">I")),
        }
        if b not in fixed:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        return fixed[b]()

    def _str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def _array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        if "__msgpack_chunked_array__" in out:
            raise ValueError("chunked msgpack arrays (leaves above 1 GiB) "
                             "are not supported")
        return out

    def _ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        arr = _ndarray_from_bytes(payload)
        return arr if code == _EXT_NDARRAY else arr[()]


def _ndarray_from_bytes(payload: bytes) -> np.ndarray:
    shape, dtype_name, buf = read_msgpack(payload)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(dtype_name)).reshape(shape).copy()


def read_msgpack(data: bytes) -> Any:
    """Decode one msgpack object (the flax subset; see module docstring)."""
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def _sized(n: int, small: int, small_base: int, codes) -> bytes:
    """A msgpack length header: the one-byte form below ``small`` (where
    there is one), else the first of (8-, 16-, 32-bit) ``codes`` that fits."""
    if n < small:
        return bytes([small_base | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack length {n} too large")


def write_msgpack(obj: Any) -> bytes:
    """Encode nested dicts, lists, strings, bytes, bools, None, ints, floats
    and numpy arrays as flax's msgpack (arrays as ext type 1)."""
    if obj is None:
        return b"\xc0"
    if isinstance(obj, bool):
        return b"\xc3" if obj else b"\xc2"
    if isinstance(obj, int):
        if 0 <= obj < 1 << 64:
            return (bytes([obj]) if obj < 128
                    else b"\xcf" + struct.pack(">Q", obj))
        return b"\xd3" + struct.pack(">q", obj)
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        raw = obj.encode("utf-8")
        return _sized(len(raw), 32, 0xA0, (0xD9, 0xDA, 0xDB)) + raw
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return _sized(len(obj), 0, 0, (0xC4, 0xC5, 0xC6)) + bytes(obj)
    if isinstance(obj, (list, tuple)):
        return (_sized(len(obj), 16, 0x90, (None, 0xDC, 0xDD))
                + b"".join(write_msgpack(o) for o in obj))
    if isinstance(obj, dict):
        return (_sized(len(obj), 16, 0x80, (None, 0xDE, 0xDF))
                + b"".join(write_msgpack(k) + write_msgpack(v)
                           for k, v in obj.items()))
    if isinstance(obj, (np.ndarray, np.generic)):
        code = _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR
        arr = np.asarray(obj)
        payload = write_msgpack((list(arr.shape), arr.dtype.name,
                                 arr.tobytes("C")))
        return (_sized(len(payload), 0, 0, (0xC7, 0xC8, 0xC9))
                + struct.pack(">b", code) + payload)
    raise TypeError(f"cannot encode {type(obj).__name__} as msgpack")


def save_checkpoint(model: Union[torch.nn.Module, Dict[str, torch.Tensor]],
                    path: Union[str, Path]) -> Path:
    """Write the flax variable tree of a model (or of its ``state_dict``)
    as ``<path>.ckpt``; returns that path."""
    path = Path(path)
    if path.suffix != CKPT_SUFFIX:
        path = path.with_suffix(CKPT_SUFFIX)
    sd = model.state_dict() if isinstance(model, torch.nn.Module) else model
    path.write_bytes(write_msgpack(variables_from_state_dict(sd)))
    return path


def write_sidecar(cfg: TrainConfig, path_models: Union[str, Path],
                  extra: Optional[dict] = None) -> Path:
    """Write ``<run_name>.json`` under ``path_models``: the keys of the JAX
    package's ``write_sidecar``, with ``extra`` (training times, epochs)
    merged in."""
    sidecar = {
        "architecture": list(cfg.model.architecture),
        "batch_size": cfg.batch_size, "label_type": cfg.label_type,
        "loss": cfg.loss, "num_gpus": cfg.num_devices or 1,
        "optimizer": cfg.optimizer, "run_name": cfg.run_name,
        "transforms": AUGMENTATION_TRANSFORMS, "max_epochs": cfg.max_epochs,
        "framework": "microbeseg_torch",
        "compute_dtype": cfg.compute_dtype, "seed": cfg.seed}
    if extra:
        sidecar.update(extra)
    out = Path(path_models) / f"{cfg.run_name}.json"
    out.write_text(json.dumps(sidecar, ensure_ascii=False, indent=2),
                   encoding="utf-8")
    return out


def save_model(model: torch.nn.Module, cfg: TrainConfig,
               path_models: Union[str, Path]) -> Path:
    """Write ``<run_name>.ckpt`` (the flax variable tree of ``model``) and
    its JSON sidecar under ``path_models``; returns the ``.ckpt`` path."""
    path_models = Path(path_models)
    path_models.mkdir(parents=True, exist_ok=True)
    ckpt = save_checkpoint(model, path_models / cfg.run_name)
    write_sidecar(cfg, path_models)
    return ckpt


TRAIN_STATE_SUFFIX = ".train_state"


def save_train_state(arrays: Dict[str, Any], host: Dict[str, Any],
                     stem: Union[str, Path]) -> Path:
    """A resumable mid-training snapshot: ``<stem>.train_state`` holds
    ``arrays`` (the model's and the optimizer's state dicts and the
    augmentation generator's state) through ``torch.save``, a format of
    this package that the JAX package cannot read; ``<stem>.train_state.
    json`` holds the loop's ``host`` state under the JAX package's keys
    (``epoch``, ``best_loss``, ``epochs_wo_improvement``, ``train_hist``,
    ``val_hist``, ``np_rng``, ``sched``, ``second_run``, ``cfg``)."""
    stem = Path(stem)
    path = stem.with_suffix(TRAIN_STATE_SUFFIX)
    torch.save(arrays, path)
    stem.with_suffix(TRAIN_STATE_SUFFIX + ".json").write_text(
        json.dumps(host))
    return path


def load_train_state(stem: Union[str, Path]
                     ) -> Optional[Tuple[Dict[str, Any], Dict[str, Any]]]:
    """(arrays on the CPU, host) of a ``save_train_state`` snapshot, or None
    if there is none.  ``load_state_dict`` moves the arrays to the model's
    device."""
    stem = Path(stem)
    path = stem.with_suffix(TRAIN_STATE_SUFFIX)
    meta = stem.with_suffix(TRAIN_STATE_SUFFIX + ".json")
    if not (path.is_file() and meta.is_file()):
        return None
    arrays = torch.load(path, map_location="cpu", weights_only=False)
    return arrays, json.loads(meta.read_text())


def peek_train_state(stem: Union[str, Path]) -> Optional[Dict[str, Any]]:
    """Host state of a snapshot without touching the array payload."""
    meta = Path(stem).with_suffix(TRAIN_STATE_SUFFIX + ".json")
    return json.loads(meta.read_text()) if meta.is_file() else None


def load_variables(path: Union[str, Path]) -> Dict[str, Any]:
    """The ``{'params', 'batch_stats'}`` tree of a flax ``.ckpt`` as nested
    dicts of numpy arrays."""
    return read_msgpack(Path(path).read_bytes())


def _stem(model_path: Union[str, Path]) -> Path:
    model_path = Path(model_path)
    return (model_path.with_suffix("") if model_path.suffix == CKPT_SUFFIX
            else model_path)


def load_model(model_path: Union[str, Path],
               device: Optional[Union[str, torch.device]] = None
               ) -> Tuple[UNet, TrainConfig]:
    """Load (model, train_config) from a checkpoint path or stem.

    The JSON sidecar must sit next to the ``.ckpt`` (same stem).  The model
    is returned in eval mode on ``device`` (the CUDA card by default)."""
    device = resolve_device(device)
    stem = _stem(model_path)
    cfg = train_config_from_sidecar(
        read_sidecar(stem.parent / f"{stem.name}.json"))
    model = build_unet(cfg.model)
    sd = state_dict_from_variables(
        load_variables(stem.with_suffix(CKPT_SUFFIX)))
    model.load_state_dict(sd)
    return model.to(device).eval(), cfg
