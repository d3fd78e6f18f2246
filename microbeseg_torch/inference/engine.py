"""Inference engine: batched forward + post-processing on the card.

Port of the bucket path of ``microbeseg_tpu/inference/engine.py``: raw frames
upload once at their native dtype, are normalised per frame to [-1, 1],
padded up-left with -1 to the pad bucket, run through the (D)U-Net in
batches (bf16 autocast on CUDA), cropped back, and post-processed on the
device; only uint16 masks come back.

Not ported yet (they raise ``NotImplementedError``): ``scale_factor < 1``,
``apply_clahe``, ``quantize``, ``use_tiling`` and frames beyond the bucket
table (ROADMAP Queue 1 items 3, 5, 12 and 6), and boundary-method
post-processing.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from microbeseg_torch.config import InferConfig
from microbeseg_torch.models.io import load_model
from microbeseg_torch.ops.postprocessing import distance_postprocessing
from microbeseg_torch.utils.device import resolve_device
from microbeseg_torch.utils.image import pad_bucket_shape

# numpy dtypes that upload as they are; anything else goes up as float32
_UPLOAD_DTYPES = frozenset(("uint8", "int16", "int32", "float32"))


class InferenceEngine:
    """Runs a trained (D)U-Net on 2D frames / 2D+t stacks."""

    def __init__(self, model: torch.nn.Module, label_type: str = "distance",
                 cfg: Optional[InferConfig] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 max_seeds: Optional[int] = None,
                 extra: Sequence[torch.nn.Module] = ()):
        """``extra``: further ensemble members whose predictions are
        averaged with ``model``'s; all share ``label_type``.  ``device``:
        the CUDA card unless the caller passes ``"cpu"``."""
        self.device = resolve_device(device)
        self.cfg = cfg or InferConfig()
        self._check_supported()
        self.label_type = label_type
        self.models = [m.to(self.device).eval() for m in (model, *extra)]
        if self.device.type == "cuda":
            self.models = [m.to(memory_format=torch.channels_last)
                           for m in self.models]
        # None -> instance capacity scales with frame area (_seeds_cap)
        self.max_seeds = max_seeds
        # out-of-memory fallbacks taken (zero predictions / masks)
        self.oom_count = 0

    def _check_supported(self) -> None:
        unported = {
            "scale_factor < 1": (self.cfg.scale_factor < 1,
                                 "ROADMAP Queue 1 item 3"),
            "apply_clahe": (self.cfg.apply_clahe, "ROADMAP Queue 1 item 5"),
            "quantize": (self.cfg.quantize, "ROADMAP Queue 1 item 12"),
            "use_tiling": (self.cfg.use_tiling, "ROADMAP Queue 1 item 6"),
        }
        for name, (on, item) in unported.items():
            if on:
                raise NotImplementedError(
                    f"InferConfig {name} is not ported yet ({item})")

    @classmethod
    def from_checkpoint(cls, model_path: Union[str, Path],
                        cfg: Optional[InferConfig] = None,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> "InferenceEngine":
        model, train_cfg = load_model(model_path, device=device)
        return cls(model, train_cfg.label_type, cfg=cfg, device=device)

    @classmethod
    def from_checkpoints(cls, model_paths: Sequence[Union[str, Path]],
                         cfg: Optional[InferConfig] = None,
                         device: Optional[Union[str, torch.device]] = None
                         ) -> "InferenceEngine":
        """Ensemble engine: predictions averaged over several checkpoints."""
        loaded = [load_model(p, device=device) for p in model_paths]
        label_types = {t.label_type for _, t in loaded}
        if len(label_types) > 1:
            raise ValueError(
                f"ensemble members disagree on label_type: {label_types}")
        return cls(loaded[0][0], loaded[0][1].label_type, cfg=cfg,
                   device=device, extra=[m for m, _ in loaded[1:]])

    # ------------------------------------------------------------------

    def _seeds_cap(self, h: int, w: int) -> int:
        """Instance capacity of post-processing for an (h, w) frame: 256 at
        crop sizes, one seed per 256 px on large frames, at most 32768."""
        if self.max_seeds is not None:
            return self.max_seeds
        return int(min(32768, max(256, (h * w) // 256)))

    def _device_batch(self, h: int, w: int) -> int:
        """Frames per forward call: cfg.batch_size at 256^2, fewer on larger
        buckets (2x headroom over the area-proportional count)."""
        area = max(h * w, 1)
        return max(1, min(self.cfg.batch_size,
                          (self.cfg.batch_size * 2 * 256 * 256) // area))

    def _resident_frames_cap(self, h: int, w: int, dtype) -> int:
        """Frames of a stack held on the device at once (raw upload plus
        float32 prediction maps), so memory stays bounded in T."""
        pred_bytes = 8 if self.label_type == "distance" else 12
        per_frame = h * w * (np.dtype(dtype).itemsize + pred_bytes)
        return max(1, (6 << 30) // max(per_frame, 1))

    def _prep_ops(self, x: torch.Tensor) -> torch.Tensor:
        """Raw (B, H, W) frames -> float32 normalised to [-1, 1] per frame;
        a constant frame maps to all-zero."""
        x = x.to(torch.float32)
        mn = x.amin(dim=(1, 2), keepdim=True)
        mx = x.amax(dim=(1, 2), keepdim=True)
        denom = mx - mn
        safe = torch.where(denom > 0, denom, torch.ones_like(denom))
        return torch.where(denom > 0, 2.0 * (x - mn) / safe - 1.0,
                           torch.zeros_like(x))

    def _net_apply(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Model application on normalised, padded (B, H, W, 1) input:
        distance -> (border, cell) each (B, H, W); boundary -> (softmax
        probs (B, H, W, 3),).  Ensemble members average head-wise; with
        ``cfg.tta`` predictions also average over the 4 flips, or all 8
        dihedral transforms when H == W (both heads are scalar fields, so
        inverse-mapping and averaging is exact)."""
        def base(xv):
            acc = None
            for model in self.models:
                preds = model(xv)
                if self.label_type == "distance":
                    out = [preds[0][..., 0], preds[1][..., 0]]
                else:
                    out = [torch.softmax(preds, dim=-1)]
                acc = out if acc is None else [a + b for a, b in zip(acc, out)]
            return [a / len(self.models) for a in acc]

        if not self.cfg.tta:
            return tuple(base(x))
        square = x.shape[1] == x.shape[2]
        variants = [(t, fy, fx)
                    for t in ((False, True) if square else (False,))
                    for fy in (False, True)
                    for fx in (False, True)]
        acc = None
        for t, fy, fx in variants:
            xv = x.transpose(1, 2) if t else x
            xv = torch.flip(xv, (1,)) if fy else xv
            xv = torch.flip(xv, (2,)) if fx else xv
            inv = []
            for p in base(xv):  # invert in reverse order
                p = torch.flip(p, (2,)) if fx else p
                p = torch.flip(p, (1,)) if fy else p
                inv.append(p.transpose(1, 2) if t else p)
            acc = inv if acc is None else [a + b for a, b in zip(acc, inv)]
        return tuple(a / len(variants) for a in acc)

    def _forward_chunk(self, raw: torch.Tensor, pad_y: int,
                       pad_x: int) -> Tuple[torch.Tensor, ...]:
        """Raw (b, h, w) frames -> de-padded float32 predictions."""
        x = self._prep_ops(raw)
        x = torch.nn.functional.pad(x, (pad_x, 0, pad_y, 0), value=-1.0)
        x = x[..., None]
        with torch.inference_mode(), torch.autocast(
                "cuda", dtype=torch.bfloat16,
                enabled=self.device.type == "cuda"):
            preds = self._net_apply(x)
        return tuple(p[:, pad_y:, pad_x:].float() for p in preds)

    def _zero_preds(self, b: int, h: int, w: int) -> Tuple[torch.Tensor, ...]:
        z = torch.zeros((b, h, w), dtype=torch.float32, device=self.device)
        if self.label_type == "distance":
            return z, z.clone()
        return (torch.zeros((b, h, w, 3), dtype=torch.float32,
                            device=self.device),)

    def _upload(self, frames: np.ndarray) -> torch.Tensor:
        frames = np.ascontiguousarray(frames)
        if frames.dtype == np.uint16:
            # uploads at 2 bytes a pixel; torch has little uint16 arithmetic,
            # so the bits go up as int16 and widen on the device
            x = torch.tensor(frames.view(np.int16), device=self.device)
            return x.to(torch.int32).bitwise_and(0xFFFF)
        if str(frames.dtype) not in _UPLOAD_DTYPES:
            frames = frames.astype(np.float32)
        return torch.tensor(frames, device=self.device)

    def _predict_bucket(self, frames: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """Bucket-pad path: one raw upload, then prep+forward chunks of the
        device batch.  Out-of-memory gives zero predictions for the chunk
        (the reference's all-zero fallback) and is counted."""
        T, H, W = frames.shape
        try:
            th, tw = pad_bucket_shape(H, W)
        except ValueError:
            raise NotImplementedError(
                f"{H}x{W} frames exceed the pad-bucket table; tiled "
                "inference is not ported yet (ROADMAP Queue 1 item 6)"
            ) from None
        bs = self._device_batch(th, tw)
        raw = self._upload(frames)
        outs = []
        for s in range(0, T, bs):
            chunk = raw[s:s + bs]
            n = chunk.shape[0]
            if n < bs:  # pad the ragged tail to the full batch shape
                chunk = torch.cat([chunk, torch.zeros(
                    (bs - n, H, W), dtype=chunk.dtype, device=self.device)])
            try:
                out = self._forward_chunk(chunk, th - H, tw - W)
            except torch.cuda.OutOfMemoryError:
                self.oom_count += 1
                out = self._zero_preds(bs, H, W)
            outs.append(tuple(o[:n] for o in out))
        return tuple(torch.cat([o[i] for o in outs])
                     for i in range(len(outs[0])))

    def predict_raw(self, frames: np.ndarray) -> Tuple[np.ndarray, ...]:
        """CNN predictions for a (T, H, W) stack (or one (H, W) frame) at
        the original resolution: distance -> (border, cell) each (T, H, W);
        boundary -> (T, H, W, 3) softmax."""
        frames = np.asarray(frames)
        if frames.ndim == 2:
            frames = frames[None]
        T, H, W = frames.shape
        cap = self._resident_frames_cap(H, W, frames.dtype)
        outs = [tuple(p.cpu().numpy() for p in
                      self._predict_bucket(frames[s:s + cap]))
                for s in range(0, T, cap)]
        return tuple(np.concatenate([o[i] for o in outs])
                     for i in range(len(outs[0])))

    def postprocess(self, border: torch.Tensor, cell: torch.Tensor,
                    th_cell: float, th_seed: float) -> np.ndarray:
        """Device predictions (T, H, W) -> uint16 masks, in device batches.
        Out-of-memory gives zero masks for the batch, counted."""
        T, H, W = cell.shape
        bs = self._device_batch(H, W)
        masks = np.empty((T, H, W), np.uint16)
        for s in range(0, T, bs):
            try:
                m = distance_postprocessing(
                    border[s:s + bs], cell[s:s + bs], th_seed, th_cell,
                    max_seeds=self._seeds_cap(H, W))
                masks[s:s + bs] = m.cpu().numpy()
            except torch.cuda.OutOfMemoryError:
                self.oom_count += 1
                masks[s:s + bs] = 0
        return masks

    def segment(self, frames: np.ndarray,
                th_cell: Optional[float] = None,
                th_seed: Optional[float] = None) -> np.ndarray:
        """Full pipeline: (T, H, W) raw frames -> (T, H, W) uint16 instances."""
        if self.label_type != "distance":
            raise NotImplementedError(
                "boundary-method post-processing is not ported yet "
                "(ROADMAP Queue 1 item 2b)")
        frames = np.asarray(frames)
        squeeze = frames.ndim == 2
        if squeeze:
            frames = frames[None]
        th_cell = self.cfg.th_cell if th_cell is None else th_cell
        th_seed = self.cfg.th_seed if th_seed is None else th_seed
        T, H, W = frames.shape
        cap = self._resident_frames_cap(H, W, frames.dtype)
        masks = np.empty(frames.shape, np.uint16)
        for s in range(0, T, cap):
            border, cell = self._predict_bucket(frames[s:s + cap])
            masks[s:s + cap] = self.postprocess(border, cell, th_cell,
                                                th_seed)
        return masks[0] if squeeze else masks
