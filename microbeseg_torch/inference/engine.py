"""Inference engine: batched forward + post-processing on the card.

Port of ``microbeseg_tpu/inference/engine.py``: raw frames upload once at
their native dtype, are normalised per frame to [-1, 1] (after CLAHE when
``apply_clahe``), scaled down when ``scale_factor < 1``, and run through
the (D)U-Net in batches (bf16 autocast on CUDA) on one of two paths:

- the bucket path pads each frame up-left with -1 to its pad bucket and
  crops the predictions back;
- the tiled path, for frames beyond the bucket table or with
  ``use_tiling`` for frames larger than a tile, cuts overlapping tiles on
  the device, runs them in batches and stitches the predictions with
  feathered weights.

Predictions scale back up to the frame, are post-processed on the device,
and only uint16 masks come back.

What depends on the label type (the normalisation, the pad value, the
fields a model gives, the refusals, the post-processing, the threshold
grid) is its entry in ``inference/label_types.py``; with
``label_type="flows"`` the network is Cellpose-SAM (``models/vit_sam.py``),
normalised by its percentiles, padded with 0 and always tiled.  The engine
stitches, scales and batches every field by its shape alone.

With ``InferConfig.quantize`` the large-spatial 3x3 convolutions take their
int8 path (``models.blocks.QuantConv``, kernel K5).  Their activation scales
are calibrated once per padded shape, on the first frames or tiles of that
shape; until then, and after a calibration pass that ran out of memory,
a layer quantises with each sample's own maximum.

With ``mesh=`` (``parallel.mesh.get_mesh``) the engine holds one replica of
each model on every device of the mesh.  The device batch and the
pre-processing chunk grow by the number of devices, as the JAX engine's
do, and each device takes its contiguous share of every forward batch and
of every post-processing batch, on a host thread of its own; the shares'
predictions and masks come back in frame order.  An int8 engine
calibrates once, on the first device, and every replica carries the same
activation scales.
"""

from __future__ import annotations

import copy
import math
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from microbeseg_torch.config import InferConfig
from microbeseg_torch.inference.label_types import label_type_entry
from microbeseg_torch.inference.tiling import (
    extract_tiles_device,
    stitch_tiles_device,
    tile_positions,
)
from microbeseg_torch.models.blocks import ConvBlock, QuantConv
from microbeseg_torch.models.io import load_model
from microbeseg_torch.models.unet import set_quantize
from microbeseg_torch.ops.augment import clahe
from microbeseg_torch.ops.resize import resize
from microbeseg_torch.parallel.mesh import (Mesh, batch_sharding,
                                            replicated_sharding)
from microbeseg_torch.utils.device import resolve_device
from microbeseg_torch.utils.image import pad_bucket_shape
from microbeseg_torch.utils.profiling import span

# numpy dtypes that upload as they are; anything else goes up as float32
_UPLOAD_DTYPES = frozenset(("uint8", "int16", "int32", "float32"))


class InferenceEngine:
    """Runs a trained (D)U-Net on 2D frames / 2D+t stacks."""

    def __init__(self, model: torch.nn.Module, label_type: str = "distance",
                 cfg: Optional[InferConfig] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 max_seeds: Optional[int] = None,
                 extra: Sequence[torch.nn.Module] = (),
                 mesh: Optional[Mesh] = None):
        """``extra``: further ensemble members whose predictions are
        averaged with ``model``'s; all share ``label_type``.  ``device``:
        the CUDA card unless the caller passes ``"cpu"``.  ``mesh``: run
        data-parallel over its devices (it then names the device)."""
        self.mesh = mesh
        self.device = (mesh.devices[0] if mesh is not None
                       else resolve_device(device))
        self.cfg = cfg or InferConfig()
        if self.cfg.quantize and extra:
            raise ValueError("quantize is not supported for ensembles "
                             "(per-member activation calibration is not "
                             "implemented)")
        self.label_type = label_type
        # everything that depends on the label type
        self._lt = label_type_entry(label_type)
        self._lt.check(model, self.cfg)
        # padded (h, w) shapes whose calibration pass has run: larger frames
        # quantise more layers, so each shape calibrates once.  None: the
        # engine runs no int8 layer
        self._quant_shapes: Optional[set] = None
        if self.cfg.quantize and any(isinstance(m, ConvBlock)
                                     for m in model.modules()):
            # the engine's own copy: the int8 switch and the calibrated
            # maxima must not show in the caller's model
            model = set_quantize(copy.deepcopy(model))
            self._quant_shapes = set()
        self.models = [m.to(self.device).eval() for m in (model, *extra)]
        if self.device.type == "cuda":
            self.models = [m.to(memory_format=torch.channels_last)
                           for m in self.models]
        # the models of each device of the mesh; the first are self.models
        self._replicas = [self.models]
        if mesh is not None:
            self._replicas = [list(r) for r in zip(
                *(replicated_sharding(mesh, m) for m in self.models))]
        self._pools: Optional[list] = None
        # None -> instance capacity scales with frame area (_seeds_cap)
        self.max_seeds = max_seeds
        # out-of-memory fallbacks taken (zero predictions / masks)
        self.oom_count = 0

    @classmethod
    def from_checkpoint(cls, model_path: Union[str, Path],
                        cfg: Optional[InferConfig] = None,
                        device: Optional[Union[str, torch.device]] = None,
                        mesh: Optional[Mesh] = None) -> "InferenceEngine":
        device = mesh.devices[0] if mesh is not None else device
        model, train_cfg = load_model(model_path, device=device)
        return cls(model, train_cfg.label_type, cfg=cfg, device=device,
                   mesh=mesh)

    @classmethod
    def from_checkpoints(cls, model_paths: Sequence[Union[str, Path]],
                         cfg: Optional[InferConfig] = None,
                         device: Optional[Union[str, torch.device]] = None,
                         mesh: Optional[Mesh] = None) -> "InferenceEngine":
        """Ensemble engine: predictions averaged over several checkpoints."""
        device = mesh.devices[0] if mesh is not None else device
        loaded = [load_model(p, device=device) for p in model_paths]
        label_types = {t.label_type for _, t in loaded}
        if len(label_types) > 1:
            raise ValueError(
                f"ensemble members disagree on label_type: {label_types}")
        return cls(loaded[0][0], loaded[0][1].label_type, cfg=cfg,
                   device=device, extra=[m for m, _ in loaded[1:]],
                   mesh=mesh)

    # ------------------------------------------------------------------
    # the mesh
    # ------------------------------------------------------------------

    @property
    def _n_devices(self) -> int:
        return 1 if self.mesh is None else self.mesh.size

    def _on_devices(self, fn, shares: Sequence[tuple]) -> list:
        """``fn(i, *share)`` for each non-empty share, with device i of the
        mesh current, each device on a host thread of its own when there
        are several; the results in share order."""
        jobs = [(i, sh) for i, sh in enumerate(shares) if sh[0].shape[0]]

        def run(i, sh):
            dev = self.mesh.devices[i]
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    return fn(i, *sh)
            return fn(i, *sh)

        if len(jobs) == 1:
            return [run(*jobs[0])]
        if self._pools is None:
            self._pools = [ThreadPoolExecutor(1) for _ in self.mesh.devices]
        futures = [self._pools[i].submit(run, i, sh) for i, sh in jobs]
        return [f.result() for f in futures]

    def _shares(self, tensors: Sequence[torch.Tensor]) -> list:
        """Per device of the mesh, its contiguous share of each tensor."""
        return list(zip(*(batch_sharding(self.mesh, t) for t in tensors)))

    def _sync_quant_replicas(self) -> None:
        """Every replica takes the first one's calibrated activation
        scales, so a mesh quantises as one device does."""
        src = [m for m in self.models[0].modules() if isinstance(m, QuantConv)]
        for models in self._replicas[1:]:
            dst = [m for m in models[0].modules()
                   if isinstance(m, QuantConv)]
            for a, b in zip(src, dst):
                b.act_amax = a.act_amax.to(b.act_amax.device)
                b.calibrated = a.calibrated

    # ------------------------------------------------------------------

    @property
    def _quant_calibrated(self) -> bool:
        return bool(self._quant_shapes)

    def _quant_pending(self, h: int, w: int) -> bool:
        """Whether padded shape (h, w) still waits for its calibration."""
        return (self._quant_shapes is not None
                and (h, w) not in self._quant_shapes)

    def _ensure_quant_calibrated(self, sample: torch.Tensor) -> None:
        """int8 activation-scale calibration on normalised, padded (b, h, w)
        frames or tiles: one forward of at most 4 of them (and no more than
        the device batch) on per-sample scales records each int8 layer's
        ``|x|`` maximum, which merges into the layer's ``act_amax``; later
        forwards quantise with that static scale.  Runs once per padded
        shape.  A pass that runs out of memory leaves the layers as they
        were and still marks the shape done."""
        h, w = sample.shape[1:]
        if not self._quant_pending(h, w):
            return
        b = max(1, min(4, self._device_batch(h, w), sample.shape[0]))
        layers = [m for m in self.models[0].modules()
                  if isinstance(m, QuantConv)]
        for m in layers:
            m.calibrating = True
        try:
            with torch.inference_mode(), torch.autocast(
                    "cuda", dtype=torch.bfloat16,
                    enabled=self.device.type == "cuda"):
                self.models[0](sample[:b, ..., None])
            for m in layers:
                m.commit_calibration()
        except torch.cuda.OutOfMemoryError:
            pass
        finally:
            for m in layers:
                m.calibrating = False
                m._seen_amax = None
        self._quant_shapes.add((h, w))
        self._sync_quant_replicas()

    def _maybe_calibrate_bucket(self, raw: torch.Tensor, sh: int, sw: int,
                                th: int, tw: int) -> None:
        """Calibration sample of the bucket path: the first frames through
        the forward's own normalise, scale and -1 pad chain."""
        if not self._quant_pending(th, tw):
            return
        n = max(1, min(4, self._prep_chunk_cap(*raw.shape[1:])))
        try:
            x = self._prep_padded(raw[:n], sh, sw, th - sh, tw - sw)
        except torch.cuda.OutOfMemoryError:
            self._quant_shapes.add((th, tw))
            return
        self._ensure_quant_calibrated(x)

    def _maybe_calibrate_tiles(self, raw: torch.Tensor, sh: int, sw: int,
                               ph: int, pw: int, tile: int, pos) -> None:
        """Calibration sample of the tiled path: the tiles of the first
        frame, cut as the forward cuts them."""
        if not self._quant_pending(tile, tile):
            return
        try:
            tiles = self._cut_tiles(raw[:1], sh, sw, ph, pw, tile, pos)[0]
        except torch.cuda.OutOfMemoryError:
            self._quant_shapes.add((tile, tile))
            return
        self._ensure_quant_calibrated(tiles)

    def _seeds_cap(self, h: int, w: int) -> int:
        """Instance capacity of post-processing for an (h, w) frame: 256 at
        crop sizes, one seed per 256 px on large frames, at most 32768."""
        if self.max_seeds is not None:
            return self.max_seeds
        return int(min(32768, max(256, (h * w) // 256)))

    def _device_batch(self, h: int, w: int) -> int:
        """Frames per forward call: cfg.batch_size at 256^2, fewer on larger
        buckets (2x headroom over the area-proportional count); times the
        devices of the mesh, so a batch divides over them."""
        area = max(h * w, 1)
        return max(1, min(self.cfg.batch_size,
                          (self.cfg.batch_size * 2 * 256 * 256) // area)
                   ) * self._n_devices

    def _resident_frames_cap(self, h: int, w: int, dtype) -> int:
        """Frames of a stack held on the device at once (raw upload plus
        float32 prediction maps), so memory stays bounded in T."""
        pred_bytes = 4 * sum(math.prod(f) for f in self._lt.fields)
        per_frame = h * w * (np.dtype(dtype).itemsize + pred_bytes)
        return max(1, (6 << 30) // max(per_frame, 1))

    def _prep_chunk_cap(self, h: int, w: int) -> int:
        """Frames per device call that pre-processing can afford.  CLAHE
        holds a few index and lookup planes per frame at the unscaled size
        (an int64 bin plane, an int64 gather index and four float32
        lookups, about 64 bytes a pixel), which ``_device_batch`` knows
        nothing about; the cap keeps them under 2 GiB per chunk (per
        device of the mesh)."""
        if not self.cfg.apply_clahe:
            return 1 << 30
        return max(1, (2 << 30) // (h * w * 64)) * self._n_devices

    def _scaled_hw(self, h: int, w: int) -> Tuple[int, int]:
        """The size the network sees for an (h, w) frame."""
        scale = self.cfg.scale_factor
        if scale >= 1:
            return h, w
        return max(int(round(h * scale)), 1), max(int(round(w * scale)), 1)

    def _prep_ops(self, x: torch.Tensor) -> torch.Tensor:
        """Raw (B, H, W) frames -> float32 normalised per frame as the label
        type normalises, after CLAHE on the [0, 1]-rescaled frame when
        ``apply_clahe``."""
        x = x.to(torch.float32)
        if self.cfg.apply_clahe:
            mn = x.amin(dim=(1, 2), keepdim=True)
            mx = x.amax(dim=(1, 2), keepdim=True)
            x = clahe((x - mn) / torch.clamp(mx - mn, min=1e-7)) * 65535.0
        return self._lt.normalize(x)

    def _prep(self, raw: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
        """Raw frames -> normalised frames at the network's size (sh, sw):
        "cubic" down when ``scale_factor < 1``.  The frame's own min and
        max are taken before any tile is cut."""
        return resize(self._prep_ops(raw), (sh, sw), "cubic")

    def _prep_padded(self, raw: torch.Tensor, sh: int, sw: int, pad_y: int,
                     pad_x: int) -> torch.Tensor:
        """``_prep``, then the up-left pad to the bucket with the label
        type's pad value (-1, the normalised minimum)."""
        return torch.nn.functional.pad(self._prep(raw, sh, sw),
                                       (pad_x, 0, pad_y, 0),
                                       value=self._lt.pad_value)

    def _cut_tiles(self, raw: torch.Tensor, sh: int, sw: int, ph: int,
                   pw: int, tile: int, pos) -> torch.Tensor:
        """Raw (b, H, W) frames -> their normalised tiles (b, n, tile,
        tile); a frame with a side below the tile is padded down-right with
        the label type's pad value first (-1; 0 for flows)."""
        norm = self._prep(raw, sh, sw)
        if ph or pw:
            norm = torch.nn.functional.pad(norm, (0, pw, 0, ph),
                                           value=self._lt.pad_value)
        return extract_tiles_device(norm, tile, pos)

    def _net_apply(self, x: torch.Tensor, models: Sequence[torch.nn.Module]
                   ) -> Tuple[torch.Tensor, ...]:
        """Model application on normalised, padded (B, H, W, 1) input -> the
        label type's fields, each (B, H, W) or (B, H, W, C).  Ensemble
        members average field-wise; with ``cfg.tta`` predictions also
        average over the 4 flips, or all 8 dihedral transforms when H == W
        (every field is per pixel, so inverse-mapping and averaging is
        exact).  ``models``: the members on ``x``'s device."""
        def base(xv):
            acc = None
            for model in models:
                out = self._lt.apply(model, xv)
                acc = out if acc is None else [a + b for a, b in zip(acc, out)]
            return [a / len(models) for a in acc]

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

    def _forward(self, x: torch.Tensor, pad_y: int = 0,
                 pad_x: int = 0) -> Tuple[torch.Tensor, ...]:
        """Normalised (b, h, w) frames or tiles, already padded up-left by
        (pad_y, pad_x) -> float32 predictions with the pad cropped off.
        Under a mesh each device runs its share of the batch."""
        def run(i, xs):
            with torch.inference_mode(), torch.autocast(
                    "cuda", dtype=torch.bfloat16,
                    enabled=self.device.type == "cuda"):
                preds = self._net_apply(xs[..., None], self._replicas[i])
            return tuple(p[:, pad_y:, pad_x:].float() for p in preds)

        if self.mesh is None:
            return run(0, x)
        outs = self._on_devices(run, self._shares([x]))
        return tuple(torch.cat([o[k].to(self.device) for o in outs])
                     for k in range(len(outs[0])))

    def _forward_chunk(self, raw: torch.Tensor, sh: int, sw: int, pad_y: int,
                       pad_x: int) -> Tuple[torch.Tensor, ...]:
        """Bucket path for raw (b, h, w) frames: prep, scale down, pad,
        forward, crop, scale back up -> float32 predictions at (h, w)."""
        preds = self._forward(self._prep_padded(raw, sh, sw, pad_y, pad_x),
                              pad_y, pad_x)
        return tuple(resize(p, raw.shape[1:], "linear") for p in preds)

    def _zero_preds(self, b: int, h: int, w: int) -> Tuple[torch.Tensor, ...]:
        """All-zero fields of ``b`` frames of (h, w): the out-of-memory
        fallback."""
        return tuple(torch.zeros((b, h, w, *f), dtype=torch.float32,
                                 device=self.device) for f in self._lt.fields)

    def _upload(self, frames: np.ndarray) -> torch.Tensor:
        with span("mseg.segment.upload"):
            frames = np.ascontiguousarray(frames)
            if frames.dtype == np.uint16:
                # uploads at 2 bytes a pixel; torch has little uint16
                # arithmetic, so the bits go up as int16 and widen on the
                # device
                x = torch.tensor(frames.view(np.int16), device=self.device)
                return x.to(torch.int32).bitwise_and(0xFFFF)
            if str(frames.dtype) not in _UPLOAD_DTYPES:
                frames = frames.astype(np.float32)
            return torch.tensor(frames, device=self.device)

    def _predict_raw_dev(self, frames: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """``predict_raw`` with the predictions left on the device, where
        ``segment`` post-processes them.  The tiled path takes frames whose
        scaled size is beyond the bucket table, with ``use_tiling`` those
        with a side above the tile size, and every frame of a label type
        that is always tiled."""
        frames = np.asarray(frames)
        if frames.ndim == 2:
            frames = frames[None]
        if self._lt.always_tiled:
            return self._predict_tiled(frames)
        sh, sw = self._scaled_hw(*frames.shape[1:])
        try:
            th, tw = pad_bucket_shape(sh, sw)
        except ValueError:
            return self._predict_tiled(frames)
        if self.cfg.use_tiling and max(sh, sw) > self.cfg.tile_size:
            return self._predict_tiled(frames)
        return self._predict_bucket(frames, sh, sw, th, tw)

    def _predict_bucket(self, frames: np.ndarray, sh: int, sw: int, th: int,
                        tw: int) -> Tuple[torch.Tensor, ...]:
        """Bucket-pad path: one raw upload, then prep+forward chunks of the
        device batch.  Out-of-memory gives zero predictions for the chunk
        (the reference's all-zero fallback) and is counted."""
        T, H, W = frames.shape
        bs = min(self._device_batch(th, tw), self._prep_chunk_cap(H, W))
        raw = self._upload(frames)
        self._maybe_calibrate_bucket(raw, sh, sw, th, tw)
        outs = []
        for s in range(0, T, bs):
            chunk = raw[s:s + bs]
            n = chunk.shape[0]
            if n < bs:  # pad the ragged tail to the full batch shape
                chunk = torch.cat([chunk, torch.zeros(
                    (bs - n, H, W), dtype=chunk.dtype, device=self.device)])
            try:
                with span("mseg.segment.forward"):
                    out = self._forward_chunk(chunk, sh, sw, th - sh,
                                              tw - sw)
            except torch.cuda.OutOfMemoryError:
                self.oom_count += 1
                out = self._zero_preds(bs, H, W)
            outs.append(tuple(o[:n] for o in out))
        return tuple(torch.cat([o[i] for o in outs])
                     for i in range(len(outs[0])))

    def _predict_tiled(self, frames: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """Sliding-window path: one raw upload; per chunk of frames, prep
        with the frame's own min and max, tiles cut on the device, forward
        in device batches of tiles, feathered stitching on the device.  A
        frame with a side below the tile is tiled over its extent padded
        with the label type's pad value and the stitched maps are cropped
        back.  Memory stays bounded because frame chunks are processed end
        to end and not every tile is held.  Out-of-memory gives zero
        predictions for the chunk, counted."""
        tile, overlap = self.cfg.tile_size, self.cfg.tile_overlap
        T, H, W = frames.shape
        sh, sw = self._scaled_hw(H, W)
        ph, pw = max(tile - sh, 0), max(tile - sw, 0)
        pos = [(y, x) for y in tile_positions(sh + ph, tile, overlap)
               for x in tile_positions(sw + pw, tile, overlap)]
        n = len(pos)
        bs_tile = self._device_batch(tile, tile)
        # frames per chunk: a whole number of tile batches where possible,
        # capped by a tile-memory budget and the stack length
        ideal = bs_tile // math.gcd(n, bs_tile)
        budget = max(bs_tile, (256 << 20) // (tile * tile * 4))
        bs0 = max(1, min(ideal, max(1, budget // n),
                         self._prep_chunk_cap(H, W), T))
        raw = self._upload(frames)
        self._maybe_calibrate_tiles(raw, sh, sw, ph, pw, tile, pos)
        stitched = []
        for s in range(0, T, bs0):
            chunk = raw[s:s + bs0]
            try:
                stitched.append(self._tiled_chunk(chunk, sh, sw, ph, pw,
                                                  tile, pos, bs_tile))
            except torch.cuda.OutOfMemoryError:
                self.oom_count += 1
                stitched.append(self._zero_preds(chunk.shape[0], sh, sw))
        with span("mseg.segment.stitch"):
            return tuple(
                resize(torch.cat([c[i] for c in stitched]), (H, W), "linear")
                for i in range(len(stitched[0])))

    def _tiled_chunk(self, chunk: torch.Tensor, sh: int, sw: int, ph: int,
                     pw: int, tile: int, pos, bs_tile: int
                     ) -> Tuple[torch.Tensor, ...]:
        """Raw (b, H, W) frames -> stitched predictions at (b, sh, sw)."""
        b, n = chunk.shape[0], len(pos)
        with span("mseg.segment.forward"):
            flat = self._cut_tiles(chunk, sh, sw, ph, pw, tile, pos).reshape(
                b * n, tile, tile)
            preds = [self._forward(flat[ts:ts + bs_tile])
                     for ts in range(0, b * n, bs_tile)]
        full = (sh + ph, sw + pw)

        def stitch(field):   # (b * n, tile, tile) or (b * n, tile, tile, c)
            if field.ndim == 3:
                return stitch_tiles_device(field.view(b, n, tile, tile), pos,
                                           full)[:, :sh, :sw]
            c = field.shape[-1]
            # channels ride the stitch batch axis: (b * c, n, tile, tile)
            chan = field.view(b, n, tile, tile, c).movedim(-1, 1).reshape(
                b * c, n, tile, tile)
            sp = stitch_tiles_device(chan, pos, full).view(b, c, *full)
            return sp[:, :, :sh, :sw].movedim(1, -1)

        with span("mseg.segment.stitch"):
            return tuple(stitch(torch.cat([p[i] for p in preds]))
                         for i in range(len(preds[0])))

    def predict_raw(self, frames: np.ndarray) -> Tuple[np.ndarray, ...]:
        """CNN predictions for a (T, H, W) stack (or one (H, W) frame) at
        the original resolution: the label type's fields, distance ->
        (border, cell) each (T, H, W); boundary -> (T, H, W, 3) softmax;
        flows -> (T, H, W, 3) (dY, dX, cell probability)."""
        frames = np.asarray(frames)
        if frames.ndim == 2:
            frames = frames[None]
        T, H, W = frames.shape
        cap = self._resident_frames_cap(H, W, frames.dtype)
        outs = [tuple(p.cpu().numpy() for p in
                      self._predict_raw_dev(frames[s:s + cap]))
                for s in range(0, T, cap)]
        return tuple(np.concatenate([o[i] for o in outs])
                     for i in range(len(outs[0])))

    def postprocess(self, preds: Tuple[torch.Tensor, ...], th_cell: float,
                    th_seed: float) -> np.ndarray:
        """Device predictions of T frames (distance: (border, cell);
        boundary: (probs,); flows: ((dY, dX, cell probability),)) -> (T, H,
        W) uint16 masks, in device batches
        (one frame at a time at 2048^2; under a mesh, each device its
        share of a batch).  Out-of-memory gives zero masks for the batch,
        counted."""
        T, H, W = preds[0].shape[:3]
        bs = self._device_batch(H, W)
        cap = self._seeds_cap(H, W)
        masks = np.empty((T, H, W), np.uint16)

        def run(i, dst, *chunk):
            with span("mseg.segment.postprocess"):
                m = self._lt.postprocess(chunk, th_cell, th_seed, cap,
                                         self.cfg)
            with span("mseg.segment.download"):
                dst[...] = m.cpu().numpy()

        for s in range(0, T, bs):
            chunk = [p[s:s + bs] for p in preds]
            try:
                if self.mesh is None:
                    run(0, masks[s:s + bs], *chunk)
                else:   # each device post-processes its share
                    shares = self._shares(chunk)
                    ends = np.cumsum([s] + [sh[0].shape[0] for sh in shares])
                    self._on_devices(run, [
                        (masks[a:b], *sh)
                        for a, b, sh in zip(ends, ends[1:], shares)])
            except torch.cuda.OutOfMemoryError:
                self.oom_count += 1
                masks[s:s + bs] = 0
        return masks

    def segment(self, frames: np.ndarray,
                th_cell: Optional[float] = None,
                th_seed: Optional[float] = None) -> np.ndarray:
        """Full pipeline: (T, H, W) raw frames -> (T, H, W) uint16 instances."""
        frames = np.asarray(frames)
        squeeze = frames.ndim == 2
        if squeeze:
            frames = frames[None]
        th_cell = self.cfg.th_cell if th_cell is None else th_cell
        th_seed = self.cfg.th_seed if th_seed is None else th_seed
        T, H, W = frames.shape
        cap = self._resident_frames_cap(H, W, frames.dtype)
        masks = np.empty(frames.shape, np.uint16)
        with span("mseg.segment"):
            for s in range(0, T, cap):
                preds = self._predict_raw_dev(frames[s:s + cap])
                masks[s:s + cap] = self.postprocess(preds, th_cell, th_seed)
        return masks[0] if squeeze else masks

    def segment_grid(self, frame: np.ndarray, th_pairs) -> np.ndarray:
        """Threshold-grid segmentation of one (H, W) frame: th_pairs (n, 2)
        of (th_cell, th_seed) -> (n, H, W) uint16, the grid post-processed
        as one batch on the device.  Distance models only: the boundary
        method has no thresholds to grid over."""
        if self._lt.grid is None:
            raise ValueError(
                "segment_grid applies only to distance models; use "
                "segment() for the boundary method (no threshold grid)")
        frame = np.asarray(frame)
        border, cell = self._predict_raw_dev(frame[None])
        cap = self._seeds_cap(*frame.shape[-2:])

        def run(i, pairs, b, c):
            return self._lt.grid(b[0], c[0], pairs,
                                 max_seeds=cap).cpu().numpy()

        try:
            if self.mesh is None:
                return run(0, th_pairs, border, cell)
            # each device post-processes its share of the grid
            shares = [(p, border.to(d), cell.to(d)) for p, d in zip(
                np.array_split(np.asarray(th_pairs), self._n_devices),
                self.mesh.devices)]
            return np.concatenate(self._on_devices(run, shares))
        except torch.cuda.OutOfMemoryError:
            self.oom_count += 1
            return np.zeros((len(th_pairs),) + frame.shape[-2:], np.uint16)
