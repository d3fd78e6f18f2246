"""Data-management workers on the ImageStore abstraction, on the port.

The port of ``microbeseg_tpu/client/workers.py``: the reference's OMERO
workers on the ``ImageStore`` interface, so they run identically against a
live OMERO server (OmeroStore) or a local filesystem (LocalStore):

- export_trainset  <- DataExportWorker (src/utils/data_export.py:18-116)
- import_data      <- DataImportWorker (src/utils/data_import.py:17-286)
- analyze_dataset  <- AnalysisWorker (src/inference/analysis.py:12-211)
- export_results   <- ResultExportWorker (src/inference/result_export.py:11-224)
- CropGenerator    <- DataCropWorker + GUI crop-list logic
  (src/utils/data_cropping.py:19-330, src/microbe_seg_gui.py:2121-2329)
- infer_dataset    <- InferWorker (src/inference/infer.py:22-390)

``infer_dataset`` and ``CropGenerator`` take the port's ``InferenceEngine``;
``analyze_dataset`` runs ``ops/regionprops`` on the device (the CUDA card
unless ``device="cpu"``) in place of JAX's jitted, vmapped regionprops, and
writes its CSV as pandas' ``to_csv`` does (the evaluator's ``_Table``: the
port imports no pandas).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from microbeseg_torch.client.contours import (
    polygon_to_mask,
    roi_string_to_polygon,
)
from microbeseg_torch.client.store import (
    ANALYSIS_NAMESPACE,
    ImageStore,
    RoiPolygon,
    timestamp,
)
from microbeseg_torch.evaluation.evaluator import _Table
from microbeseg_torch.ops.regionprops import regionprops
from microbeseg_torch.utils.device import resolve_device
from microbeseg_torch.utils.image import min_max_normalization
from microbeseg_torch.utils.tiff import imread, imwrite


def _noop(*a, **k):
    pass


def _parsed_poly(p: RoiPolygon) -> np.ndarray:
    """Parse-once cache: the per-frame rasterize loop of a 2D+t stack would
    otherwise re-parse every polygon string size_t times."""
    arr = getattr(p, "_xy", None)
    if arr is None:
        arr = roi_string_to_polygon(p.points)
        p._xy = arr
    return arr


def _rasterize_rois(polys: Sequence[RoiPolygon], t: int,
                    shape: Tuple[int, int]) -> np.ndarray:
    """Polygon ROIs of frame t -> uint16 instance mask (one id per ROI).

    Uses the batched native rasterizer (native/contours.cpp) when available;
    per-polygon Python fallback otherwise (identical semantics)."""
    frame_polys = [_parsed_poly(p) for p in polys if p.t == t]
    from microbeseg_torch.client.native import rasterize_rois_native
    native = rasterize_rois_native(frame_polys, shape)
    if native is not None:
        return native
    mask = np.zeros(shape, np.uint16)
    for inst, poly in enumerate(frame_polys, start=1):
        mask[polygon_to_mask(poly, shape)] = inst
    return mask


def _mask_to_rois(mask: np.ndarray, t: int = 0, z: int = 0) -> List[RoiPolygon]:
    from microbeseg_torch.client.contours import mask_to_roi_strings
    return [RoiPolygon(t=t, z=z, points=s) for s in mask_to_roi_strings(mask)]


# ---------------------------------------------------------------------------
# Trainset export (reference data_export.py:18-116)
# ---------------------------------------------------------------------------

def export_trainset(store: ImageStore, dataset_id: int, target_dir: Path,
                    channel: int = 0,
                    text_output: Callable[[str], None] = _noop,
                    progress: Callable[[int], None] = _noop,
                    should_stop: Callable[[], bool] = lambda: False) -> Optional[Path]:
    """Download a trainset: rasterize ROIs to masks, renormalize with stored
    per-crop min/max, write img_/mask_ TIFFs into {train,val,test}; skip
    pre-labeled-but-uncorrected crops (reference :94-96)."""
    name = store.dataset_name(dataset_id)
    root = Path(target_dir) / name
    for sub in ("train", "val", "test"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    images = store.list_images(dataset_id)
    for i, ref in enumerate(images):
        if should_stop():
            text_output("Stop export due to user interaction.")
            import shutil
            shutil.rmtree(root, ignore_errors=True)
            return None
        meta = store.get_map_annotation(ref.image_id)
        subset = meta.get("set", "train")
        pre_labeled = meta.get("pre_labeled", "False") == "True"
        corrected = meta.get("last_modification", "") != ""
        if pre_labeled and not corrected:
            continue  # skip uncorrected pre-labels
        img = store.get_plane(ref.image_id, 0, channel, 0)
        polys = store.get_polygons(ref.image_id)
        mask = _rasterize_rois(polys, 0, img.shape)
        # renormalize to uint16 with stored frame stats (reference :99-101)
        vmin = float(meta.get("min_frame", img.min()))
        vmax = float(meta.get("max_frame", img.max()))
        img01 = (min_max_normalization(img, vmin, vmax) + 1.0) / 2.0
        img16 = (img01 * 65535).astype(np.uint16)
        imwrite(root / subset / f"img_{ref.image_id}.tif", img16)
        imwrite(root / subset / f"mask_{ref.image_id}.tif", mask)
        progress(int(100 * (i + 1) / max(len(images), 1)))
    return root


# ---------------------------------------------------------------------------
# Data import (reference data_import.py:17-286)
# ---------------------------------------------------------------------------

def import_data(store: ImageStore, dataset_id: int, img_paths: Sequence[Path],
                mask_paths: Sequence[Path], crop_size: int,
                split_probs: Tuple[float, float, float] = (0.8, 0.1, 0.1),
                seed: int = 0,
                text_output: Callable[[str], None] = _noop,
                progress: Callable[[int], None] = _noop) -> List[int]:
    """Import local img/mask pairs as crop images with metadata + ROIs.

    Pads small images to crop_size or center-crops a grid, skipping
    near-empty crops (reference :125-185); assigns train/val/test randomly by
    probability (:188-194); uploads with the 15-key map annotation (:197-230)
    and polygon ROIs (:240-256); names crops img_extNNN by the persisted
    num_ext counter and re-uploads split_info.json on the trainset dataset
    (:67-78, :201-207, :258-272).
    """
    rng = np.random.default_rng(seed)
    uploaded = []
    split_info = load_split_info(store, dataset_id)
    for n, (ip, mp) in enumerate(zip(img_paths, mask_paths)):
        img = imread(ip)
        mask = imread(mp) if mp is not None else None
        if img.ndim == 3 and img.shape[-1] == 3:
            img = img.mean(-1).astype(img.dtype)  # RGB -> grayscale
        # frame stats from the ORIGINAL image, before padding/cropping —
        # all crops of one image share them (reference data_import.py:
        # 125-131 computes them first; per-crop stats on a zero-padded
        # crop would store min_frame=0 and skew the export renormalization)
        stats = dict(min_frame=float(img.min()),
                     max_frame=float(img.max()),
                     mean_frame=float(img.mean()),
                     std_frame=float(img.std()))
        crops = _grid_crops(img, mask, crop_size)
        # ONE split draw per image: different crops of the same image stay
        # in the same set (reference :188-194)
        subset = rng.choice(["train", "val", "test"], p=split_probs)
        for crop_img, crop_mask, (cy, cx) in crops:
            iid = store.upload_image(
                dataset_id,
                f"img_ext{split_info['num_ext']:03d}.tif",  # reference :201
                crop_img.astype(np.uint16))
            store.set_map_annotation(iid, {
                "set": subset, "crop_y": cy, "crop_x": cx,
                "source_file": Path(ip).name,
                "pre_labeled": "False",
                "last_modification": timestamp() if crop_mask is not None else "",
                "upload_date": timestamp(), **stats})
            if crop_mask is not None and crop_mask.max() > 0:
                store.add_polygons(iid, _mask_to_rois(crop_mask))
            split_info["num_ext"] += 1
            uploaded.append(iid)
        progress(int(100 * (n + 1) / len(img_paths)))
    if uploaded:
        save_split_info(store, dataset_id, split_info)
    return uploaded


def _grid_crops(img: np.ndarray, mask: Optional[np.ndarray], crop_size: int):
    """Pad-to-crop or center grid crops, skipping near-empty mask crops."""
    H, W = img.shape[:2]
    out = []
    if H <= crop_size or W <= crop_size:
        ph, pw = max(crop_size - H, 0), max(crop_size - W, 0)
        if ph > H or pw > W:
            return out  # too much padding needed -> skip (reference :139-141)
        # centered zero padding (reference :143-148)
        pads = ((int(np.ceil(ph / 2)), ph // 2), (int(np.ceil(pw / 2)), pw // 2))
        img_p = np.pad(img, pads)
        mask_p = np.pad(mask, pads) if mask is not None else None
        out.append((img_p[:crop_size, :crop_size],
                    None if mask_p is None else mask_p[:crop_size, :crop_size],
                    (0, 0)))
        return out
    ny, nx = H // crop_size, W // crop_size
    oy = (H - ny * crop_size) // 2
    ox = (W - nx * crop_size) // 2
    for gy in range(ny):
        for gx in range(nx):
            y, x = oy + gy * crop_size, ox + gx * crop_size
            ci = img[y:y + crop_size, x:x + crop_size]
            cm = mask[y:y + crop_size, x:x + crop_size] if mask is not None else None
            if cm is not None and (cm > 0).mean() < 0.005:
                continue  # skip near-empty crops
            out.append((ci, cm, (y, x)))
    return out


# ---------------------------------------------------------------------------
# Analysis (reference analysis.py:12-211)
# ---------------------------------------------------------------------------

_ANALYSIS_COLUMNS = ["frame", "cell_count", "mean_area", "total_area",
                     "mean_major_axis", "mean_minor_axis"]
_CHUNK = 8  # frames per device call (bounds memory: 8 x 2048^2 int32)


def analyze_dataset(store: ImageStore, image_ids: Sequence[int],
                    result_dir: Path,
                    text_output: Callable[[str], None] = _noop,
                    progress: Callable[[int], None] = _noop,
                    device=None) -> List[Path]:
    """Per-frame counts / areas / axis lengths from polygon ROIs, written to
    CSV and attached under the analysis namespace.  ``regionprops`` runs on
    ``device`` (the CUDA card unless ``"cpu"``), one call per chunk of 8
    frames at one instance capacity per stack: capacity only pads the
    segment sums and the present-mask filters the zeros, so per-frame stats
    equal per-frame caps.  No relabel pass: ``_rasterize_rois`` assigns
    sequential ids 1..n, and ids erased by covering polygons only leave
    zero-area rows that the present-mask filters."""
    device = resolve_device(device)
    result_dir = Path(result_dir)
    result_dir.mkdir(parents=True, exist_ok=True)
    outputs = []
    for i, iid in enumerate(image_ids):
        ref = store.get_image(iid)
        polys = store.get_polygons(iid)
        masks = np.stack([_rasterize_rois(polys, t, (ref.size_y, ref.size_x))
                          for t in range(ref.size_t)]).astype(np.int32)
        n_max = int(masks.max())
        rows = []
        if n_max == 0:
            rows = [dict(frame=t, cell_count=0, mean_area=0.0,
                         total_area=0.0, mean_major_axis=0.0,
                         mean_minor_axis=0.0) for t in range(ref.size_t)]
        else:
            cap = max(16, 1 << (n_max - 1).bit_length())
            for start in range(0, ref.size_t, _CHUNK):
                chunk = masks[start:start + _CHUNK]
                props = regionprops(torch.from_numpy(chunk).to(device),
                                    max_labels=cap)
                area, major, minor = (
                    p.cpu().numpy() for p in (props.area,
                                              props.major_axis_length,
                                              props.minor_axis_length))
                for j in range(chunk.shape[0]):
                    areas = area[j]
                    present = areas > 0
                    any_cells = bool(present.any())
                    rows.append(dict(
                        frame=start + j,
                        cell_count=int(present.sum()),
                        mean_area=float(areas[present].mean())
                        if any_cells else 0.0,
                        total_area=float(areas[present].sum())
                        if any_cells else 0.0,
                        mean_major_axis=float(major[j][present].mean())
                        if any_cells else 0.0,
                        mean_minor_axis=float(minor[j][present].mean())
                        if any_cells else 0.0))
        out = result_dir / f"analysis_{ref.name or iid}.csv"
        _Table(_ANALYSIS_COLUMNS, rows).write(out)   # as pandas' to_csv
        store.delete_attachments(iid, namespace=ANALYSIS_NAMESPACE)
        store.attach_file(iid, out, namespace=ANALYSIS_NAMESPACE)
        outputs.append(out)
        progress(int(100 * (i + 1) / len(image_ids)))
    return outputs


# ---------------------------------------------------------------------------
# Result export (reference result_export.py:11-224)
# ---------------------------------------------------------------------------

def export_results(store: ImageStore, image_ids: Sequence[int],
                   result_dir: Path, channel: int = 0,
                   text_output: Callable[[str], None] = _noop,
                   progress: Callable[[int], None] = _noop) -> None:
    """Download planes + ROIs; write {stem}.tif, _mask.tif, _overlay.tif
    (yellow outlines on grayscale, one RGB frame per time point —
    reference result_export.py:183-204), _outlines.tif, plus the
    analysis CSV."""
    result_dir = Path(result_dir)
    result_dir.mkdir(parents=True, exist_ok=True)
    for i, iid in enumerate(image_ids):
        ref = store.get_image(iid)
        polys = store.get_polygons(iid)
        frames, masks, overlays, outlines = [], [], [], []
        for t in range(ref.size_t):
            img = store.get_plane(iid, 0, channel, t)
            mask = _rasterize_rois(polys, t, img.shape)
            outline = _outline(mask)
            img8 = (255 * (min_max_normalization(img) + 1) / 2).astype(np.uint8)
            overlay = np.stack([img8] * 3, axis=-1)
            overlay[outline] = (255, 255, 0)  # yellow
            frames.append(img)
            masks.append(mask)
            overlays.append(overlay)
            outlines.append(outline.astype(np.uint8) * 255)
        stem = Path(ref.name).stem or str(iid)
        imwrite(result_dir / f"{stem}.tif", np.squeeze(np.stack(frames)))
        imwrite(result_dir / f"{stem}_mask.tif", np.squeeze(np.stack(masks)))
        imwrite(result_dir / f"{stem}_outlines.tif",
                np.squeeze(np.stack(outlines)))
        imwrite(result_dir / f"{stem}_overlay.tif",
                np.squeeze(np.stack(overlays)))
        for name in store.list_attachments(iid, namespace=ANALYSIS_NAMESPACE):
            store.download_attachment(iid, name, result_dir / name)
        progress(int(100 * (i + 1) / len(image_ids)))


def _outline(mask: np.ndarray) -> np.ndarray:
    """Instance outlines: pixels whose 4-neighbor has a different label."""
    m = np.asarray(mask)
    out = np.zeros(m.shape, bool)
    out[:-1] |= (m[:-1] != m[1:]) & (m[:-1] > 0)
    out[1:] |= (m[1:] != m[:-1]) & (m[1:] > 0)
    out[:, :-1] |= (m[:, :-1] != m[:, 1:]) & (m[:, :-1] > 0)
    out[:, 1:] |= (m[:, 1:] != m[:, :-1]) & (m[:, 1:] > 0)
    return out


# ---------------------------------------------------------------------------
# Crop creation with pre-labeling (reference data_cropping.py + GUI logic)
# ---------------------------------------------------------------------------

@dataclass
class Crop:
    image_id: int
    frame: int
    y: int
    x: int
    img: np.ndarray
    display: np.ndarray
    rois: List[RoiPolygon]
    overlay: Optional[np.ndarray]
    # full-frame statistics BEFORE padding/cropping (the reference stores
    # these for later denormalization at export, data_cropping.py:171)
    min_frame: float = 0.0
    max_frame: float = 0.0
    mean_frame: float = 0.0
    std_frame: float = 0.0


SPLIT_INFO_NAMESPACE = "split.info.namespace"  # reference gui:2189, 2785
SPLIT_INFO_NAME = "split_info.json"


def default_split_info() -> dict:
    """Reference split_info shape (microbe_seg_gui.py:2195-2206): 'used' =
    [image_id, frame, channel] triples already offered for cropping,
    'num_acc' = accepted interactive crops (drives split_assignment and
    img_NNN naming), 'num_ext' = imported external crops (img_extNNN)."""
    return {"used": [], "num_acc": 0, "num_ext": 0}


def load_split_info(store: ImageStore, trainset_id: int) -> dict:
    """Download the trainset's persisted split_info.json file annotation
    (reference gui:2188-2206) — session-spanning used-frame dedup and split
    counters; defaults on first use."""
    import tempfile

    info = default_split_info()
    with tempfile.TemporaryDirectory() as td:
        path = store.download_dataset_attachment(
            trainset_id, SPLIT_INFO_NAME, Path(td) / SPLIT_INFO_NAME)
        if path is not None:
            info.update(json.loads(path.read_text()))
    for key, val in default_split_info().items():
        info.setdefault(key, val)
    return info


def save_split_info(store: ImageStore, trainset_id: int,
                    split_info: dict) -> None:
    """Replace the trainset's split_info.json annotation (reference
    gui:2782-2796 deletes stale annotations in the namespace, then links the
    fresh file)."""
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td) / SPLIT_INFO_NAME
        tmp.write_text(json.dumps(split_info, ensure_ascii=False, indent=2))
        store.delete_dataset_attachments(trainset_id,
                                         namespace=SPLIT_INFO_NAMESPACE)
        store.attach_dataset_file(trainset_id, tmp,
                                  namespace=SPLIT_INFO_NAMESPACE)


class CropGenerator:
    """Builds the shuffled crop list (<=40% of frames, <=30 per experiment,
    used-frame dedup; reference microbe_seg_gui.py:2144-2149, 2247-2287) and
    yields 1-3 random crop windows in disjoint segments along the longer
    axis (data_cropping.py:157-199), with optional model pre-labeling.

    ``trainset_id`` enables session persistence: split_info.json is loaded
    from the trainset dataset and re-uploaded after every accepted crop, so
    used-frame dedup and the 4/2/2 counters survive restarts (reference
    gui:2188-2206, 2782-2796)."""

    def __init__(self, store: ImageStore, crop_size: int,
                 engine=None, split_info: Optional[dict] = None,
                 seed: int = 0, channel: int = 0,
                 trainset_id: Optional[int] = None):
        self.store = store
        self.crop_size = crop_size
        self.engine = engine
        self.trainset_id = trainset_id
        if split_info is None:
            split_info = (load_split_info(store, trainset_id)
                          if trainset_id is not None else default_split_info())
        self.split_info = split_info
        self.rng = np.random.default_rng(seed)
        self.channel = channel

    def crop_list(self, dataset_id: int) -> List[Tuple[int, int]]:
        used = {tuple(u) for u in self.split_info["used"]}
        items = []
        for ref in self.store.list_images(dataset_id):
            if ref.size_z > 1:
                continue  # skip z-stacks
            if self.channel + 1 > ref.size_c:
                continue  # missing channel
            # accept down to 0.9x the crop size — smaller frames are padded
            # with the frame minimum (reference gui:2254, cropping :175-180)
            if min(ref.size_y, ref.size_x) < 0.9 * self.crop_size:
                continue
            # evenly strided frame subset: <=40% of frames, ~30 per
            # experiment (reference gui:2248-2251)
            if 0.4 * ref.size_t > 30:
                # true ceil: the reference's int(np.ceil(size_t // 30))
                # floor-divides INSIDE the ceil, letting up to 2x the
                # 30-frame cap through (80 frames -> stride 2 -> 40)
                stride = int(np.ceil(ref.size_t / 30))
            else:
                # exact reference parity: int(1/0.4) truncates to 2, so
                # 50% of frames are offered despite the "maximum 40%"
                # comment (gui:2148-2151) — keep its actual behavior
                stride = int(1 / 0.4)
            for t in range(0, ref.size_t, max(stride, 1)):
                if (ref.image_id, t, self.channel) in used:
                    continue
                items.append((ref.image_id, int(t)))
        self.rng.shuffle(items)
        return items

    def next_crops(self, image_id: int, frame: int) -> List[Crop]:
        img = self.store.get_plane(image_id, 0, self.channel, frame)
        H, W = img.shape
        cs = self.crop_size
        if 0.9 * cs > H or 0.9 * cs > W:
            return []  # too small even with padding (reference :174-176)
        # frame statistics before padding (reference :171)
        img_min, img_max = float(img.min()), float(img.max())
        stats = dict(min_frame=img_min, max_frame=img_max,
                     mean_frame=float(img.mean()),
                     std_frame=float(img.std()))
        # longer axis hosts 1-3 disjoint segments, one crop each
        # (reference :157-168, :182-199)
        crop_dim = 0 if H > W else 1
        long_side = (H, W)[crop_dim]
        n = 3 if long_side > 3 * cs else (2 if long_side > 2 * cs else 1)
        y_pads, x_pads = max(cs - H, 0), max(cs - W, 0)
        img = np.pad(img, ((0, y_pads), (0, x_pads)),
                     constant_values=img_min)
        crops = []
        for i in range(n):
            c = img.shape[crop_dim] // n
            if y_pads > 0 and x_pads > 0:
                y, x = 0, 0
            elif crop_dim == 0 and y_pads == 0 and img.shape[0] > cs:
                # crop i confined to segment [i*c, (i+1)*c) of the long axis
                y = int(self.rng.integers(
                    i * c, min(img.shape[0] - cs, (i + 1) * c - cs) + 1))
                x = int(self.rng.integers(0, img.shape[1] - cs + 1))
            elif crop_dim == 1 and x_pads == 0 and img.shape[1] > cs:
                y = int(self.rng.integers(0, img.shape[0] - cs + 1))
                x = int(self.rng.integers(
                    i * c, min(img.shape[1] - cs, (i + 1) * c - cs) + 1))
            else:
                y, x = 0, 0
            crop = img[y:y + cs, x:x + cs]
            # display scaled by FRAME min/max, not crop min/max
            # (reference :205-206)
            display = (255 * (min_max_normalization(crop, img_min, img_max)
                              + 1) / 2).astype(np.uint8)
            rois, overlay = [], None
            if self.engine is not None:
                mask = self.engine.segment(crop)
                rois = _mask_to_rois(mask)
                outline = _outline(mask)
                overlay = np.stack([display] * 3, axis=-1)
                overlay[outline] = (255, 255, 0)
            crops.append(Crop(image_id=image_id, frame=frame, y=y, x=x,
                              img=crop, display=display, rois=rois,
                              overlay=overlay, **stats))
        return crops

    def upload_crop(self, crop: Crop, trainset_id: int, subset: str,
                    persist: bool = True) -> int:
        num = self.split_info["num_acc"]
        iid = self.store.upload_image(
            trainset_id, f"img_{num:03d}.tif",  # reference gui:2726
            crop.img.astype(np.uint16))
        self.store.set_map_annotation(iid, {
            "set": subset, "source_image": crop.image_id,
            "frame": crop.frame, "crop_y": crop.y, "crop_x": crop.x,
            "crop_size": self.crop_size, "channel": self.channel,
            "pre_labeled": str(bool(crop.rois)),
            "last_modification": "", "upload_date": timestamp(),
            "min_frame": crop.min_frame, "max_frame": crop.max_frame,
            "mean_frame": crop.mean_frame, "std_frame": crop.std_frame})
        if crop.rois:
            self.store.add_polygons(iid, crop.rois)
        # counters + used entry (reference gui:2743-2744), persisted to the
        # trainset so a restarted session keeps deduping (gui:2782-2796)
        self.split_info["num_acc"] += 1
        # accepting several crops of one frame (keys 1/2/3) calls this once
        # per crop — record the frame triple only once
        entry = [int(crop.image_id), int(crop.frame), int(self.channel)]
        if entry not in self.split_info["used"]:
            self.split_info["used"].append(entry)
        if persist and self.trainset_id is not None:
            save_split_info(self.store, self.trainset_id, self.split_info)
        return iid

    def mark_skipped(self, image_id: int, frame: int,
                     persist: bool = True) -> None:
        """Record a frame whose crops were all rejected so it is not offered
        again (the reference appends denied frames to 'used' too —
        split_info comment gui:2196)."""
        entry = [int(image_id), int(frame), int(self.channel)]
        if entry not in self.split_info["used"]:
            self.split_info["used"].append(entry)
        if persist and self.trainset_id is not None:
            save_split_info(self.store, self.trainset_id, self.split_info)


def split_assignment(num_crops: int) -> str:
    """Deterministic train/val/test assignment by accepted-crop count
    (reference microbe_seg_gui.py:2848-2865): the first 8 crops fill
    4 train / 2 val / 2 test in a fixed order, afterwards a 6-cycle keeps
    roughly 4/1/1 proportions."""
    if num_crops < 8:
        return ["train", "train", "val", "test",
                "train", "train", "val", "test"][num_crops]
    return ["train", "train", "val",
            "train", "train", "test"][(num_crops - 8) % 6]


# ---------------------------------------------------------------------------
# OMERO-dataset inference (reference infer.py:22-390)
# ---------------------------------------------------------------------------

# Label-tool attachments deleted on overwrite (reference infer.py:197-205)
LABEL_TOOL_ATTACHMENTS = ["simpleSegmentation.json", "GUISegmentation.json"]


def infer_dataset(store: ImageStore, image_ids: Sequence[int], engine,
                  model_name: str, upload: bool = True,
                  overwrite: bool = False,
                  result_dir: Optional[Path] = None,
                  channel: int = 0,
                  text_output: Callable[[str], None] = _noop,
                  progress: Callable[[int], None] = _noop,
                  should_stop: Callable[[], bool] = lambda: False,
                  pipeline: bool = True) -> None:
    """Segment stored images on one channel: skip z-stacks / missing channel
    (reference infer.py:171) / no write permission (:157) / already-processed
    (map annotations 'inference_model'/'inference_date' or an existing local
    mask file, :179-185, :211-215); overwrite deletes old ROIs plus label-tool
    and analysis attachments (:186-205); frames are batched through the engine
    (reference loops batch=1); results go back as polygon ROIs + annotations,
    or local per-channel mask TIFFs (:320-322).

    With ``pipeline=True`` the host-side result handling (contour tracing,
    ROI upload, mask write) runs on one helper thread so it overlaps the NEXT
    image's device compute — contour tracing is native code outside the GIL
    and `engine.segment` waits on the card, so the overlap is real.
    The single worker keeps store mutations in image order, and every store
    call on either thread holds ``store.lock`` (one OMERO connection is not
    thread-safe).  Note ``progress`` (and nothing else) is invoked FROM the
    helper thread when ``pipeline=True`` — pass a thread-safe callable (Qt
    signal emits are).  Results and store state are identical to the serial
    path (``pipeline=False``)."""
    from concurrent.futures import ThreadPoolExecutor

    # Dedupe while preserving order: a repeated id (explicit --files plus a
    # dataset expansion containing the same image) would otherwise race the
    # pipelined finish() of its first occurrence — the 'processed' check and
    # overwrite deletions could run before the first pass's ROIs/annotations
    # commit, re-segmenting the image and double-uploading ROIs.
    image_ids = list(dict.fromkeys(int(i) for i in image_ids))

    lock = store.lock  # materialize on the main thread before workers start

    def finish(i: int, iid: int, masks: np.ndarray,
               mask_path: Optional[Path]) -> None:
        if masks.ndim == 2:
            masks = masks[None]
        if upload:
            rois = []
            for t in range(masks.shape[0]):
                rois.extend(_mask_to_rois(masks[t], t=t))
            with lock:
                store.add_polygons(iid, rois)
                store.set_map_annotation(
                    iid, {"inference_model": model_name,
                          "inference_date": timestamp()})
        if mask_path is not None:
            mask_path.parent.mkdir(parents=True, exist_ok=True)
            imwrite(mask_path, np.squeeze(masks))
        progress(int(100 * (i + 1) / len(image_ids)))

    pending: List = []

    def drain(limit: int) -> None:
        while len(pending) > limit:
            pending.pop(0).result()  # re-raises the helper's exception

    with ThreadPoolExecutor(max_workers=1) as pool:
        try:
            for i, iid in enumerate(image_ids):
                if should_stop():
                    drain(0)
                    text_output("Stop inference due to user interaction.")
                    return
                with lock:
                    ref = store.get_image(iid)
                    can = (not upload) or store.can_annotate(iid)
                if upload and not can:
                    text_output(f"Skip {ref.name} (no write permission)")
                    continue
                if ref.size_z > 1:
                    text_output(f"Skip {ref.name} (is z-stack)")
                    continue
                if channel + 1 > ref.size_c:
                    text_output(f"Skip {ref.name} (not enough channels found)")
                    continue
                stem = Path(ref.name).stem or str(iid)
                mask_path = (Path(result_dir)
                             / f"mask_{stem}_channel{channel}.tif"
                             if result_dir is not None else None)
                if upload:
                    with lock:
                        meta = store.get_map_annotation(iid)
                    processed = bool(meta.get("inference_model"))
                else:
                    processed = mask_path is not None and mask_path.is_file()
                if processed and not overwrite:
                    text_output(f"Skip {ref.name} (already processed and "
                                "overwriting not enabled)")
                    continue
                if overwrite and upload:
                    with lock:
                        store.delete_polygons(iid)
                        store.delete_attachments(
                            iid, namespace=ANALYSIS_NAMESPACE,
                            names=LABEL_TOOL_ATTACHMENTS)
                with lock:
                    frames = np.stack([store.get_plane(iid, 0, channel, t)
                                       for t in range(ref.size_t)])
                masks = engine.segment(frames)
                if pipeline:
                    # ≤2 outstanding mask stacks bound host memory; drain
                    # first so a helper failure stops the loop promptly
                    drain(1)
                    pending.append(pool.submit(finish, i, iid,
                                               np.asarray(masks), mask_path))
                else:
                    finish(i, iid, np.asarray(masks), mask_path)
            drain(0)  # success path: propagate any helper failure
        finally:
            # unwind path: wait for stragglers without masking the
            # in-flight exception (drain(0) above already re-raised on
            # the success path and left pending empty)
            for f in pending:
                try:
                    f.result()
                except Exception:
                    pass
            pending.clear()
