"""Model evaluation: threshold-grid inference and AJI+ scoring.

Port of ``microbeseg_tpu/evaluation/evaluator.py`` (the reference's
EvalWorker protocol, src/evaluation/eval.py:28-427) on the port's engine:

- each test image's whole th_cell x th_seed grid is post-processed as one
  batch on the device (``distance_postprocessing_grid`` with the default
  ``max_seeds=256``, as the JAX evaluator calls it; not ``segment_grid``,
  whose seed cap scales with the frame);
- per-threshold mask directories, best-threshold selection, ``scores.csv``,
  the aggregated ``{results}.csv`` with stale-test-set eviction by sha1
  hash, and the test-set zip keep the JAX evaluator's artifacts.

The JAX evaluator writes its CSVs with pandas; the port writes the same
bytes with the ``csv`` module (see ``_Table``) and returns the aggregated
table as a list of row dicts.  The evaluator runs on the CUDA card unless
``device`` says otherwise.
"""

from __future__ import annotations

import csv
import hashlib
import os
import re
import shutil
import zipfile
from itertools import product
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from microbeseg_torch.config import EvalConfig, InferConfig
from microbeseg_torch.evaluation.metrics import (get_fast_aji,
                                                 get_fast_aji_plus,
                                                 get_fast_dice_2,
                                                 get_fast_pq, remap_label)
from microbeseg_torch.inference.engine import InferenceEngine
from microbeseg_torch.ops.postprocessing import (
    boundary_postprocessing, distance_postprocessing_grid)
from microbeseg_torch.utils.device import resolve_device
from microbeseg_torch.utils.image import border_correction
from microbeseg_torch.utils.tiff import imread, imwrite

_VERSION = "test set version"


def _noop(*a, **k):
    pass


# ---------------------------------------------------------------------------
# CSV tables, byte for byte as pandas writes and reads them
# ---------------------------------------------------------------------------

_POW10 = [float(f"1e{k}") for k in range(309)]
_INT = re.compile(r"[+-]?\d+\Z")
_FLOAT = re.compile(r"[+-]?(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?\Z")


def _pandas_float(text: str) -> float:
    """A float as pandas' default C parser reads it (``precise_xstrtod`` in
    pandas/_libs/src/parser/tokenizer.c): at most 17 significant digits
    accumulated in a double, then one multiply or divide by a power of 10.
    This is not always the nearest double (about a third of 17-digit reprs
    come back an ulp off), and the JAX evaluator writes back what pandas
    read, so the port reads the same way.  ValueError if not a number."""
    m = _FLOAT.match(text)
    if m is None or not (m.group(1) or m.group(2)):
        raise ValueError(text)
    number, exponent, n_digits = 0.0, 0, 0
    for ch in m.group(1):
        if n_digits < 17:
            number = number * 10.0 + (ord(ch) - 48)
            n_digits += 1
        else:
            exponent += 1
    for ch in m.group(2) or "":
        if n_digits >= 17:
            break
        number = number * 10.0 + (ord(ch) - 48)
        n_digits += 1
        exponent -= 1
    if text.startswith("-"):
        number = -number
    if m.group(3):
        digits = m.group(3).lstrip("+-")[:17]
        exponent += -int(digits) if m.group(3).startswith("-") else int(
            digits)
    if exponent > 308:
        return number * float("inf")
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return number * 0.0
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _kind(values: list) -> str:
    """The pandas dtype of a column of these values: 'str' (object), 'int'
    (int64, no missing value) or 'float' (float64; None is NaN)."""
    present = [v for v in values if v is not None]
    if any(isinstance(v, str) for v in present):
        return "str"
    if len(present) == len(values) and all(isinstance(v, int)
                                           for v in present):
        return "int"
    return "float"


def _text_kind(texts: List[str]) -> str:
    """The dtype pandas.read_csv gives a column of these fields: 'int' when
    every field is an integer, 'float' when every non-empty one is a number
    (empty fields are NaN), 'str' (object) otherwise or without rows."""
    if not texts:
        return "str"
    if all(_INT.match(t) for t in texts):
        return "int"
    try:
        for t in texts:
            if t:
                _pandas_float(t)
    except ValueError:
        return "str"
    return "float"


def _widest(a: str, b: str) -> str:
    for k in ("str", "float"):
        if k in (a, b):
            return k
    return "int"


class _Table:
    """Columns, rows (dicts) and each column's pandas dtype kind."""

    def __init__(self, columns: List[str], rows: List[dict],
                 kinds: Optional[Dict[str, str]] = None):
        self.columns, self.rows = list(columns), rows
        self.kinds = kinds or {c: _kind([r.get(c) for r in rows])
                               for c in columns}

    @classmethod
    def from_columns(cls, data: Dict[str, list]) -> "_Table":
        cols = list(data)
        n = len(data[cols[0]]) if cols else 0
        return cls(cols, [{c: data[c][i] for c in cols} for i in range(n)])

    @classmethod
    def read(cls, path: Path) -> "_Table":
        """``pd.read_csv(path)``, its columns typed by ``_text_kind``, except
        ``test set version``, always read as a string.  pandas would read a
        version made only of digits as an integer, which never equals the
        new rows' string version, so the JAX evaluator evicts those rows as
        stale; the port keeps them."""
        with open(path, newline="", encoding="utf-8") as f:
            records = list(csv.reader(f))
        columns, records = records[0], records[1:]
        rows = [dict(zip(columns, r)) for r in records]
        kinds = {c: "str" if c == _VERSION else _text_kind(
                     [r[c] for r in rows]) for c in columns}
        for c in columns:
            parse = {"int": int, "float": _pandas_float, "str": str}[kinds[c]]
            for r in rows:
                r[c] = parse(r[c]) if r[c] else None
        return cls(columns, rows, kinds)

    def concat(self, other: "_Table") -> "_Table":
        """``pd.concat([self, other], ignore_index=True)``: the union of the
        columns in order of appearance; a column missing from a frame is
        NaN there, and a frame's dtypes count even when it has no rows (as
        pandas 3 combines them)."""
        columns = self.columns + [c for c in other.columns
                                  if c not in self.columns]
        kinds = {c: _widest(self.kinds.get(c, "float"),
                            other.kinds.get(c, "float")) for c in columns}
        rows = [{c: r.get(c) for c in columns}
                for r in self.rows + other.rows]
        return _Table(columns, rows, kinds)

    def write(self, path: Path) -> None:
        """``to_csv(path, header=True, index=False)``: floats as ``repr``
        (integers in a float column too), NaN as an empty field, minimal
        quoting, '\\n' line ends."""
        def cell(v, kind):
            if v is None:
                return ""
            if kind == "float":
                return repr(float(v))
            return str(v)

        with open(path, "w", newline="", encoding="utf-8") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(self.columns)
            for r in self.rows:
                w.writerow([cell(r.get(c), self.kinds[c])
                            for c in self.columns])


# ---------------------------------------------------------------------------
# Threshold refinement
# ---------------------------------------------------------------------------

def _grid_spacing(values) -> float:
    """Smallest spacing of a threshold axis (refinement starts at half it)."""
    vs = sorted(set(values))
    if len(vs) < 2:
        return 0.05
    return min(b - a for a, b in zip(vs, vs[1:]))


def refine_candidates(best, d_cell: float, d_seed: float, seen):
    """3x3 neighbourhood of ``best`` at (d_cell, d_seed) spacing, minus
    already-evaluated points and out-of-range thresholds.  Rounding to 4
    decimals keeps directory names (``{th_cell}_{th_seed}``) canonical."""
    bc, bs = best
    cands = []
    for i in (-1, 0, 1):
        for j in (-1, 0, 1):
            tc = round(bc + i * d_cell, 4)
            ts = round(bs + j * d_seed, 4)
            if not (0.005 <= tc <= 0.995 and 0.005 <= ts <= 0.995):
                continue
            if (tc, ts) in seen:
                continue
            cands.append((tc, ts))
    return cands


class Evaluator:
    def __init__(self, cfg: Optional[EvalConfig] = None,
                 text_output: Callable[[str], None] = _noop,
                 progress: Callable[[int], None] = _noop,
                 should_stop: Callable[[], bool] = lambda: False,
                 device=None, mesh=None):
        """``mesh``: the engines it builds run data-parallel over its
        devices (it then names the device)."""
        self.cfg = cfg or EvalConfig()
        self.text_output = text_output
        self.progress = progress
        self.should_stop = should_stop
        self.mesh = mesh
        self.device = (mesh.devices[0] if mesh is not None
                       else resolve_device(device))

    # ------------------------------------------------------------------

    def evaluate(self, path_data: Path, path_results: Path,
                 models: Sequence[Path], start_message: str = ""
                 ) -> Optional[List[dict]]:
        """Evaluate checkpoints on ``{path_data}/test``; returns the rows of
        the aggregated scores table (None if aborted)."""
        path_data = Path(path_data)
        path_results = Path(path_results)
        test_masks = sorted((path_data / "test").glob("mask*.tif"))
        if len(test_masks) < 2:
            self.text_output("Not enough test images found. At least 2 are "
                             "needed (better more)")
            return None
        self.text_output(start_message)

        scores = {"model": [], "th_cell": [], "th_seed": [],
                  "aji+ (mean)": [], "aji+ (std)": []}
        for m in self.cfg.extra_metrics:
            scores[f"{m} (mean)"] = []
        scores[_VERSION] = []

        # ensemble mode: ALL given checkpoints form ONE averaged model ->
        # one row; otherwise one row per checkpoint
        if self.cfg.ensemble and len(models) > 1:
            jobs = [[Path(p) for p in models]]
        else:
            jobs = [[Path(p)] for p in models]

        for i, group in enumerate(jobs):
            model_path = group[0]
            name = "+".join(p.stem for p in group)
            out_dir = path_results / f"{model_path.parent.stem}_{name}"
            if out_dir.is_dir():
                shutil.rmtree(out_dir)
            out_dir.mkdir(parents=True)

            if self.should_stop():
                self.text_output("Stop evaluation due to user interaction.")
                return None

            # eval pre-processing: no CLAHE, no scaling (reference
            # eval.py:123-124); EvalConfig.batch_size drives device batching
            icfg = InferConfig(batch_size=self.cfg.batch_size,
                               tta=self.cfg.tta)
            engine = (InferenceEngine.from_checkpoint(
                          model_path, cfg=icfg, device=self.device,
                          mesh=self.mesh)
                      if len(group) == 1 else
                      InferenceEngine.from_checkpoints(
                          group, cfg=icfg, device=self.device,
                          mesh=self.mesh))
            label_type = engine.label_type

            if label_type == "distance":
                ths = list(product(self.cfg.th_cells, self.cfg.th_seeds))
            else:
                ths = [-1]

            self._inference(engine, path_data / "test", ths, out_dir)
            if label_type == "distance" and self.cfg.refine_steps > 0:
                self._refine(engine, path_data / "test", out_dir, ths)
            result = self._calc_scores(out_dir, path_data / "test",
                                       label_type)
            if result is None:
                return None
            score, std, th_cell, th_seed, version = result
            scores["model"].append(f"{model_path.parent.stem}: {name}")
            scores["th_cell"].append(th_cell)
            scores["th_seed"].append(th_seed)
            scores["aji+ (mean)"].append(score)
            scores["aji+ (std)"].append(std)
            if self.cfg.extra_metrics:
                extras = self._extra_scores(out_dir, path_data / "test")
                for m in self.cfg.extra_metrics:
                    scores[f"{m} (mean)"].append(extras[m])
            scores[_VERSION].append(version)

            self._zip_test_set(path_data, out_dir)
            self.progress(int(100 * (i + 1) / len(jobs)))

        table = _Table.from_columns(scores)
        agg_path = path_results.parent / f"{path_results.stem}.csv"
        if agg_path.is_file() and table.rows:
            old = _Table.read(agg_path)
            # evict scores from a different (stale) test-set version
            version = table.rows[0][_VERSION]
            old.rows = [r for r in old.rows if r.get(_VERSION) == version]
            table = table.concat(old)
            seen = set()
            table.rows = [r for r in table.rows
                          if not (r["model"] in seen or seen.add(r["model"]))]
        table.rows.sort(key=lambda r: r["model"])
        table.write(agg_path)
        self.progress(100)
        return table.rows

    # ------------------------------------------------------------------

    def _refine(self, engine, test_dir: Path, out_dir: Path, ths) -> None:
        """Coarse-to-fine threshold search (``EvalConfig.refine_steps``):
        evaluate the 3x3 neighbourhood of the running best at half the
        previous spacing, for ``refine_steps`` rounds.  The refined
        directories join the grid directories, so ``_calc_scores``'s
        best-threshold selection is unchanged."""
        d_cell = _grid_spacing(self.cfg.th_cells) / 2
        d_seed = _grid_spacing(self.cfg.th_seeds) / 2
        # exact tuples: keys must reproduce _inference's directory names
        seen = {(tc, ts) for tc, ts in ths}
        means = {}

        def ensure_scored(th_list) -> bool:
            for th in th_list:
                if th in means:
                    continue
                res = self._score_dir(out_dir / f"{th[0]}_{th[1]}", test_dir)
                if res is None:
                    return False
                means[th] = float(np.mean(res[1])) if res[1] else 0.0
            return True

        if not ensure_scored(sorted(seen)):
            return
        for step in range(self.cfg.refine_steps):
            if self.should_stop():
                return
            best = max(means, key=means.get)
            cands = refine_candidates(best, d_cell, d_seed, seen)
            if cands:
                self.text_output(
                    f"Refine round {step + 1}: best th {best} "
                    f"(AJI+ {means[best]:.4f}), testing {len(cands)} "
                    f"neighbors at spacing ({d_cell:.4g}, {d_seed:.4g})")
                self._inference(engine, test_dir, cands, out_dir)
                seen |= set(cands)
                if not ensure_scored(cands):
                    return
            d_cell /= 2
            d_seed /= 2

    def _inference(self, engine, test_dir: Path, ths, out_dir: Path) -> None:
        """Predict the test set, same-shape images batched together
        (``engine.predict_raw`` once per shape); each distance frame's
        whole threshold grid is post-processed as one batch on the
        evaluator's device."""
        img_paths = sorted(test_dir.glob("img*.tif"))
        by_shape: dict = {}
        for p in img_paths:
            img = imread(p)
            by_shape.setdefault(img.shape, []).append((p, img))

        def on_device(a):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   device=self.device)

        for shape, items in by_shape.items():
            if self.should_stop():
                return
            stack = np.stack([img for _, img in items])
            preds = engine.predict_raw(stack)
            for i, (p, _) in enumerate(items):
                file_id = p.stem.split("img")[-1]
                if engine.label_type == "distance":
                    border, cell = preds[0][i], preds[1][i]
                    masks = distance_postprocessing_grid(
                        on_device(border), on_device(cell),
                        np.asarray(ths, np.float32)).cpu().numpy()
                    for (th_cell, th_seed), mask in zip(ths, masks):
                        sub = out_dir / f"{th_cell}_{th_seed}"
                        sub.mkdir(exist_ok=True)
                        imwrite(sub / f"mask{file_id}.tif",
                                mask.astype(np.uint16))
                        if self.cfg.save_raw_pred:
                            raw = np.stack([cell, border])
                            imwrite(sub / f"raw{file_id}.tif",
                                    raw.astype(np.float32))
                else:
                    probs = preds[0][i]
                    mask = boundary_postprocessing(
                        on_device(probs)).cpu().numpy()
                    imwrite(out_dir / f"mask{file_id}.tif",
                            mask.astype(np.uint16))
                    if self.cfg.save_raw_pred:
                        # channel-first (3, H, W) float stack: a trailing
                        # size-3 float axis is not a writable RGB image
                        imwrite(out_dir / f"raw{file_id}.tif",
                                np.moveaxis(probs, -1, 0).astype(np.float32))

    # ------------------------------------------------------------------

    def _masks(self, pred_id: Path, gt_dir: Path):
        """Border-corrected (ground truth, prediction) of one test image."""
        return (border_correction(imread(gt_dir / pred_id.name),
                                  self.cfg.border_width),
                border_correction(imread(pred_id), self.cfg.border_width))

    def _score_dir(self, pred_dir: Path, gt_dir: Path):
        names, vals = [], []
        for pred_id in sorted(pred_dir.glob("mask*.tif")):
            if self.should_stop():
                self.text_output("Stop metric calculation.")
                return None
            ground_truth, prediction = self._masks(pred_id, gt_dir)
            if prediction.max() > 0:
                aji = get_fast_aji_plus(remap_label(ground_truth),
                                        remap_label(prediction))
            else:
                aji = 0.0
            names.append(pred_id.stem)
            vals.append(aji)
        return names, vals

    _EXTRA_FNS = {
        "aji": lambda t, p: get_fast_aji(t, p),
        "dice": lambda t, p: get_fast_dice_2(t, p),
        "pq": lambda t, p: get_fast_pq(t, p)[0][2],
    }

    def _extra_scores(self, pred_dir: Path, gt_dir: Path) -> dict:
        """Per-image extra metric columns (``EvalConfig.extra_metrics``) on
        the AJI+-selected best-threshold masks at the top of ``pred_dir``;
        appends the columns to its ``scores.csv`` and returns the
        per-metric means."""
        cols: dict = {m: [] for m in self.cfg.extra_metrics}
        names = []
        for pred_id in sorted(pred_dir.glob("mask*.tif")):
            ground_truth, prediction = self._masks(pred_id, gt_dir)
            t, p = remap_label(ground_truth), remap_label(prediction)
            names.append(pred_id.stem)
            for m in self.cfg.extra_metrics:
                cols[m].append(self._EXTRA_FNS[m](t, p)
                               if p.max() > 0 else 0.0)
        csv_path = pred_dir / "scores.csv"
        if csv_path.is_file() and names:
            # a left merge on "test image"
            table = _Table.read(csv_path)
            extra = _Table.from_columns(cols)
            by_name = dict(zip(names, extra.rows))
            for r in table.rows:
                r.update(by_name.get(r["test image"],
                                     dict.fromkeys(cols)))
            table.columns += [c for c in cols if c not in table.columns]
            table.kinds.update(extra.kinds)
            table.write(csv_path)
        return {m: float(np.mean(v)) if v else 0.0
                for m, v in cols.items()}

    def _write_scores(self, path: Path, names, vals) -> str:
        """``scores.csv`` sorted by image; returns the test-set version."""
        table = _Table.from_columns({"test image": names, "aji+": vals})
        table.rows.sort(key=lambda r: r["test image"])
        table.write(path / "scores.csv")
        return hashlib.sha1(str(names).encode("UTF-8")).hexdigest()[:10]

    def _calc_scores(self, prediction_path: Path, test_set_path: Path,
                     label_type: str):
        if label_type == "distance":
            best = (0.0, 0.0, 0.0, 0.0, None, None, None)
            for sub_dir in sorted(prediction_path.iterdir()):
                if not sub_dir.is_dir():
                    continue
                res = self._score_dir(sub_dir, test_set_path)
                if res is None:
                    return None
                names, vals = res
                mean, std = float(np.mean(vals)), float(np.std(vals))
                if mean > best[0] or best[4] is None:
                    th_cell = float(sub_dir.name.split("_")[0])
                    th_seed = float(sub_dir.name.split("_")[-1])
                    best = (mean, std, th_cell, th_seed, sub_dir.name,
                            names, vals)
            # keep only the best-threshold masks at the top level
            for sub_dir in sorted(prediction_path.iterdir()):
                if not sub_dir.is_dir():
                    continue
                if sub_dir.name == best[4]:
                    for f in sub_dir.glob("*"):
                        shutil.move(str(f), str(prediction_path / f.name))
                shutil.rmtree(sub_dir)
            names, vals = best[5], best[6]
            if names is None:
                # stopped before (or no) prediction dirs were scored
                return None
            version = self._write_scores(prediction_path, names, vals)
            return best[0], best[1], best[2], best[3], version

        res = self._score_dir(prediction_path, test_set_path)
        if res is None or not res[0]:
            return None  # stopped before any prediction was scored
        names, vals = res
        version = self._write_scores(prediction_path, names, vals)
        return float(np.mean(vals)), float(np.std(vals)), -1, -1, version

    # ------------------------------------------------------------------

    def _zip_test_set(self, path_data: Path, out_dir: Path) -> None:
        with zipfile.ZipFile(out_dir / "test_set.zip", "w") as z:
            z.write(path_data, arcname=path_data.stem,
                    compress_type=zipfile.ZIP_DEFLATED)
            z.write(path_data / "test",
                    arcname=os.path.join(path_data.stem, "test"),
                    compress_type=zipfile.ZIP_DEFLATED)
            for f in (path_data / "test").glob("*"):
                z.write(f, arcname=os.path.join(path_data.stem, "test",
                                                f.name),
                        compress_type=zipfile.ZIP_DEFLATED)
