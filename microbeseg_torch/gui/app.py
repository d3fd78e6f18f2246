"""Qt main window: thin interactive shell over the port's headless workers.

Port of ``microbeseg_tpu/gui/app.py``: the same window, its widgets and
shortcuts, on the port's stores, client workers, label generation,
``run_training``, ``Evaluator`` and ``InferenceEngine``.  Every worker
takes the window's ``device`` (default: the CUDA card); the engines are
built inside the job that runs them, on its thread (cuDNN keeps its plans
per thread).  The evaluation CSVs are read with the ``csv`` module.

    python -m microbeseg_torch.gui.app

Without PyQt5 the entry point exits 1 and names the headless CLIs.

Workflow parity with the reference GUI (reference: src/microbe_seg_gui.py):
dataset/trainset selection (:553-), crop creation with accept/reject keys
1/2/3/space/s (:2121-2329, :2687-2811), training pipeline export -> labels ->
train (:2602-2684), evaluation (:1039-1113), inference (:1546-1596), analysis
and result export menus, Ctrl+C job cancellation (:2641), dark palette.

Every long-running job is one of the headless worker functions running on a
QThread; progress/text callbacks are bridged to Qt signals.  The data backend
is an ImageStore (LocalStore directory or OMERO when omero-py is present).
"""

from __future__ import annotations

import csv
import dataclasses
import sys
import threading
from pathlib import Path

_HEADLESS = (
    "PyQt5 is not installed - the GUI is unavailable in this "
    "environment.\nHeadless equivalents:\n"
    "  python -m microbeseg_torch.cli.train --train_dir <trainset>\n"
    "  python -m microbeseg_torch.cli.infer_local -i <imgs> -m <model>\n"
    "  python -m microbeseg_torch.cli.infer_store --local_store <store> "
    "--dataset <id> -m <model>\n"
    "  python -m microbeseg_torch.cli.evaluate -d <trainset> -m <models...>\n"
    "  python -m microbeseg_torch.cli.serve -m <model> --port 8000")

if __name__ == "__main__":
    try:
        import PyQt5  # noqa: F401
    except ImportError:
        print(_HEADLESS)
        sys.exit(1)

from PyQt5.QtCore import QObject, Qt, QThread, pyqtSignal
from PyQt5.QtGui import QColor, QImage, QKeySequence, QPalette, QPixmap
from PyQt5.QtWidgets import (
    QApplication,
    QCheckBox,
    QComboBox,
    QDoubleSpinBox,
    QFileDialog,
    QGridLayout,
    QHBoxLayout,
    QLabel,
    QLineEdit,
    QListWidget,
    QMainWindow,
    QMessageBox,
    QProgressBar,
    QPushButton,
    QShortcut,
    QSpinBox,
    QTextEdit,
    QVBoxLayout,
    QWidget,
)

import numpy as np


class WorkerBridge(QObject):
    """Runs a headless worker callable on a QThread, bridging the callback
    contract (text_output / progress / should_stop) to Qt signals."""

    finished = pyqtSignal(object)
    progress = pyqtSignal(int)
    text_output = pyqtSignal(str)

    def __init__(self, fn, *args, **kwargs):
        super().__init__()
        self._fn = fn
        self._args = args
        self._kwargs = kwargs
        self._stop = threading.Event()

    def stop(self):
        self._stop.set()

    def run(self):
        try:
            result = self._fn(*self._args,
                              text_output=self.text_output.emit,
                              progress=self.progress.emit,
                              should_stop=self._stop.is_set,
                              **self._kwargs)
        except Exception as exc:  # surface errors in the log pane
            self.text_output.emit(f"Error: {exc}")
            result = None
        self.finished.emit(result)


def _np_to_pixmap(arr: np.ndarray) -> QPixmap:
    arr = np.ascontiguousarray(arr)
    if arr.ndim == 2:
        img = QImage(arr.data, arr.shape[1], arr.shape[0], arr.shape[1],
                     QImage.Format_Grayscale8)
    else:
        img = QImage(arr.data, arr.shape[1], arr.shape[0], 3 * arr.shape[1],
                     QImage.Format_RGB888)
    return QPixmap.fromImage(img.copy())


class MicrobeSegMainWindow(QMainWindow):
    def __init__(self, store_root: Path, model_path: Path,
                 training_data_path: Path, eval_results_path: Path,
                 inference_results_path: Path, device=None):
        super().__init__()
        from microbeseg_torch.client.store import LocalStore

        # the torch device every worker runs on (None: the CUDA card)
        self.device = device
        self.store = LocalStore(store_root)
        self.model_path = Path(model_path)
        self.training_data_path = Path(training_data_path)
        self.eval_results_path = Path(eval_results_path)
        self.inference_results_path = Path(inference_results_path)
        self._threads = []
        self._active_bridge = None
        self._crops = []
        self._crop_idx = 0
        self._accepted = set()

        self.setWindowTitle("microbeSEG (PyTorch)")
        self._build_ui()
        self._apply_dark_palette()
        try:
            self.refresh_model_list()
        except Exception:
            pass  # store/model dirs may not exist yet

    # ------------------------------------------------------------------
    def _build_ui(self):
        central = QWidget()
        layout = QGridLayout(central)

        # OMERO connection bar (reference gui:141-148, 927-1004: Username/
        # Password/Host/Port + Connect/Disconnect; LocalStore when offline)
        conn_row = 6
        layout.addWidget(QLabel("Host:"), conn_row, 0)
        self.host_edit = QLineEdit()
        layout.addWidget(self.host_edit, conn_row, 1)
        layout.addWidget(QLabel("Port:"), conn_row, 2)
        self.port_box = QSpinBox()
        self.port_box.setRange(1, 65535)
        self.port_box.setValue(4064)
        layout.addWidget(self.port_box, conn_row, 3)
        layout.addWidget(QLabel("Username:"), conn_row, 4)
        self.username_edit = QLineEdit()
        layout.addWidget(self.username_edit, conn_row, 5)
        layout.addWidget(QLabel("Password:"), conn_row, 6)
        self.password_edit = QLineEdit()
        self.password_edit.setEchoMode(QLineEdit.Password)
        layout.addWidget(self.password_edit, conn_row, 7)
        self.connect_button = QPushButton("Connect")
        self.connect_button.clicked.connect(self.on_connect)
        layout.addWidget(self.connect_button, conn_row + 1, 6)
        self.disconnect_button = QPushButton("Disconnect")
        self.disconnect_button.clicked.connect(self.on_disconnect)
        layout.addWidget(self.disconnect_button, conn_row + 1, 7)
        # group selection (reference 'Change group', gui:1309-1352)
        self.group_button = QPushButton("Change group")
        self.group_button.clicked.connect(self.on_change_group)
        layout.addWidget(self.group_button, conn_row + 2, 6)
        self.group_combo = QComboBox()
        self.group_combo.currentIndexChanged.connect(self.on_group_selected)
        layout.addWidget(self.group_combo, conn_row + 2, 7)

        # project browsing + trainset creation (reference gui:151-207,
        # 1658-1991: Project(s)/Dataset(s) browsing, 'Training set' + Add)
        layout.addWidget(QLabel("Project id:"), conn_row + 1, 0)
        self.project_box = QSpinBox()
        self.project_box.setRange(-1, 10 ** 6)
        self.project_box.setValue(-1)
        layout.addWidget(self.project_box, conn_row + 1, 1)
        self.browse_button = QPushButton("Dataset(s)")
        self.browse_button.clicked.connect(self.on_browse_datasets)
        layout.addWidget(self.browse_button, conn_row + 1, 2)
        self.dataset_combo = QComboBox()
        self.dataset_combo.currentIndexChanged.connect(
            self.on_dataset_selected)
        layout.addWidget(self.dataset_combo, conn_row + 1, 3)
        layout.addWidget(QLabel("New trainset:"), conn_row + 1, 4)
        self.new_trainset_edit = QLineEdit()
        layout.addWidget(self.new_trainset_edit, conn_row + 1, 5)
        self.add_trainset_button = QPushButton("Add")
        self.add_trainset_button.clicked.connect(self.on_add_trainset)
        layout.addWidget(self.add_trainset_button, conn_row + 2, 5)

        # training settings (reference gui:347-370: batch size, iterations,
        # optimizer, method) + device info (reference gui:240-245)
        # one row below the group widgets (conn_row + 2) — sharing that row
        # stacked Overwrite/eval-scope on top of the group button/combo in
        # real Qt (ADVICE r2); fake_qt now asserts one widget per grid cell
        set_row = conn_row + 3
        layout.addWidget(QLabel("Batch size:"), set_row, 0)
        self.batch_size_box = QSpinBox()
        self.batch_size_box.setRange(1, 64)
        self.batch_size_box.setValue(4)
        layout.addWidget(self.batch_size_box, set_row, 1)
        layout.addWidget(QLabel("Iterations:"), set_row, 2)
        self.iterations_box = QSpinBox()
        self.iterations_box.setRange(1, 10)
        self.iterations_box.setValue(1)
        layout.addWidget(self.iterations_box, set_row, 3)
        self.optimizer_combo = QComboBox()
        self.optimizer_combo.addItems(["ranger", "adam"])
        layout.addWidget(self.optimizer_combo, set_row, 4)
        self.method_combo = QComboBox()
        self.method_combo.addItems(["distance", "boundary"])
        layout.addWidget(self.method_combo, set_row + 1, 4)
        self.device_label = QLabel(self._device_info())
        layout.addWidget(self.device_label, set_row + 1, 0, 1, 3)
        # training-only multi-device toggle (reference 'use multiple gpus'
        # checkbox, README.md:53 / get_num_gpus gui:1232-1242; here: train
        # data-parallel on every visible card)
        self.multi_device_checkbox = QCheckBox("Use all devices")
        self.multi_device_checkbox.setChecked(True)
        layout.addWidget(self.multi_device_checkbox, set_row + 1, 3)

        # pre-labeling + crop split override (reference gui:274-288)
        self.prelabel_checkbox = QCheckBox("Pre-labeling")
        layout.addWidget(self.prelabel_checkbox, set_row + 1, 6)
        # overwrite existing inference results (reference inference menu)
        self.overwrite_checkbox = QCheckBox("Overwrite")
        layout.addWidget(self.overwrite_checkbox, set_row, 6)
        # upload results to the store as ROIs (reference upload checkbox,
        # gui:431-432, default checked)
        self.upload_checkbox = QCheckBox("Upload")
        self.upload_checkbox.setChecked(True)
        layout.addWidget(self.upload_checkbox, set_row, 5)
        # evaluation scope (reference eval menu model list with select-all /
        # per-model selection, gui:1039-1121)
        self.eval_scope_combo = QComboBox()
        self.eval_scope_combo.addItems(["all models", "selected models"])
        layout.addWidget(self.eval_scope_combo, set_row, 7)
        layout.addWidget(QLabel("Add to:"), set_row + 1, 5)
        self.split_combo = QComboBox()
        self.split_combo.addItems(["auto", "train", "val", "test"])
        layout.addWidget(self.split_combo, set_row + 1, 7)

        # dataset / trainset selection
        layout.addWidget(QLabel("Dataset id:"), 0, 0)
        self.dataset_box = QSpinBox()
        self.dataset_box.setRange(1, 10 ** 6)
        layout.addWidget(self.dataset_box, 0, 1)
        layout.addWidget(QLabel("Trainset id:"), 0, 2)
        self.trainset_box = QSpinBox()
        self.trainset_box.setRange(1, 10 ** 6)
        layout.addWidget(self.trainset_box, 0, 3)
        layout.addWidget(QLabel("Crop size:"), 0, 4)
        self.crop_size_box = QComboBox()
        # reference crop sizes (gui:208-211)
        self.crop_size_box.addItems(["256", "320", "128", "512", "768",
                                     "1024"])
        layout.addWidget(self.crop_size_box, 0, 5)
        # channel selection (reference settings area, microbe_seg_gui.py)
        layout.addWidget(QLabel("Channel:"), 0, 6)
        self.channel_box = QSpinBox()
        self.channel_box.setRange(0, 16)
        layout.addWidget(self.channel_box, 0, 7)

        # trained-model selection with AJI+ scores
        # (reference get_trained_models, microbe_seg_gui.py:1273-1299)
        layout.addWidget(QLabel("Model:"), 1, 4)
        self.model_box = QComboBox()
        self.model_box.currentIndexChanged.connect(self.on_model_selected)
        layout.addWidget(self.model_box, 1, 5, 1, 3)

        # named project browsing (reference project-selection dialogs list
        # projects BY NAME, gui:1658-1797)
        self.projects_button = QPushButton("Project(s)")
        self.projects_button.clicked.connect(self.on_browse_projects)
        layout.addWidget(self.projects_button, 2, 4)
        self.project_combo = QComboBox()
        self.project_combo.currentIndexChanged.connect(
            self.on_project_selected)
        layout.addWidget(self.project_combo, 2, 5)

        # inference settings (reference: per-model best eval thresholds or
        # the [0.10, 0.45] defaults, gui:1438-1445; sliding-window checkbox
        # gui:434 — hidden there because unimplemented, functional here;
        # CLAHE/scale from the inference pre-processing transforms,
        # inference_dataset.py:43-140)
        layout.addWidget(QLabel("th_cell:"), 2, 6)
        self.th_cell_box = QDoubleSpinBox()
        self.th_cell_box.setRange(0.0, 1.0)
        self.th_cell_box.setSingleStep(0.005)
        self.th_cell_box.setDecimals(3)
        self.th_cell_box.setValue(0.10)
        layout.addWidget(self.th_cell_box, 2, 7)
        layout.addWidget(QLabel("th_seed:"), 3, 3)
        self.th_seed_box = QDoubleSpinBox()
        self.th_seed_box.setRange(0.0, 1.0)
        self.th_seed_box.setSingleStep(0.005)
        self.th_seed_box.setDecimals(3)
        self.th_seed_box.setValue(0.45)
        layout.addWidget(self.th_seed_box, 3, 4)
        self.sliding_checkbox = QCheckBox("Sliding window")
        layout.addWidget(self.sliding_checkbox, 3, 5)
        self.clahe_checkbox = QCheckBox("CLAHE")
        layout.addWidget(self.clahe_checkbox, 3, 6)
        self.scale_box = QDoubleSpinBox()
        self.scale_box.setRange(0.1, 1.0)
        self.scale_box.setSingleStep(0.05)
        self.scale_box.setDecimals(2)
        self.scale_box.setValue(1.0)
        self.scale_box.setToolTip("Inference scale factor (downscale "
                                  "before the forward pass)")
        layout.addWidget(self.scale_box, 3, 7)

        # extended evaluation seed grid: touching rod chains separate at
        # higher th_seed than the reference grid's 0.45 cap (eval.py:128)
        # covers — measured +0.10 AJI+ on rod/chain morphology
        # (docs/E2E_RESULTS.md "Rod gap root-caused"); the best grid point
        # then prefills the inference thresholds via the aggregated csv
        self.eval_grid_checkbox = QCheckBox("Extended seed grid (rods)")
        self.eval_grid_checkbox.setToolTip(
            "Evaluate th_seed up to 0.75 (reference grid stops at 0.45); "
            "recommended for rod-shaped cells in touching chains")
        layout.addWidget(self.eval_grid_checkbox, conn_row + 2, 0, 1, 3)

        # test-time augmentation (beyond reference, InferConfig.tta):
        # dihedral-averaged predictions in inference and evaluation
        self.tta_checkbox = QCheckBox("TTA")
        self.tta_checkbox.setToolTip(
            "Test-time augmentation: average predictions over the dihedral "
            "transforms (4-8x forward cost, small quality gain)")
        layout.addWidget(self.tta_checkbox, conn_row + 2, 3)

        # ensemble evaluation (beyond reference, EvalConfig.ensemble):
        # all evaluated models fold into ONE averaged model/row
        self.ensemble_checkbox = QCheckBox("Ensemble")
        self.ensemble_checkbox.setToolTip(
            "Evaluate the selected models as ONE averaged ensemble "
            "(one result row) instead of one row per model")
        layout.addWidget(self.ensemble_checkbox, conn_row + 2, 4)

        # per-model evaluation multi-select (reference eval model list,
        # gui:1039-1121)
        self.eval_model_list = QListWidget()
        self.eval_model_list.setSelectionMode(QListWidget.ExtendedSelection)
        layout.addWidget(self.eval_model_list, 4, 6, 2, 2)

        # workflow buttons
        buttons = [
            ("Import data", self.on_import),
            ("Create crops", self.on_create_crops),
            # lambda, not the bare method: QPushButton.clicked emits a
            # bool that would land in `mode` and break the deep-link branch
            ("Annotate", lambda: self.on_annotate()),
            ("Export trainset", self.on_export),
            ("Train", self.on_train),
            ("Evaluate", self.on_evaluate),
            ("Inference", self.on_inference),
            ("Analysis", self.on_analysis),
            ("Export results", self.on_result_export),
            ("Correct", lambda: self.on_annotate(mode="correct")),
            ("Stop (Ctrl+C)", self.on_stop),
        ]
        self.buttons = {}
        row = 1
        for i, (name, cb) in enumerate(buttons):
            btn = QPushButton(name)
            btn.clicked.connect(cb)
            self.buttons[name] = btn
            layout.addWidget(btn, row + i // 4, i % 4)

        # crop review pane
        # the 10 workflow buttons occupy rows 1-3 (4 per row, cols 0-3);
        # the preview/log panes start below them at row 4
        self.crop_label = QLabel("crop preview")
        self.crop_label.setMinimumSize(320, 320)
        self.crop_label.setAlignment(Qt.AlignCenter)
        layout.addWidget(self.crop_label, 4, 0, 2, 4)

        # log + progress
        self.log = QTextEdit()
        self.log.setReadOnly(True)
        layout.addWidget(self.log, 4, 4, 1, 2)
        self.progress_bar = QProgressBar()
        layout.addWidget(self.progress_bar, 5, 4, 1, 2)

        self.setCentralWidget(central)
        self.statusBar().showMessage("Ready")

        # shortcuts (reference: Ctrl+C stop, 1/2/3/space/s crop keys, F1)
        QShortcut(QKeySequence("Ctrl+C"), self, activated=self.on_stop)
        QShortcut(QKeySequence("1"), self, activated=lambda: self.accept_crop(0))
        QShortcut(QKeySequence("2"), self, activated=lambda: self.accept_crop(1))
        QShortcut(QKeySequence("3"), self, activated=lambda: self.accept_crop(2))
        QShortcut(QKeySequence(Qt.Key_Space), self, activated=self.skip_crop)
        QShortcut(QKeySequence("S"), self, activated=self.skip_crop)
        QShortcut(QKeySequence("F1"), self, activated=self.show_help)

    def _device_info(self) -> str:
        """Compute-device summary (reference device settings, gui:240-245):
        the torch device the workers run on and the CUDA device count."""
        try:
            import torch

            from microbeseg_torch.utils.device import resolve_device
            return (f"Device: {resolve_device(self.device)} "
                    f"({torch.cuda.device_count()} CUDA device(s))")
        except Exception:
            return "Device: unavailable"

    # ------------------------------------------------------------------
    # OMERO connection + browsing (reference gui:927-1004, 1645-1991)
    # ------------------------------------------------------------------
    def on_connect(self):
        from microbeseg_torch.client.store import OmeroStore

        host = self.host_edit.text().strip()
        if not host:
            self.log.append("No host given — staying on the local store.")
            return
        try:
            store = OmeroStore(self.username_edit.text(),
                               self.password_edit.text(),
                               host, int(self.port_box.value()))
        except Exception as exc:
            QMessageBox.information(self, "Connection failed", str(exc))
            return
        if getattr(self, "_local_store", None) is not None:
            # already connected: close the old gateway, keep the ORIGINAL
            # local store as the disconnect fallback
            try:
                self.store.close()
            except Exception:
                pass
        else:
            self._local_store = self.store
        self.store = store
        self.log.append(f"Connected to {host}.")

    def on_disconnect(self):
        local = getattr(self, "_local_store", None)
        if local is None:
            self.log.append("Not connected.")
            return
        try:
            self.store.close()
        except Exception:
            pass
        self.store = local
        self._local_store = None
        self.log.append("Disconnected — back on the local store.")

    def on_change_group(self):
        """List the user's permission groups (reference gui:1309-1352)."""
        try:
            groups = self.store.list_groups()
        except Exception as exc:
            self.log.append(f"Error: {exc}")
            return
        self._groups = groups
        self.group_combo.clear()
        self.group_combo.addItems([f"{name} ({gid})" for gid, name in groups])
        if groups:
            self.group_combo.setCurrentIndex(0)

    def on_group_selected(self, idx: int):
        groups = getattr(self, "_groups", [])
        if 0 <= idx < len(groups):
            gid, name = groups[idx]
            try:
                self.store.set_group(gid)
            except Exception as exc:
                self.log.append(f"Error: {exc}")
                return
            # group change invalidates the browsing scope (reference
            # gui:1330-1349 clears all selection lists)
            self.dataset_combo.clear()
            self._dataset_ids = []
            self.log.append(f"Switched to group '{name}' ({gid}).")

    def on_browse_datasets(self):
        """Populate the dataset list for the selected project (reference
        project/dataset browsing dialogs, gui:1658-1797)."""
        try:
            ids = self.store.list_datasets(int(self.project_box.value()))
        except Exception as exc:
            self.log.append(f"Error: {exc}")
            return
        self._dataset_ids = ids
        self.dataset_combo.clear()
        self.dataset_combo.addItems(
            [f"{i}: {self.store.dataset_name(i)}" for i in ids])
        if ids:
            self.dataset_combo.setCurrentIndex(0)
            self.on_dataset_selected(0)
        else:
            self.log.append("No datasets in this project.")

    def on_dataset_selected(self, idx: int):
        ids = getattr(self, "_dataset_ids", [])
        if 0 <= idx < len(ids):
            self.dataset_box.setValue(ids[idx])
            self.trainset_box.setValue(ids[idx])

    def on_browse_projects(self):
        """List the store's projects by name (reference selection dialogs,
        gui:1658-1797); picking one scopes dataset browsing to it."""
        try:
            projects = self.store.list_projects()
        except Exception as exc:
            self.log.append(f"Error: {exc}")
            return
        self._projects = projects
        self.project_combo.clear()
        self.project_combo.addItems(
            [f"{pid}: {name}" for pid, name in projects])
        if projects:
            self.project_combo.setCurrentIndex(0)
        else:
            self.log.append("No projects found.")

    def on_project_selected(self, idx: int):
        projects = getattr(self, "_projects", [])
        if 0 <= idx < len(projects):
            self.project_box.setValue(projects[idx][0])

    def on_add_trainset(self):
        """Create a new trainset dataset (reference 'Training set' + Add,
        gui:1879-1991)."""
        name = self.new_trainset_edit.text().strip()
        if not name:
            self.log.append("Give the new trainset a name first.")
            return
        try:
            new_id = self.store.create_dataset(
                name, project_id=int(self.project_box.value()))
            # crop_size rides the trainset as a map annotation so every
            # later crop session uses the size the set was created with
            # (reference gui:1976-1981)
            self.store.set_dataset_map_annotation(
                new_id, {"crop_size": self.crop_size_box.currentText()})
        except Exception as exc:
            self.log.append(f"Error: {exc}")
            return
        self.trainset_box.setValue(new_id)
        self.log.append(f"Created trainset '{name}' (id {new_id}).")

    def _apply_dark_palette(self):
        palette = QPalette()
        palette.setColor(QPalette.Window, QColor(53, 53, 53))
        palette.setColor(QPalette.WindowText, Qt.white)
        palette.setColor(QPalette.Base, QColor(35, 35, 35))
        palette.setColor(QPalette.Text, Qt.white)
        palette.setColor(QPalette.Button, QColor(53, 53, 53))
        palette.setColor(QPalette.ButtonText, Qt.white)
        palette.setColor(QPalette.Highlight, QColor(42, 130, 218))
        QApplication.instance().setPalette(palette)

    # ------------------------------------------------------------------
    def _run_worker(self, fn, *args, on_done=None, **kwargs):
        if self._active_bridge is not None:
            QMessageBox.information(self, "Busy", "A job is already running.")
            return
        bridge = WorkerBridge(fn, *args, **kwargs)
        thread = QThread()
        bridge.moveToThread(thread)
        bridge.text_output.connect(self.log.append)
        bridge.progress.connect(self.progress_bar.setValue)
        bridge._on_done = on_done
        bridge._thread = thread
        # completion MUST land on the GUI thread: connecting a bound method
        # of this QMainWindow gives a queued cross-thread connection, while
        # a plain closure slot would execute in the worker thread and touch
        # widgets from there (intermittent crashes in real Qt)
        bridge.finished.connect(self._worker_finished)
        thread.started.connect(bridge.run)
        self._threads.append((thread, bridge))
        self._active_bridge = bridge
        self.statusBar().showMessage("Busy")
        thread.start()

    def _worker_finished(self, result):
        """GUI-thread completion slot for every WorkerBridge."""
        bridge = self._active_bridge
        self.statusBar().showMessage("Ready")
        self._active_bridge = None
        if bridge is None:
            return
        bridge._thread.quit()
        bridge._thread.wait()
        # prune finished jobs so long sessions do not accumulate one
        # QThread + bridge (plus captured args) per job
        self._threads = [(t, b) for t, b in self._threads if b is not bridge]
        if bridge._on_done:
            bridge._on_done(result)

    def closeEvent(self, event):  # noqa: N802 (Qt naming)
        """Stop any running job and wait its thread out before the window
        dies — destroying a live QThread aborts the process in real Qt."""
        if self._active_bridge is not None:
            self._active_bridge.stop()
        for thread, _ in self._threads:
            thread.quit()
            thread.wait()
        self._threads = []
        parent_close = getattr(super(), "closeEvent", None)
        if parent_close is not None:  # absent on the headless fake
            parent_close(event)

    def on_stop(self):
        if self._active_bridge is not None:
            self._active_bridge.stop()
            self.log.append("Stop requested.")

    def show_help(self):
        QMessageBox.information(
            self, "Help",
            "1/2/3: accept crop · space/s: skip · Ctrl+C: stop job\n"
            "Workflows match hip-satomi/microbeSEG; see docs/PARITY.md")

    # ------------------------------------------------------------------
    # model listing (reference get_trained_models, gui:1273-1299)
    # ------------------------------------------------------------------
    def get_trained_models(self):
        """(label, ckpt_path) per trained model; AJI+ appended when the
        aggregated evaluation csv has a score for it."""
        trainset = self.store.dataset_name(int(self.trainset_box.value()))
        scores = {}
        agg = self.eval_results_path / f"{trainset}.csv"
        if agg.is_file():
            for row in _csv_rows(agg):
                # model column format: "{trainset}: {run_name}"
                name = str(row["model"]).split(": ")[-1]
                scores[name] = float(row["aji+ (mean)"])
        out = []
        for ckpt in sorted((self.model_path / trainset).glob("*.ckpt")):
            label = ckpt.stem
            if ckpt.stem in scores:
                label += f"  (AJI+ {scores[ckpt.stem]:.3f})"
            out.append((label, ckpt))
        return out

    def refresh_model_list(self):
        self._models = self.get_trained_models()
        self.model_box.clear()
        self.model_box.addItems([label for label, _ in self._models])
        # the eval menu offers the same models as a multi-select list
        # (reference gui:1039-1121)
        self.eval_model_list.clear()
        self.eval_model_list.addItems([label for label, _ in self._models])

    def _selected_model(self):
        models = getattr(self, "_models", None) or self.get_trained_models()
        if not models:
            return None
        idx = max(self.model_box.currentIndex(), 0)
        return models[min(idx, len(models) - 1)][1]

    def on_model_selected(self, idx: int):
        """Prefill th_cell/th_seed with the model's best evaluation
        thresholds from the aggregated csv, else the [0.10, 0.45] defaults
        (reference gui:1438-1445)."""
        ckpt = self._selected_model()
        th_cell, th_seed = 0.10, 0.45
        if ckpt is not None:
            try:
                trainset = self.store.dataset_name(
                    int(self.trainset_box.value()))
                agg = self.eval_results_path / f"{trainset}.csv"
                if agg.is_file():
                    rows = [r for r in _csv_rows(agg)
                            if str(r["model"]).endswith(f": {ckpt.stem}")]
                    if rows:
                        th_cell = float(rows[0]["th_cell"])
                        th_seed = float(rows[0]["th_seed"])
            except Exception:
                pass
        self.th_cell_box.setValue(th_cell)
        self.th_seed_box.setValue(th_seed)

    # ------------------------------------------------------------------
    # workflows
    # ------------------------------------------------------------------
    def on_import(self):
        """Import local img/mask pairs into the trainset (reference
        DataImportWorker + GUI import menu)."""
        from microbeseg_torch.client.workers import import_data

        files, _ = QFileDialog.getOpenFileNames(
            self, "Select images (mask_* files are paired automatically)")
        if not files:
            return
        img_paths = [Path(f) for f in files
                     if not Path(f).name.startswith("mask")]
        mask_paths = []
        for p in img_paths:
            cand = p.parent / p.name.replace("img", "mask")
            mask_paths.append(cand if cand.is_file() and cand != p else None)

        def job(text_output, progress, should_stop):
            return import_data(self.store, int(self.trainset_box.value()),
                               img_paths, mask_paths,
                               crop_size=int(self.crop_size_box.currentText()),
                               text_output=text_output, progress=progress)

        self._run_worker(job)

    def on_annotate(self, mode: str = "annotate"):
        """Open the external annotation tool deep-linked to the trainset
        ('annotate') or the dashboard ('correct'); reference
        open_annotation_tool, gui:1993-2004."""
        import json
        import urllib.parse
        import webbrowser

        settings_path = Path.cwd() / "settings.json"
        url = ""
        if settings_path.is_file():
            url = json.loads(settings_path.read_text()).get(
                "annotation_tool_url", "")
        if not url:
            self.log.append("No annotation_tool_url in settings.json")
            return
        if not url.endswith("/"):
            url += "/"
        user = self.username_edit.text()
        if mode == "annotate":
            url = (f"{url}login?u={user}&p=&r=/omero-dataset;"
                   f"dataset={int(self.trainset_box.value())}")
        else:
            url = (f"{url}login?u={user}&p=&r="
                   + urllib.parse.quote("omero-dashboard"))
        webbrowser.open(url)

    def on_export(self):
        from microbeseg_torch.client.workers import export_trainset
        # trainset crops are stored single-channel (the channel selection
        # happened at crop creation), so export always reads channel 0
        self._run_worker(export_trainset, self.store,
                         int(self.trainset_box.value()),
                         self.training_data_path)

    def on_train(self):
        from microbeseg_torch.training.workers import create_labels, run_training

        trainset = self.store.dataset_name(int(self.trainset_box.value()))
        path_data = self.training_data_path / trainset
        models = self.model_path / trainset
        models.mkdir(parents=True, exist_ok=True)
        # training settings from the settings area (reference gui:347-370)
        method = self.method_combo.currentText()
        optimizer = self.optimizer_combo.currentText()
        iterations = int(self.iterations_box.value())
        batch_size = int(self.batch_size_box.value())
        # reference: multi-GPU is a training-only toggle (README.md:53);
        # unchecked = single device, like the reference's num_gpus=1
        num_devices = None if self.multi_device_checkbox.isChecked() else 1
        device = self.device

        def pipeline(text_output, progress, should_stop):
            if not create_labels(path_data, method,
                                 text_output=text_output,
                                 progress=progress, should_stop=should_stop,
                                 device=device):
                return False
            return run_training(path_data, models, method, iterations,
                                optimizer, batch_size,
                                num_devices=num_devices,
                                text_output=text_output,
                                progress=progress, should_stop=should_stop,
                                device=device)

        self._run_worker(pipeline)

    def on_evaluate(self):
        """Export the test set from the store, THEN evaluate — one chained
        job, like the reference's eval button wiring (gui:1062-1092 starts
        the eval thread from export_thread.finished)."""
        from microbeseg_torch.client.workers import export_trainset
        from microbeseg_torch.config import EvalConfig
        from microbeseg_torch.evaluation.evaluator import Evaluator

        ecfg = EvalConfig(tta=self.tta_checkbox.isChecked(),
                          ensemble=self.ensemble_checkbox.isChecked())
        if self.eval_grid_checkbox.isChecked():
            ecfg = dataclasses.replace(
                ecfg, th_seeds=(0.35, 0.45, 0.55, 0.65, 0.75))
        trainset = self.store.dataset_name(int(self.trainset_box.value()))
        if self.eval_scope_combo.currentText() == "selected models":
            selected = {it.text()
                        for it in self.eval_model_list.selectedItems()}
            models = [ckpt for label, ckpt in
                      getattr(self, "_models", []) if label in selected]
            if not models:
                self.log.append("Select at least one model for evaluation!")
                return
        else:
            models = sorted((self.model_path / trainset).glob("*.ckpt"))
        if not models:
            self.log.append("No models found.")
            return
        trainset_id = int(self.trainset_box.value())

        def job(text_output, progress, should_stop):
            export_trainset(self.store, trainset_id, self.training_data_path,
                            text_output=text_output, progress=progress,
                            should_stop=should_stop)
            if should_stop():
                return None
            ev = Evaluator(cfg=ecfg, text_output=text_output, progress=progress,
                           should_stop=should_stop, device=self.device)
            return ev.evaluate(self.training_data_path / trainset,
                               self.eval_results_path / trainset, models)

        self._run_worker(job, on_done=lambda _: self.refresh_model_list())

    def _infer_config(self):
        """InferConfig from the settings widgets (thresholds, sliding
        window, CLAHE, scale factor)."""
        from microbeseg_torch.config import InferConfig

        return InferConfig(
            th_cell=float(self.th_cell_box.value()),
            th_seed=float(self.th_seed_box.value()),
            apply_clahe=self.clahe_checkbox.isChecked(),
            scale_factor=float(self.scale_box.value()),
            use_tiling=self.sliding_checkbox.isChecked(),
            tta=self.tta_checkbox.isChecked())

    def on_inference(self):
        from microbeseg_torch.client.workers import infer_dataset
        from microbeseg_torch.inference.engine import InferenceEngine

        ckpt = self._selected_model()
        if ckpt is None:
            self.log.append("No models found.")
            return
        cfg = self._infer_config()
        ids = [r.image_id for r in
               self.store.list_images(int(self.dataset_box.value()))]

        def job(text_output, progress, should_stop):
            # built on the thread that runs it: cuDNN keeps its plans per
            # thread
            engine = InferenceEngine.from_checkpoint(ckpt, cfg=cfg,
                                                     device=self.device)
            return infer_dataset(self.store, ids, engine,
                                 model_name=ckpt.stem,
                                 upload=self.upload_checkbox.isChecked(),
                                 overwrite=self.overwrite_checkbox.isChecked(),
                                 result_dir=self.inference_results_path,
                                 channel=int(self.channel_box.value()),
                                 text_output=text_output, progress=progress,
                                 should_stop=should_stop)

        self._run_worker(job)

    def on_analysis(self):
        from microbeseg_torch.client.workers import analyze_dataset
        ids = [r.image_id for r in
               self.store.list_images(int(self.dataset_box.value()))]

        def job(text_output, progress, should_stop):
            return analyze_dataset(self.store, ids,
                                   self.inference_results_path,
                                   text_output=text_output,
                                   progress=progress, device=self.device)

        self._run_worker(job)

    def on_result_export(self):
        from microbeseg_torch.client.workers import export_results
        ids = [r.image_id for r in
               self.store.list_images(int(self.dataset_box.value()))]

        def job(text_output, progress, should_stop):
            return export_results(self.store, ids,
                                  self.inference_results_path,
                                  channel=int(self.channel_box.value()),
                                  text_output=text_output, progress=progress)

        self._run_worker(job)

    # ------------------------------------------------------------------
    # interactive crop creation (reference :2121-2329)
    # ------------------------------------------------------------------
    def on_create_crops(self):
        from microbeseg_torch.client.workers import CropGenerator

        self._prelabel_ckpt = None
        if self.prelabel_checkbox.isChecked():
            # pre-labeling with the selected model (reference gui:274-276,
            # 2006-2031); the engine is built by the first crop job
            ckpt = self._selected_model()
            if ckpt is None:
                self.log.append("Pre-labeling: no model available.")
            else:
                self._prelabel_ckpt = ckpt
                self.log.append(f"Pre-labeling with {ckpt.stem}.")
        trainset_id = int(self.trainset_box.value())
        # crop size comes from the trainset's map annotation (reference
        # gui:2172-2185); the combo box is only the fallback for trainsets
        # created outside this GUI
        try:
            meta = self.store.get_dataset_map_annotation(trainset_id)
        except Exception:
            meta = {}
        if meta.get("crop_size"):
            crop_size = int(meta["crop_size"])
        else:
            crop_size = int(self.crop_size_box.currentText())
            self.log.append("No crop_size annotation on the trainset — "
                            f"using {crop_size} from the selector.")
        # split_info (used-frame dedup + split counters) persists on the
        # trainset across sessions (reference gui:2188-2206)
        self._crop_gen = CropGenerator(
            self.store, crop_size=crop_size, engine=None,
            channel=int(self.channel_box.value()), trainset_id=trainset_id)
        self._crop_items = self._crop_gen.crop_list(
            int(self.dataset_box.value()))
        if not self._crop_items:
            self.log.append("No frames available for cropping.")
            return
        self._next_crop_set()

    def _next_crop_set(self):
        """Produce the next 1-3 crop proposals on the worker thread: plane
        downloads and pre-label inference must not block the event loop
        (the reference runs its DataCropWorker on a QThread the same way,
        gui:2121-2329)."""
        self._accepted = set()
        self._crops = []
        if not self._crop_items:
            self.log.append("Crop creation finished.")
            return
        items, gen = self._crop_items, self._crop_gen
        ckpt = getattr(self, "_prelabel_ckpt", None)

        def produce(text_output, progress, should_stop):
            if ckpt is not None and gen.engine is None:
                from microbeseg_torch.inference.engine import InferenceEngine
                gen.engine = InferenceEngine.from_checkpoint(
                    ckpt, device=self.device)
            while items and not should_stop():
                image_id, frame = items.pop()
                crops = gen.next_crops(image_id, frame)
                if crops:
                    return crops
            return []

        self._run_worker(produce, on_done=self._crop_set_ready)

    def _crop_set_ready(self, crops):
        self._crops = crops or []
        if not self._crops:
            self.log.append("Crop creation finished.")
            return
        self._crop_idx = 0
        self._show_crop()

    def _show_crop(self):
        if not self._crops:
            return
        crop = self._crops[self._crop_idx]
        disp = crop.overlay if crop.overlay is not None else crop.display
        self.crop_label.setPixmap(_np_to_pixmap(disp))
        self.statusBar().showMessage(
            f"Crop {self._crop_idx + 1}/{len(self._crops)} — "
            "1/2/3 accept, space/s skip")

    def accept_crop(self, idx: int):
        """Accept ONE of the proposed crops and stay on the set — the
        reference's three accept-checkboxes allow any subset of the 1-3
        crops (gui:2687-2725); keys 1/2/3 accept crop 1/2/3, space moves
        on.  The set advances automatically once every crop is taken."""
        from microbeseg_torch.client.workers import split_assignment
        if not self._crops or idx >= len(self._crops):
            return
        # 'Add to:' override (reference train/val/test checkboxes,
        # gui:283-288); 'auto' follows the reference's persisted
        # accepted-crop counter (gui:2707: split_assignment(num_acc))
        if idx in self._accepted:
            return  # keys 1/2/3 keep their original crop positions
        override = self.split_combo.currentText()
        subset = (override if override != "auto"
                  else split_assignment(self._crop_gen.split_info["num_acc"]))
        self._crop_gen.upload_crop(self._crops[idx],
                                   int(self.trainset_box.value()), subset)
        self._accepted.add(idx)
        self.log.append(f"Crop accepted -> {subset}")
        if len(self._accepted) == len(self._crops):
            self._next_crop_set()
            return
        self._crop_idx = next(i for i in range(len(self._crops))
                              if i not in self._accepted)
        self._show_crop()

    def skip_crop(self):
        """Advance within the crop set; skipping past the last crop moves
        to the next frame (the frame lands in split_info['used'] either via
        an accepted crop or, when nothing was accepted, as a denied frame —
        reference gui:2196, so it is never offered again)."""
        if not self._crops:
            return
        if self._crop_idx + 1 < len(self._crops):
            self._crop_idx += 1
            self._show_crop()
            return
        crop = self._crops[0]
        self._crop_gen.mark_skipped(crop.image_id, crop.frame)
        self.log.append("Frame done.")
        self._next_crop_set()


def _csv_rows(path: Path):
    """The rows of an evaluation CSV as dicts (the evaluator's ``_Table``
    writes them as pandas does)."""
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def run_gui(store_root: Path = Path("./store"),
            model_path: Path = Path("./models"),
            training_data_path: Path = Path("./training_dataset"),
            eval_results_path: Path = Path("./evaluation"),
            inference_results_path: Path = Path("./results"),
            device=None) -> int:
    app = QApplication(sys.argv)
    app.setStyle("Fusion")
    win = MicrobeSegMainWindow(store_root, model_path, training_data_path,
                               eval_results_path, inference_results_path,
                               device=device)
    win.resize(1100, 700)
    win.show()
    return app.exec_()


if __name__ == "__main__":
    sys.exit(run_gui())
