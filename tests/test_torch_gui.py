"""The port's GUI on the fake Qt layer (mirrors ``tests/test_gui.py``).

The real ``microbeseg_torch.gui.app`` runs on ``tests/fake_qt.py`` with
``device="cpu"``: the widget tree, the worker bridge (QThread runs inline
in the fake), the crop-review keys, the busy guard, the model list with
AJI+ read through ``csv``, the multi-device checkbox, OMERO on the fake
gateway, and an inference round trip.  Then the port's window against
JAX's on copies of one ``LocalStore``: equal store writes for crop review
and export, and for inference from one checkpoint masks at the engine
tests' IoU >= 0.99.  Last, the entry point without PyQt5.
"""

import importlib
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tests import fake_qt
from tests.test_torch_engine import checkpoint  # noqa: F401


REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _fresh_app(package):
    fake_qt.install()
    for mod in (f"{package}.gui.app", f"{package}.gui"):
        sys.modules.pop(mod, None)
    app = importlib.import_module(f"{package}.gui.app")
    importlib.reload(app)
    return app


@pytest.fixture
def gui_app():
    return _fresh_app("microbeseg_torch")


def _window(app, tmp_path, rng, with_data=True):
    from microbeseg_torch.client.store import LocalStore
    from microbeseg_torch.client.workers import import_data
    from microbeseg_torch.utils.tiff import imwrite
    from tests.conftest import synthetic_blobs

    store_root = tmp_path / "store"
    store = LocalStore(store_root)
    exp_id = store.create_dataset("experiment")
    trainset_id = store.create_dataset("trainset64")
    if with_data:
        stack = rng.integers(0, 65535, (6, 96, 96)).astype(np.uint16)
        store.upload_image(exp_id, "movie.tif", stack)
        src = tmp_path / "src"
        src.mkdir()
        imgs, masks = [], []
        for i in range(4):
            m = synthetic_blobs(rng, shape=(64, 64), n_blobs=3)
            img = ((m > 0) * 30000 + 2000).astype(np.uint16)
            imwrite(src / f"img{i}.tif", img)
            imwrite(src / f"mask{i}.tif", m)
            imgs.append(src / f"img{i}.tif")
            masks.append(src / f"mask{i}.tif")
        import_data(store, trainset_id, imgs, masks, crop_size=64, seed=3)

    fake_qt.QApplication([])
    win = app.MicrobeSegMainWindow(
        store_root, tmp_path / "models", tmp_path / "training_dataset",
        tmp_path / "evaluation", tmp_path / "results", device="cpu")
    win.dataset_box.setValue(exp_id)
    win.trainset_box.setValue(trainset_id)
    return win, store, exp_id, trainset_id


class TestGuiSmoke:
    def test_build_ui_and_shortcuts(self, gui_app, tmp_path, rng):
        win, *_ = _window(gui_app, tmp_path, rng, with_data=False)
        assert len(win.buttons) == 11  # incl. 'Correct' (annotation tool)
        assert win.statusBar().currentMessage() == "Ready"
        # reference shortcut set: Ctrl+C, 1/2/3, space, s, F1
        seqs = {s.seq for s in fake_qt.QShortcut.registry}
        assert {"Ctrl+C", "1", "2", "3", "S", "F1"} <= seqs
        fake_qt.QShortcut.trigger("F1")
        assert fake_qt.QMessageBox.shown  # help dialog

    def test_export_worker_roundtrip(self, gui_app, tmp_path, rng):
        win, store, _, tid = _window(gui_app, tmp_path, rng)
        win.buttons["Export trainset"].click()  # runs inline on the fake
        assert win.statusBar().currentMessage() == "Ready"
        assert win.progress_bar.value() == 100
        root = tmp_path / "training_dataset" / "trainset64"
        assert len(list(root.glob("*/img_*.tif"))) == 4
        assert len(list(root.glob("*/mask_*.tif"))) == 4

    def test_crop_review_flow(self, gui_app, tmp_path, rng):
        win, store, eid, tid = _window(gui_app, tmp_path, rng)
        win.crop_size_box.setCurrentIndex(2)  # 128 -> fits the 96px movie? no
        win.crop_size_box._items = ["64"]
        win.crop_size_box._idx = 0
        before = len(store.list_images(tid))
        win.buttons["Create crops"].click()
        assert win.crop_label._pixmap is not None  # preview rendered
        fake_qt.QShortcut.trigger("1")  # accept first crop
        assert "Crop accepted -> train" in win.log.toPlainText()
        assert len(store.list_images(tid)) == before + 1

    def test_crop_size_annotation_round_trip(self, gui_app, tmp_path, rng):
        """'Add' stores crop_size on the new trainset (reference
        gui:1976-1981); crop creation reads it back (:2172-2185), ignoring
        the combo box."""
        win, store, eid, tid = _window(gui_app, tmp_path, rng)
        win.new_trainset_edit.setText("ts2")
        win.crop_size_box._items = ["64"]
        win.crop_size_box._idx = 0
        win.add_trainset_button.click()
        new_id = int(win.trainset_box.value())
        assert store.get_dataset_map_annotation(new_id)["crop_size"] == "64"
        # read-back: combo now says something else; annotation wins
        win.crop_size_box._items = ["320"]
        win.crop_size_box._idx = 0
        win.buttons["Create crops"].click()
        assert win._crop_gen.crop_size == 64

    def test_skip_denies_frame_and_session_restart_dedups(
            self, gui_app, tmp_path, rng):
        """Skipping past the last crop records the frame in the persisted
        split_info (reference keeps denied frames in 'used', gui:2196);
        a rebuilt window does not offer used frames again."""
        win, store, eid, tid = _window(gui_app, tmp_path, rng)
        store.set_dataset_map_annotation(tid, {"crop_size": "64"})
        win.buttons["Create crops"].click()
        n_frames = len(win._crop_items) + 1
        fake_qt.QShortcut.trigger("1")  # accept (frame 1 used)
        fake_qt.QShortcut.trigger("S")  # deny frame 2
        assert "Frame done." in win.log.toPlainText()

        win2, *_ = _window(gui_app, tmp_path, rng, with_data=False)
        win2.store = store
        win2.dataset_box.setValue(eid)
        win2.trainset_box.setValue(tid)
        win2.buttons["Create crops"].click()
        assert win2._crop_gen.split_info["num_acc"] == 1
        assert len(win2._crop_items) + 1 == n_frames - 2

    def test_split_counter_continues_reference_pattern(
            self, gui_app, tmp_path, rng):
        """'auto' split follows split_assignment(num_acc) (reference
        gui:2707): third accepted crop -> val."""
        win, store, eid, tid = _window(gui_app, tmp_path, rng)
        store.set_dataset_map_annotation(tid, {"crop_size": "64"})
        win.buttons["Create crops"].click()
        subsets = []
        for _ in range(3):
            fake_qt.QShortcut.trigger("1")
        for ref in store.list_images(tid):
            meta = store.get_map_annotation(ref.image_id)
            if meta.get("source_image"):
                subsets.append(meta["set"])
        assert sorted(subsets) == ["train", "train", "val"]

    def test_busy_guard(self, gui_app, tmp_path, rng):
        win, *_ = _window(gui_app, tmp_path, rng)
        win._active_bridge = object()  # simulate running job
        n = len(fake_qt.QMessageBox.shown)
        win.buttons["Export trainset"].click()
        assert len(fake_qt.QMessageBox.shown) == n + 1  # "Busy" dialog

    def test_model_list_with_aji_scores(self, gui_app, tmp_path, rng):
        win, *_ = _window(gui_app, tmp_path, rng, with_data=False)
        models = tmp_path / "models" / "trainset64"
        models.mkdir(parents=True)
        (models / "distance_model_01.ckpt").write_bytes(b"x")
        (models / "distance_model_02.ckpt").write_bytes(b"x")
        (tmp_path / "evaluation").mkdir(exist_ok=True)
        (tmp_path / "evaluation" / "trainset64.csv").write_text(
            "model,th_cell,th_seed,aji+ (mean),aji+ (std),test set version\n"
            "trainset64: distance_model_01,0.1,0.45,0.881,0.02,abc123\n")
        win.refresh_model_list()
        labels = [win.model_box.itemText(i)
                  for i in range(win.model_box.count())]
        assert labels[0] == "distance_model_01  (AJI+ 0.881)"
        assert labels[1] == "distance_model_02"  # unevaluated: no score
        win.model_box.setCurrentIndex(1)
        assert win._selected_model().name == "distance_model_02.ckpt"

    def test_inference_roundtrip(self, gui_app, tmp_path, rng, monkeypatch):
        win, store, eid, tid = _window(gui_app, tmp_path, rng)
        models = tmp_path / "models" / "trainset64"
        models.mkdir(parents=True)
        (models / "distance_model_01.ckpt").write_bytes(b"x")
        win.refresh_model_list()

        class DummyEngine:
            def segment(self, frames):
                m = np.zeros(frames.shape, np.uint16)
                m[..., 10:30, 10:30] = 1
                return m

        from microbeseg_torch.inference import engine as eng_mod
        seen = []
        monkeypatch.setattr(eng_mod.InferenceEngine, "from_checkpoint",
                            classmethod(lambda cls, p, cfg=None, device=None:
                                        seen.append(device) or DummyEngine()))
        win.buttons["Inference"].click()
        img_id = store.list_images(eid)[0].image_id
        assert store.get_map_annotation(img_id)["inference_model"] == \
            "distance_model_01"
        assert (tmp_path / "results" / "mask_movie_channel0.tif").exists()
        assert seen == ["cpu"]  # built in the job, on the window's device

    def test_import_via_dialog(self, gui_app, tmp_path, rng):
        from microbeseg_torch.utils.tiff import imwrite
        from tests.conftest import synthetic_blobs

        win, store, _, tid = _window(gui_app, tmp_path, rng, with_data=False)
        src = tmp_path / "newdata"
        src.mkdir()
        m = synthetic_blobs(rng, shape=(64, 64), n_blobs=3)
        imwrite(src / "img0.tif", ((m > 0) * 30000).astype(np.uint16))
        imwrite(src / "mask0.tif", m)
        win.crop_size_box._items = ["64"]
        win.crop_size_box._idx = 0
        fake_qt.QFileDialog.next_files = [src / "img0.tif", src / "mask0.tif"]
        before = len(store.list_images(tid))
        win.buttons["Import data"].click()
        assert len(store.list_images(tid)) == before + 1

    def test_connect_disconnect_omero(self, gui_app, tmp_path, rng):
        """The connection bar builds a REAL OmeroStore against the fake
        gateway and Disconnect restores the local store (reference
        gui:927-1004)."""
        from tests import fake_omero

        win, local_store, *_ = _window(gui_app, tmp_path, rng,
                                       with_data=False)
        fake_omero.install()
        win.host_edit.setText("fake.host")
        win.username_edit.setText("user")
        win.password_edit.setText("pw")
        win.connect_button.click()
        from microbeseg_torch.client.store import OmeroStore
        assert isinstance(win.store, OmeroStore)
        assert "Connected to fake.host." in win.log.toPlainText()
        win.disconnect_button.click()
        assert win.store.root == local_store.root
        assert "Disconnected" in win.log.toPlainText()

    def test_double_connect_keeps_local_fallback(self, gui_app, tmp_path,
                                                 rng):
        """Connecting twice (e.g. switching hosts) must close the first
        gateway and keep the ORIGINAL LocalStore as the disconnect target."""
        from tests import fake_omero

        win, local_store, *_ = _window(gui_app, tmp_path, rng,
                                       with_data=False)
        fake_omero.install()
        win.host_edit.setText("fake.host")
        win.username_edit.setText("user")
        win.password_edit.setText("pw")
        win.connect_button.click()
        first = win.store
        win.host_edit.setText("fake.host")  # "another" host
        win.connect_button.click()
        assert win.store is not first
        assert win._local_store.root == local_store.root  # not the gateway
        win.disconnect_button.click()
        assert win.store.root == local_store.root

    def test_browse_datasets_and_new_trainset(self, gui_app, tmp_path, rng):
        win, store, eid, tid = _window(gui_app, tmp_path, rng,
                                       with_data=False)
        win.browse_button.click()
        labels = [win.dataset_combo.itemText(i)
                  for i in range(win.dataset_combo.count())]
        assert f"{eid}: experiment" in labels
        assert f"{tid}: trainset64" in labels
        # selecting a dataset syncs the id spin boxes
        win.dataset_combo.setCurrentIndex(labels.index(f"{eid}: experiment"))
        assert win.dataset_box.value() == eid

        win.new_trainset_edit.setText("trainset128")
        win.add_trainset_button.click()
        new_id = win.trainset_box.value()
        assert store.dataset_name(new_id) == "trainset128"

    def test_split_override_and_settings(self, gui_app, tmp_path, rng):
        win, store, eid, tid = _window(gui_app, tmp_path, rng)
        win.crop_size_box._items = ["64"]
        win.crop_size_box._idx = 0
        # 'Add to: test' overrides the 4/2/2 cycle (reference gui:283-288)
        win.split_combo.setCurrentIndex(3)
        win.buttons["Create crops"].click()
        fake_qt.QShortcut.trigger("1")
        assert "Crop accepted -> test" in win.log.toPlainText()
        # settings widgets expose the reference's training knobs
        assert win.optimizer_combo.currentText() == "ranger"
        assert win.method_combo.currentText() == "distance"
        assert win.batch_size_box.value() == 4
        assert win.device_label.text() == "Device: cpu (0 CUDA device(s))"

    def test_multi_device_checkbox_reaches_run_training(
            self, gui_app, tmp_path, rng, monkeypatch):
        """'Use all devices' (reference 'use multiple gpus', README.md:53:
        training-only) -> run_training num_devices: None = whole mesh,
        unchecked = 1 device like the reference's num_gpus=1."""
        import microbeseg_torch.training.workers as tw

        win, store, eid, tid = _window(gui_app, tmp_path, rng)
        calls = []
        monkeypatch.setattr(tw, "create_labels", lambda *a, **k: True)
        monkeypatch.setattr(tw, "run_training",
                            lambda *a, **k: calls.append(k) or True)
        assert win.multi_device_checkbox.isChecked()
        win.on_train()
        win.multi_device_checkbox.setChecked(False)
        win.on_train()
        assert calls[0]["num_devices"] is None
        assert calls[1]["num_devices"] == 1
        assert [c["device"] for c in calls] == ["cpu", "cpu"]

    def test_change_group(self, gui_app, tmp_path, rng):
        """Group browsing + selection against the fake gateway (reference
        'Change group', gui:1309-1352): groups list sorted by name, the
        selection scopes the gateway via setOmeroGroup and clears the
        dataset browsing state."""
        from tests import fake_omero

        win, *_ = _window(gui_app, tmp_path, rng, with_data=False)
        fake_omero.install()
        win.host_edit.setText("fake.host")
        win.username_edit.setText("u")
        win.connect_button.click()
        win.group_button.click()
        labels = [win.group_combo.itemText(i)
                  for i in range(win.group_combo.count())]
        assert labels == ["lab-alpha (0)", "lab-beta (7)"]
        win.group_combo.setCurrentIndex(1)
        assert "Switched to group 'lab-beta' (7)." in win.log.toPlainText()
        assert win.store._conn.group_set[-1] == "7"

    def test_annotation_tool_deep_links(self, gui_app, tmp_path, rng,
                                        monkeypatch):
        """Annotate deep-links to the trainset; Correct to the dashboard
        (reference open_annotation_tool, gui:1993-2004)."""
        import webbrowser

        win, _, _, tid = _window(gui_app, tmp_path, rng, with_data=False)
        monkeypatch.chdir(tmp_path)
        (tmp_path / "settings.json").write_text(
            '{"annotation_tool_url": "http://tool.local/obiwan"}')
        win.username_edit.setText("alice")
        opened = []
        monkeypatch.setattr(webbrowser, "open", opened.append)
        win.on_annotate()
        win.buttons["Correct"].click()
        assert opened[0] == (
            f"http://tool.local/obiwan/login?u=alice&p=&r=/omero-dataset;"
            f"dataset={tid}")
        assert opened[1].startswith(
            "http://tool.local/obiwan/login?u=alice&p=&r=omero-dashboard")

    def test_eval_scope_selected_models(self, gui_app, tmp_path, rng,
                                        monkeypatch):
        """'selected models' scope evaluates exactly the multi-selected
        entries of the eval model list (reference eval-menu selection,
        gui:1039-1121); empty selection raises the reference's message."""
        win, *_ = _window(gui_app, tmp_path, rng, with_data=False)
        models = tmp_path / "models" / "trainset64"
        models.mkdir(parents=True)
        (models / "distance_model_01.ckpt").write_bytes(b"x")
        (models / "distance_model_02.ckpt").write_bytes(b"x")
        (models / "distance_model_03.ckpt").write_bytes(b"x")
        win.refresh_model_list()
        win.eval_scope_combo.setCurrentIndex(1)  # selected models

        seen = []

        from microbeseg_torch.evaluation import evaluator as ev_mod

        class FakeEvaluator:
            def __init__(self, **kw):
                pass

            def evaluate(self, data_dir, results_dir, models):
                seen.extend(models)
                return None

        monkeypatch.setattr(ev_mod, "Evaluator", FakeEvaluator)
        # no selection -> reference's model-selection message, no eval
        win.buttons["Evaluate"].click()
        assert "Select at least one model" in win.log.toPlainText()
        assert seen == []
        # multi-select two of the three models
        win.eval_model_list.item(0).setSelected(True)
        win.eval_model_list.item(2).setSelected(True)
        win.buttons["Evaluate"].click()
        assert sorted(m.name for m in seen) == [
            "distance_model_01.ckpt", "distance_model_03.ckpt"]

    def test_eval_exports_testset_first(self, gui_app, tmp_path, rng,
                                        monkeypatch):
        """The eval button chains export -> evaluate (reference gui wiring
        starts the eval thread from export_thread.finished, :1062-1092):
        the trainset is on the store only, yet evaluation sees exported
        files on disk."""
        from pathlib import Path

        win, store, eid, tid = _window(gui_app, tmp_path, rng)
        models = tmp_path / "models" / "trainset64"
        models.mkdir(parents=True)
        (models / "distance_model_01.ckpt").write_bytes(b"x")
        win.refresh_model_list()

        exported_at_eval = []

        from microbeseg_torch.evaluation import evaluator as ev_mod

        class FakeEvaluator:
            def __init__(self, **kw):
                pass

            def evaluate(self, data_dir, results_dir, models):
                exported_at_eval.append(
                    len(list(Path(data_dir).glob("*/img_*.tif"))))
                return None

        monkeypatch.setattr(ev_mod, "Evaluator", FakeEvaluator)
        win.buttons["Evaluate"].click()
        assert exported_at_eval == [4]  # all 4 imported crops on disk

    def test_extended_seed_grid_checkbox(self, gui_app, tmp_path, rng,
                                         monkeypatch):
        """The 'Extended seed grid (rods)' checkbox widens EvalConfig's
        th_seeds (rod chains separate above the reference grid's 0.45 cap,
        docs/E2E_RESULTS.md); unchecked stays the reference grid."""
        win, store, eid, tid = _window(gui_app, tmp_path, rng)
        models = tmp_path / "models" / "trainset64"
        models.mkdir(parents=True)
        (models / "distance_model_01.ckpt").write_bytes(b"x")
        win.refresh_model_list()

        cfgs = []

        from microbeseg_torch.evaluation import evaluator as ev_mod

        class FakeEvaluator:
            def __init__(self, **kw):
                cfgs.append(kw["cfg"])

            def evaluate(self, data_dir, results_dir, models):
                return None

        monkeypatch.setattr(ev_mod, "Evaluator", FakeEvaluator)
        win.buttons["Evaluate"].click()
        win.eval_grid_checkbox.setChecked(True)
        win.buttons["Evaluate"].click()
        assert cfgs[0].th_seeds == (0.35, 0.45)  # reference eval.py:128
        assert cfgs[1].th_seeds == (0.35, 0.45, 0.55, 0.65, 0.75)
        assert cfgs[1].th_cells == cfgs[0].th_cells
        assert not cfgs[0].tta
        win.tta_checkbox.setChecked(True)
        win.ensemble_checkbox.setChecked(True)
        win.buttons["Evaluate"].click()
        assert cfgs[2].tta and cfgs[2].ensemble
        assert not cfgs[0].ensemble

    def test_inference_settings_reach_engine_and_worker(
            self, gui_app, tmp_path, rng, monkeypatch):
        """th_cell/th_seed, sliding window, CLAHE, scale and upload widgets
        flow into InferConfig / infer_dataset kwargs."""
        win, store, eid, tid = _window(gui_app, tmp_path, rng)
        models = tmp_path / "models" / "trainset64"
        models.mkdir(parents=True)
        (models / "distance_model_01.ckpt").write_bytes(b"x")
        win.refresh_model_list()
        win.th_cell_box.setValue(0.075)
        win.th_seed_box.setValue(0.35)
        win.sliding_checkbox.setChecked(True)
        win.clahe_checkbox.setChecked(True)
        win.scale_box.setValue(0.5)
        win.upload_checkbox.setChecked(False)
        win.tta_checkbox.setChecked(True)

        captured = {}

        from microbeseg_torch.inference import engine as eng_mod

        class FakeEngine:
            @classmethod
            def from_checkpoint(cls, ckpt, cfg=None, device=None, mesh=None):
                captured["cfg"] = cfg
                captured["device"] = device
                return cls()

        import microbeseg_torch.client.workers as wk

        def fake_infer(store_, ids, engine, **kw):
            captured["kwargs"] = kw

        monkeypatch.setattr(eng_mod, "InferenceEngine", FakeEngine)
        monkeypatch.setattr(wk, "infer_dataset", fake_infer)
        win.buttons["Inference"].click()
        cfg = captured["cfg"]
        assert (cfg.th_cell, cfg.th_seed) == (0.075, 0.35)
        assert cfg.use_tiling and cfg.apply_clahe
        assert cfg.scale_factor == 0.5
        assert cfg.tta
        assert captured["kwargs"]["upload"] is False
        assert captured["device"] == "cpu"

    def test_model_selection_prefills_best_thresholds(
            self, gui_app, tmp_path, rng):
        """Selecting a model with evaluation scores prefills its best
        thresholds (reference gui:1438-1445); unscored models keep the
        [0.10, 0.45] defaults."""
        win, *_ = _window(gui_app, tmp_path, rng, with_data=False)
        models = tmp_path / "models" / "trainset64"
        models.mkdir(parents=True)
        (models / "distance_model_01.ckpt").write_bytes(b"x")
        (models / "distance_model_02.ckpt").write_bytes(b"x")
        ev = tmp_path / "evaluation"
        ev.mkdir(exist_ok=True)
        (ev / "trainset64.csv").write_text(
            "model,th_cell,th_seed,aji+ (mean),aji+ (std)\n"
            "trainset64: distance_model_01,0.125,0.35,0.91,0.01\n")
        win.refresh_model_list()
        win.model_box.setCurrentIndex(0)  # scored model
        assert (win.th_cell_box.value(), win.th_seed_box.value()) == (0.125,
                                                                      0.35)
        win.model_box.setCurrentIndex(1)  # unscored -> defaults
        assert (win.th_cell_box.value(), win.th_seed_box.value()) == (0.10,
                                                                      0.45)

    def test_project_browsing_by_name(self, gui_app, tmp_path, rng):
        """'Project(s)' lists projects by name (reference gui:1658-1797);
        picking one scopes the dataset browse."""
        win, store, *_ = _window(gui_app, tmp_path, rng, with_data=False)
        pid = store.create_project("wetlab-2026")
        did = store.create_dataset("expA", project_id=pid)
        win.projects_button.click()
        assert f"{pid}: wetlab-2026" in [
            win.project_combo.itemText(i)
            for i in range(win.project_combo.count())]
        win.project_combo.setCurrentIndex(
            [win.project_combo.itemText(i)
             for i in range(win.project_combo.count())].index(
                 f"{pid}: wetlab-2026"))
        assert int(win.project_box.value()) == pid
        win.browse_button.click()
        assert int(win.dataset_box.value()) == did

    def test_stop_shortcut(self, gui_app, tmp_path, rng):
        win, *_ = _window(gui_app, tmp_path, rng, with_data=False)

        class Bridge:
            stopped = False

            def stop(self):
                Bridge.stopped = True

        win._active_bridge = Bridge()
        fake_qt.QShortcut.trigger("Ctrl+C")
        assert Bridge.stopped
        assert "Stop requested." in win.log.toPlainText()

    def test_multi_accept_within_one_crop_set(self, gui_app, tmp_path, rng):
        """Several of a frame's 1-3 proposed crops can be accepted (the
        reference's three accept-checkboxes, gui:2687-2725): keys keep
        their positions, the set advances once all crops are taken."""
        win, store, eid, tid = _window(gui_app, tmp_path, rng,
                                       with_data=False)
        # wide movie -> 3 crops per frame (200 > 3*64)
        stack = rng.integers(0, 65535, (6, 96, 220)).astype(np.uint16)
        store.upload_image(eid, "wide.tif", stack)
        store.set_dataset_map_annotation(tid, {"crop_size": "64"})
        win.buttons["Create crops"].click()
        assert len(win._crops) == 3
        before = len(store.list_images(tid))
        frames_left = len(win._crop_items)
        fake_qt.QShortcut.trigger("1")
        fake_qt.QShortcut.trigger("2")
        # still the same frame set (one crop remains)
        assert len(win._crop_items) == frames_left
        assert len(store.list_images(tid)) == before + 2
        fake_qt.QShortcut.trigger("2")  # re-accepting is a no-op
        assert len(store.list_images(tid)) == before + 2
        fake_qt.QShortcut.trigger("3")  # last crop -> advances
        assert len(store.list_images(tid)) == before + 3
        assert len(win._crop_items) == frames_left - 1


# ---------------------------------------------------------------------------
# the port's window against JAX's, on copies of one LocalStore
# ---------------------------------------------------------------------------

def _store_copies(tmp_path, rng):
    """One store with data (the port's ``_window`` set-up), copied once for
    each package.  -> ({package: root}, experiment id, trainset id)"""
    app = _fresh_app("microbeseg_torch")
    _, store, eid, tid = _window(app, tmp_path / "src", rng)
    store.set_dataset_map_annotation(tid, {"crop_size": "64"})
    roots = {}
    for package in ("microbeseg_tpu", "microbeseg_torch"):
        roots[package] = tmp_path / package
        shutil.copytree(store.root, roots[package] / "store")
    return roots, eid, tid


def _open(package, root, eid, tid):
    """``package``'s window on ``root``, with only its own shortcuts live
    (the fake's registry is reset)."""
    app = _fresh_app(package)
    fake_qt.QApplication([])
    kw = {"device": "cpu"} if package == "microbeseg_torch" else {}
    win = app.MicrobeSegMainWindow(
        root / "store", root / "models", root / "training_dataset",
        root / "evaluation", root / "results", **kw)
    win.dataset_box.setValue(eid)
    win.trainset_box.setValue(tid)
    return win


def test_crop_review_and_export_write_what_jax_writes(tmp_path, rng):
    """Crop review (accept, skip a frame, accept, 'Add to: val') and the
    trainset export through each window: equal store files (timestamps by
    presence) and equal exported trainsets."""
    from tests.test_torch_client import _tree

    roots, eid, tid = _store_copies(tmp_path, rng)
    for package, root in roots.items():
        win = _open(package, root, eid, tid)
        win.buttons["Create crops"].click()
        fake_qt.QShortcut.trigger("1")
        fake_qt.QShortcut.trigger("S")
        win.split_combo.setCurrentIndex(2)
        fake_qt.QShortcut.trigger("1")
        win.buttons["Export trainset"].click()
        assert "Crop accepted -> val" in win.log.toPlainText()
    jroot, troot = roots["microbeseg_tpu"], roots["microbeseg_torch"]
    assert _tree(troot / "store") == _tree(jroot / "store")
    exported = _tree(troot / "training_dataset")
    assert len(exported) >= 6
    assert exported == _tree(jroot / "training_dataset")


def test_inference_masks_match_the_jax_window(tmp_path, rng, monkeypatch,
                                              checkpoint):  # noqa: F811
    """Inference through each window from one checkpoint, on a dataset of 3
    blob frames of 48^2 and one 2-frame 2D+t image, at thresholds from the
    fields: every image gets ``inference_model``, and the masks each
    window writes agree at per-frame IoU >= 0.99 (the JAX engine in float32
    under matmul precision 'highest')."""
    import jax
    import jax.numpy as jnp

    from microbeseg_torch.inference.engine import InferenceEngine
    from microbeseg_torch.utils.tiff import imread
    from microbeseg_tpu.inference import engine as jeng
    from microbeseg_tpu.models.io import load_model as jload
    from tests.oracles import masks_iou
    from tests.test_torch_engine import _frames, _thresholds

    frames = _frames(n=5, size=48)
    th_cell, th_seed = _thresholds(InferenceEngine.from_checkpoint(
        checkpoint, device="cpu").predict_raw(frames)[1])
    roots, eid, tid = _store_copies(tmp_path, rng)

    def jax_f32(cls, path, cfg=None, mesh=None):
        model, variables, tcfg = jload(path, dtype=jnp.float32)
        return cls(model, variables, tcfg.label_type, cfg=cfg)

    monkeypatch.setattr(jeng.InferenceEngine, "from_checkpoint",
                        classmethod(jax_f32))
    for package, root in roots.items():
        win = _open(package, root, eid, tid)
        store = win.store
        did = store.create_dataset("blobs")
        for i in range(3):
            store.upload_image(did, f"f{i}.tif", frames[i])
        store.upload_image(did, "series.tif", frames[3:])
        models = root / "models" / "trainset64"
        models.mkdir(parents=True)
        for f in checkpoint.parent.glob(f"{checkpoint.name}*"):
            shutil.copy(f, models / f.name)
        win.refresh_model_list()
        win.dataset_box.setValue(did)
        win.th_cell_box.setValue(th_cell)
        win.th_seed_box.setValue(th_seed)
        with jax.default_matmul_precision("highest"):
            win.buttons["Inference"].click()
        assert "Error" not in win.log.toPlainText(), win.log.toPlainText()
        for ref in store.list_images(did):
            assert (store.get_map_annotation(ref.image_id)["inference_model"]
                    == checkpoint.name)
    names = sorted(p.name for p in (roots["microbeseg_torch"]
                                    / "results").glob("mask_*.tif"))
    assert len(names) == 4
    for name in names:
        ours = imread(roots["microbeseg_torch"] / "results" / name)
        ref = imread(roots["microbeseg_tpu"] / "results" / name)
        ours, ref = ours.reshape(-1, 48, 48), ref.reshape(-1, 48, 48)
        for a, b in zip(ref, ours):
            assert len(np.unique(a)) > 2
            assert masks_iou(a, b) >= 0.99


def test_entry_point_without_pyqt5_names_the_headless_clis():
    """``python -m microbeseg_torch.gui.app`` where PyQt5 cannot be
    imported: exit code 1 and the port's headless CLIs."""
    code = ("import runpy, sys\n"
            "sys.modules['PyQt5'] = None\n"
            "runpy.run_module('microbeseg_torch.gui.app', "
            "run_name='__main__')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 1, res.stderr
    assert "PyQt5 is not installed" in res.stdout
    for cli in ("train", "infer_local", "infer_store", "evaluate", "serve"):
        assert f"python -m microbeseg_torch.cli.{cli}" in res.stdout
    assert "jax" not in res.stdout
