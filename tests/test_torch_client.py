"""The port's client layer against the JAX package's, on the CPU.

Contours: ROI strings, parsed polygons and rasterised masks equal to JAX's,
exactly, and the native and Python routes equal to each other.  Stores: a
``LocalStore`` written by either package is byte for byte the other's and
reads back equal in both; the port's stores pass JAX's contract tests (its
``OmeroStore`` on ``tests/fake_omero.py``).  Workers, with one
deterministic stub engine given to both packages: equal store states and
files, exactly (timestamps compared only by presence); analysis counts
exactly and its float columns within 1e-5 relative (regionprops' moments are
summed in float64 by the port, in float32 by JAX).  ``cli.infer_store``
with both real engines from one checkpoint: per-frame IoU >= 0.99 of the
rasterised ROIs.
"""

import csv
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax
import jax.numpy as jnp

from microbeseg_tpu.client import contours as jcontours
from microbeseg_tpu.client import store as jstore
from microbeseg_tpu.client import workers as jworkers
from microbeseg_torch.client import contours as tcontours
from microbeseg_torch.client import native as tnative
from microbeseg_torch.client import store as tstore
from microbeseg_torch.client import workers as tworkers
from microbeseg_torch.utils.tiff import imread, imwrite
from tests.conftest import synthetic_blobs
from tests.oracles import masks_iou
from tests.test_client import TestOmeroStoreSpecific as _JaxOmeroSpecific
from tests.test_client import TestStoreContract as _JaxStoreContract
from tests.test_torch_engine import _frames, _thresholds, checkpoint  # noqa: F401

# map-annotation keys that hold the time of a write: compared by presence
_TIME_KEYS = ("inference_date", "upload_date", "last_modification")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Several test processes share the cores (see test_torch_engine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# contours
# ---------------------------------------------------------------------------

def _contour_masks():
    rng = np.random.default_rng(21)
    blobs = synthetic_blobs(rng, shape=(64, 64), n_blobs=9)
    yy, xx = np.mgrid[0:48, 0:48]
    r2 = (yy - 24) ** 2 + (xx - 24) ** 2
    holes = ((r2 <= 400) & (r2 >= 49)).astype(np.uint16)   # an annulus
    holes[2:6, 2:30] = 2
    holes[3, 10:20] = 0                                       # a slit hole
    frags = synthetic_blobs(rng, shape=(56, 60), n_blobs=5)
    top = int(frags.max())
    frags[2:6, 2:6] = top + 1                                 # one id in
    frags[50:54, 52:56] = top + 1                             # 3 fragments
    frags[30, 2] = top + 1
    frags[54, 2] = top + 2                                    # one pixel
    return {"blobs": blobs, "holes": holes, "fragments": frags}


@pytest.mark.parametrize("name", ["blobs", "holes", "fragments"])
def test_contours_match_jax(name):
    """ROI strings, their parsed polygons, the rasterised masks and the
    polygons with holes equal JAX's exactly."""
    mask = _contour_masks()[name]
    strings = tcontours.mask_to_roi_strings(mask)
    assert strings == jcontours.mask_to_roi_strings(mask) and strings
    for s in strings:
        poly = tcontours.roi_string_to_polygon(s)
        np.testing.assert_array_equal(poly, jcontours.roi_string_to_polygon(s))
        np.testing.assert_array_equal(
            tcontours.polygon_to_mask(poly, mask.shape),
            jcontours.polygon_to_mask(poly, mask.shape))
    ours = tcontours.mask_to_polygons(mask, include_holes=True)
    ref = jcontours.mask_to_polygons(mask, include_holes=True)
    assert list(ours) == list(ref)
    for k in ref:
        assert len(ours[k]) == len(ref[k])
        for a, b in zip(ours[k], ref[k]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tworkers._rasterize_rois(tworkers._mask_to_rois(mask), 0, mask.shape),
        jworkers._rasterize_rois(jworkers._mask_to_rois(mask), 0, mask.shape))
    for k, (ys, xs) in jcontours.get_indices_pandas(mask).items():
        oy, ox = tcontours.get_indices_pandas(mask)[k]
        np.testing.assert_array_equal(oy, ys)
        np.testing.assert_array_equal(ox, xs)


@pytest.mark.parametrize("name", ["blobs", "holes", "fragments"])
def test_native_and_python_routes_agree(name, monkeypatch):
    """The library of native/contours.cpp and the port's Python loops give
    the same strings, polygons, boundaries and rasterised masks."""
    mask = _contour_masks()[name]
    assert tnative.get_lib() is not None  # g++ builds it here
    native = (tcontours.mask_to_roi_strings(mask),
              tcontours.mask_to_polygons(mask),
              tcontours.trace_boundary(mask == mask.max()),
              tworkers._rasterize_rois(tworkers._mask_to_rois(mask), 0,
                                       mask.shape))
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    python = (tcontours.mask_to_roi_strings(mask),
              tcontours.mask_to_polygons(mask),
              tcontours.trace_boundary(mask == mask.max()),
              tworkers._rasterize_rois(tworkers._mask_to_rois(mask), 0,
                                       mask.shape))
    assert native[0] == python[0]
    assert list(native[1]) == list(python[1])
    for k in python[1]:
        for a, b in zip(native[1][k], python[1][k]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(native[2], python[2])
    np.testing.assert_array_equal(native[3], python[3])


def test_native_library_builds_under_build_native():
    lib = tnative.get_lib()
    assert lib is not None
    path = Path(lib._name)
    assert path.parent == tnative.BUILD_DIR and path.name.startswith(
        "libmbs_contours-")
    assert path.parent.parent.name == "build"


# ---------------------------------------------------------------------------
# stores
# ---------------------------------------------------------------------------

def _tree(root: Path) -> dict:
    """Every file under ``root``: relative path -> bytes, with the map
    annotations' time keys replaced by their presence."""
    out = {}
    for p in sorted(root.rglob("*")):
        if not p.is_file():
            continue
        rel = str(p.relative_to(root))
        data = p.read_bytes()
        if p.name == "map.json":
            kv = json.loads(data)
            for k in _TIME_KEYS:
                if k in kv:
                    kv[k] = bool(kv[k])
            data = kv
        out[rel] = data
    return out


def _fill_store(store, tmp: Path, rng) -> None:
    """The same writes through either package's LocalStore."""
    pid = store.create_project("proj")
    did = store.create_dataset("exp", project_id=pid)
    store.create_dataset("other")
    stack = rng.integers(0, 65535, (3, 20, 24)).astype(np.uint16)
    iid = store.upload_image(did, "stack.tif", stack)
    store.upload_image(did, "mc.tif",
                       rng.integers(0, 999, (2, 3, 8, 10)).astype(np.uint16))
    store.upload_image(did, "one.tif",
                       rng.integers(0, 255, (12, 14)).astype(np.uint8))
    store.set_map_annotation(iid, {"set": "train", "min_frame": 3.5})
    store.set_map_annotation(iid, {"inference_model": "m01"})
    store.add_polygons(iid, [tstore.RoiPolygon(t=0, z=0, points="1,1 3,1 3,3"),
                             tstore.RoiPolygon(t=2, z=0, points="4,4 9,4 9,9")])
    f = tmp / "analysis_a.csv"
    f.write_text("x\n1\n")
    store.attach_file(iid, f, namespace=tstore.ANALYSIS_NAMESPACE)
    g = tmp / "notes.txt"
    g.write_text("n")
    store.attach_file(iid, g)
    store.set_dataset_map_annotation(did, {"crop_size": 256})
    s = tmp / "split_info.json"
    s.write_text('{"used": [], "num_acc": 1}')
    store.attach_dataset_file(did, s, namespace="split.info.namespace")


def _read_store(store) -> dict:
    """Everything a reader of the store sees."""
    out = {"projects": store.list_projects()}
    for pid, _ in out["projects"]:
        for did in store.list_datasets(pid):
            out[f"ds{did}"] = (store.dataset_name(did),
                               store.get_dataset_map_annotation(did),
                               store.list_dataset_attachments(did))
            for ref in store.list_images(did):
                i = ref.image_id
                planes = [store.get_plane(i, 0, c, t).tolist()
                          for t in range(ref.size_t)
                          for c in range(ref.size_c)]
                out[f"img{i}"] = (
                    (ref.name, ref.size_t, ref.size_c, ref.size_z,
                     ref.size_y, ref.size_x, ref.dataset_id),
                    planes, store.get_map_annotation(i),
                    [(p.t, p.z, p.points) for p in store.get_polygons(i)],
                    store.list_attachments(i),
                    store.list_attachments(
                        i, namespace=tstore.ANALYSIS_NAMESPACE),
                    store.image_group(i))
    return out


def test_local_store_layout_is_jax_byte_for_byte(tmp_path):
    """The same writes through each package leave equal files, and each
    package reads the other's store as its own."""
    roots = {}
    for name, mod in (("jax", jstore), ("torch", tstore)):
        tmp = tmp_path / f"src_{name}"
        tmp.mkdir()
        roots[name] = tmp_path / name
        _fill_store(mod.LocalStore(roots[name]), tmp,
                    np.random.default_rng(4))
    assert _tree(roots["jax"]) == _tree(roots["torch"])
    for root in roots.values():
        ref = _read_store(jstore.LocalStore(root))
        assert ref["projects"] and len(ref) > 3
        assert _read_store(tstore.LocalStore(root)) == ref
    # one more write by the other package keeps the files equal
    for name, other in (("jax", tstore), ("torch", jstore)):
        s = other.LocalStore(roots[name])
        s.delete_attachments(1, names=["notes.txt"])
        s.delete_polygons(1)
    assert _tree(roots["jax"]) == _tree(roots["torch"])


@pytest.fixture(params=["local", "omero"])
def _port_store(request, tmp_path):
    if request.param == "local":
        yield tstore.LocalStore(tmp_path / "store"), None
    else:
        from tests import fake_omero
        server = fake_omero.install()
        yield tstore.OmeroStore("user", "pw", "fake.host", 4064), server


class TestPortStoreContract(_JaxStoreContract):
    """JAX's store contract tests, run on the port's stores."""

    @pytest.fixture
    def any_store(self, _port_store):
        return _port_store


class TestPortOmeroStore(_JaxOmeroSpecific):
    """JAX's OmeroStore tests on the fake gateway, run on the port's."""

    def _store(self):
        from tests import fake_omero
        server = fake_omero.install()
        return tstore.OmeroStore("u", "p", "h", 4064), server

    def test_refused_connection(self):
        from tests import fake_omero
        server = fake_omero.install()
        server.refuse_connect = True
        with pytest.raises(ConnectionError, match="No OMERO connection"):
            tstore.OmeroStore("u", "p", "h", 4064)


# ---------------------------------------------------------------------------
# workers, with one stub engine for both packages
# ---------------------------------------------------------------------------

class StubEngine:
    """Deterministic masks: 8-connected components above each frame's
    mean."""
    cfg = None

    def segment(self, frames, th_cell=None, th_seed=None):
        f = np.asarray(frames)
        squeeze = f.ndim == 2
        f = f[None] if squeeze else f
        out = np.stack([ndimage.label(fr > fr.mean(),
                                      structure=np.ones((3, 3)))[0]
                        for fr in f]).astype(np.uint16)
        return out[0] if squeeze else out


def _sources(tmp: Path):
    """4 image/mask pairs of 48^2 and one 96 x 52 (two grid crops)."""
    rng = np.random.default_rng(7)
    src = tmp / "src"
    src.mkdir()
    imgs, masks = [], []
    for i, shape in enumerate([(48, 48)] * 4 + [(96, 52)]):
        mask = synthetic_blobs(rng, shape=shape, n_blobs=5, r_range=(4, 9))
        img = ((mask > 0) * 30000 + 2000
               + rng.integers(0, 500, shape)).astype(np.uint16)
        imwrite(src / f"im{i}.tif", img)
        imwrite(src / f"ma{i}.tif", mask)
        imgs.append(src / f"im{i}.tif")
        masks.append(src / f"ma{i}.tif")
    return imgs, masks


def _stack(seed=8, t=3, shape=(40, 44)):
    rng = np.random.default_rng(seed)
    return np.stack([(synthetic_blobs(rng, shape=shape, n_blobs=5) > 0)
                     * 20000 + 1000 + rng.integers(0, 300, shape)
                     for _ in range(t)]).astype(np.uint16)


@pytest.fixture()
def both(tmp_path):
    """A JAX and a port LocalStore, each filled by its own package's
    ``import_data`` from the same files, plus one 2D+t image."""
    imgs, masks = _sources(tmp_path)
    out = {}
    for name, st, wk in (("jax", jstore, jworkers),
                         ("torch", tstore, tworkers)):
        store = st.LocalStore(tmp_path / f"store_{name}")
        did = store.create_dataset("trainset")
        ids = wk.import_data(store, did, imgs, masks, crop_size=48,
                             split_probs=(0.5, 0.3, 0.2), seed=1)
        ids.append(store.upload_image(did, "series.tif", _stack()))
        out[name] = (store, did, ids)
    return out


def test_import_data_matches_jax(both):
    (js, jdid, jids), (ts, tdid, tids) = both["jax"], both["torch"]
    assert jids == tids and len(tids) == 7
    assert _tree(ts.root) == _tree(js.root)
    meta = ts.get_map_annotation(tids[0])
    assert meta["last_modification"] and meta["upload_date"]


def test_export_trainset_matches_jax(both, tmp_path):
    roots = {n: wk.export_trainset(both[n][0], both[n][1], tmp_path / f"x_{n}")
             for n, wk in (("jax", jworkers), ("torch", tworkers))}
    assert roots["torch"].name == roots["jax"].name == "trainset"
    tree = _tree(roots["torch"])
    assert len(tree) == 14 and tree == _tree(roots["jax"])


@pytest.mark.parametrize("pipeline", [True, False])
def test_infer_dataset_matches_jax(both, tmp_path, pipeline):
    """Upload and local masks, then an overwrite pass (deletions of ROIs,
    analysis and label-tool attachments) and a skip pass: equal store
    states and mask files."""
    for name, wk in (("jax", jworkers), ("torch", tworkers)):
        store, _, ids = both[name]
        extra = tmp_path / f"GUISegmentation_{name}.json"
        extra.write_text("{}")
        store.attach_file(ids[0], extra.rename(
            extra.with_name("GUISegmentation.json")))
        out = tmp_path / f"masks_{name}"
        msgs = []
        wk.infer_dataset(store, ids + ids[:2], StubEngine(), "stub_01",
                         result_dir=out, pipeline=pipeline,
                         text_output=msgs.append)
        wk.infer_dataset(store, ids[:3], StubEngine(), "stub_02",
                         overwrite=True, pipeline=pipeline)
        wk.infer_dataset(store, ids[3:], StubEngine(), "stub_03",
                         pipeline=pipeline, text_output=msgs.append)
        wk.infer_dataset(store, ids, StubEngine(), "stub_04", upload=False,
                         result_dir=out, pipeline=pipeline,
                         text_output=msgs.append)
        both[name] = both[name] + (msgs,)
    js, ts = both["jax"][0], both["torch"][0]
    assert _tree(ts.root) == _tree(js.root)
    assert both["torch"][3] == both["jax"][3]
    assert _tree(tmp_path / "masks_torch") == _tree(tmp_path / "masks_jax")
    tids = both["torch"][2]
    meta = ts.get_map_annotation(tids[-1])
    assert meta["inference_model"] == "stub_01" and meta["inference_date"]
    assert ts.get_map_annotation(tids[0])["inference_model"] == "stub_02"
    assert sum("already processed" in m for m in both["torch"][3]) == 4 + 7
    assert ts.list_attachments(both["torch"][2][0]) == []
    assert len(ts.get_polygons(both["torch"][2][-1])) > 3


def test_export_results_and_analysis_match_jax(both, tmp_path):
    """export_results' files byte for byte; analyze_dataset's CSV counts
    exactly and floats within 1e-5 relative, frame by frame, including a
    2D+t image and a frame without cells."""
    for name, wk in (("jax", jworkers), ("torch", tworkers)):
        store, _, ids = both[name]
        wk.infer_dataset(store, ids, StubEngine(), "stub", pipeline=False)
        store.delete_polygons(ids[1])            # a frame without cells
        kw = {"device": "cpu"} if name == "torch" else {}
        csvs = wk.analyze_dataset(store, ids, tmp_path / f"an_{name}", **kw)
        both[name] = both[name] + (csvs,)
        wk.export_results(store, ids, tmp_path / f"res_{name}")
    for a, b in zip(both["torch"][3], both["jax"][3]):
        assert a.name == b.name
        ours = list(csv.reader(a.open()))
        ref = list(csv.reader(b.open()))
        assert ours[0] == ref[0] and len(ours) == len(ref)
        for ro, rr in zip(ours[1:], ref[1:]):
            assert ro[:2] == rr[:2]                  # frame, cell_count
            np.testing.assert_allclose([float(v) for v in ro[2:]],
                                       [float(v) for v in rr[2:]],
                                       rtol=1e-5, atol=0)
    rows = list(csv.reader(both["torch"][3][-1].open()))
    assert len(rows) == 4 and int(rows[1][1]) > 0
    assert list(csv.reader(both["torch"][3][1].open()))[1][1] == "0"
    res = _tree(tmp_path / "res_torch")
    ref = _tree(tmp_path / "res_jax")
    csv_names = [k for k in ref if k.startswith("analysis_")]
    assert len(res) == len(ref) == 7 * 5
    assert {k: v for k, v in res.items() if k not in csv_names} == {
        k: v for k, v in ref.items() if k not in csv_names}


def test_regionprops_of_a_stack_equals_frame_by_frame():
    """``analyze_dataset``'s one call per chunk: each image of a (B, H, W)
    stack gets exactly the properties of its own call."""
    from microbeseg_torch.ops.regionprops import regionprops

    rng = np.random.default_rng(5)
    stack = np.stack([synthetic_blobs(rng, shape=(40, 52), n_blobs=n)
                      for n in (6, 0, 9)]).astype(np.int32)
    stack[2][stack[2] == 3] = 0                  # an absent id
    got = regionprops(torch.from_numpy(stack), max_labels=16)
    for j, frame in enumerate(stack):
        one = regionprops(torch.from_numpy(frame), max_labels=16)
        for a, b in zip(got, one):
            assert a.shape[0] == 3
            assert torch.equal(a[j], b)
    assert int((got.area[0] > 0).sum()) == int(stack[0].max())
    assert float(got.area[1].sum()) == 0.0


def test_analyze_dataset_on_the_card_by_default(both, tmp_path, monkeypatch):
    """Without ``device=`` the analysis asks for the card (and raises
    here, where there is none)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store, _, ids = both["torch"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tworkers.analyze_dataset(store, ids[:1], tmp_path / "an")


def test_crop_generator_matches_jax(tmp_path):
    """From one seed: the same crop list, the same crops, displays,
    pre-labels and overlays, and the same uploads and split_info."""
    out = {}
    frames = [_stack(9, t=6, shape=(100, 60)), _stack(10, t=2, shape=(50, 50))]
    for name, st, wk in (("jax", jstore, jworkers),
                         ("torch", tstore, tworkers)):
        store = st.LocalStore(tmp_path / name)
        src = store.create_dataset("experiments")
        for i, f in enumerate(frames):
            store.upload_image(src, f"exp{i}.tif", f)
        trainset = store.create_dataset("trainset")
        gen = wk.CropGenerator(store, crop_size=48, engine=StubEngine(),
                               seed=5, trainset_id=trainset)
        items = gen.crop_list(src)
        crops = [c for it in items for c in gen.next_crops(*it)]
        for k, c in enumerate(crops[:4]):
            gen.upload_crop(c, trainset, wk.split_assignment(k))
        gen.mark_skipped(*items[-1])
        out[name] = (store, items, crops)
    (js, jitems, jcrops), (ts, titems, tcrops) = out["jax"], out["torch"]
    assert titems == jitems and len(titems) >= 4
    assert len(tcrops) == len(jcrops) >= 6
    for a, b in zip(tcrops, jcrops):
        assert (a.image_id, a.frame, a.y, a.x) == (b.image_id, b.frame,
                                                  b.y, b.x)
        for f in ("img", "display", "overlay"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert [r.points for r in a.rois] == [r.points for r in b.rois]
        assert a.rois and (a.min_frame, a.std_frame) == (b.min_frame,
                                                         b.std_frame)
    assert _tree(ts.root) == _tree(js.root)


# ---------------------------------------------------------------------------
# cli.infer_store with both real engines
# ---------------------------------------------------------------------------

def test_cli_infer_store_matches_jax(checkpoint, tmp_path, monkeypatch):  # noqa: F811
    """Both CLIs on a copy of one LocalStore (4 single frames and one
    3-frame 2D+t image of 48^2) from one checkpoint: every image gets ROIs
    and ``inference_model``; the rasterised ROIs reach per-frame IoU >= 0.99
    against JAX's; ``-r`` writes the masks the port's engine gives."""
    from microbeseg_tpu.cli import infer_local as jinfer_local
    from microbeseg_tpu.cli import infer_store as jcli
    from microbeseg_tpu.inference.engine import InferenceEngine as JEngine
    from microbeseg_tpu.models.io import load_model as jload
    from microbeseg_torch.cli import infer_store as tcli
    from microbeseg_torch.inference.engine import InferenceEngine

    frames = _frames(n=7, size=48)
    eng = InferenceEngine.from_checkpoint(checkpoint, device="cpu")
    th_cell, th_seed = _thresholds(eng.predict_raw(frames)[1])
    roots = {}
    for name, st in (("jax", jstore), ("torch", tstore)):
        roots[name] = tmp_path / name
        store = st.LocalStore(roots[name])
        did = store.create_dataset("d")
        for i in range(4):
            store.upload_image(did, f"f{i}.tif", frames[i])
        store.upload_image(did, "series.tif", frames[4:])

    def jax_engine(stems, cfg):
        model, variables, tcfg = jload(stems[0], dtype=jnp.float32)
        return JEngine(model, variables, tcfg.label_type, cfg=cfg)

    monkeypatch.setattr(jinfer_local, "build_engine", jax_engine)
    argv = ["--dataset", "1", "-m", str(checkpoint), "-t", repr(th_cell),
            repr(th_seed)]
    with jax.default_matmul_precision("highest"):
        assert jcli.main(argv + ["--local_store", str(roots["jax"])]) == 0
    assert tcli.main(argv + ["--local_store", str(roots["torch"]),
                             "--device", "cpu", "-r",
                             str(tmp_path / "masks")]) == 0
    js, ts = jstore.LocalStore(roots["jax"]), tstore.LocalStore(roots["torch"])
    for ref in ts.list_images(1):
        meta = ts.get_map_annotation(ref.image_id)
        assert meta["inference_model"] == "port_01" and meta["inference_date"]
        mine = ts.get_polygons(ref.image_id)
        theirs = js.get_polygons(ref.image_id)
        written = imread(tmp_path / "masks"
                         / f"mask_{Path(ref.name).stem}_channel0.tif")
        written = written.reshape(ref.size_t, ref.size_y, ref.size_x)
        planes = np.stack([ts.get_plane(ref.image_id, 0, 0, t)
                           for t in range(ref.size_t)])
        np.testing.assert_array_equal(
            written, eng.segment(planes, th_cell=th_cell, th_seed=th_seed))
        for t in range(ref.size_t):
            shape = (ref.size_y, ref.size_x)
            a = tworkers._rasterize_rois(mine, t, shape)
            b = jworkers._rasterize_rois(theirs, t, shape)
            assert len(np.unique(b)) > 2
            assert masks_iou(b, a) >= 0.99


def test_cli_infer_store_needs_the_card_or_device_cpu(checkpoint,  # noqa: F811
                                                      tmp_path, monkeypatch):
    from microbeseg_torch.cli import infer_store as tcli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = tstore.LocalStore(tmp_path / "s")
    did = store.create_dataset("d")
    store.upload_image(did, "a.tif", _frames(n=1, size=48)[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--dataset", str(did), "-m", str(checkpoint),
                   "--local_store", str(tmp_path / "s")])
    assert tstore.LocalStore(tmp_path / "s").get_polygons(1) == []
