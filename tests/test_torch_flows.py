"""Cellpose's flow dynamics in the port (``microbeseg_torch/ops/flows.py``)
against the plain reference (``tests/cpsam_reference.py``) on the CPU:
well-separated cells come back exactly from the flows of their own masks;
the plain follow route takes the reference's ``grid_sample`` steps; the
seeds and regions, the flow check and the fill match the reference's; the
flow check removes a mask whose flows are wrong, the fill removes small
masks and fills holes; the engine's flows path gives the reference
pipeline's masks, records its spans and counters, and refuses what it
does not run."""

import numpy as np
import pytest
import torch

import cpsam_reference as ref
from microbeseg_torch.config import CellposeSAMConfig, InferConfig
from microbeseg_torch.inference.engine import InferenceEngine
from microbeseg_torch.models.vit_sam import build_cellpose_sam
from microbeseg_torch.ops import flows
from microbeseg_torch.utils import profiling

CFG = InferConfig()


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def ellipses(shape, cells):
    """(H, W) int64 masks: ellipses (cy, cx, ry, rx) labelled 1.. in
    order."""
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    m = np.zeros(shape, np.int64)
    for i, (cy, cx, ry, rx) in enumerate(cells):
        m[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] = i + 1
    return m


CELLS = [(14, 14, 7, 9), (15, 50, 6, 6), (44, 20, 9, 7), (48, 58, 8, 10),
         (78, 30, 5, 8), (80, 70, 9, 9)]


def fields_of(masks):
    """Cellpose's own flows of the masks (x 5, as a network gives them) and
    a cell probability of +-4."""
    mu = ref.masks_to_flows(masks, "cpu")
    dP = torch.from_numpy(5 * mu).float()
    cp = torch.from_numpy(np.where(masks > 0, 4.0, -4.0)).float()
    return dP, cp


def same_partition(a: np.ndarray, b: np.ndarray) -> bool:
    """The same masks, whatever their numbers."""
    pairs = set(zip(a.ravel().tolist(), b.ravel().tolist()))
    return len(pairs) == len(np.unique(a)) == len(np.unique(b))


def test_separated_cells_come_back_exactly():
    masks = ellipses((96, 96), CELLS)
    dP, cp = fields_of(masks)
    got = flows.flows_postprocessing(dP, cp, CFG).numpy()
    assert got.max() == len(CELLS)
    assert same_partition(got, masks)
    np.testing.assert_array_equal(got, ref.compute_masks(dP, cp, CFG.__dict__))


def test_plain_follow_is_the_reference_steps():
    masks = ellipses((96, 96), CELLS)
    dP, cp = fields_of(masks)
    dP = dP + 0.7 * torch.randn(dP.shape, generator=torch.Generator()
                                .manual_seed(1))
    fg = cp > 0
    idx = torch.nonzero(fg.reshape(-1)).squeeze(1)
    got = flows.follow_flows(dP, fg, idx, 60)
    inds = tuple(i.numpy() for i in torch.nonzero(fg, as_tuple=True))
    want = ref.steps_interp(dP * fg / 5., inds, 60)
    np.testing.assert_array_equal(got.T.numpy(), want)


def test_seeds_and_regions_match_the_reference():
    g = np.random.default_rng(2)
    H, W = 80, 90
    # end points gathered around a few sinks, some scattered
    sinks = g.integers(5, 75, (7, 2))
    pick = g.integers(0, 7, 1500)
    pts = np.clip(sinks[pick] + g.integers(-2, 3, (1500, 2)), 0, 79)
    pts[::9] = g.integers(0, 80, (len(pts[::9]), 2))
    idx = g.choice(H * W, 1500, replace=False)
    inds = np.unravel_index(idx, (H, W))
    got = flows.get_masks(torch.from_numpy(pts), torch.from_numpy(idx), H, W,
                          0.4).numpy()
    want = ref.get_masks(pts.T.copy(), inds, (H, W), 0.4)
    assert want.max() >= 3
    np.testing.assert_array_equal(got, want)


def test_flow_check_removes_the_mask_with_wrong_flows():
    masks = ellipses((96, 96), CELLS)
    dP, _ = fields_of(masks)
    bad = torch.from_numpy(masks == 3)
    dP[:, bad] = -dP[:, bad]           # cell 3's flows point outwards
    got = flows.remove_bad_flow_masks(torch.from_numpy(masks), dP, 0.4)
    assert sorted(np.unique(got.numpy()).tolist()) == [0, 1, 2, 4, 5, 6]
    want = ref.remove_bad_flow_masks(masks, dP.numpy(), 0.4, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_small_masks_go_and_holes_fill():
    masks = ellipses((64, 64), [(20, 20, 10, 10), (45, 45, 9, 9),
                                (50, 12, 2, 2)])
    masks[18:23, 18:23] = 0                    # a hole in mask 1
    masks[44:47, 44:46] = 0                    # and one in mask 2
    got = flows.fill_holes_and_remove_small_masks(torch.from_numpy(masks),
                                                  15).numpy()
    assert got.max() == 2                      # mask 3 (13 px) is gone
    assert (got[18:23, 18:23] == 1).all() and (got[44:47, 44:46] == 2).all()
    np.testing.assert_array_equal(
        got, ref.fill_holes_and_remove_small_masks(masks, 15))


def seeded_frames(n, size, seed):
    """Frames of a few bright ellipses on a noisy background."""
    g = np.random.default_rng(seed)
    frames = g.normal(2500, 900, (n, size, size))
    for f in frames:
        cells = [(g.integers(12, size - 12), g.integers(12, size - 12),
                  g.integers(4, 9), g.integers(4, 9)) for _ in range(9)]
        f[ellipses((size, size), cells) > 0] += 28000
    return np.clip(frames, 0, 65535).astype(np.uint16)


def tiny_model():
    from benchmark.families import cellpose_sam as fam
    cfg = fam.tiny(dict(fam.PUBLISHED))
    state = fam.make_weights(cfg, 11, "cpu")
    model = build_cellpose_sam(CellposeSAMConfig(**cfg)).eval()
    model.load_state_dict(state)
    return model, cfg, state


INFER = dict(use_tiling=True, tile_size=64, tile_overlap=14)


def test_engine_flows_path_is_the_reference_pipeline():
    model, cfg, state = tiny_model()
    frames = seeded_frames(2, 150, 3)
    engine = InferenceEngine(model, "flows", cfg=InferConfig(**INFER),
                             device="cpu")
    got = engine.segment(frames)
    assert got.dtype == np.uint16 and got.shape == frames.shape
    seg = ref.Segmenter(cfg, state, dict(CFG.__dict__, **INFER))
    fields = seg.fields_of(frames, "cpu")
    want = np.stack(seg.masks(fields))
    assert min(m.max() for m in want) >= 3
    np.testing.assert_array_equal(got, want)
    # a frame smaller than a tile, padded with 0
    np.testing.assert_array_equal(
        engine.segment(frames[0, :50, :40]),
        seg.masks(seg.fields_of(frames[:1, :50, :40], "cpu"))[0])


def test_engine_flows_spans_and_counters():
    from torch.profiler import ProfilerActivity, profile
    model, _, _ = tiny_model()
    engine = InferenceEngine(model, "flows", cfg=InferConfig(**INFER),
                             device="cpu")
    frames = seeded_frames(1, 100, 4)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        engine.segment(frames)
    s = profiling.summary()
    profiling.reset()
    for name in ("follow", "masks", "qc", "fill"):
        assert s["spans"][f"mseg.segment.flows.{name}"]["count"] == 1
    # 2 blocks a forward, 4 tiles in one forward
    assert s["spans"]["mseg.vit.attention"]["count"] == 2
    fg = int((engine.predict_raw(frames)[0][0, ..., 2] > 0).sum())
    assert s["counters"]["flow_points"] == fg
    assert s["counters"]["qc_iterations"] > 0


@pytest.mark.parametrize("over", [dict(tta=True), dict(quantize=True),
                                  dict(scale_factor=0.5),
                                  dict(tile_size=128)])
def test_engine_refuses_what_the_flows_path_does_not_run(over):
    model, _, _ = tiny_model()
    with pytest.raises(ValueError):
        InferenceEngine(model, "flows", cfg=InferConfig(**dict(INFER, **over)),
                        device="cpu")


def test_kernel_library_builds_once_under_mesh_threads(tmp_path,
                                                       monkeypatch):
    """A flows engine on a mesh post-processes on one host thread per
    device, and each thread's first ``follow_flows`` loads ``follow``'s
    library: it is built once, and every thread gets the one library."""
    import threading
    import time
    from concurrent.futures import ThreadPoolExecutor

    from microbeseg_torch.kernels import _build

    builds, opened = [], []

    def build_all(names):
        builds.append(list(names))
        time.sleep(0.2)
        for name in names:
            _build._lib_path(name).write_bytes(b"")

    def cdll(path):
        opened.append(path)
        return object()

    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_lib_path",
                        lambda name: tmp_path / f"lib{name}.so")
    monkeypatch.setattr(_build, "build_all", build_all)
    monkeypatch.setattr(_build.ctypes, "CDLL", cdll)
    start = threading.Barrier(4)

    def load(_):
        start.wait()
        return _build.load("follow")

    with ThreadPoolExecutor(4) as pool:
        libs = list(pool.map(load, range(4)))
    assert builds == [["follow"]] and len(opened) == 1
    assert all(lib is libs[0] for lib in libs)
