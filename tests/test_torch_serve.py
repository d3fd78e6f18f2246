"""The port's serving daemon on the CPU: real HTTP round trips.

Responses equal the same engine's ``segment`` bit for bit (npy and TIFF),
and reach per-frame IoU >= 0.99 against the JAX daemon on the same weights
(float32, highest matmul precision; the two engines' fields differ by ulps).
The status codes of every error case equal the JAX daemon's.  At most four
requests read and decode a body at once.  Every CLI parser of the port has
JAX's arguments with JAX's defaults, plus ``--device``.
"""

import importlib
import io
import json
import threading
import time
from http.client import HTTPConnection

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from microbeseg_tpu.config import InferConfig as JInferConfig
from microbeseg_tpu.inference.engine import InferenceEngine as JEngine
from microbeseg_tpu.models.io import load_model as jload
from microbeseg_torch.cli import serve as tserve
from microbeseg_torch.config import InferConfig
from microbeseg_torch.inference.engine import InferenceEngine
from tests.oracles import masks_iou
from tests.test_torch_engine import _frames, _thresholds, checkpoint  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Several test processes share the cores (see test_torch_engine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _start(httpd):
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return thread


def _stop(httpd, thread):
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=5)
    assert not thread.is_alive()


@pytest.fixture(scope="module")
def engine(checkpoint):  # noqa: F811
    eng = InferenceEngine.from_checkpoint(
        checkpoint, cfg=InferConfig(batch_size=4), device="cpu")
    th_cell, th_seed = _thresholds(eng.predict_raw(_frames(n=4, size=48))[1])
    eng.cfg = InferConfig(batch_size=4, th_cell=th_cell, th_seed=th_seed)
    return eng


@pytest.fixture(scope="module")
def servers(engine, checkpoint):  # noqa: F811
    """The port's daemon on ``engine`` and the JAX daemon on the same
    weights and thresholds (float32, highest precision)."""
    from microbeseg_tpu.cli import serve as jserve

    prec = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    model, variables, tcfg = jload(checkpoint, dtype=jnp.float32)
    jeng = JEngine(model, variables, tcfg.label_type, cfg=JInferConfig(
        batch_size=4, th_cell=engine.cfg.th_cell, th_seed=engine.cfg.th_seed))
    info = {"model": ["port_01"], "label_type": "distance"}
    ours = tserve.serve(engine, info, "127.0.0.1", 0)
    theirs = jserve.serve(jeng, info, "127.0.0.1", 0)
    threads = [_start(ours), _start(theirs)]
    try:
        yield ours.server_address, theirs.server_address
    finally:
        _stop(ours, threads[0])
        _stop(theirs, threads[1])
        jax.config.update("jax_default_matmul_precision", prec)


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def _tif(frames):
    from PIL import Image

    pil = [Image.fromarray(f) for f in frames]
    buf = io.BytesIO()
    pil[0].save(buf, format="TIFF", save_all=True, append_images=pil[1:])
    return buf.getvalue()


def _post(addr, path, body, headers=None):
    conn = HTTPConnection(*addr, timeout=120)
    conn.request("POST", path, body=body, headers=headers or {})
    resp = conn.getresponse()
    out = (resp.status, dict(resp.getheaders()), resp.read())
    conn.close()
    return out


def _masks(status, headers, data):
    assert status == 200, data
    if headers["Content-Type"] == "image/tiff":
        from PIL import Image

        with Image.open(io.BytesIO(data)) as im:
            out = []
            for i in range(getattr(im, "n_frames", 1)):
                im.seek(i)
                out.append(np.asarray(im))
        masks = np.stack(out)
    else:
        masks = np.load(io.BytesIO(data), allow_pickle=False)
    assert [int(c) for c in headers["X-Instances"].split(",")] == [
        int(m.max()) for m in masks]
    return masks


def test_healthz(servers):
    conn = HTTPConnection(*servers[0], timeout=30)
    conn.request("GET", "/healthz")
    resp = conn.getresponse()
    payload = json.loads(resp.read())
    conn.close()
    assert resp.status == 200
    assert payload == {"status": "ok", "model": ["port_01"],
                       "label_type": "distance"}


@pytest.mark.parametrize("fmt", ["npy", "tif"])
def test_responses_equal_segment_and_jax(servers, engine, fmt):
    """Bit for bit the engine's ``segment``; IoU >= 0.99 against JAX's
    daemon on the same request."""
    frames = _frames(n=4, size=48)  # 3 frames would read as 3 channels
    body = _npy(frames) if fmt == "npy" else _tif(frames)
    path = "/segment" + ("?format=tif" if fmt == "tif" else "")
    ours = _masks(*_post(servers[0], path, body))
    np.testing.assert_array_equal(ours, engine.segment(frames))
    theirs = _masks(*_post(servers[1], path, body))
    assert ours.shape == theirs.shape == frames.shape
    assert ours.dtype == np.uint16
    for a, b in zip(ours, theirs):
        assert len(np.unique(b)) > 2
        assert masks_iou(b, a) >= 0.99


def test_query_params_reach_the_engine(servers, engine):
    frames = _frames(n=2, size=48)
    th_cell = engine.cfg.th_cell * 1.3
    got = _masks(*_post(servers[0], f"/segment?th_cell={th_cell!r}&"
                        "channel=0", _npy(frames)))
    np.testing.assert_array_equal(got, engine.segment(frames, th_cell=th_cell))
    loose = _masks(*_post(servers[0], "/segment", _npy(frames)))
    assert (got > 0).sum() < (loose > 0).sum()
    # one (H, W) frame and an (H, W, 3) RGB frame by channel
    rgb = np.stack([frames[0], frames[1], frames[0]], axis=-1)
    got = _masks(*_post(servers[0], "/segment?channel=1", _npy(rgb)))
    np.testing.assert_array_equal(got[0], engine.segment(frames[1]))


def _raw(addr, method, path, headers, body=b""):
    conn = HTTPConnection(*addr, timeout=120)
    conn.putrequest(method, path)
    for k, v in headers.items():
        conn.putheader(k, v)
    conn.endheaders()
    if body:
        conn.send(body)
    resp = conn.getresponse()
    out = (resp.status, resp.read())
    conn.close()
    return out


_ERROR_CASES = {
    "bad payload": ("POST", "/segment", b"not an image"),
    "unknown POST path": ("POST", "/nope", b""),
    "unknown GET path": ("GET", "/nope", None),
    "unknown format": ("POST", "/segment?format=png", "npy"),
    "tiff alias": ("POST", "/segment?format=tiff", "npy"),
    "bad threshold": ("POST", "/segment?th_cell=abc", "npy"),
    "bad channel": ("POST", "/segment?channel=x", "npy"),
    "unsupported shape": ("POST", "/segment",
                          _npy(np.zeros((1, 1, 2, 2, 2), np.uint16))),
    "malformed Content-Length": ("POST", "/segment", "banana"),
    "oversized": ("POST", "/segment", "huge"),
}


@pytest.mark.parametrize("case", sorted(_ERROR_CASES))
def test_status_codes_match_jax(servers, case):
    method, path, body = _ERROR_CASES[case]
    frames_body = _npy(_frames(n=1, size=48))
    results = []
    for addr in servers:
        if body == "banana":
            results.append(_raw(addr, method, path,
                                {"Content-Length": "banana"}))
        elif body == "huge":
            # announce a body above the limit, send none: the daemon must
            # answer before reading
            results.append(_raw(addr, method, path,
                                {"Content-Length": str(600 * 1024 * 1024)}))
        elif method == "GET":
            results.append(_raw(addr, "GET", path, {}))
        else:
            data = frames_body if body == "npy" else body
            results.append(_raw(addr, method, path,
                                {"Content-Length": str(len(data))}, data))
    (ours, our_body), (theirs, their_body) = results
    assert ours == theirs
    assert ours in (200, 400, 404, 413)
    if ours != 200:
        assert set(json.loads(our_body)) == set(json.loads(their_body)) == {
            "error"}
    # the daemon is still alive afterwards
    assert _raw(servers[0], "GET", "/healthz", {})[0] == 200


def test_engine_failure_is_500_not_400():
    class ExplodingEngine:
        cfg = InferConfig()
        label_type = "distance"

        def segment(self, *a, **k):
            raise RuntimeError("CUDA out of memory: synthetic")

    httpd = tserve.serve(ExplodingEngine(), {"model": ["x"]}, "127.0.0.1", 0)
    thread = _start(httpd)
    try:
        status, _, data = _post(httpd.server_address, "/segment",
                                _npy(_frames(n=1, size=48)))
        assert status == 500
        assert "synthetic" in json.loads(data)["error"]
    finally:
        _stop(httpd, thread)


def test_concurrent_clients_correct_and_isolated(servers, engine):
    """4 clients x 2 requests at once: each response is ``segment`` of its
    own frames."""
    payloads = [_frames(n=2, size=40 + 4 * i) for i in range(4)]
    results = {}

    def client(i):
        for k in range(2):
            results[i, k] = _post(servers[0], "/segment", _npy(payloads[i]))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for (i, _), res in results.items():
        np.testing.assert_array_equal(_masks(*res),
                                      engine.segment(payloads[i]))
    assert len(results) == 8


def test_the_engine_runs_on_one_thread():
    """8 clients at once: every ``segment`` runs on the daemon's one engine
    thread (cuDNN caches its plans per thread), never two at a time, and
    ``server_close`` stops that thread."""
    seen, active, peak, guard = set(), [0], [0], threading.Lock()

    class RecordingEngine:
        cfg = InferConfig()
        label_type = "distance"

        def segment(self, frames, th_cell=None, th_seed=None):
            with guard:
                seen.add(threading.get_ident())
                active[0] += 1
                peak[0] = max(peak[0], active[0])
            time.sleep(0.02)
            with guard:
                active[0] -= 1
            return np.ones(np.asarray(frames).shape, np.uint16)

    httpd = tserve.serve(RecordingEngine(), {}, "127.0.0.1", 0)
    thread = _start(httpd)
    statuses = []
    clients = [threading.Thread(target=lambda: statuses.append(_post(
        httpd.server_address, "/segment", _npy(_frames(n=1, size=32)))[0]))
        for _ in range(8)]
    try:
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=120)
            assert not c.is_alive()
    finally:
        _stop(httpd, thread)
    assert statuses == [200] * 8 and peak[0] == 1
    assert len(seen) == 1 and threading.get_ident() not in seen
    assert not any(t.ident in seen for t in threading.enumerate())


def test_at_most_four_requests_decode_at_once(servers, monkeypatch):
    """10 clients at once, each decode held for 0.2 s: never more than 4
    inside read + decode (and more than one: they do overlap), and all
    answered."""
    active, peak, guard = [0], [0], threading.Lock()
    decode = tserve.decode_payload

    def slow_decode(body, channel):
        with guard:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        time.sleep(0.2)
        with guard:
            active[0] -= 1
        return decode(body, channel)

    monkeypatch.setattr(tserve, "decode_payload", slow_decode)
    body = _npy(_frames(n=1, size=32))
    statuses = []

    def client():
        statuses.append(_post(servers[0], "/segment", body)[0])

    threads = [threading.Thread(target=client) for _ in range(10)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert statuses == [200] * 10
    # without the semaphore all 10 would decode at once
    assert 2 <= peak[0] <= tserve.MAX_DECODING == 4


def test_main_needs_the_card_or_device_cpu(checkpoint, monkeypatch):  # noqa: F811
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--model", str(checkpoint), "--port", "0"])
    args = tserve.build_parser().parse_args(
        ["--model", str(checkpoint), "--device", "cpu", "-b", "2"])
    eng = tserve.engine_from_args(args)
    assert eng.device.type == "cpu" and eng.cfg.batch_size == 2


_PARSERS = {
    "serve": ["--model", "m"],
    "infer_store": ["-m", "m"],
    "infer_local": ["-i", "d", "-m", "m"],
    "train": [],
    "evaluate": ["-d", "d", "-m", "m"],
}


@pytest.mark.parametrize("cli", sorted(_PARSERS))
def test_parser_defaults_match_jax(cli):
    """Argument by argument: the same options, defaults, types, nargs,
    choices and required flags; the port adds only ``--device``."""
    jp = importlib.import_module(f"microbeseg_tpu.cli.{cli}").build_parser()
    tp = importlib.import_module(f"microbeseg_torch.cli.{cli}").build_parser()

    def table(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs,
                         a.choices, a.required, type(a).__name__)
                for a in parser._actions}

    ours, ref = table(tp), table(jp)
    assert set(ours) - set(ref) == {"device"}
    assert ours["device"][1] is None
    for dest, row in ref.items():
        assert ours[dest] == row, dest
    argv = _PARSERS[cli]
    ours = vars(tp.parse_args(argv))
    assert ours.pop("device") is None
    assert ours == vars(jp.parse_args(argv))


def test_profiling_matches_jax_and_traces(tmp_path):
    """``StepTimer`` is JAX's (same summary and report from the same
    durations); ``device_trace`` writes a Chrome trace of the block."""
    from microbeseg_tpu.utils.profiling import StepTimer as JStepTimer
    from microbeseg_torch.utils.profiling import StepTimer, device_trace

    ours, ref = StepTimer(), JStepTimer()
    for name, d in (("load", 0.25), ("step", 0.5), ("step", 0.125)):
        ours.durations[name].append(d)
        ref.durations[name].append(d)
    assert ours.summary() == ref.summary() and ours.report() == ref.report()
    with ours.phase("block"):
        pass
    assert ours.summary()["block"]["count"] == 1
    with device_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("aten::" in e.get("name", "") for e in trace["traceEvents"])

