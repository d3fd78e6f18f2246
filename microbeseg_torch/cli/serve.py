"""HTTP serving daemon on the port: a persistent engine behind a
zero-dependency API.

The port of ``microbeseg_tpu/cli/serve.py``, with the same protocol and the
same error codes.  One process holds the card and the engine, and segments
request payloads at steady-state speed.  Request decode and response encode
run on per-request threads and overlap another request's device section,
which one engine lock serialises (one card, one engine).  The engine itself
runs on one long-lived thread: PyTorch caches cuDNN's convolution plans per
thread, so on a new thread per request every forward rebuilt them
(``chip_smoke.py``'s serve phase times a fresh thread's first ``segment``
beside a warm one).  At
most four requests read and decode a body at once (a fixed semaphore): each
may buffer up to ``--max_body_mb``, so unbounded connections would bound
nothing.

  GET  /healthz             -> 200 JSON {model, label_type, ...}
  POST /segment             -> uint16 instance masks
       body: a TIFF (any shape infer_local supports) or a .npy array
       (magic-sniffed); query params: th_cell, th_seed, channel,
       format=npy|tif (response encoding, default npy)
       response: application/x-npy (T, H, W) uint16, or a multi-frame
       TIFF; X-Instances header = per-frame instance counts
  400 bad payload or parameters, 404 unknown path, 413 body above the
  limit (refused before reading it), 500 engine failure on a valid request

Run: ``python -m microbeseg_torch.cli.serve --model <stem> --port 8000``
(``--device cpu`` serves from the CPU).  Thresholds given per request
override the CLI defaults; engine-level options (tiling, TTA, ensemble,
quantize, batch size) are fixed at startup like the batch CLIs.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
from concurrent.futures import ThreadPoolExecutor
from http.server import (BaseHTTPRequestHandler, HTTPServer,
                         ThreadingHTTPServer)
from urllib.parse import parse_qs, urlparse

import numpy as np

from microbeseg_torch.cli.infer_local import build_engine, dispatch_shape
from microbeseg_torch.config import InferConfig
from microbeseg_torch.inference.engine import InferenceEngine

# requests that may read and decode a body at once
MAX_DECODING = 4


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="microbeSEG serving daemon (PyTorch/CUDA)")
    parser.add_argument("--model", "-m", required=True, type=str, nargs="+",
                        help="Model path; several paths form an ensemble")
    parser.add_argument("--thresholds", "-t", default=[0.10, 0.45],
                        type=float, nargs="+",
                        help="Default th_cell th_seed (per-request "
                        "query params override)")
    parser.add_argument("--host", default="127.0.0.1", type=str)
    parser.add_argument("--port", "-p", default=8000, type=int)
    parser.add_argument("--batch_size", "-b", default=8, type=int)
    parser.add_argument("--sliding_window", default=False,
                        action="store_true")
    parser.add_argument("--tile_size", default=1024, type=int)
    parser.add_argument("--tile_overlap", default=128, type=int)
    parser.add_argument("--quantize", default=False, action="store_true")
    parser.add_argument("--tta", default=False, action="store_true")
    parser.add_argument("--max_body_mb", default=512, type=int,
                        help="Reject request bodies above this size with "
                        "413 before reading them (largest supported frame, "
                        "8192^2 uint16, is 128 MB; a 2000-frame 256^2 "
                        "stack is 250 MB)")
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card)")
    return parser


def engine_from_args(args) -> InferenceEngine:
    cfg = InferConfig(th_cell=args.thresholds[0], th_seed=args.thresholds[1],
                      batch_size=args.batch_size,
                      use_tiling=args.sliding_window,
                      tile_size=args.tile_size,
                      tile_overlap=args.tile_overlap,
                      quantize=args.quantize, tta=args.tta)
    return build_engine(args.model, cfg, device=args.device)


def decode_payload(body: bytes, channel: int):
    """TIFF or .npy bytes -> (T, H, W) stack via the CLI shape dispatch."""
    if body[:6] == b"\x93NUMPY":
        arr = np.load(io.BytesIO(body), allow_pickle=False)
    else:
        from microbeseg_torch.utils.tiff import _pil, _promote

        with _pil().open(io.BytesIO(body)) as im:
            frames = []
            for i in range(getattr(im, "n_frames", 1)):
                im.seek(i)
                frames.append(np.asarray(_promote(im)))
        arr = frames[0] if len(frames) == 1 else np.stack(frames)
    return dispatch_shape(arr, channel)


def encode_masks(masks: np.ndarray, fmt: str) -> tuple[bytes, str]:
    if fmt == "tif":
        from microbeseg_torch.utils.tiff import _pil

        frames = [_pil().fromarray(m) for m in masks]
        buf = io.BytesIO()
        frames[0].save(buf, format="TIFF", save_all=len(frames) > 1,
                       append_images=frames[1:])
        return buf.getvalue(), "image/tiff"
    buf = io.BytesIO()
    np.save(buf, masks, allow_pickle=False)
    return buf.getvalue(), "application/x-npy"


def make_handler(engine: InferenceEngine, model_info: dict,
                 max_body_bytes: int = 512 * 1024 * 1024):
    # one card, one engine: the device section serializes here while
    # decode/encode of other requests proceed on their own threads; it runs
    # on the engine's own thread, which keeps its per-thread caches warm
    engine_lock = threading.Lock()
    engine_thread = ThreadPoolExecutor(max_workers=1,
                                       thread_name_prefix="engine")
    decoding = threading.BoundedSemaphore(MAX_DECODING)

    class Handler(BaseHTTPRequestHandler):
        # bound socket reads: a client that connects and never sends a
        # request would otherwise hold its thread forever
        # (BaseHTTPRequestHandler treats a timeout as connection close)
        timeout = 120

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                self._json(200, {"status": "ok", **model_info})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/segment":
                self._json(404, {"error": "unknown path"})
                return
            q = parse_qs(url.query)

            def qf(name, default):
                return float(q[name][0]) if name in q else default

            fmt = q.get("format", ["npy"])[0]
            if fmt == "tiff":
                fmt = "tif"
            if fmt not in ("npy", "tif"):
                self._json(400, {"error": f"unknown format {fmt!r} "
                                 "(use npy or tif)"})
                return
            # client errors (bad payload/params) -> 400; engine/device
            # failures on a valid request -> 500, so retrying clients and
            # monitoring see a server fault, not a rejected request
            try:
                length = int(self.headers.get("Content-Length", 0) or 0)
            except (TypeError, ValueError):
                self._json(400, {"error": "invalid Content-Length header"})
                return
            if length > max_body_bytes:
                # refuse BEFORE reading: the body never enters memory.  The
                # unread bytes make the connection unusable for a further
                # request, so close it (clients see the 413 first).
                self.close_connection = True
                self._json(413, {"error": f"payload {length} bytes exceeds "
                                 f"the {max_body_bytes}-byte limit"})
                return
            try:
                th_cell = qf("th_cell", engine.cfg.th_cell)
                th_seed = qf("th_seed", engine.cfg.th_seed)
                with decoding:
                    body = self.rfile.read(length)
                    channel = int(q.get("channel", ["0"])[0])
                    stack = decode_payload(body, channel)
                    del body
                if stack is None:
                    self._json(400, {"error": "unsupported image shape"})
                    return
            except Exception as exc:
                self._json(400, {"error": str(exc)})
                return
            try:
                with engine_lock:
                    masks = engine_thread.submit(
                        engine.segment, stack, th_cell=th_cell,
                        th_seed=th_seed).result()
                masks = masks if masks.ndim == 3 else masks[None]
                payload, ctype = encode_masks(masks, fmt)
            except Exception as exc:
                self._json(500, {"error": str(exc)})
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.send_header("X-Instances", ",".join(
                str(int(m.max())) for m in masks))
            self.end_headers()
            self.wfile.write(payload)

    Handler.engine_thread = engine_thread
    return Handler


class _Server(ThreadingHTTPServer):
    # worker threads must not block interpreter exit on a hung client
    daemon_threads = True

    def server_close(self):
        super().server_close()
        self.RequestHandlerClass.engine_thread.shutdown(wait=True)


def serve(engine: InferenceEngine, model_info: dict, host: str, port: int,
          server_cls=_Server,
          max_body_bytes: int = 512 * 1024 * 1024) -> HTTPServer:
    """Build the HTTP server (caller runs serve_forever / shutdown).

    Threaded: concurrent clients decode/encode in parallel, at most
    ``MAX_DECODING`` reading a body at once, while the engine lock
    serializes the device section on the engine's thread.  ``server_close``
    stops that thread."""
    return server_cls((host, port),
                      make_handler(engine, model_info, max_body_bytes))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if len(args.thresholds) != 2:
        raise ValueError(
            f"{len(args.thresholds)} thresholds given, needed are 2")
    engine = engine_from_args(args)
    info = {"model": [str(m) for m in args.model],
            "label_type": engine.label_type,
            "tta": args.tta, "tiling": args.sliding_window,
            "ensemble": len(args.model) > 1}
    httpd = serve(engine, info, args.host, args.port,
                  max_body_bytes=args.max_body_mb * 1024 * 1024)
    print(f"serving {args.model} on http://{args.host}:{args.port} "
          "(GET /healthz, POST /segment)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
