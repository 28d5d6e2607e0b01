"""HTTP front end for the tracking service.

The port of ``aicamera_tpu/server.py``: a stdlib ``ThreadingHTTPServer``
over a :class:`~aicamera_tpu_torch.serving.TrackingService`. Clients POST
raw frames and receive per-frame track JSON; one device-owning worker
batches concurrent requests into chunks (``serving.py``), the HTTP layer is
transport only.

Endpoints:
    GET  /v1/healthz   -> {"status": "ok", "backend": "cuda"|"cpu",
                           "device": the GPU's name, or "cpu"}
    GET  /v1/stats     -> {"frames": N, "wall_s": S, "fps": F}
    POST /v1/track     -> body: a raw (H, W, 3) uint8 BGR buffer with the
                          headers X-Frame-Height and X-Frame-Width, or an
                          encoded JPEG or PNG image (no such headers).
                          Response: {"frame_index": i, "tracks": [
                              [x1, y1, x2, y2, track_id, class_name, conf],
                              ...]}
    POST /v1/reset     -> fresh tracker state (ids restart at 1)

Encoded images are decoded by their bytes, whatever the ``Content-Type``,
as ``cv2.imdecode`` does in the JAX server: baseline JPEG by the port's own
codec (bitwise what ``cv2.imdecode`` gives, the EXIF orientation applied)
and PNG by ``utils/png.py``. A body that is neither, or a kind the decoders
refuse (a progressive JPEG, a 16-bit PNG), is answered 400 with the
reason.

Frames on all connections form one stream (single tenant). For many
independent tenant streams use
:class:`~aicamera_tpu_torch.serving.MultiTenantTrackingService` in-process.

Usage:
    python -m aicamera_tpu_torch.server --port 8321 [--device cpu]
        [--chunk 8] [--max_latency_ms 30] [--tracker deepsort]
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_BAD_FRAME = ("could not read the frame; send raw (H, W, 3) uint8 BGR bytes "
              "with X-Frame-Height/X-Frame-Width")


class TrackingHTTPServer:
    """Owns a TrackingService and a ThreadingHTTPServer around it."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8321,
                 service=None, **service_kwargs):
        if service is None:
            from .serving import TrackingService
            service = TrackingService(**service_kwargs)
        self.service = service
        self._frames = 0
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # quiet request logging (stdout noise at 1000s of fps)
            def log_message(self, *args):
                pass

            def _json(self, code: int, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/v1/healthz":
                    self._json(200, dict(status="ok", **outer.device_info()))
                elif self.path == "/v1/stats":
                    with outer._lock:
                        n = outer._frames
                        dt = time.perf_counter() - outer._t0
                    self._json(200, {"frames": n, "wall_s": round(dt, 3),
                                     "fps": round(n / dt, 2) if dt else 0.0})
                else:
                    self._json(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length)
                if self.path == "/v1/reset":
                    try:
                        outer.service.reset().result(timeout=30.0)
                    except Exception as e:
                        self._json(503, {"error": str(e)})
                        return
                    with outer._lock:
                        outer._frames = 0
                        outer._t0 = time.perf_counter()
                    self._json(200, {"status": "reset"})
                    return
                if self.path != "/v1/track":
                    self._json(404, {"error": f"unknown path {self.path}"})
                    return
                frame, error = outer._decode_frame(raw, self.headers)
                if frame is None:
                    self._json(400, {"error": error})
                    return
                try:
                    result = outer.service.submit(frame).result(timeout=30.0)
                except Exception as e:
                    self._json(503, {"error": str(e)})
                    return
                with outer._lock:
                    outer._frames += 1
                self._json(200, {
                    "frame_index": result.frame_index,
                    "tracks": [[int(x1), int(y1), int(x2), int(y2),
                                int(tid), cls, round(float(conf), 4)]
                               for (x1, y1, x2, y2, tid, cls, conf)
                               in result.tracks],
                })

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self.httpd.server_address[:2]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)

    def device_info(self) -> dict:
        """The torch device the service's pipeline runs on."""
        dev = self.service.pipeline.device
        if dev.type == "cuda":
            import torch
            return {"backend": "cuda",
                    "device": torch.cuda.get_device_name(dev)}
        return {"backend": dev.type, "device": str(dev)}

    @staticmethod
    def _decode_frame(raw: bytes, headers):
        """``(frame, None)`` for a raw frame, else ``(None, reason)``."""
        h = headers.get("X-Frame-Height")
        w = headers.get("X-Frame-Width")
        if h and w:  # raw uint8 BGR buffer
            try:
                h, w = int(h), int(w)
            except ValueError:
                return None, _BAD_FRAME
            if h <= 0 or w <= 0 or len(raw) != h * w * 3:
                return None, _BAD_FRAME
            return np.frombuffer(raw, np.uint8).reshape(h, w, 3), None
        from .utils.jpeg import decode_image
        try:
            return decode_image(raw), None
        except (ValueError, MemoryError) as e:
            return None, (f"could not decode the image ({e}); send a "
                          "baseline JPEG, a PNG, or raw (H, W, 3) uint8 BGR "
                          "bytes with X-Frame-Height/X-Frame-Width")

    def start(self):
        self._thread.start()
        return self

    def shutdown(self):
        """Stop accepting requests, drain the device worker. Idempotent."""
        self.httpd.shutdown()
        self.httpd.server_close()
        self.service.shutdown()


def main(argv=None):
    ap = argparse.ArgumentParser(description="AICamera tracking server "
                                 "(PyTorch/CUDA port)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8321)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--max_latency_ms", type=float, default=30.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the pipeline runs (default the GPU)")
    ap.add_argument("--tracker", default="deepsort",
                    choices=("deepsort", "bytetrack", "ocsort"),
                    help="tracker core behind the service")
    args = ap.parse_args(argv)

    server = TrackingHTTPServer(host=args.host, port=args.port,
                                chunk_size=args.chunk,
                                max_latency_ms=args.max_latency_ms,
                                tracker=args.tracker, device=args.device)
    print(f"AICamera tracking server on http://{server.host}:"
          f"{server.port} ({server.device_info()['device']}, "
          f"chunk={args.chunk}, latency window={args.max_latency_ms}ms)")
    server.start()
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("shutting down...")
        server.shutdown()


if __name__ == "__main__":
    main()
