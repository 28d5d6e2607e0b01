"""Port: the HTTP front end (``aicamera_tpu_torch/server.py``) on the CPU,
the cases of ``tests/test_server.py`` on ``127.0.0.1:0``.

Raw frames are tracked, and the tracks are those of the service behind the
server (ids, classes and boxes identical, conf to the 4 decimals the JSON
carries); JPEG and PNG bodies are decoded as the JAX server decodes them
and tracked, an undecodable body is answered 400; ``reset`` restarts the ids; ``main`` parses the JAX server's flags
with ``--device cuda|cpu`` (default the GPU)."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aicamera_tpu_torch import config, server  # noqa: E402
from aicamera_tpu_torch.core.state import TrackerParams  # noqa: E402
from aicamera_tpu_torch.runtime.pipeline import TrackingPipeline  # noqa: E402
from aicamera_tpu_torch.scenes import moving_rectangles  # noqa: E402
from aicamera_tpu_torch.server import TrackingHTTPServer  # noqa: E402
from aicamera_tpu_torch.serving import TrackingService  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    PyTorch's thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FRAME_HW = (96, 128)
PIPE_KW = dict(input_shape=(128, 128), chunk_size=2, max_reid_crops=4,
               device="cpu",
               tracker_params=TrackerParams(max_tracks=16, max_detections=8,
                                            nn_budget=4, max_age=10),
               yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
               reid_weights=str(config.REID_SYNTHETIC_PATH))
RAW = {"X-Frame-Height": str(FRAME_HW[0]), "X-Frame-Width": str(FRAME_HW[1])}


@pytest.fixture(scope="module")
def srv():
    svc = TrackingService(pipeline=TrackingPipeline(**PIPE_KW),
                          chunk_size=2, max_latency_ms=10.0)
    s = TrackingHTTPServer(host="127.0.0.1", port=0, service=svc).start()
    yield s
    s.shutdown()


def _url(s, path):
    return f"http://127.0.0.1:{s.port}{path}"


def _post(s, path, body=b"", headers=None):
    req = urllib.request.Request(_url(s, path), data=body,
                                 headers=headers or {}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(s, path):
    with urllib.request.urlopen(_url(s, path), timeout=30) as r:
        return json.loads(r.read())


def test_healthz_names_the_torch_device(srv):
    body = _get(srv, "/v1/healthz")
    assert body == {"status": "ok", "backend": "cpu", "device": "cpu"}


def test_track_raw_frames_and_stats(srv):
    rng = np.random.RandomState(0)
    frame = rng.randint(0, 255, (*FRAME_HW, 3), np.uint8)
    indices = []
    for _ in range(3):
        status, body = _post(srv, "/v1/track", frame.tobytes(), RAW)
        assert status == 200
        assert isinstance(body["tracks"], list)
        indices.append(body["frame_index"])
    assert indices == sorted(indices)  # per-stream ordering
    stats = _get(srv, "/v1/stats")
    assert stats["frames"] >= 3 and stats["fps"] > 0


def test_tracks_equal_the_service_after_reset(srv):
    """After ``reset``, raw POSTs of a scene give the tracks of a fresh
    pipeline over the same frames (one request at a time: each rides a
    padded chunk of its own), ids from 1."""
    status, body = _post(srv, "/v1/reset")
    assert status == 200 and body == {"status": "reset"}
    assert _get(srv, "/v1/stats")["frames"] == 0
    frames = moving_rectangles(6, FRAME_HW, n_objects=3, seed=3)
    got = []
    for f in frames:
        status, body = _post(srv, "/v1/track", f.tobytes(), RAW)
        assert status == 200
        got.append(body["tracks"])
    ref = TrackingPipeline(**PIPE_KW)
    want = [ref.process_frame(f).tracks for f in frames]
    assert [[t[:6] for t in g] for g in got] == \
        [[list(t[:6]) for t in w] for w in want]
    for g, w in zip(got, want):
        for tg, tw in zip(g, w):
            assert tg[6] == pytest.approx(round(tw[6], 4), abs=1e-4)
    assert min(t[4] for g in got for t in g) == 1


def test_image_body_is_answered_400(srv):
    """Encoded bodies are decoded by their bytes, whatever the Content-Type,
    as the JAX server's ``cv2.imdecode`` does: a JPEG and a PNG body give
    the frame the JAX server decodes, bitwise, and the tracks of the same
    frames POSTed raw (one at a time after a reset each); a progressive
    JPEG, which the baseline decoder refuses, and a garbage body are
    answered 400 with the reason."""
    import cv2
    from aicamera_tpu.server import TrackingHTTPServer as JaxServer
    frames = moving_rectangles(4, FRAME_HW, n_objects=3, seed=3)
    bodies = {
        "jpeg": [cv2.imencode(".jpg", f)[1].tobytes() for f in frames],
        "png": [cv2.imencode(".png", f)[1].tobytes() for f in frames]}
    for kind, encoded in bodies.items():
        decoded = []
        for body in encoded:
            got, err = TrackingHTTPServer._decode_frame(body, {})
            assert err is None
            want = JaxServer._decode_frame(body, {})
            np.testing.assert_array_equal(got, want)
            decoded.append(got)
        assert _post(srv, "/v1/reset")[0] == 200   # the same frames raw
        raw_tracks = []
        for f in decoded:
            status, body = _post(srv, "/v1/track", f.tobytes(), RAW)
            assert status == 200
            raw_tracks.append(body["tracks"])
        assert sum(map(len, raw_tracks)) > 0
        if kind == "png":              # lossless
            np.testing.assert_array_equal(np.stack(decoded), frames)
        assert _post(srv, "/v1/reset")[0] == 200
        got_tracks = []
        for body, ctype in zip(encoded, ("image/jpeg", "image/png",
                                         "application/octet-stream", "")):
            status, reply = _post(srv, "/v1/track", body,
                                  {"Content-Type": ctype} if ctype else {})
            assert status == 200, reply
            got_tracks.append(reply["tracks"])
        assert got_tracks == raw_tracks, kind
    progressive = cv2.imencode(".jpg", frames[0],
                               [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1]
    for body, why in ((progressive.tobytes(), "progressive"),
                      (b"\xff\xd8\xff\xe0 not raw", "JPEG"),
                      (b"GIF89a not raw", "neither a JPEG nor a PNG")):
        status, reply = _post(srv, "/v1/track", body,
                              {"Content-Type": "image/jpeg"})
        assert status == 400
        assert why in reply["error"] and "X-Frame-Height" in reply["error"]


def _png_with(png: bytes, ihdr=None, idat=None) -> bytes:
    """``png`` with its IHDR and IDAT bodies replaced, the CRCs valid."""
    import struct
    import zlib
    out, pos, idat_done = [png[:8]], 8, False
    while pos < len(png):
        (length,) = struct.unpack(">I", png[pos:pos + 4])
        kind, body = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR" and ihdr is not None:
            body = ihdr(body)
        if kind == b"IDAT" and idat is not None:
            if idat_done:
                continue
            body, idat_done = idat(body), True
        out.append(struct.pack(">I", len(body)) + kind + body
                   + struct.pack(">I", zlib.crc32(kind + body)))
    return b"".join(out)


def _hostile_bodies():
    """Small bodies that claim huge frames or hold corrupt data."""
    import struct
    import zlib

    import cv2
    frame = moving_rectangles(1, (16, 16), n_objects=1, seed=5)[0]
    jpeg = cv2.imencode(".jpg", frame)[1].tobytes()
    sof = jpeg.index(b"\xff\xc0")          # height, width at +5, +7
    huge_jpeg = (jpeg[:sof + 5] + struct.pack(">HH", 65535, 65535)
                 + jpeg[sof + 9:])
    png = cv2.imencode(".png", frame)[1].tobytes()
    rows = zlib.decompress(png[png.index(b"IDAT") + 4:])  # one IDAT here

    def size(w, h):
        return lambda body: struct.pack(">II", w, h) + body[8:]

    return {
        "jpeg_65535x65535": (huge_jpeg, "2**30 pixels"),
        "png_65535x65535": (_png_with(png, ihdr=size(65535, 65535)),
                            "larger than"),
        "png_corrupt_zlib": (_png_with(png, idat=lambda b: b[:2] + bytes(
            x ^ 0x5A for x in b[2:])), "corrupt image data"),
        "png_inflates_past_its_header": (_png_with(png, idat=lambda b: (
            zlib.compress(bytes(50 << 20)))), "bytes of image data"),
        "png_unknown_filter": (_png_with(png, idat=lambda b: zlib.compress(
            b"\x07" + rows[1:])), "unknown filter type 7"),
    }


@pytest.mark.parametrize("case", ["jpeg_65535x65535", "png_65535x65535",
                                  "png_corrupt_zlib",
                                  "png_inflates_past_its_header",
                                  "png_unknown_filter"])
def test_hostile_bodies_are_answered_400(srv, case):
    """A few hundred bytes that claim a 65535x65535 frame are refused before
    the decoder allocates anything for it (OpenCV's 2**30-pixel cap); a
    PNG whose zlib stream is corrupt, inflates past its header's size or
    names an unknown filter is refused too. Each gets 400 with the reason,
    the server's memory does not grow, and the server answers after."""
    import resource
    body, why = _hostile_bodies()[case]
    assert len(body) < 60_000
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    status, reply = _post(srv, "/v1/track", body,
                          {"Content-Type": "image/png"})
    grown_kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    assert status == 400, reply
    assert why in reply["error"], reply["error"]
    assert grown_kib < 64 * 1024, grown_kib
    assert _get(srv, "/v1/healthz")["status"] == "ok"


def test_reset_and_bad_input(srv):
    status, body = _post(srv, "/v1/reset")
    assert status == 200 and body["status"] == "reset"
    status, _ = _post(srv, "/v1/track", b"not-an-image")
    assert status == 400
    status, _ = _post(srv, "/v1/track", b"\x00" * 10, RAW)   # wrong size
    assert status == 400
    status, _ = _post(srv, "/v1/track", b"", {"X-Frame-Height": "x",
                                             "X-Frame-Width": "2"})
    assert status == 400
    status, _ = _post(srv, "/v1/nope")
    assert status == 404
    with pytest.raises(urllib.error.HTTPError):
        _get(srv, "/v1/nope")


def test_main_builds_the_server_from_its_flags(monkeypatch):
    """``main``: the JAX server's flags, ``--device`` cuda (default) or
    cpu; the service gets the chunk, the latency window, the tracker and
    the device."""
    seen = {}

    class Stop(Exception):
        pass

    class Fake:
        def __init__(self, **kw):
            seen.update(kw)
            self.host, self.port = kw["host"], kw["port"]

        def device_info(self):
            return {"backend": seen["device"], "device": seen["device"]}

        def start(self):
            raise Stop

    monkeypatch.setattr(server, "TrackingHTTPServer", Fake)
    with pytest.raises(Stop):
        server.main(["--port", "0", "--chunk", "4", "--max_latency_ms", "12",
                     "--tracker", "bytetrack", "--device", "cpu"])
    assert seen == dict(host="0.0.0.0", port=0, chunk_size=4,
                        max_latency_ms=12.0, tracker="bytetrack",
                        device="cpu")
    with pytest.raises(Stop):
        server.main([])
    assert seen["device"] == "cuda" and seen["chunk_size"] == 8
    with pytest.raises(SystemExit):
        server.main(["--device", "tpu"])


def test_server_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU error cannot be shown")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrackingHTTPServer(host="127.0.0.1", port=0, input_shape=(128, 128))
