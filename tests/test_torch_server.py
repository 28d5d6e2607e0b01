"""Port: the HTTP front end (``aicamera_tpu_torch/server.py``) on the CPU,
the cases of ``tests/test_server.py`` on ``127.0.0.1:0``.

Raw frames are tracked, and the tracks are those of the service behind the
server (ids, classes and boxes identical, conf to the 4 decimals the JSON
carries); an encoded image is answered 400, since the port has no image
decoder; ``reset`` restarts the ids; ``main`` parses the JAX server's flags
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
    """JPEG and PNG bodies cannot be decoded without OpenCV: 400, with a
    message that asks for raw frames."""
    for ctype in ("image/jpeg", "image/png"):
        status, body = _post(srv, "/v1/track", b"\xff\xd8\xff\xe0 not raw",
                             {"Content-Type": ctype})
        assert status == 400
        assert "X-Frame-Height" in body["error"] and "raw" in body["error"]


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
