"""Port: MJPEG ``.avi`` video I/O (``utils/avi.py``, ``utils/video_io.py``)
against OpenCV, on seeded scenes.

- A port-written AVI read through ``cv2.VideoCapture(path,
  CAP_OPENCV_MJPEG)`` (libjpeg) is bitwise the port's own encode-then-decode
  of each frame; through ``CAP_FFMPEG`` (another IDCT and chroma upsampler:
  values may differ by a few levels, so only the count, size and fps are
  compared) and through the JAX package's ``VideoReader`` (FFmpeg) it has
  the right frame count, size and fps.
- A cv2-written MJPEG AVI (``CAP_OPENCV_MJPEG``) read by the port's
  ``VideoReader`` and ``NativeVideoReader`` (1 and 3 threads) is bitwise
  what OpenCV reads.
- Past a lowered RIFF limit the writer goes on in OpenDML ``AVIX`` RIFFs;
  the port's readers and FFmpeg read every frame (OpenCV's own MJPEG
  backend reads the first RIFF only: it has no OpenDML support).
- The writer never drops a frame, and raises when a frame cannot be
  written.
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from aicamera_tpu_torch.scenes import moving_rectangles  # noqa: E402
from aicamera_tpu_torch.utils import avi, video_io  # noqa: E402
from aicamera_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg  # noqa

HW = (96, 128)


@pytest.fixture(scope="module")
def frames():
    return moving_rectangles(12, HW, n_objects=3, seed=5)


def _write(path, frames, fps=25.0, **kw):
    w = video_io.VideoWriter(str(path), fps, HW, **kw)
    for f in frames:
        w.write(f)
    w.release()
    return w


def _cv2_read(path, api):
    cap = cv2.VideoCapture(str(path), api)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return out, fps


def test_port_avi_reads_in_opencv_and_ffmpeg(tmp_path, frames):
    w = _write(tmp_path / "clip.mp4", frames, fps=29.97)
    assert w.path == tmp_path / "clip.avi" and w.frames_written == 12
    got, fps = _cv2_read(w.path, cv2.CAP_OPENCV_MJPEG)
    assert len(got) == 12 and fps == pytest.approx(29.97)
    for f, g in zip(frames, got):
        np.testing.assert_array_equal(g, decode_jpeg(encode_jpeg(f)))
    got, fps = _cv2_read(w.path, cv2.CAP_FFMPEG)
    assert len(got) == 12 and got[0].shape == (*HW, 3)
    assert fps == pytest.approx(29.97)
    # the JAX package's reader opens it through FFmpeg
    from aicamera_tpu.utils.video_io import VideoReader as JaxReader
    r = JaxReader(str(w.path))
    try:
        jax_frames = list(r.frames())
        assert (r.width, r.height) == (HW[1], HW[0])
        assert r.fps == pytest.approx(29.97)
        assert r.frame_count == 12 and len(jax_frames) == 12
    finally:
        r.release()
    index = avi.read_index(w.path)
    assert (index.width, index.height, index.frame_count) == (128, 96, 12)
    assert index.fps == pytest.approx(29.97)


@pytest.fixture(scope="module")
def cv2_clip(tmp_path_factory, frames):
    path = tmp_path_factory.mktemp("cv") / "cv.avi"
    vw = cv2.VideoWriter(str(path), cv2.CAP_OPENCV_MJPEG,
                         cv2.VideoWriter_fourcc(*"MJPG"), 24, (HW[1], HW[0]))
    for f in frames:
        vw.write(f)
    vw.release()
    want, fps = _cv2_read(path, cv2.CAP_OPENCV_MJPEG)
    assert len(want) == 12 and fps == 24
    return path, want


def test_video_reader_reads_a_cv2_mjpeg_avi(cv2_clip):
    path, want = cv2_clip
    r = video_io.VideoReader(str(path), queue_depth=2, max_frames=10)
    try:
        assert (r.width, r.height, r.frame_count, r.fps) == (128, 96, 12, 24)
        chunks = list(r.chunks(4))
    finally:
        r.release()
    assert [len(c) for c in chunks] == [4, 4, 2]
    np.testing.assert_array_equal(np.concatenate(chunks), np.stack(want[:10]))


@pytest.mark.parametrize("n_threads", [1, 3])
def test_native_reader_reads_a_cv2_mjpeg_avi(cv2_clip, n_threads):
    path, want = cv2_clip
    r = video_io.NativeVideoReader(str(path), n_threads=n_threads,
                                   queue_depth=4)
    try:
        assert (r.width, r.height, r.frame_count, r.fps) == (128, 96, 12, 24)
        chunks = list(r.chunks(5))
        assert len(r.read_chunk(3)) == 0
    finally:
        r.release()
    assert [len(c) for c in chunks] == [5, 5, 2]
    np.testing.assert_array_equal(np.concatenate(chunks), np.stack(want))
    r = video_io.NativeVideoReader(str(path), n_threads=n_threads,
                                   max_frames=3)
    assert len(list(r.frames())) == 3
    r.release()
    r.release()   # idempotent


def test_opendml_past_a_lowered_riff_limit(tmp_path, frames):
    w = _write(tmp_path / "long.avi", frames, riff_limit=20_000)
    data = w.path.read_bytes()
    assert data.count(b"AVIX") >= 2 and b"ix00" in data and b"indx" in data
    index = avi.read_index(w.path)
    assert index.frame_count == 12
    want = [decode_jpeg(encode_jpeg(f)) for f in frames]
    r = video_io.VideoReader(str(w.path))
    np.testing.assert_array_equal(np.stack(list(r.frames())), np.stack(want))
    r.release()
    r = video_io.NativeVideoReader(str(w.path), n_threads=2)
    np.testing.assert_array_equal(np.concatenate(list(r.chunks(5))),
                                  np.stack(want))
    r.release()
    got, fps = _cv2_read(w.path, cv2.CAP_FFMPEG)
    assert len(got) == 12 and fps == 25
    got, _ = _cv2_read(w.path, cv2.CAP_OPENCV_MJPEG)
    assert 0 < len(got) < 12     # OpenCV: the first RIFF's idx1 only
    for g, f in zip(got, want):
        np.testing.assert_array_equal(g, f)


def test_writer_never_drops_a_frame(tmp_path):
    """A backlog far beyond the queue (a queue of 2): ``release`` waits for
    all of them."""
    big = moving_rectangles(40, HW, n_objects=4, seed=9)
    w = _write(tmp_path / "all.avi", big, queue_depth=2)
    assert w.frames_written == 40
    assert avi.read_index(w.path).frame_count == 40
    r = video_io.VideoReader(str(w.path))
    got = list(r.frames())
    r.release()
    assert len(got) == 40
    np.testing.assert_array_equal(got[-1], decode_jpeg(encode_jpeg(big[-1])))


def test_writer_raises_instead_of_dropping(tmp_path, frames):
    w = video_io.VideoWriter(str(tmp_path / "bad.avi"), 30.0, HW)
    w.write(frames[0])
    w.write(np.zeros((10, 10, 3), np.uint8))      # the wrong size
    with pytest.raises(RuntimeError, match="video writer failed after 1"):
        w.release()


def test_inputs_still_not_ported(tmp_path):
    (tmp_path / "x.mp4").write_bytes(b"")
    for make in (lambda: video_io.VideoReader(0),
                 lambda: video_io.NativeVideoReader(1),
                 lambda: video_io.VideoReader(str(tmp_path / "x.mp4")),
                 lambda: video_io.NativeVideoReader(str(tmp_path / "x.mp4"))):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            make()
    with pytest.raises(ValueError, match="not an AVI"):
        avi.read_index(tmp_path / "x.mp4")
