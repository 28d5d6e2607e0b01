"""Video I/O without OpenCV: threaded readers and a threaded writer.

The port of ``aicamera_tpu/utils/video_io.py``, with the same surfaces. The
JAX package decodes and encodes through OpenCV (FFmpeg); the port has its
own baseline JPEG codec (``native/jpeg.cpp``) and an AVI container
(``utils/avi.py``), so it reads and writes Motion-JPEG ``.avi`` files, the
format OpenCV's own ``CAP_OPENCV_MJPEG`` backend reads and writes, plus
``.npy`` files of frames:

- :class:`VideoReader`: a ``.npy`` file of ``(N, H, W, 3)`` uint8 BGR frames
  (memory-mapped), read ahead by a background thread into a bounded queue,
  or an MJPEG ``.avi``, decoded ahead by one C++ worker of
  :class:`NativeVideoReader` with the GIL released, so it overlaps the
  device loop.
- :class:`NativeVideoReader`: an MJPEG ``.avi`` decoded by C++ threads into a
  bounded ring; :meth:`~NativeVideoReader.read_chunk` drains ``k`` frames in
  one ctypes call. Every MJPEG frame is intra-coded, so ``n_threads``
  workers split the frame index among themselves.
- :class:`VideoWriter`: a threaded MJPEG ``.avi`` writer (JPEG quality 95,
  4:2:0, as ``cv2.imencode`` defaults to). A ``.mp4`` (or any other) name
  becomes ``.avi``, as the JAX writer falls back to ``.avi`` when mp4 is not
  available; ``writer.path`` is the file written. :meth:`~VideoWriter.
  release` waits for every queued frame and raises if encoding or writing
  failed: no frame is dropped silently.

Webcams (no V4L2 capture), ``.mp4`` and other containers (H.264/MPEG-4
need a codec the port does not have) raise the not-ported error.
"""

from __future__ import annotations

import ctypes
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

from .. import config, not_ported

_WINDOW_BYTES = 512 << 20   # NativeVideoReader's ring, at most


def _usable_cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # non-Linux
        return os.cpu_count() or 1


def _check_source(source) -> Path:
    if isinstance(source, int):
        raise not_ported(f"webcam input (camera {source}: the port has no "
                         "V4L2 capture; pass an MJPEG .avi or a .npy file)")
    path = Path(str(source))
    if path.suffix.lower() not in (".npy", ".avi"):
        raise not_ported(
            f"decoding {path.suffix or 'this'} input (H.264/MPEG-4 and "
            "other codecs need OpenCV/FFmpeg; pass an MJPEG .avi or a .npy "
            "file of frames)")
    if not path.exists():
        raise FileNotFoundError(f"Input video not found: {source}")
    return path


class VideoReader:
    """Threaded frame reader over a ``.npy`` file or an MJPEG ``.avi`` (the
    latter a one-worker :class:`NativeVideoReader`)."""

    def __init__(self, source, queue_depth: int = 64,
                 max_frames: Optional[int] = None):
        path = _check_source(source)
        self.is_webcam = False
        self.max_frames = max_frames
        self._native = None
        if path.suffix.lower() == ".avi":
            self._native = NativeVideoReader(path, queue_depth=queue_depth,
                                             max_frames=max_frames,
                                             n_threads=1)
            for k in ("fps", "height", "width", "frame_count"):
                setattr(self, k, getattr(self._native, k))
            return
        self._array = a = np.load(path, mmap_mode="r")
        if a.ndim != 4 or a.shape[-1] != 3 or a.dtype != np.uint8:
            raise ValueError(f"{path} holds {a.dtype}{a.shape}; expected "
                             "an (N, H, W, 3) uint8 array of BGR frames")
        self.fps = float(config.DEFAULT_OUTPUT_FPS)  # a .npy names none
        self.height, self.width = int(a.shape[1]), int(a.shape[2])
        self.frame_count = int(a.shape[0])
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._stopped = threading.Event()
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._read_loop, daemon=True)
        self._thread.start()

    def _read_loop(self):
        n = self.frame_count if self.max_frames is None \
            else min(self.frame_count, self.max_frames)
        try:
            for i in range(n):
                frame = np.array(self._array[i])  # pages the frame in
                while not self._stopped.is_set():
                    try:
                        self._q.put(frame, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stopped.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised by frames()
            self.error = e
        self._q.put(None)  # sentinel

    def frames(self) -> Iterator[np.ndarray]:
        if self._native is not None:
            yield from self._native.frames()
            return
        while True:
            frame = self._q.get()
            if frame is None:
                if self.error is not None:
                    raise self.error
                return
            yield frame

    def chunks(self, k: int) -> Iterator[np.ndarray]:
        """``(n <= k, H, W, 3)`` chunks until the end of the input: the feed
        of ``TrackingPipeline.process_chunks``."""
        if self._native is not None:
            yield from self._native.chunks(k)
            return
        buf = []
        for frame in self.frames():
            buf.append(frame)
            if len(buf) == k:
                yield np.stack(buf)
                buf = []
        if buf:
            yield np.stack(buf)

    def release(self):
        if self._native is not None:
            self._native.release()
            return
        self._stopped.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
        self._array = None


class NativeVideoReader:
    """An MJPEG ``.avi`` decoded by C++ threads (``native/jpeg.cpp``).

    Decode runs on ``n_threads`` C++ workers with no GIL involvement, each
    taking the next frame of the index, into a ring of ``queue_depth``
    frames (default 64; never more than fit in 512 MiB, nor fewer than two
    a worker); frames are
    drained in whole chunks with one ctypes call per :meth:`read_chunk`.
    Same surface as :class:`VideoReader` (``frames()``, ``fps/width/height/
    frame_count/is_webcam``, ``release``) plus :meth:`read_chunk`.
    ``n_threads=None`` uses ``min(4, usable cores)``.
    """

    def __init__(self, source, queue_depth: Optional[int] = None,
                 max_frames: Optional[int] = None,
                 n_threads: Optional[int] = None):
        from .. import native
        from . import avi
        path = _check_source(source)
        if path.suffix.lower() != ".avi":
            raise ValueError(f"{path}: NativeVideoReader reads MJPEG .avi "
                             "files; use VideoReader for .npy frames")
        if n_threads is None:
            n_threads = min(4, max(1, _usable_cores()))
        index = avi.read_index(path)
        self.is_webcam = False
        self.width, self.height = index.width, index.height
        self.fps = index.fps or float(config.DEFAULT_OUTPUT_FPS)
        n = index.frame_count if max_frames is None \
            else min(index.frame_count, int(max_frames))
        self.frame_count = index.frame_count
        self.max_frames = max_frames
        frame_bytes = self.width * self.height * 3
        depth = max(2 * int(n_threads), min(
            int(queue_depth or 64), _WINDOW_BYTES // max(frame_bytes, 1)))
        self._lib = native.jpeg_lib()
        self._offsets = np.ascontiguousarray(index.offsets[:n], np.int64)
        self._sizes = np.ascontiguousarray(index.sizes[:n], np.int32)
        handle = self._lib.mj_open(
            str(path).encode(),
            self._offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self._sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n, self.width, self.height, max(1, int(n_threads)), depth)
        if not handle:
            raise RuntimeError(f"Could not open video source: {source}")
        self._handle = handle

    def read_chunk(self, k: int) -> np.ndarray:
        """Block until k frames are decoded (or the end) and return them as
        one (n, H, W, 3) BGR uint8 array, n <= k; n == 0 at the end."""
        if self._handle is None:
            return np.zeros((0, self.height, self.width, 3), np.uint8)
        buf = np.empty((k, self.height, self.width, 3), np.uint8)
        n = self._lib.mj_read(
            self._handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            k)
        if n < 0:
            from .jpeg import error_name
            raise RuntimeError(f"native video read failed: {error_name(n)}")
        return buf[:n]

    def chunks(self, k: int) -> Iterator[np.ndarray]:
        """Yield ``(n <= k, H, W, 3)`` chunks until the end of the stream:
        the feed for ``TrackingPipeline.process_chunks``."""
        while True:
            chunk = self.read_chunk(k)
            if len(chunk) == 0:
                return
            yield chunk

    def frames(self) -> Iterator[np.ndarray]:
        while True:
            chunk = self.read_chunk(1)
            if len(chunk) == 0:
                return
            yield chunk[0]

    def release(self):
        if self._handle is not None:
            self._lib.mj_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass


class VideoWriter:
    """Threaded MJPEG ``.avi`` writer: up to 4 threads encode (ctypes
    calls, the GIL released) and one thread appends the frames in order.
    ``riff_limit`` is the RIFF size past which the file goes on in OpenDML
    ``AVIX`` lists (``utils/avi.py``)."""

    def __init__(self, path: str, fps: float, frame_hw: Tuple[int, int],
                 queue_depth: int = 128, riff_limit: Optional[int] = None):
        from . import avi
        from .. import native
        native.jpeg_lib()        # build the codec now, not in a thread
        path = Path(path)
        if path.suffix.lower() != ".avi":
            path = path.with_suffix(".avi")   # MJPEG lives in AVI
        path.parent.mkdir(parents=True, exist_ok=True)
        self.path = path
        self.frame_hw = tuple(int(v) for v in frame_hw)
        self.frames_written = 0
        kw = {} if riff_limit is None else {"riff_limit": riff_limit}
        self._avi = avi.AviWriter(path, fps, self.frame_hw, **kw)
        self._pool = ThreadPoolExecutor(
            max_workers=min(4, max(1, _usable_cores())),
            thread_name_prefix="mjpeg-encode")
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._error: Optional[BaseException] = None
        self._released = False
        self._thread = threading.Thread(target=self._write_loop, daemon=True)
        self._thread.start()

    def _encode(self, frame: np.ndarray) -> bytes:
        from .jpeg import encode_jpeg
        if frame.shape != (*self.frame_hw, 3) or frame.dtype != np.uint8:
            raise ValueError(f"frame {frame.dtype}{frame.shape} for a "
                             f"{self.frame_hw[1]}x{self.frame_hw[0]} video")
        return encode_jpeg(frame)

    def _write_loop(self):
        while True:
            fut = self._q.get()
            if fut is None:
                return
            if self._error is not None:
                continue                      # drain after a failure
            try:
                self._avi.write(fut.result())
                self.frames_written += 1
            except BaseException as e:  # noqa: BLE001 - raised by release()
                self._error = e

    def write(self, frame: np.ndarray):
        if self._error is not None:
            raise RuntimeError(f"video writer failed: {self._error}") \
                from self._error
        self._q.put(self._pool.submit(self._encode, frame))

    def release(self):
        """Write every queued frame, close the file; raise if any frame
        could not be encoded or written."""
        if self._released:
            return
        self._released = True
        self._q.put(None)
        self._thread.join()
        self._pool.shutdown(wait=True)
        self._avi.close()
        if self._error is not None:
            raise RuntimeError(f"video writer failed after "
                               f"{self.frames_written} frames: "
                               f"{self._error}") from self._error
