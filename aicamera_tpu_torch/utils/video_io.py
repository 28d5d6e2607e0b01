"""Video input: a threaded decode-ahead reader over a ``.npy`` frame file.

The port of ``aicamera_tpu/utils/video_io.py``, and the one place where the
port's input differs from the JAX package's: that reader decodes video files
and webcams with OpenCV, which the port does not import. :class:`VideoReader`
here has the same surface (``fps``, ``width``, ``height``, ``frame_count``,
``is_webcam``, ``max_frames``, ``frames()``, ``release()``, plus
``chunks(k)``) over a ``.npy`` file holding an ``(N, H, W, 3)`` uint8 BGR
array, which is memory-mapped and read ahead by a background thread into a
bounded queue, so that paging the file in overlaps the device work. Any other
input, :class:`NativeVideoReader` and :class:`VideoWriter` raise the
not-ported error.

Make such a file with ``numpy.save("frames.npy", frames)``, for example from
``aicamera_tpu_torch.scenes.moving_rectangles``.
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from .. import config, not_ported

class VideoReader:
    """Threaded frame reader over a ``.npy`` file of BGR frames."""

    def __init__(self, source, queue_depth: int = 64,
                 max_frames: Optional[int] = None):
        if isinstance(source, int):
            raise not_ported("webcam input (it needs OpenCV)")
        path = Path(str(source))
        if path.suffix != ".npy":
            raise not_ported(f"decoding {path.suffix or 'this'} input (it "
                             "needs OpenCV; pass a .npy file of frames)")
        if not path.exists():
            raise FileNotFoundError(f"Input video not found: {source}")
        self._array = np.load(path, mmap_mode="r")
        a = self._array
        if a.ndim != 4 or a.shape[-1] != 3 or a.dtype != np.uint8:
            raise ValueError(f"{path} holds {a.dtype}{a.shape}; expected an "
                             "(N, H, W, 3) uint8 array of BGR frames")
        self.is_webcam = False
        self.fps = float(config.DEFAULT_OUTPUT_FPS)  # a .npy names none
        self.height, self.width = int(a.shape[1]), int(a.shape[2])
        self.frame_count = int(a.shape[0])
        self.max_frames = max_frames
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._decode_loop,
                                        daemon=True)
        self._thread.start()

    def _decode_loop(self):
        n = self.frame_count if self.max_frames is None \
            else min(self.frame_count, self.max_frames)
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
        self._q.put(None)  # sentinel

    def frames(self) -> Iterator[np.ndarray]:
        while True:
            frame = self._q.get()
            if frame is None:
                return
            yield frame

    def chunks(self, k: int) -> Iterator[np.ndarray]:
        """``(n <= k, H, W, 3)`` chunks until the end of the file: the feed
        of ``TrackingPipeline.process_chunks``."""
        buf = []
        for frame in self.frames():
            buf.append(frame)
            if len(buf) == k:
                yield np.stack(buf)
                buf = []
        if buf:
            yield np.stack(buf)

    def release(self):
        self._stopped.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
        self._array = None


class NativeVideoReader:
    """The native C++ decoder's reader: not ported."""

    def __init__(self, *args, **kwargs):
        raise not_ported("NativeVideoReader (the native decoder needs "
                         "OpenCV)")


class VideoWriter:
    """The mp4 writer: not ported."""

    def __init__(self, *args, **kwargs):
        raise not_ported("VideoWriter (writing video needs OpenCV)")
