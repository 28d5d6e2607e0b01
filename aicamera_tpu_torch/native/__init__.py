"""ctypes bindings for the port's host C++ (``native/*.cpp``).

The port of ``aicamera_tpu/native/__init__.py``. Two libraries, each built
on first use by ``ops/host_build.py`` (``c++ -O3 -std=c++17 -fPIC -shared
-pthread`` into the git-ignored ``_build/``) and loaded with
``ctypes.CDLL``, which releases the GIL during every call:

- ``aicam_host.cpp``: :func:`lapjv` (optimal assignment) and
  :func:`letterbox` (the fused CPU letterbox), the JAX wrapper's semantics;
  ``blend_glyphs``, the text of ``utils/visualization.py``;
  ``png_unfilter``, the scanline filters of ``utils/png.py``.
- ``jpeg.cpp``: baseline JPEG decode and encode and the threaded MJPEG frame
  decoder, used through ``utils/jpeg.py`` and ``utils/video_io.py``.

The JAX package degrades quietly when its build fails; here a missing
compiler or a failed build raises with the compiler's output
(:func:`available` and :func:`video_available` are True, or raise).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_lock = threading.Lock()
_libs: dict = {}

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int)
_f32p = ctypes.POINTER(ctypes.c_float)


def _bind_host(lib):
    lib.lapjv_solve.restype = ctypes.c_int
    lib.lapjv_solve.argtypes = [_f32p, ctypes.c_int, ctypes.c_int, _i32p]
    lib.letterbox_u8.restype = None
    lib.letterbox_u8.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, _f32p,
                                 *[ctypes.c_int] * 6]
    lib.blend_glyphs.restype = None
    lib.blend_glyphs.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, _u8p,
                                 _i32p, ctypes.c_int, _i32p]
    lib.png_unfilter.restype = ctypes.c_int
    lib.png_unfilter.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                 ctypes.c_int64, ctypes.c_int, _u8p]


def _bind_jpeg(lib):
    lib.jpeg_info.restype = ctypes.c_int
    lib.jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_int64, _i32p, _i32p,
                              _i32p, _i32p]
    lib.jpeg_decode.restype = ctypes.c_int
    lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, _u8p,
                                ctypes.c_int, ctypes.c_int]
    lib.jpeg_encode.restype = ctypes.c_int64
    lib.jpeg_encode.argtypes = [_u8p, *[ctypes.c_int] * 4, _u8p,
                                ctypes.c_int64]
    lib.mj_open.restype = ctypes.c_void_p
    lib.mj_open.argtypes = [ctypes.c_char_p,
                            ctypes.POINTER(ctypes.c_int64),
                            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                            *[ctypes.c_int] * 4]
    lib.mj_read.restype = ctypes.c_int
    lib.mj_read.argtypes = [ctypes.c_void_p, _u8p, ctypes.c_int]
    lib.mj_close.restype = None
    lib.mj_close.argtypes = [ctypes.c_void_p]


def _load(name: str, bind):
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            from ..ops import host_build
            lib = host_build.load_library(_DIR / f"{name}.cpp")
            bind(lib)
            _libs[name] = lib
        return lib


def host_lib():
    """The assignment and letterbox library (built on first use)."""
    return _load("aicam_host", _bind_host)


def jpeg_lib():
    """The JPEG and MJPEG library (built on first use)."""
    return _load("jpeg", _bind_jpeg)


def available() -> bool:
    """True once the host library is built and loaded; raises otherwise."""
    return host_lib() is not None


def video_available() -> bool:
    """True once the codec library is built and loaded; raises otherwise."""
    return jpeg_lib() is not None


def lapjv(cost: np.ndarray) -> np.ndarray:
    """Optimal assignment on an (nr, nc) cost matrix.

    Returns col4row (nr,) int32; when nr > nc the problem is solved on the
    transpose and rows left over get -1. Raises RuntimeError if the problem
    is infeasible.
    """
    lib = host_lib()
    cost = np.ascontiguousarray(cost, np.float32)
    nr, nc = cost.shape
    transposed = False
    if nr > nc:
        cost = np.ascontiguousarray(cost.T)
        nr, nc = nc, nr
        transposed = True
    col4row = np.empty(nr, np.int32)
    rc = lib.lapjv_solve(cost.ctypes.data_as(_f32p), nr, nc,
                         col4row.ctypes.data_as(_i32p))
    if rc != 0:
        raise RuntimeError(f"lapjv_solve failed: rc={rc}")
    if transposed:
        out = np.full(nc, -1, np.int32)
        out[col4row] = np.arange(nr, dtype=np.int32)
        return out
    return col4row


def letterbox(frame_bgr_u8: np.ndarray, spec) -> np.ndarray:
    """Fused host letterbox: (H, W, 3) uint8 BGR -> (Dh, Dw, 3) f32 RGB in
    [0, 1], 114-padded. ``spec`` is an ``ops.preprocess.LetterboxSpec``."""
    lib = host_lib()
    frame = np.ascontiguousarray(frame_bgr_u8, np.uint8)
    sh, sw = spec.src_hw
    dh, dw = spec.dst_hw
    out = np.empty((dh, dw, 3), np.float32)
    lib.letterbox_u8(frame.ctypes.data_as(_u8p), sh, sw,
                     out.ctypes.data_as(_f32p), dh, dw, spec.unpad_hw[0],
                     spec.unpad_hw[1], spec.top, spec.left)
    return out
