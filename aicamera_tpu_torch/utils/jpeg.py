"""Baseline JPEG decode and encode without OpenCV.

What ``cv2.imdecode(buf, cv2.IMREAD_COLOR)``, ``cv2.imread(path)`` and
``cv2.imencode(".jpg", frame)`` give, bit for bit, from the port's own
codec (``native/jpeg.cpp``, libjpeg-turbo's integer arithmetic; see its
header). The work runs in one ctypes call, with the GIL released.

- :func:`decode_jpeg`: an ``(H, W, 3)`` uint8 BGR array, gray replicated to
  three channels, the EXIF orientation applied as ``IMREAD_COLOR`` applies
  it. Progressive, arithmetic-coded, lossless, hierarchical, 12-bit and
  CMYK/YCCK files raise ``ValueError`` naming the kind.
- :func:`encode_jpeg`: cv2's defaults: quality 95, 4:2:0 (a gray frame:
  one component), baseline, standard Huffman tables, JFIF header.
- :func:`decode_image`: JPEG or PNG by the magic bytes, as ``imdecode``
  picks its decoder (PNG through ``utils/png.py``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

_ERRORS = {
    -1: "not a JPEG file (no SOI marker)",
    -2: "truncated JPEG data",
    -3: "progressive JPEG is not supported (baseline only)",
    -4: "arithmetic-coded JPEG is not supported (Huffman only)",
    -5: "lossless JPEG is not supported",
    -6: "hierarchical JPEG is not supported",
    -7: "12-bit JPEG is not supported (8-bit only)",
    -8: "CMYK/YCCK JPEG is not supported",
    -9: "JPEG with neither 1 nor 3 components is not supported",
    -10: "JPEG sampling factors beyond 2x2 are not supported",
    -11: "JPEG with a missing or bad Huffman or quantization table",
    -12: "corrupt JPEG entropy-coded data",
    -13: "JPEG without a frame header",
    -14: "I/O error reading JPEG data",
    -15: "JPEG frame of another size than expected",
    -16: "JPEG larger than 2**30 pixels (OpenCV's CV_IO_MAX_IMAGE_PIXELS)",
    -17: "out of memory decoding or encoding JPEG",
}
_SOI = b"\xff\xd8"
_PNG = b"\x89PNG\r\n\x1a\n"


def error_name(code: int) -> str:
    return _ERRORS.get(code, f"JPEG error {code}")


def _lib():
    from .. import native
    return native.jpeg_lib()


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ``ApplyExifOrientation`` for tags 2-8."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}
    axes = flip.get(orientation)
    if axes:
        img = np.flip(img, axes)
    return np.ascontiguousarray(img)


def jpeg_info(data: bytes):
    """``(width, height, components, orientation)`` from a JPEG's headers."""
    w, h, n, o = (ctypes.c_int() for _ in range(4))
    rc = _lib().jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h),
                          ctypes.byref(n), ctypes.byref(o))
    if rc:
        raise ValueError(error_name(rc))
    return w.value, h.value, n.value, o.value


def decode_jpeg(data: bytes, apply_orientation: bool = True) -> np.ndarray:
    """Decode JPEG bytes to an ``(H, W, 3)`` uint8 BGR array."""
    data = bytes(data)
    w, h, _, orientation = jpeg_info(data)
    out = np.empty((h, w, 3), np.uint8)
    rc = _lib().jpeg_decode(data, len(data),
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                            w, h)
    if rc:
        raise ValueError(error_name(rc))
    return _orient(out, orientation) if apply_orientation else out


def read_jpeg(path: str | Path) -> np.ndarray:
    """``cv2.imread(path)`` for a JPEG file."""
    return decode_jpeg(Path(path).read_bytes())


def encode_jpeg(frame: np.ndarray, quality: int = 95) -> bytes:
    """Encode an ``(H, W, 3)`` uint8 BGR (or ``(H, W)`` gray) frame."""
    frame = np.ascontiguousarray(frame, np.uint8)
    if frame.ndim == 2:
        channels = 1
    elif frame.ndim == 3 and frame.shape[2] in (1, 3):
        channels = frame.shape[2]
    else:
        raise ValueError(f"cannot encode an array of shape {frame.shape}")
    h, w = frame.shape[:2]
    lib = _lib()
    cap = h * w * channels + 4096
    src = frame.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.jpeg_encode(src, w, h, channels, int(quality),
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                            cap)
        if n >= 0:
            return out[:n].tobytes()
        if n > -1000:
            raise ValueError(error_name(int(n)))
        cap = -int(n) - 1000


def decode_image(raw: bytes) -> np.ndarray:
    """JPEG or PNG bytes to an ``(H, W, 3)`` uint8 BGR array, the decoder
    picked by the magic bytes; ``ValueError`` for anything else."""
    if raw[:2] == _SOI:
        return decode_jpeg(raw)
    if raw[:8] == _PNG:
        from .png import decode_png
        return decode_png(raw)
    raise ValueError("neither a JPEG nor a PNG image")
