"""PNG decoding with the standard library's ``zlib``: frames without OpenCV.

Reads non-interlaced 8-bit grayscale, RGB and RGBA PNGs (filter types 0-4,
undone by ``png_unfilter`` in ``native/aicam_host.cpp``; chunk CRCs
checked) into what ``cv2.imread(path)`` returns for them: an
``(H, W, 3)`` uint8 BGR array, gray replicated to three channels and alpha
dropped. Any other kind of PNG raises ``ValueError`` naming what it holds.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}      # colour type -> samples a pixel
MAX_PIXELS = 1 << 30   # OpenCV's CV_IO_MAX_IMAGE_PIXELS default
_KINDS = {0: "grayscale", 2: "RGB", 3: "palette", 4: "grayscale+alpha",
          6: "RGBA"}


def read_png(path: str | Path) -> np.ndarray:
    """Decode the PNG file at ``path`` to an ``(H, W, 3)`` uint8 BGR array."""
    return decode_png(Path(path).read_bytes(), str(path))


def _chunks(data: bytes, name: str):
    pos = len(_SIGNATURE)
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        end = pos + 12 + length
        if end > len(data):
            raise ValueError(f"{name}: truncated {kind!r} chunk")
        (crc,) = struct.unpack(">I", data[end - 4:end])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{name}: bad CRC in the {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos = end
    raise ValueError(f"{name}: no IEND chunk")


def decode_png(data: bytes, name: str = "PNG") -> np.ndarray:
    """Decode PNG bytes to an ``(H, W, 3)`` uint8 BGR array."""
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{name}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(
            f"{name}: {depth}-bit {_KINDS.get(ctype, f'colour type {ctype}')}"
            f"{', interlaced' if interlace else ''} PNG; only non-interlaced "
            "8-bit grayscale, RGB and RGBA are read")
    if w * h > MAX_PIXELS:
        raise ValueError(f"{name}: {w}x{h} PNG is larger than {MAX_PIXELS} "
                         "pixels")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    need = h * (stride + 1)
    try:   # never more than the header's size, whatever the stream holds
        raw = zlib.decompressobj().decompress(b"".join(idat), need + 1)
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt image data ({e})") from None
    if len(raw) != need:
        raise ValueError(f"{name}: {len(raw)} bytes of image data for "
                         f"{w}x{h}")
    out = np.empty((h, w, bpp), np.uint8)
    from .. import native
    bad = native.host_lib().png_unfilter(
        raw, h, stride, bpp, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if bad:
        raise ValueError(f"{name}: unknown filter type "
                         f"{raw[(bad - 1) * (stride + 1)]}")
    if bpp == 1:
        return np.repeat(out, 3, axis=2)
    return np.ascontiguousarray(out[..., 2::-1])
