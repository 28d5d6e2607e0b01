"""PNG decoding with the standard library's ``zlib``: frames without OpenCV.

Reads non-interlaced 8-bit grayscale, RGB and RGBA PNGs (filter types 0-4,
chunk CRCs checked) into what ``cv2.imread(path)`` returns for them: an
``(H, W, 3)`` uint8 BGR array, gray replicated to three channels and alpha
dropped. Any other kind of PNG raises ``ValueError`` naming what it holds.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}      # colour type -> samples a pixel
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
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{name}: {len(raw)} bytes of image data for "
                         f"{w}x{h}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        out[y] = prev = _unfilter(int(rows[y, 0]), rows[y, 1:], prev, bpp,
                                  name)
    img = out.reshape(h, w, bpp)
    if bpp == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., 2::-1])


def _unfilter(kind: int, cur: np.ndarray, prev: np.ndarray, bpp: int,
              name: str) -> np.ndarray:
    """One scanline's bytes with its filter undone (PNG spec, section 9)."""
    if kind == 0:
        return cur
    if kind == 1:      # Sub: a running sum of each pixel's samples, mod 256
        return np.cumsum(cur.reshape(-1, bpp), axis=0,
                         dtype=np.uint8).reshape(-1)
    if kind == 2:      # Up
        return cur + prev
    if kind not in (3, 4):
        raise ValueError(f"{name}: unknown filter type {kind}")
    # Average and Paeth predict from the byte to the left: sequential
    x, b = bytearray(cur.tobytes()), prev.tolist()
    for i in range(len(x)):
        a = x[i - bpp] if i >= bpp else 0
        if kind == 3:
            x[i] = (x[i] + ((a + b[i]) >> 1)) & 0xFF
            continue
        c = b[i - bpp] if i >= bpp else 0
        p = a + b[i] - c
        pa, pb, pc = abs(p - a), abs(p - b[i]), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b[i] if pb <= pc else c)
        x[i] = (x[i] + pred) & 0xFF
    return np.frombuffer(bytes(x), np.uint8)
