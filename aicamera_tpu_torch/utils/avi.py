"""RIFF AVI container for Motion-JPEG video: a reader and a writer.

What the port reads and writes in place of OpenCV's video I/O: every frame
an intra-coded JPEG (``utils/jpeg.py``), so any frame decodes on its own.

:class:`AviWriter` writes ``RIFF('AVI ')`` with ``hdrl`` (``avih``; a
``strl`` of ``strh`` for an ``MJPG`` video stream, ``strf`` as a
BITMAPINFOHEADER and an OpenDML ``indx`` super index; an ``odml``/``dmlh``
list with the total frame count), a ``movi`` list of ``00dc`` chunks, and an
``idx1`` index of the frames in that first RIFF. Past ``riff_limit`` bytes
(1 GiB) the file goes on in ``RIFF('AVIX')`` lists, each ``movi`` closed by an
OpenDML ``ix00`` standard index that the super index points at, so files of
any length stay readable by OpenDML readers such as FFmpeg (OpenCV's own
MJPEG reader reads the first RIFF only).

:func:`read_index` returns the stream's frame size, rate (``dwRate /
dwScale``) and the file offset and size of every frame, from the OpenDML
indexes, else ``idx1``, else by scanning the ``movi`` lists.
"""

from __future__ import annotations

import dataclasses
import struct
from fractions import Fraction
from pathlib import Path
from typing import BinaryIO, List, Optional, Tuple

import numpy as np

RIFF_LIMIT = 1 << 30          # bytes in one RIFF before an AVIX follows
SUPER_INDEX_ENTRIES = 256     # AVIX RIFFs the reserved super index holds
AVIF_HASINDEX = 0x10
AVIIF_KEYFRAME = 0x10
_DC = b"00dc"


@dataclasses.dataclass
class AviIndex:
    width: int
    height: int
    fps: float
    offsets: np.ndarray       # int64: file offset of each frame's data
    sizes: np.ndarray         # int32: bytes of each frame

    @property
    def frame_count(self) -> int:
        return len(self.offsets)


def _chunks(f: BinaryIO, start: int, end: int):
    """(fourcc, data offset, size, list type or None) of the chunks in
    [start, end)."""
    pos = start
    while pos + 8 <= end:
        f.seek(pos)
        head = f.read(12)
        if len(head) < 8:
            return
        fourcc, size = head[:4], struct.unpack("<I", head[4:8])[0]
        kind = head[8:12] if fourcc in (b"RIFF", b"LIST") else None
        yield fourcc, pos + 8, size, kind
        pos += 8 + size + (size & 1)


def read_index(path: str | Path) -> AviIndex:
    """Parse an MJPEG AVI's headers and frame index."""
    path = Path(path)
    file_end = path.stat().st_size
    with open(path, "rb") as f:
        head = f.read(12)
        if head[:4] != b"RIFF" or head[8:12] != b"AVI ":
            raise ValueError(f"{path}: not an AVI file")
        avih = strh = strf = indx = idx1 = None
        movis: List[Tuple[int, int]] = []    # (list data offset, end)

        def walk(start, end):
            nonlocal avih, strh, strf, indx, idx1
            for fourcc, off, size, kind in _chunks(f, start, end):
                if fourcc in (b"RIFF", b"LIST"):
                    if kind == b"movi":
                        movis.append((off, min(off + size, file_end)))
                    elif kind in (b"AVI ", b"AVIX", b"hdrl", b"strl",
                                  b"odml"):
                        if kind == b"strl" and strh is not None:
                            continue          # the first stream only
                        walk(off + 4, min(off + size, file_end))
                    continue
                f.seek(off)
                if fourcc == b"avih":
                    avih = f.read(size)
                elif fourcc == b"strh" and strh is None:
                    strh = f.read(size)
                elif fourcc == b"strf" and strf is None:
                    strf = f.read(size)
                elif fourcc == b"indx" and indx is None:
                    indx = f.read(size)
                elif fourcc == b"idx1":
                    idx1 = f.read(size)

        walk(0, file_end)
        # the top-level RIFFs after the first (AVIX)
        if strh is None or strf is None:
            raise ValueError(f"{path}: no video stream header")
        if strh[:4] != b"vids":
            raise ValueError(f"{path}: the first stream is not video")
        fourcc = strf[16:20]
        if fourcc not in (b"MJPG", b"mjpg", b"JPEG", b"jpeg"):
            raise ValueError(f"{path}: {fourcc!r} video is not Motion-JPEG")
        scale, rate = struct.unpack("<II", strh[20:28])
        width, height = struct.unpack("<ii", strf[4:12])
        fps = rate / scale if scale else 0.0

        offsets: List[int] = []
        sizes: List[int] = []
        if indx is not None and indx[3] == 0x00:      # AVI_INDEX_OF_INDEXES
            n_used = struct.unpack("<I", indx[4:8])[0]
            for i in range(n_used):
                q, _, _ = struct.unpack("<QII", indx[24 + 16 * i:40 + 16 * i])
                f.seek(q)
                ck = f.read(8)
                body = f.read(struct.unpack("<I", ck[4:8])[0])
                n = struct.unpack("<I", body[4:8])[0]
                base = struct.unpack("<Q", body[12:20])[0]
                ent = np.frombuffer(body[24:24 + 8 * n], "<u4").reshape(n, 2)
                offsets.extend((base + ent[:, 0].astype(np.int64)).tolist())
                sizes.extend((ent[:, 1] & 0x7FFFFFFF).tolist())
        elif idx1 is not None and movis:
            ent = np.frombuffer(idx1[:len(idx1) // 16 * 16],
                                "<u4").reshape(-1, 4)
            ids = [struct.pack("<I", int(c)) for c in ent[:, 0]]
            keep = [i for i, c in enumerate(ids) if c[2:] in (b"dc", b"db")
                    and c[:2] == b"00"]
            ent = ent[keep]
            movi = movis[0][0]                        # the 'movi' fourcc
            base = movi
            if len(ent):
                f.seek(movi + int(ent[0, 2]))
                if f.read(4)[2:] not in (b"dc", b"db"):
                    base = 0                          # absolute offsets
            offsets = (base + ent[:, 2].astype(np.int64) + 8).tolist()
            sizes = ent[:, 3].tolist()
        else:
            for start, end in movis:
                for ck, off, size, _ in _chunks(f, start + 4, end):
                    if ck[:2] == b"00" and ck[2:] in (b"dc", b"db"):
                        offsets.append(off)
                        sizes.append(size)
        offsets_a = np.asarray(offsets, np.int64)
        sizes_a = np.asarray(sizes, np.int32)
        keep = sizes_a > 0                            # dropped frames
        return AviIndex(width=int(width), height=abs(int(height)), fps=fps,
                        offsets=offsets_a[keep], sizes=sizes_a[keep])


def _rate(fps: float) -> Tuple[int, int]:
    frac = Fraction(fps).limit_denominator(1_000_000)
    return frac.numerator, frac.denominator


class AviWriter:
    """Append JPEG frames to an MJPEG AVI; :meth:`close` writes the indexes
    and fixes the headers. Not thread-safe: one writer thread."""

    def __init__(self, path: str | Path, fps: float,
                 frame_hw: Tuple[int, int], riff_limit: int = RIFF_LIMIT):
        self.path = Path(path)
        self.height, self.width = (int(v) for v in frame_hw)
        self.fps = float(fps)
        self.riff_limit = int(riff_limit)
        self.frames = 0
        self._f: Optional[BinaryIO] = open(self.path, "wb")
        self._riffs: List[dict] = []
        self._max_frame = 0
        self._write_headers()
        self._open_riff(first=True)

    # header layout: offsets kept so that close() can patch them
    def _write_headers(self):
        f = self._f
        rate, scale = _rate(self.fps)
        f.write(b"RIFF\0\0\0\0AVI ")
        hdrl_start = f.tell()
        f.write(b"LIST\0\0\0\0hdrl")
        self._avih = f.tell() + 8
        f.write(b"avih" + struct.pack("<I", 56) + struct.pack(
            "<14I", int(round(1e6 / self.fps)) if self.fps else 0, 0, 0,
            AVIF_HASINDEX, 0, 0, 1, 0, self.width, self.height, 0, 0, 0, 0))
        strl_start = f.tell()
        f.write(b"LIST\0\0\0\0strl")
        self._strh = f.tell() + 8
        f.write(b"strh" + struct.pack("<I", 56) + b"vids" + b"MJPG" +
                struct.pack("<IHHIIIIIIII", 0, 0, 0, 0, scale, rate, 0, 0, 0,
                            0xFFFFFFFF, 0) +
                struct.pack("<4h", 0, 0, self.width, self.height))
        f.write(b"strf" + struct.pack("<I", 40) + struct.pack(
            "<IiiHH4sIiiII", 40, self.width, self.height, 1, 24, b"MJPG",
            self.width * self.height * 3, 0, 0, 0, 0))
        self._indx = f.tell()
        n = SUPER_INDEX_ENTRIES
        f.write(b"indx" + struct.pack("<I", 24 + 16 * n) +
                struct.pack("<HBBI4s3I", 4, 0, 0, 0, _DC, 0, 0, 0) +
                b"\0" * (16 * n))
        self._patch_size(strl_start)
        odml_start = f.tell()
        f.write(b"LIST\0\0\0\0odml")
        self._dmlh = f.tell() + 8
        f.write(b"dmlh" + struct.pack("<I", 248) + b"\0" * 248)
        self._patch_size(odml_start)
        self._patch_size(hdrl_start)

    def _patch_size(self, start: int, end: Optional[int] = None):
        f = self._f
        end = f.tell() if end is None else end
        f.seek(start + 4)
        f.write(struct.pack("<I", end - start - 8))
        f.seek(end)

    def _open_riff(self, first=False):
        f = self._f
        riff = {"start": 0 if first else f.tell(), "frames": []}
        if not first:
            f.write(b"RIFF\0\0\0\0AVIX")
        riff["movi"] = f.tell()
        f.write(b"LIST\0\0\0\0movi")
        self._riffs.append(riff)

    def _close_riff(self):
        f = self._f
        riff = self._riffs[-1]
        frames = riff["frames"]
        base = riff["movi"]
        ix = f.tell()
        f.write(b"ix00" + struct.pack("<I", 24 + 8 * len(frames)) +
                struct.pack("<HBBI4sQI", 2, 0, 1, len(frames), _DC, base, 0))
        f.write(b"".join(struct.pack("<II", off - base, size)
                         for off, size in frames))
        riff["ix"] = (ix, 8 + 24 + 8 * len(frames), len(frames))
        self._patch_size(riff["movi"])
        if riff["start"] == 0:      # the first RIFF carries idx1
            movi = riff["movi"] + 8  # offsets from the 'movi' fourcc
            f.write(b"idx1" + struct.pack("<I", 16 * len(frames)))
            f.write(b"".join(struct.pack("<4sIII", _DC, AVIIF_KEYFRAME,
                                         off - 8 - movi, size)
                             for off, size in frames))
        self._patch_size(riff["start"])

    def write(self, jpeg: bytes):
        """Append one frame's JPEG bytes."""
        f = self._f
        size = len(jpeg)
        riff = self._riffs[-1]
        # the frame, its idx1 and ix00 entries, and room for the headers
        need = size + 9 + 24 * (len(riff["frames"]) + 1) + 1024
        if f.tell() - riff["start"] + need > self.riff_limit \
                and riff["frames"]:
            if len(self._riffs) >= SUPER_INDEX_ENTRIES:
                raise ValueError("AVI longer than the reserved super index")
            self._close_riff()
            self._open_riff()
        self._riffs[-1]["frames"].append((f.tell() + 8, size))
        f.write(_DC + struct.pack("<I", size) + jpeg)
        if size & 1:
            f.write(b"\0")
        self.frames += 1
        self._max_frame = max(self._max_frame, size)

    def close(self):
        if self._f is None:
            return
        f = self._f
        self._close_riff()
        end = f.tell()
        first = len(self._riffs[0]["frames"])
        # avih: total frames (of the first RIFF, as OpenDML asks), buffer
        f.seek(self._avih + 16)
        f.write(struct.pack("<I", first))
        f.seek(self._avih + 28)
        f.write(struct.pack("<I", self._max_frame))
        f.seek(self._strh + 32)          # dwLength, dwSuggestedBufferSize
        f.write(struct.pack("<II", self.frames, self._max_frame))
        f.seek(self._dmlh)
        f.write(struct.pack("<I", self.frames))
        f.seek(self._indx + 8 + 4)
        f.write(struct.pack("<I", len(self._riffs)))
        f.seek(self._indx + 8 + 24)
        for riff in self._riffs:
            off, size, n = riff["ix"]
            f.write(struct.pack("<QII", off, size, n))
        f.seek(end)
        f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
