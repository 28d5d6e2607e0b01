"""Flax msgpack checkpoints: read and write, in plain Python.

A frozen copy of the reader and writer in ``aicamera_tpu_torch/runtime/
params.py`` (the subset of msgpack that ``flax.serialization.to_bytes``
writes), kept with the benchmark: the reference reads the same raw weight
files as the program, through code of its own.
"""

from __future__ import annotations

import struct

import numpy as np

# --- msgpack reader ----------------------------------------------------------

_EXT_NDARRAY = 1   # flax.serialization._MsgpackExtType.ndarray
_EXT_NPSCALAR = 3  # flax.serialization._MsgpackExtType.npscalar


class _Reader:
    """Sequential msgpack decoder over one bytes buffer."""

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self._array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return str(self._take(b & 0x1f), "utf-8")
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        sized = {  # code: (length format, kind)
            0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
            0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
            0xdc: (">H", "array"), 0xdd: (">I", "array"),
            0xde: (">H", "map"), 0xdf: (">I", "map"),
            0xc7: (">B", "ext"), 0xc8: (">H", "ext"), 0xc9: (">I", "ext"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self._unpack(fmt)
            if kind == "bin":
                return bytes(self._take(n))
            if kind == "str":
                return str(self._take(n), "utf-8")
            if kind == "array":
                return self._array(n)
            if kind == "map":
                return self._map(n)
            return self._ext(n)
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        scalars = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H",
                   0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h",
                   0xd2: ">i", 0xd3: ">q"}
        if b in scalars:
            return self._unpack(scalars[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _array(self, n: int):
        return [self.read() for _ in range(n)]

    def _map(self, n: int):
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _ext(self, n: int):
        code = struct.unpack(">b", self._take(1))[0]
        payload = bytes(self._take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        # payload: msgpack [shape, dtype name, raw bytes]
        shape, dtype_name, raw = _Reader(payload).read()
        arr = np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(
            shape).copy()
        return arr if code == _EXT_NDARRAY else arr[()]


def read_flax_msgpack(data: bytes):
    """Decode bytes written by ``flax.serialization.to_bytes`` into a nested
    dict of numpy arrays (what ``flax.serialization.msgpack_restore``
    returns)."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after msgpack object")
    return out


# --- msgpack writer ----------------------------------------------------------

def _pack_len(n: int, fix, codes) -> bytes:
    """A length header in the smallest form, as the msgpack package picks:
    ``fix = (base, limit)`` for the one-byte form (None: there is none),
    ``codes`` the type bytes of the 8-, 16- and 32-bit forms (None: that
    form does not exist)."""
    if fix and n < fix[1]:
        return bytes([fix[0] | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"object of length {n} is too large for msgpack")


def _pack(obj) -> bytes:
    if obj is None:
        return b"\xc0"
    if isinstance(obj, str):
        raw = obj.encode("utf-8")
        return _pack_len(len(raw), (0xa0, 32), (0xd9, 0xda, 0xdb)) + raw
    if isinstance(obj, bytes):
        return _pack_len(len(obj), None, (0xc4, 0xc5, 0xc6)) + obj
    if isinstance(obj, int) and not isinstance(obj, bool) and obj >= 0:
        if obj < 128:
            return bytes([obj])
        for code, fmt in ((0xcc, ">B"), (0xcd, ">H"), (0xce, ">I"),
                          (0xcf, ">Q")):
            if obj < 1 << (8 * struct.calcsize(fmt)):
                return bytes([code]) + struct.pack(fmt, obj)
    if isinstance(obj, (tuple, list)):
        return _pack_len(len(obj), (0x90, 16), (None, 0xdc, 0xdd)) \
            + b"".join(_pack(x) for x in obj)
    if isinstance(obj, dict):
        return _pack_len(len(obj), (0x80, 16), (None, 0xde, 0xdf)) \
            + b"".join(_pack(k) + _pack(v) for k, v in obj.items())
    if isinstance(obj, np.ndarray):
        if obj.dtype.hasobject or obj.dtype.names:
            raise ValueError("object and structured arrays are not "
                             "serializable")
        payload = _pack((obj.shape, obj.dtype.name, obj.tobytes("C")))
        fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
        head = (bytes([fixext[len(payload)]]) if len(payload) in fixext
                else _pack_len(len(payload), None, (0xc7, 0xc8, 0xc9)))
        return head + struct.pack(">b", _EXT_NDARRAY) + payload
    raise TypeError(f"cannot serialize {type(obj).__name__}")


def write_flax_msgpack(tree: dict) -> bytes:
    """Encode a nested dict of numpy arrays (and ``None``) as
    ``flax.serialization.to_bytes`` encodes the same state dict; arrays of a
    gigabyte or more, which Flax splits into chunks, are refused."""
    for _, leaf in _flatten(tree):
        if isinstance(leaf, np.ndarray) and leaf.nbytes >= 2 ** 30:
            raise ValueError("arrays of 2**30 bytes or more are not "
                             "supported")
    return _pack(tree)


def load_flax_msgpack(path) -> dict:
    with open(path, "rb") as f:
        return read_flax_msgpack(f.read())


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v
