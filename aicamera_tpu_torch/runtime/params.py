"""Model weights: Flax msgpack checkpoints -> PyTorch modules.

Two layers:

- :func:`read_flax_msgpack` is a pure-Python reader for the msgpack subset
  that ``flax.serialization.to_bytes`` writes (maps, str, bin, arrays, ints,
  floats, nil/bool and the ndarray extension type). The GPU host has neither
  ``msgpack`` nor ``flax``, so the port carries its own reader.
  :func:`write_flax_msgpack` is its counterpart for a dict of numpy arrays
  (tracker-state checkpoints, ``runtime/checkpoint.py``), byte for byte what
  Flax writes.
- :func:`yolo_state_dict_from_flax` / :func:`reid_state_dict_from_flax` map
  a nested dict of numpy arrays (the Flax params tree) onto the port's module
  names: conv kernels HWIO -> OIHW, Dense ``(in, out)`` -> ``(out, in)``.
  Loading is strict: every leaf must be consumed and every parameter filled.

Resolution mirrors the JAX package: an explicit path (``.msgpack`` or
``.onnx``) must exist; without one, the default checkpoint, then the default
ONNX file (imported by ``models/onnx_import.py`` and cached as msgpack), then
a seeded random init with a warning.
"""

from __future__ import annotations

import struct
import warnings
from pathlib import Path

import numpy as np
import torch

from .. import config
from ..device import resolve_device
from ..models.reid import ReIDNet
from ..models.yolov8 import YOLOv8

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


# --- Flax tree -> torch state dict -------------------------------------------

def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _state_dict_from_flax(tree) -> dict:
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}
    for path, leaf in _flatten(tree):
        arr = np.array(leaf, np.float32)  # a writable copy
        *mods, leaf_name = path
        if leaf_name == "kernel":
            if arr.ndim == 4:      # conv HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:    # Dense (in, out) -> (out, in)
                arr = arr.T
            else:
                raise ValueError(f"unexpected kernel rank at {path}")
            name = "weight"
        elif leaf_name == "bias":
            name = "bias"
        else:
            raise ValueError(f"unexpected Flax leaf {'/'.join(path)}")
        out[".".join((*mods, name))] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return out


def flax_tree(model: torch.nn.Module) -> dict:
    """A module's weights as the Flax params tree, f32 numpy (the inverse of
    :func:`_state_dict_from_flax`): conv kernels OIHW -> HWIO, Dense
    ``(out, in)`` -> ``(in, out)``; what an engine file stores."""
    tree = {}
    for key, t in model.state_dict().items():
        *mods, leaf = key.split(".")
        arr = t.detach().float().cpu().numpy()
        if leaf == "weight":
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
            leaf = "kernel"
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)
    return {"params": tree}


def tensor_tree(tree) -> dict:
    """A nested dict of numpy arrays as CPU tensors (an engine file's int8
    trees)."""
    return {k: tensor_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def yolo_state_dict_from_flax(tree) -> dict:
    """YOLOv8 Flax params tree -> ``models.yolov8.YOLOv8`` state dict."""
    return _state_dict_from_flax(tree)


def reid_state_dict_from_flax(tree) -> dict:
    """ReIDNet Flax params tree -> ``models.reid.ReIDNet`` state dict."""
    return _state_dict_from_flax(tree)


def load_state_strict(model: torch.nn.Module, state: dict) -> None:
    """Load ``state`` into ``model``; raises on a missing, extra or
    mis-shaped entry."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"checkpoint does not match the model: missing "
                       f"{missing[:5]}, unexpected {extra[:5]}")
    for k, v in state.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"shape mismatch at {k}: checkpoint "
                             f"{tuple(v.shape)}, model {tuple(own[k].shape)}")
    model.load_state_dict(state, strict=True)


def seeded_init_(model: torch.nn.Module, seed: int = 0) -> None:
    """Fan-in-scaled normal weights, zero biases, from a seeded generator
    (the JAX package's ``template_params`` rule; the bits differ)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for _, p in sorted(model.named_parameters()):
            if p.ndim <= 1:
                p.zero_()
            else:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=gen) * fan_in ** -0.5)


def compute_dtype(device) -> torch.dtype:
    """bf16 on the GPU, f32 on the CPU (the JAX package's policy)."""
    return torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32


def _resolve(model, weights_path, default_path, default_onnx, convert,
             example_input, cache_path, device, dtype, what: str):
    """The JAX package's lookup: an explicit path must exist and is never
    cached; else the default ``.msgpack``, then the default ``.onnx``
    (imported and cached as msgpack at ``cache_path``), then a seeded random
    init with a warning."""
    device = resolve_device(device)  # None: the GPU, or raise without one
    dtype = dtype or compute_dtype(device)
    if weights_path:
        path = Path(weights_path)
        from .engine import (is_engine_file, is_xla_engine_file,
                             xla_engine_error)
        if is_xla_engine_file(path):
            raise xla_engine_error(path)
        if is_engine_file(path):
            raise ValueError(
                f"{path} is a serialized engine artifact (.cudae): it bakes "
                "weights + preprocess into a fixed batch-1 program and "
                "cannot initialize a weight-based pipeline. Load it with "
                "YOLODetector(engine_path=...) / ReIDModel(engine_path=...),"
                " or pass the .msgpack/.onnx weights file here instead.")
        if path.suffix not in (".msgpack", ".onnx"):
            raise ValueError(f"unsupported weights file {path}: expected a "
                             ".msgpack Flax checkpoint or a .onnx export")
        if not path.exists():
            raise FileNotFoundError(
                f"weights file not found: {path} (an explicit path does not "
                "fall back to random init)")
    else:
        path = default_path
    onnx_path = path if path.suffix == ".onnx" else default_onnx
    if path.suffix == ".msgpack" and path.exists():
        load_state_strict(model, convert(load_flax_msgpack(path)))
    elif onnx_path.exists():
        from ..models.onnx_import import import_conv_net_params
        tree = import_conv_net_params(onnx_path, flax_tree(model), model,
                                      example_input)
        if not weights_path:
            # only the default location caches: an explicit path (tests,
            # experiments) must not overwrite it
            cache_path.parent.mkdir(parents=True, exist_ok=True)
            cache_path.write_bytes(write_flax_msgpack(tree))
        load_state_strict(model, convert(tree))
    else:
        warnings.warn(f"No {what} weights found at {path} / {onnx_path}; "
                      "using seeded random init (outputs will be "
                      "meaningless).")
        seeded_init_(model)
    return model.to(device=device, dtype=dtype).eval()


def resolve_yolo_params(variant: str = "n", num_classes: int = 80,
                        weights_path: str | None = None, device=None,
                        dtype: torch.dtype | None = None) -> YOLOv8:
    """The YOLOv8 detector with its weights, on ``device`` in ``dtype``.
    ``weights_path``: a ``.msgpack`` checkpoint or a ``.onnx`` export; none:
    the default checkpoint, else the default ONNX file (cached as msgpack),
    else a seeded init. ``device=None`` is the GPU (raises without one); the
    default ``dtype`` is bf16 there and f32 on the CPU."""
    cache = (config.YOLO_PARAMS_PATH if variant == "n" else
             config.YOLO_PARAMS_PATH.with_name(f"yolov8{variant}.msgpack"))
    return _resolve(YOLOv8(variant=variant, num_classes=num_classes),
                    weights_path, config.YOLO_PARAMS_PATH,
                    config.YOLO_ONNX_PATH, yolo_state_dict_from_flax,
                    torch.zeros(1, 3, 64, 64), cache, device, dtype,
                    f"YOLOv8{variant}")


def resolve_reid_params(weights_path: str | None = None, device=None,
                        dtype: torch.dtype | None = None) -> ReIDNet:
    """The ReID embedder with its weights, on ``device`` in ``dtype``
    (lookup and defaults as in :func:`resolve_yolo_params`)."""
    return _resolve(ReIDNet(feature_dim=config.REID_FEATURE_DIM),
                    weights_path, config.REID_PARAMS_PATH,
                    config.REID_ONNX_PATH, reid_state_dict_from_flax,
                    torch.zeros(1, *config.REID_INPUT_SHAPE, 3),
                    config.REID_PARAMS_PATH, device, dtype, "ReID")
