"""Letterbox geometry, the plain letterbox preprocess and box unscaling.

The port of ``aicamera_tpu/ops/preprocess.py``. The geometry (min-ratio, no
scale-up, half-side padding with the +-0.1 rounding, pad value 114, the
``auto`` and ``scale_fill`` modes) is pure Python. The pixel work is the plain
PyTorch version of the letterbox kernel (``ops/letterbox.py``): a 2-tap
gather per axis whose taps and weights equal the JAX package's dense bilinear
matrix entries bit for bit, vertical pass first, then horizontal, round
half-to-even, clip, pad, BGR->RGB and a true division by 255.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

PAD_VALUE = 114.0


@dataclasses.dataclass(frozen=True)
class LetterboxSpec:
    """Static letterbox geometry for one (src, dst) shape pair."""
    src_hw: Tuple[int, int]
    dst_hw: Tuple[int, int]
    ratio: float                 # scale applied to the source
    unpad_hw: Tuple[int, int]    # resized size before padding
    pad_wh: Tuple[float, float]  # (dw, dh) half-paddings, possibly fractional
    top: int
    left: int
    # actual output canvas: == dst_hw in square mode; unpad + stride-modulo
    # padding in `auto` (minimum-rectangle) mode
    out_hw: Tuple[int, int] = None

    def __post_init__(self):
        if self.out_hw is None:
            object.__setattr__(self, "out_hw", tuple(self.dst_hw))

    @property
    def bottom(self) -> int:
        return self.out_hw[0] - self.unpad_hw[0] - self.top

    @property
    def right(self) -> int:
        return self.out_hw[1] - self.unpad_hw[1] - self.left


def letterbox_spec(src_hw: Tuple[int, int], dst_hw: Tuple[int, int],
                   scaleup: bool = False, auto: bool = False,
                   scale_fill: bool = False,
                   stride: int = 32) -> LetterboxSpec:
    """Letterbox geometry. Default: pad to exactly ``dst_hw``. ``auto``:
    minimum rectangle (padding reduced modulo ``stride``). ``scale_fill``:
    stretch to ``dst_hw`` with no padding; ``ratio`` stays the min-ratio."""
    sh, sw = src_hw
    dh_, dw_ = dst_hw
    r = min(dh_ / sh, dw_ / sw)
    if not scaleup:
        r = min(r, 1.0)
    unpad = (int(round(sh * r)), int(round(sw * r)))
    pad_w = dw_ - unpad[1]
    pad_h = dh_ - unpad[0]
    if auto:
        pad_w %= stride
        pad_h %= stride
    elif scale_fill:
        pad_w = pad_h = 0
        unpad = (dh_, dw_)
    dw = pad_w / 2.0
    dh = pad_h / 2.0
    top = int(round(dh - 0.1))
    bottom = int(round(dh + 0.1))
    left = int(round(dw - 0.1))
    right = int(round(dw + 0.1))
    out_hw = (unpad[0] + top + bottom, unpad[1] + left + right)
    return LetterboxSpec(src_hw=tuple(src_hw), dst_hw=tuple(dst_hw),
                         ratio=r, unpad_hw=unpad, pad_wh=(dw, dh),
                         top=top, left=left, out_hw=out_hw)


def resize_taps(dst: int, src: int):
    """2-tap bilinear resize taps, half-pixel centres, edge-clamped.

    Returns ``(i0, i1, w0, w1)``: int32 source indices and f32 weights of
    length ``dst``. The weights are computed in float64 exactly as the JAX
    package's dense matrix entries ``max(0, 1 - |coord - j|)`` and then cast
    to f32, so they equal that matrix's two non-zero entries per row. A
    coordinate clamped to the last source pixel has a single tap of weight 1
    (``i1 == i0``, ``w1 == 0``); an exact-integer coordinate has ``w1 == 0``.
    """
    coords = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    coords = np.clip(coords, 0.0, src - 1)
    i0 = np.floor(coords).astype(np.int64)
    j1 = i0 + 1
    w0 = np.maximum(0.0, 1.0 - np.abs(coords - i0))
    w1 = np.where(j1 < src, np.maximum(0.0, 1.0 - np.abs(coords - j1)), 0.0)
    i1 = np.minimum(j1, src - 1)
    return (i0.astype(np.int32), i1.astype(np.int32),
            w0.astype(np.float32), w1.astype(np.float32))


def letterbox_taps(spec: LetterboxSpec):
    """Per-axis taps for the content rectangle, plus whether the resize (and
    its rounding) runs at all: with ``unpad == src`` the taps are the
    identity and no rounding is applied, as in the JAX package."""
    uh, uw = spec.unpad_hw
    resize = (uh, uw) != tuple(spec.src_hw)
    if resize:
        ty = resize_taps(uh, spec.src_hw[0])
        tx = resize_taps(uw, spec.src_hw[1])
    else:
        ty = (np.arange(uh, dtype=np.int32), np.arange(uh, dtype=np.int32),
              np.ones(uh, np.float32), np.zeros(uh, np.float32))
        tx = (np.arange(uw, dtype=np.int32), np.arange(uw, dtype=np.int32),
              np.ones(uw, np.float32), np.zeros(uw, np.float32))
    return ty, tx, resize


def letterbox_plain(frames_bgr_u8: torch.Tensor, spec: LetterboxSpec,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain letterbox: uint8 BGR ``(K, H, W, 3)`` -> RGB ``(K, 3, Dh, Dw)``.

    The plain PyTorch version of the letterbox kernel, with the kernel's
    arithmetic order: ``t = w0y*p[i0y] + w1y*p[i1y]`` for each x tap, then
    ``w0x*t0 + w1x*t1``, each product and sum rounded to f32.
    """
    dev = frames_bgr_u8.device
    ty, tx, resize = letterbox_taps(spec)
    iy0, iy1, wy0, wy1 = (torch.from_numpy(a).to(dev) for a in ty)
    ix0, ix1, wx0, wx1 = (torch.from_numpy(a).to(dev) for a in tx)
    x = frames_bgr_u8.permute(0, 3, 1, 2).float()          # (K, 3, H, W)
    wy0, wy1 = wy0[:, None], wy1[:, None]
    t0 = x[:, :, iy0][..., ix0] * wy0 + x[:, :, iy1][..., ix0] * wy1
    t1 = x[:, :, iy0][..., ix1] * wy0 + x[:, :, iy1][..., ix1] * wy1
    v = t0 * wx0 + t1 * wx1                                 # (K, 3, uh, uw)
    if resize:
        v = torch.clamp(torch.round(v), 0.0, 255.0)
    k = x.shape[0]
    dh, dw = spec.out_hw
    uh, uw = spec.unpad_hw
    canvas = torch.full((k, 3, dh, dw), PAD_VALUE, dtype=torch.float32,
                        device=dev)
    canvas[:, :, spec.top:spec.top + uh, spec.left:spec.left + uw] = v
    canvas = canvas.flip(1)                                 # BGR -> RGB
    # A tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by the reciprocal, which is not the kernel's (or JAX's) true division.
    return (canvas / _f32(255.0, dev)).to(out_dtype)


@functools.lru_cache(maxsize=256)
def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A small constant tensor (a number or a tuple of numbers), uploaded
    once per ``(values, dtype, device)`` and shared by every caller, who must
    not write to it. Steps that a CUDA graph captures take their constants
    from here: a capture cannot copy from host memory."""
    return torch.tensor(values, dtype=dtype, device=device)


def _f32(value: float, device) -> torch.Tensor:
    return device_constant(float(value), torch.float32, torch.device(device))


def preprocess_yolo(frame_bgr_u8: torch.Tensor, spec: LetterboxSpec,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 BGR ``(H, W, 3)`` -> letterboxed normalized RGB
    ``(1, Dh, Dw, 3)`` (the JAX package's public layout), through
    ``ops.letterbox.letterbox``: the kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    from .letterbox import letterbox  # letterbox.py imports this module
    frame = frame_bgr_u8.contiguous()
    return letterbox(frame[None], spec, out_dtype).permute(0, 2, 3, 1)


def scale_boxes_back(boxes_xyxy: torch.Tensor,
                     spec: LetterboxSpec) -> torch.Tensor:
    """Map boxes from letterboxed space back to source-frame coordinates:
    subtract the fractional half-padding, divide by the ratio, clip."""
    dw, dh = spec.pad_wh
    sh, sw = spec.src_hw
    r = _f32(spec.ratio, boxes_xyxy.device)
    x1 = torch.clamp((boxes_xyxy[..., 0] - dw) / r, 0, sw)
    y1 = torch.clamp((boxes_xyxy[..., 1] - dh) / r, 0, sh)
    x2 = torch.clamp((boxes_xyxy[..., 2] - dw) / r, 0, sw)
    y2 = torch.clamp((boxes_xyxy[..., 3] - dh) / r, 0, sh)
    return torch.stack([x1, y1, x2, y2], dim=-1)
