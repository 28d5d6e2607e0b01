"""ReID crop extraction on the device: gather + resize + normalize, batched.

The port of ``aicamera_tpu/ops/crops.py::extract_reid_crops``, batched over
the frames of a chunk. Crop bounds are the truncated box coordinates clamped
to the frame; a box with an empty clamped extent gives a zero crop and
``valid=False``. Each crop is a half-pixel bilinear resize (horizontal pass
first, then vertical), BGR->RGB and ImageNet normalization. The horizontal
pass is the JAX package's dense 2-sparse weight matrix written as its two
non-zero taps (same weights; the zero products the dense form adds do not
change a sum). Compute dtype follows the JAX policy: bf16 on the GPU, f32 on
the CPU.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .preprocess import device_constant

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _axis_coords(lo, hi, out_size: int):
    """Bilinear sample coordinates (..., out_size) f32 for crops [lo, hi)."""
    lo_f = lo.float()[..., None]
    hi_f = hi.float()[..., None]
    scale = (hi_f - lo_f) / out_size
    ar = torch.arange(out_size, dtype=torch.float32, device=lo.device)
    coords = lo_f + (ar + 0.5) * scale - 0.5
    return torch.minimum(torch.maximum(coords, lo_f),
                         torch.maximum(hi_f - 1.0, lo_f))


def extract_reid_crops(frames_bgr: torch.Tensor, boxes_xyxy: torch.Tensor,
                       out_hw: Tuple[int, int] = (128, 64),
                       compute_dtype: torch.dtype | None = None):
    """Extract, resize and normalize ReID crops.

    Args:
        frames_bgr: ``(K, H, W, 3)`` uint8 BGR frames.
        boxes_xyxy: ``(K, N, 4)`` float boxes in frame coordinates.
        out_hw: crop size (H, W), the ReID input shape.
        compute_dtype: default bf16 on the GPU, f32 on the CPU.

    Returns:
        crops ``(K, N, out_h, out_w, 3)`` normalized RGB, and valid
        ``(K, N)`` bool (False where the clamped box was empty).
    """
    if compute_dtype is None:
        compute_dtype = (torch.bfloat16 if frames_bgr.device.type == "cuda"
                         else torch.float32)
    k, h, w = frames_bgr.shape[:3]
    n = boxes_xyxy.shape[1]
    oh, ow = out_hw
    dev = frames_bgr.device
    img = frames_bgr.to(compute_dtype)

    def bound(v, limit):
        return torch.clamp(torch.trunc(v), 0, limit).to(torch.int32)

    x1 = bound(boxes_xyxy[..., 0], w)
    y1 = bound(boxes_xyxy[..., 1], h)
    x2 = bound(boxes_xyxy[..., 2], w)
    y2 = bound(boxes_xyxy[..., 3], h)
    valid = (x1 < x2) & (y1 < y2)

    # Horizontal pass: the dense weight max(0, 1 - |coord - j|), j < W, has
    # its non-zero entries at j = floor(coord) and floor(coord) + 1.
    cx = _axis_coords(x1, x2, ow)                          # (K, N, ow)
    j0f = torch.floor(cx)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    wx0 = torch.where(j0f < w, torch.clamp(1.0 - torch.abs(cx - j0f),
                                           min=0.0), zero)
    wx1 = torch.where(j0f + 1.0 < w, torch.clamp(
        1.0 - torch.abs(cx - (j0f + 1.0)), min=0.0), zero)
    j0 = torch.clamp(j0f.long(), max=w - 1)
    j1 = torch.clamp(j0f.long() + 1, max=w - 1)
    fidx = torch.arange(k, device=dev)[:, None, None]
    # img[f, :, j, :] for per-crop column taps -> (K, N, ow, H, 3)
    g0 = img[fidx, :, j0].float()
    g1 = img[fidx, :, j1].float()
    cols = (g0 * wx0.to(compute_dtype).float()[..., None, None]
            + g1 * wx1.to(compute_dtype).float()[..., None, None])
    cols = cols.to(compute_dtype).permute(0, 1, 3, 2, 4)   # (K, N, H, ow, 3)

    # Vertical pass: exact 2-tap row gather + blend, per crop.
    cy = _axis_coords(y1, y2, oh)                          # (K, N, oh)
    i0 = torch.floor(cy).long()
    fy = (cy - i0.float())[..., None, None]                # (K, N, oh, 1, 1)
    i1 = torch.clamp(i0 + 1, max=h - 1)
    i0 = torch.clamp(i0, max=h - 1)  # a gather clamps, as JAX's does
    gi0 = i0[..., None, None].expand(k, n, oh, ow, 3)
    gi1 = i1[..., None, None].expand(k, n, oh, ow, 3)
    r0 = torch.gather(cols, 2, gi0).float()
    r1 = torch.gather(cols, 2, gi1).float()
    crops = (r0 * (1.0 - fy) + r1 * fy).to(compute_dtype)
    crops = crops.flip(-1)                                 # BGR -> RGB
    mean = device_constant(_IMAGENET_MEAN, compute_dtype, dev)
    std = device_constant(_IMAGENET_STD, compute_dtype, dev)
    c255 = device_constant(255.0, compute_dtype, dev)
    crops = (crops / c255 - mean) / std
    crops = torch.where(valid[..., None, None, None], crops,
                        torch.zeros_like(crops))
    return crops, valid
