"""Tiled (sliced) high-resolution detection: static tile grids + merge NMS.

The port of ``aicamera_tpu/ops/tiling.py``. Small objects in a
high-resolution source shrink below the detector's reach once the whole
frame is letterboxed to 640x640; slicing the frame into overlapping tiles
(SAHI, Akyon et al. 2022) and detecting on each tile at near-native scale
finds them. The grid is static per ``(frame_hw, grid, overlap)``, every tile
(and optionally the full frame) letterboxes to the same model input, so
detection is one batched forward, and the per-tile detections merge through
one global class-aware NMS (:func:`merge_detections`).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from .nms import _CLASS_OFFSET, _suppress_and_emit, _topk_stable
from .preprocess import device_constant


def tile_layout(frame_hw: Tuple[int, int], grid: Tuple[int, int],
                overlap: float = 0.2):
    """Static tile origins and size for a ``grid=(gy, gx)`` slicing.

    The tile size is the smallest integer size such that ``gy x gx`` tiles
    with a fractional ``overlap`` between neighbours cover the frame; the
    last row/column is clamped flush to the frame edge, so every pixel is
    inside at least one tile.

    Returns ``(origins, (th, tw))``: ``origins`` a row-major list of ``gy *
    gx`` ``(y0, x0)`` ints, ``(th, tw)`` the common tile size."""
    gy, gx = grid
    h, w = frame_hw
    if gy < 1 or gx < 1:
        raise ValueError(f"grid must be >= 1x1, got {grid}")
    if not 0.0 <= overlap < 1.0:
        raise ValueError(f"overlap must be in [0, 1), got {overlap}")

    def axis(n, size):
        if n == 1:
            return [0], size
        # n tiles of t with (n-1) overlaps of o*t cover n*t - (n-1)*o*t
        t = math.ceil(size / (n - (n - 1) * overlap))
        t = min(t, size)
        stride = (size - t) / (n - 1)  # exact flush packing
        return [round(i * stride) for i in range(n)], t

    ys, th = axis(gy, h)
    xs, tw = axis(gx, w)
    return [(y0, x0) for y0 in ys for x0 in xs], (th, tw)


def extract_tiles(frame_u8: torch.Tensor, origins: List[Tuple[int, int]],
                  tile_hw: Tuple[int, int]) -> torch.Tensor:
    """``(H, W, 3)`` uint8 -> contiguous ``(T, th, tw, 3)`` stack of tiles
    (the letterbox kernel takes contiguous frames)."""
    th, tw = tile_hw
    return torch.stack([frame_u8[y0:y0 + th, x0:x0 + tw]
                        for (y0, x0) in origins])


def offset_boxes(boxes_xyxy: torch.Tensor, y0: int, x0: int) -> torch.Tensor:
    """Shift tile-local xyxy boxes into frame coordinates."""
    return boxes_xyxy + device_constant((x0, y0, x0, y0), boxes_xyxy.dtype,
                                        boxes_xyxy.device)


def merge_detections(boxes: torch.Tensor, scores: torch.Tensor,
                     cls: torch.Tensor, valid: torch.Tensor,
                     iou_threshold: float, max_det: int,
                     frame_hw: Tuple[int, int] | None = None,
                     criterion: str = "iou"):
    """Global class-aware NMS over concatenated per-tile detections.

    ``boxes`` ``(N, 4)`` xyxy in frame coordinates (already offset);
    ``scores``, ``cls``, ``valid`` ``(N,)``. ``frame_hw``: the frame the
    boxes live in; the class offset then scales with it (it must exceed
    every coordinate). ``criterion``: ``"iou"`` (the in-model NMS's
    measure) or ``"ios"`` (intersection over the smaller area, which
    collapses tile-boundary fragments). The greedy keep is the NMS kernel
    for CUDA tensors (no read) and the plain version for CPU tensors.

    Returns ``(num, boxes (max_det, 4), scores (max_det,), labels
    (max_det,))``, the contract of ``fused_decode_nms`` for one image.
    Duplicates from overlapping tiles collapse to the highest-scoring
    candidate, ties to the lower index, as sequential greedy NMS would."""
    n = boxes.shape[0]
    class_offset = _CLASS_OFFSET
    if frame_hw is not None:
        # any offset strictly above the largest coordinate keeps the class
        # bands disjoint; 2x leaves headroom for un-clipped regressions
        class_offset = max(_CLASS_OFFSET, 2.0 * max(frame_hw))
    order = torch.where(valid, scores, torch.full_like(scores, -1.0))
    k_score, k_idx = _topk_stable(order, n)  # full sort by score
    num, out_boxes, out_scores, out_cls = _suppress_and_emit(
        boxes[k_idx][None], k_score[None], cls[k_idx][None],
        (k_score > 0)[None], iou_threshold, n, max_det,
        class_offset=class_offset, criterion=criterion)
    return num[0], out_boxes[0], out_scores[0], out_cls[0]
