"""Fused DFL decode + top-k + class-aware greedy NMS in PyTorch.

The port of ``aicamera_tpu/ops/nms.py`` (``fused_decode_nms`` and its
helpers), with the reference engine's ``(num, boxes, scores, labels)`` output
contract. Tie order follows ``lax.top_k``: on equal scores the lower index
comes first, which a stable descending sort gives (``torch.topk`` on CUDA
promises no order). Labels come from the argmax over logits (first maximum).

The greedy keep is the JAX package's fixpoint iteration, run batched over the
chunk: a frame that has converged stays fixed under further iterations, so
iterating until every frame has converged gives each frame's own fixpoint.
Each iteration costs one host sync (``NMS_SYNCS`` counts them). With
``fixed_iters=True`` it runs K iterations and reads nothing, for steps that
a CUDA graph captures (``runtime/engine.py``); the result is the same.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..syncs import SyncCounter

# Class-aware NMS trick: shift boxes per class so different classes never
# overlap. Larger than any letterboxed coordinate.
_CLASS_OFFSET = 8192.0

NMS_SYNCS = SyncCounter()


def _topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last axis, lower index first on ties (``lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _pairwise_iou_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(..., K, 4) xyxy -> (..., K, K) IoU."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-7)


def _pairwise_ios_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(..., K, 4) xyxy -> (..., K, K) intersection over the smaller area.

    A small fragment fully inside a larger box scores about 1 whatever the
    size ratio: the merge of tiled detections uses it to collapse
    tile-boundary fragments against the full-frame detection."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    smaller = torch.minimum(area[..., :, None], area[..., None, :])
    return inter / torch.clamp(smaller, min=1e-7)


_PAIRWISE = {"iou": _pairwise_iou_xyxy, "ios": _pairwise_ios_xyxy}


def _greedy_keep(overlap: torch.Tensor, valid: torch.Tensor,
                 fixed_iters: bool = False) -> torch.Tensor:
    """Exact greedy-NMS keep set by fixpoint iteration, batched.

    ``overlap`` (B, K, K) bool, ``valid`` (B, K) bool over score-ordered
    candidates. The greedy scan is the unique fixpoint of
    ``kept[i] = valid[i] and not any_{j<i}(kept[j] and overlap[j, i])``;
    Jacobi iteration from ``kept = valid`` reaches it in at most K steps
    (``kept[i]`` is final once every ``kept[j<i]`` is, so after ``i + 1``
    steps). The eager path stops at the fixpoint, one read a step;
    ``fixed_iters`` runs all K steps with no read: the steps after the
    fixpoint change nothing.
    """
    k = overlap.shape[-1]
    lower = torch.tril(torch.ones((k, k), dtype=torch.bool,
                                  device=overlap.device), diagonal=-1)
    ov_lower = (overlap & lower.T).float()  # ov_lower[j, i]: j < i
    if fixed_iters:
        valid_f = valid.float()
        kept_f = valid_f
        for _ in range(k):
            hits = torch.matmul(kept_f[..., None, :], ov_lower)[..., 0, :]
            kept_f = valid_f * (hits == 0)  # hits count kept j < i
        return kept_f > 0
    kept, prev = valid, ~valid
    it = 0
    while it < k and NMS_SYNCS.flag(torch.any(kept != prev)):
        sup = torch.matmul(kept.float()[..., None, :], ov_lower)[..., 0, :] > 0
        kept, prev = valid & ~sup, kept
        it += 1
    return kept


def _suppress_and_emit(k_boxes, k_score, k_cls, k_valid, iou_threshold,
                       top_k: int, max_det: int,
                       class_offset: float = _CLASS_OFFSET,
                       criterion: str = "iou", fixed_iters: bool = False):
    """Shared NMS tail over (B, K) score-ordered candidates: class shift,
    greedy suppression, emit the top ``max_det`` kept candidates.
    ``class_offset`` must exceed the largest box coordinate; ``criterion``
    is the pairwise overlap measure, ``"iou"`` or ``"ios"``;
    ``fixed_iters`` as in :func:`_greedy_keep`."""
    pairwise = _PAIRWISE.get(criterion)
    if pairwise is None:
        raise ValueError(f"criterion must be 'iou' or 'ios', got "
                         f"{criterion!r}")
    shifted = k_boxes + (k_cls.float() * class_offset)[..., None]
    overlap = pairwise(shifted) > iou_threshold
    kept = _greedy_keep(overlap, k_valid, fixed_iters)

    order_score = torch.where(kept, k_score, torch.full_like(k_score, -1.0))
    if max_det > top_k:  # more output slots than candidates: pad
        pad = max_det - top_k
        order_score = torch.nn.functional.pad(order_score, (0, pad),
                                              value=-1.0)
        k_boxes = torch.nn.functional.pad(k_boxes, (0, 0, 0, pad))
        k_cls = torch.nn.functional.pad(k_cls, (0, pad))
    out_score, out_pos = _topk_stable(order_score, max_det)
    out_valid = out_score > 0
    out_boxes = torch.gather(k_boxes, -2,
                             out_pos[..., None].expand(*out_pos.shape, 4))
    out_boxes = torch.where(out_valid[..., None], out_boxes,
                            torch.zeros_like(out_boxes))
    out_cls = torch.where(out_valid, torch.gather(k_cls, -1, out_pos),
                          torch.zeros_like(out_pos, dtype=k_cls.dtype))
    out_score = torch.where(out_valid, out_score,
                            torch.zeros_like(out_score))
    num = out_valid.sum(-1).to(torch.int32)
    return num, out_boxes, out_score, out_cls


@functools.lru_cache(maxsize=64)
def _anchor_tables(level_hw, strides, device):
    """Flat per-anchor (cx, cy) cell centres and strides, row-major over
    (h, w) per level; uploaded once per ``(level_hw, strides, device)`` and
    shared (read only)."""
    centers, stride_tab = [], []
    for (h, w), s in zip(level_hw, strides):
        ys = np.arange(h, dtype=np.float32) + 0.5
        xs = np.arange(w, dtype=np.float32) + 0.5
        centers.append(np.stack([np.tile(xs, h), np.repeat(ys, w)], axis=-1))
        stride_tab.append(np.full(h * w, s, np.float32))
    return (torch.from_numpy(np.concatenate(centers)).to(device),
            torch.from_numpy(np.concatenate(stride_tab)).to(device))


def fused_decode_nms(level_outputs, score_threshold: float = 0.25,
                     iou_threshold: float = 0.5, top_k: int = 300,
                     max_det: int = 100, strides=(8, 16, 32),
                     fixed_iters: bool = False):
    """Decode + NMS fused: DFL box decoding only for the top-k candidates.

    ``level_outputs``: per level ``(box_bins (B, h, w, 4*reg_max),
    cls_logits (B, h, w, C))`` NHWC. Returns ``num (B,) int32, boxes
    (B, max_det, 4) f32, scores (B, max_det) f32, labels (B, max_det)
    int32`` in letterboxed coordinates. ``fixed_iters``: the greedy keep
    without reads (the same result), for a captured step.
    """
    reg_max = level_outputs[0][0].shape[-1] // 4
    level_hw = tuple((bb.shape[1], bb.shape[2]) for bb, _ in level_outputs)
    batch = level_outputs[0][0].shape[0]
    device = level_outputs[0][0].device

    bins = torch.cat([bb.reshape(batch, -1, 4 * reg_max)
                      for bb, _ in level_outputs], dim=1)
    logits = torch.cat([cl.reshape(batch, -1, cl.shape[-1])
                        for _, cl in level_outputs], dim=1)
    k = min(top_k, bins.shape[1])
    centers, stride_tab = _anchor_tables(level_hw, tuple(strides),
                                         device)
    dfl_bins = torch.arange(reg_max, dtype=torch.float32, device=device)

    best_logit = torch.amax(logits, dim=-1)
    best_cls = torch.argmax(logits, dim=-1).to(torch.int32)  # first maximum
    best_score = torch.sigmoid(best_logit.float())
    valid = best_score >= score_threshold
    cand_score = torch.where(valid, best_score,
                             torch.full_like(best_score, -1.0))

    k_score, k_idx = _topk_stable(cand_score, k)                # (B, K)
    k_bins = torch.gather(bins, 1, k_idx[..., None].expand(
        batch, k, bins.shape[-1])).float().reshape(batch, k, 4, reg_max)
    dist = torch.sum(torch.softmax(k_bins, dim=-1) * dfl_bins, dim=-1)
    ctr = centers[k_idx]                                        # (B, K, 2)
    st = stride_tab[k_idx]                                      # (B, K)
    k_boxes = torch.stack(
        [(ctr[..., 0] - dist[..., 0]) * st,
         (ctr[..., 1] - dist[..., 1]) * st,
         (ctr[..., 0] + dist[..., 2]) * st,
         (ctr[..., 1] + dist[..., 3]) * st], dim=-1)
    k_cls = torch.gather(best_cls, 1, k_idx)
    k_valid = k_score > 0
    return _suppress_and_emit(k_boxes, k_score, k_cls, k_valid,
                              iou_threshold, k, max_det,
                              fixed_iters=fixed_iters)
