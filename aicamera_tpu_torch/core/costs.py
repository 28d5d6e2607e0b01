"""Batched association cost matrices (IoU, cosine appearance) and box math.

The port of ``aicamera_tpu/core/costs.py``: IoU epsilon 1e-7; cosine
distance with a 1e-7 norm floor, clipped at >= 0; appearance cost is the
minimum cosine distance over a track's gallery; infeasible entries get
``INFTY_COST``. Matrix products are full f32 (TF32 off by default for
matmuls).
"""

from __future__ import annotations

import torch

INFTY_COST = 1e5


def tlwh_to_xyah(tlwh: torch.Tensor) -> torch.Tensor:
    """(tlx, tly, w, h) -> (cx, cy, a=w/h, h); a=0 when h==0."""
    x, y, w, h = tlwh.unbind(-1)
    cx = x + w / 2.0
    cy = y + h / 2.0
    nz = h != 0
    a = torch.where(nz, w / torch.where(nz, h, torch.ones_like(h)),
                    torch.zeros_like(h))
    return torch.stack([cx, cy, a, h], dim=-1)


def mean_to_tlwh(mean: torch.Tensor) -> torch.Tensor:
    """KF state mean (cx, cy, a, h, ...) -> (tlx, tly, w, h): width a*h when
    h > 0 else 0; height clamped at >= 0."""
    cx, cy, a, h = mean[..., 0], mean[..., 1], mean[..., 2], mean[..., 3]
    w = torch.where(h > 0, a * h, torch.zeros_like(h))
    h = torch.clamp(h, min=0.0)
    return torch.stack([cx - w / 2.0, cy - h / 2.0, w, h], dim=-1)


def tlwh_to_tlbr(tlwh: torch.Tensor) -> torch.Tensor:
    """(tlx, tly, w, h) -> (x1, y1, x2, y2)."""
    return torch.cat([tlwh[..., :2], tlwh[..., :2] + tlwh[..., 2:]], dim=-1)


def iou_matrix(boxes_a_tlwh: torch.Tensor,
               boxes_b_tlwh: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of two tlwh box sets: ``(T, 4) x (N, 4) -> (T, N)``."""
    a_tl = boxes_a_tlwh[:, None, :2]
    a_br = a_tl + boxes_a_tlwh[:, None, 2:]
    b_tl = boxes_b_tlwh[None, :, :2]
    b_br = b_tl + boxes_b_tlwh[None, :, 2:]
    inter_wh = torch.clamp(torch.minimum(a_br, b_br)
                           - torch.maximum(a_tl, b_tl), min=0.0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    area_a = (boxes_a_tlwh[:, 2] * boxes_a_tlwh[:, 3])[:, None]
    area_b = (boxes_b_tlwh[:, 2] * boxes_b_tlwh[:, 3])[None, :]
    union = area_a + area_b - inter
    return inter / torch.clamp(union, min=1e-7)


def iou_cost_matrix(track_tlwh: torch.Tensor,
                    det_tlwh: torch.Tensor) -> torch.Tensor:
    """IoU association cost: ``1 - IoU``."""
    return 1.0 - iou_matrix(track_tlwh, det_tlwh)


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=1e-7)


def cosine_distance_matrix(feats_a: torch.Tensor, feats_b: torch.Tensor,
                           data_is_normalized: bool = False) -> torch.Tensor:
    """Pairwise cosine distance ``1 - cos_sim``, clipped at >= 0."""
    if not data_is_normalized:
        feats_a = _l2_normalize(feats_a)
        feats_b = _l2_normalize(feats_b)
    return torch.clamp(1.0 - feats_a @ feats_b.T, min=0.0)


def appearance_cost_matrix(gallery: torch.Tensor,
                           gallery_valid: torch.Tensor,
                           det_features: torch.Tensor,
                           det_has_feature: torch.Tensor) -> torch.Tensor:
    """Min-over-gallery cosine cost ``(T, N)`` between every track and every
    detection; ``INFTY_COST`` where a track has an empty gallery or a
    detection has no feature."""
    t, g, d = gallery.shape
    gal = _l2_normalize(gallery.reshape(t * g, d))
    det = _l2_normalize(det_features)
    dist = torch.clamp(1.0 - gal @ det.T, min=0.0).reshape(t, g, -1)
    dist = torch.where(gallery_valid[:, :, None], dist,
                       torch.full_like(dist, float("inf")))
    cost = torch.amin(dist, dim=1)
    infty = torch.full_like(cost, INFTY_COST)
    cost = torch.where(torch.any(gallery_valid, dim=1)[:, None], cost, infty)
    cost = torch.where(det_has_feature[None, :], cost, infty)
    return torch.where(torch.isfinite(cost), cost, infty)
