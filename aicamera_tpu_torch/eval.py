"""Evaluation: CLEAR-MOT, HOTA and IDF1 tracking metrics, COCO detection AP.

The port's own copy of ``aicamera_tpu/eval.py`` (the port imports nothing of
the JAX package). Host numpy code, as there: :func:`evaluate_mot` (CLEAR-MOT
with IoU-gated Hungarian correspondence and kept matches),
:func:`evaluate_hota` (HOTA, Luiten et al., IJCV 2021), :func:`evaluate_identity`
(IDF1/IDP/IDR, Ristani et al., ECCV 2016) and :func:`evaluate_detections`
(AP50/AP75/mAP@[.5:.95], COCO 101-point protocol). It solves with
``scipy.optimize.linear_sum_assignment``, the JAX package's solver, so that
where costs tie both packages pick the same pairs and count the same ID
switches.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment


@dataclasses.dataclass
class MOTResult:
    mota: float
    motp: float          # mean IoU over matched pairs (higher is better)
    id_switches: int
    false_positives: int
    misses: int
    matches: int
    num_gt: int

    def as_dict(self):
        return dataclasses.asdict(self)


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4) x (M,4) xyxy -> (N,M) IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter,
                              1e-9)


def evaluate_mot(gt_frames: Sequence[Tuple[np.ndarray, np.ndarray]],
                 hyp_frames: Sequence[Tuple[np.ndarray, np.ndarray]],
                 iou_threshold: float = 0.5) -> MOTResult:
    """CLEAR-MOT over a sequence.

    Args:
        gt_frames: per frame, (boxes_xyxy (N,4), ids (N,)) ground truth.
        hyp_frames: per frame, (boxes_xyxy (M,4), ids (M,)) tracker output.
        iou_threshold: minimum IoU for a valid correspondence.

    Returns:
        MOTResult with MOTA = 1 - (FN + FP + IDSW) / num_gt and MOTP =
        mean IoU of matched pairs.
    """
    assert len(gt_frames) == len(hyp_frames)
    last_match: Dict[int, int] = {}  # gt id -> hyp id from previous frames
    fp = fn = idsw = matches = num_gt = 0
    iou_sum = 0.0

    for (gt_boxes, gt_ids), (hyp_boxes, hyp_ids) in zip(gt_frames,
                                                        hyp_frames):
        gt_boxes = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
        hyp_boxes = np.asarray(hyp_boxes, np.float32).reshape(-1, 4)
        gt_ids = np.asarray(gt_ids).reshape(-1)
        hyp_ids = np.asarray(hyp_ids).reshape(-1)
        num_gt += len(gt_ids)

        iou = _iou_matrix(gt_boxes, hyp_boxes)
        matched_gt = set()
        matched_hyp = set()

        # CLEAR-MOT: keep last known correspondences when still valid.
        # A kept pair has the same hyp id as before, so it can never be a
        # switch; switches surface in the Hungarian stage when the kept
        # hyp is gone/gated or (after the claimed-check below) was taken
        # by the gt that last owned it.
        for gi, g_id in enumerate(gt_ids):
            if g_id in last_match:
                h_id = last_match[g_id]
                hj = np.flatnonzero(hyp_ids == h_id)
                # the claimed-check matters when two gt ids share a last
                # hyp id (the hyp jumped objects): only one may keep it;
                # the other must re-match and be charged a switch
                if (len(hj) and int(hj[0]) not in matched_hyp
                        and iou[gi, hj[0]] >= iou_threshold):
                    matched_gt.add(gi)
                    matched_hyp.add(int(hj[0]))
                    iou_sum += float(iou[gi, hj[0]])
                    matches += 1

        # Hungarian on the rest
        free_gt = [i for i in range(len(gt_ids)) if i not in matched_gt]
        free_hyp = [j for j in range(len(hyp_ids)) if j not in matched_hyp]
        if free_gt and free_hyp:
            sub = 1.0 - iou[np.ix_(free_gt, free_hyp)]
            ri, ci = linear_sum_assignment(sub)
            for r, c in zip(ri, ci):
                gi, hj = free_gt[r], free_hyp[c]
                if iou[gi, hj] >= iou_threshold:
                    g_id, h_id = int(gt_ids[gi]), int(hyp_ids[hj])
                    if g_id in last_match and last_match[g_id] != h_id:
                        idsw += 1
                    last_match[g_id] = h_id
                    matched_gt.add(gi)
                    matched_hyp.add(hj)
                    iou_sum += float(iou[gi, hj])
                    matches += 1

        fn += len(gt_ids) - len(matched_gt)
        fp += len(hyp_ids) - len(matched_hyp)

    mota = 1.0 - (fn + fp + idsw) / max(num_gt, 1)
    motp = iou_sum / max(matches, 1)
    return MOTResult(mota=mota, motp=motp, id_switches=idsw,
                     false_positives=fp, misses=fn, matches=matches,
                     num_gt=num_gt)


@dataclasses.dataclass
class HOTAResult:
    """HOTA and its decomposition, each averaged over the 19 localization
    thresholds alpha = 0.05:0.05:0.95 (the official protocol)."""
    hota: float          # mean over alphas of sqrt(DetA(a) * AssA(a))
    det_a: float         # detection accuracy TP/(TP+FN+FP)
    ass_a: float         # association accuracy (mean A(c) over TPs)
    loc_a: float         # mean IoU over TPs
    hota_by_alpha: Dict[float, float]
    num_gt: int
    num_hyp: int

    def as_dict(self):
        return dataclasses.asdict(self)


def evaluate_hota(gt_frames: Sequence[Tuple[np.ndarray, np.ndarray]],
                  hyp_frames: Sequence[Tuple[np.ndarray, np.ndarray]],
                  alphas: Sequence[float] = tuple(np.arange(0.05, 0.96,
                                                            0.05)),
                  ) -> HOTAResult:
    """HOTA over a sequence (the TrackEval reference algorithm).

    Two passes: first a global-alignment prior (accumulated per-frame
    Jaccard'd similarities per (gt id, hyp id) pair), then per-frame
    Hungarian matching on ``global_alignment * IoU`` so ties break toward
    temporally consistent identities; a matched pair is a TP at every
    alpha its IoU clears. ``AssA(a)`` averages, over TPs, the pair's
    association Jaccard ``TPA / (TPA + FNA + FPA)``.

    Args / returns: same per-frame (boxes_xyxy, ids) contract as
    :func:`evaluate_mot`. All-empty ground truth yields NaN scores.
    """
    assert len(gt_frames) == len(hyp_frames)
    eps = np.finfo(np.float64).eps
    frames = []
    gt_map: Dict[int, int] = {}
    hyp_map: Dict[int, int] = {}
    for (g_boxes, g_ids), (h_boxes, h_ids) in zip(gt_frames, hyp_frames):
        g_boxes = np.asarray(g_boxes, np.float32).reshape(-1, 4)
        h_boxes = np.asarray(h_boxes, np.float32).reshape(-1, 4)
        gi = np.array([gt_map.setdefault(int(i), len(gt_map))
                       for i in np.asarray(g_ids).reshape(-1)], int)
        hi = np.array([hyp_map.setdefault(int(i), len(hyp_map))
                       for i in np.asarray(h_ids).reshape(-1)], int)
        frames.append((gi, hi, _iou_matrix(g_boxes, h_boxes).astype(
            np.float64)))

    n_g, n_h = len(gt_map), len(hyp_map)
    num_gt = sum(len(gi) for gi, _, _ in frames)
    num_hyp = sum(len(hi) for _, hi, _ in frames)
    alphas = [float(a) for a in alphas]
    if n_g == 0:
        nan = float("nan")
        return HOTAResult(nan, nan, nan, nan,
                          {round(a, 2): nan for a in alphas}, 0, num_hyp)

    # pass 1: global alignment prior
    potential = np.zeros((n_g, n_h), np.float64)
    g_count = np.zeros(n_g, np.float64)
    h_count = np.zeros(n_h, np.float64)
    for gi, hi, sim in frames:
        if len(gi) and len(hi):
            denom = sim.sum(0)[None, :] + sim.sum(1)[:, None] - sim
            j = np.zeros_like(sim)
            m = denom > eps
            j[m] = sim[m] / denom[m]
            potential[np.ix_(gi, hi)] += j
        g_count[gi] += 1
        h_count[hi] += 1
    align = potential / np.maximum(
        g_count[:, None] + h_count[None, :] - potential, eps)

    # pass 2: per-frame matching, TP/FN/FP + pair counts per alpha
    n_a = len(alphas)
    tp = np.zeros(n_a)
    fn = np.zeros(n_a)
    fp = np.zeros(n_a)
    loc = np.zeros(n_a)
    pair = [np.zeros((n_g, n_h), np.float64) for _ in range(n_a)]
    for gi, hi, sim in frames:
        if len(gi) and len(hi):
            score = align[np.ix_(gi, hi)] * sim
            r, c = linear_sum_assignment(-score)
            matched_sim = sim[r, c]
        else:
            r = c = np.zeros(0, int)
            matched_sim = np.zeros(0)
        for a, alpha in enumerate(alphas):
            ok = matched_sim >= alpha - eps
            k = int(ok.sum())
            tp[a] += k
            fn[a] += len(gi) - k
            fp[a] += len(hi) - k
            loc[a] += float(matched_sim[ok].sum())
            if k:
                pair[a][gi[r[ok]], hi[c[ok]]] += 1

    hota_a = np.zeros(n_a)
    det_a = np.zeros(n_a)
    ass_a = np.zeros(n_a)
    loc_a = np.zeros(n_a)
    for a in range(n_a):
        ass_iou = pair[a] / np.maximum(
            g_count[:, None] + h_count[None, :] - pair[a], eps)
        ass_a[a] = float((pair[a] * ass_iou).sum()) / max(tp[a], 1.0)
        det_a[a] = tp[a] / max(tp[a] + fn[a] + fp[a], 1.0)
        loc_a[a] = loc[a] / max(tp[a], 1.0)
        hota_a[a] = float(np.sqrt(det_a[a] * ass_a[a]))
    return HOTAResult(
        hota=float(hota_a.mean()), det_a=float(det_a.mean()),
        ass_a=float(ass_a.mean()), loc_a=float(loc_a.mean()),
        hota_by_alpha={round(al, 2): float(h)
                       for al, h in zip(alphas, hota_a)},
        num_gt=num_gt, num_hyp=num_hyp)


@dataclasses.dataclass
class IdentityResult:
    """Identity metrics (Ristani et al., ECCV 2016): trajectory-level
    identity precision/recall/F1 under a GLOBAL one-to-one gt<->hyp
    trajectory assignment (contrast CLEAR-MOT, which re-matches per frame
    and counts switches locally)."""
    idf1: float
    idp: float           # IDTP / (IDTP + IDFP)
    idr: float           # IDTP / (IDTP + IDFN)
    idtp: int
    idfp: int
    idfn: int
    num_gt: int
    num_hyp: int

    def as_dict(self):
        return dataclasses.asdict(self)


def evaluate_identity(gt_frames: Sequence[Tuple[np.ndarray, np.ndarray]],
                      hyp_frames: Sequence[Tuple[np.ndarray, np.ndarray]],
                      iou_threshold: float = 0.5) -> IdentityResult:
    """IDF1/IDP/IDR over a sequence (the TrackEval Identity algorithm).

    Per frame, every (gt box, hyp box) pair with IoU >= ``iou_threshold``
    counts as a potential match for its (gt id, hyp id) trajectory pair —
    no per-frame bijection; one-to-one-ness is enforced only globally.
    A single linear assignment over trajectories (with per-trajectory
    dummy columns/rows for the unmatched case) then minimizes
    ``IDFN + IDFP``; IDTP = total gt detections - IDFN.

    Args / returns: same per-frame (boxes_xyxy, ids) contract as
    :func:`evaluate_mot`. All-empty gt AND hyp yields NaN scores.
    """
    assert len(gt_frames) == len(hyp_frames)
    gt_map: Dict[int, int] = {}
    hyp_map: Dict[int, int] = {}
    per_frame = []
    for (g_boxes, g_ids), (h_boxes, h_ids) in zip(gt_frames, hyp_frames):
        g_boxes = np.asarray(g_boxes, np.float32).reshape(-1, 4)
        h_boxes = np.asarray(h_boxes, np.float32).reshape(-1, 4)
        gi = np.array([gt_map.setdefault(int(i), len(gt_map))
                       for i in np.asarray(g_ids).reshape(-1)], int)
        hi = np.array([hyp_map.setdefault(int(i), len(hyp_map))
                       for i in np.asarray(h_ids).reshape(-1)], int)
        per_frame.append((gi, hi, _iou_matrix(g_boxes, h_boxes)))

    n_g, n_h = len(gt_map), len(hyp_map)
    gt_count = np.zeros(n_g, np.float64)
    hyp_count = np.zeros(n_h, np.float64)
    potential = np.zeros((n_g, n_h), np.float64)
    for gi, hi, iou in per_frame:
        gt_count[gi] += 1
        hyp_count[hi] += 1
        if len(gi) and len(hi):
            mg, mh = np.nonzero(iou >= iou_threshold)
            np.add.at(potential, (gi[mg], hi[mh]), 1.0)

    num_gt = int(gt_count.sum())
    num_hyp = int(hyp_count.sum())
    if n_g == 0 and n_h == 0:
        nan = float("nan")
        return IdentityResult(nan, nan, nan, 0, 0, 0, 0, 0)

    # Padded square assignment (TrackEval identity.py): row i<n_g is gt
    # trajectory i, row n_g+j is hyp j's "unmatched" dummy; col j<n_h is
    # hyp trajectory j, col n_h+i is gt i's dummy. Off-diagonal dummy
    # pairings are forbidden via a large cost.
    big = 1e10
    fn_mat = np.zeros((n_g + n_h, n_g + n_h))
    fp_mat = np.zeros_like(fn_mat)
    fn_mat[:n_g, n_h:] = big
    fp_mat[n_g:, :n_h] = big
    for g in range(n_g):
        fn_mat[g, :n_h] = gt_count[g]
        fn_mat[g, n_h + g] = gt_count[g]
    for h in range(n_h):
        fp_mat[:n_g, h] = hyp_count[h]
        fp_mat[n_g + h, h] = hyp_count[h]
    fn_mat[:n_g, :n_h] -= potential
    fp_mat[:n_g, :n_h] -= potential

    rows, cols = linear_sum_assignment(fn_mat + fp_mat)
    idfn = int(fn_mat[rows, cols].sum())
    idfp = int(fp_mat[rows, cols].sum())
    idtp = num_gt - idfn
    idf1 = idtp / max(idtp + 0.5 * idfn + 0.5 * idfp, 1e-9)
    return IdentityResult(
        idf1=float(idf1),
        idp=idtp / max(idtp + idfp, 1e-9),
        idr=idtp / max(idtp + idfn, 1e-9),
        idtp=idtp, idfp=idfp, idfn=idfn,
        num_gt=num_gt, num_hyp=num_hyp)


@dataclasses.dataclass
class DetectionAPResult:
    map_5095: float                 # mean AP over IoU .50:.05:.95
    ap50: float
    ap75: float
    per_class_ap50: Dict[int, float]
    num_gt: int
    num_pred: int

    def as_dict(self):
        return dataclasses.asdict(self)


def _average_precision(scores: np.ndarray, tp: np.ndarray,
                       num_gt: int) -> float:
    """COCO 101-point interpolated AP for one class at one IoU threshold.

    Args:
        scores: (P,) prediction confidences (any order).
        tp: (P,) 1.0 where the prediction matched an unclaimed gt box.
        num_gt: total ground-truth boxes of this class.
    """
    if num_gt == 0:
        return float("nan")
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp = tp[order]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(1.0 - tp)
    recall = cum_tp / num_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-9)
    # precision envelope (monotone non-increasing from the right)
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    # 101-point interpolation: p at the first recall point >= each level
    levels = np.linspace(0.0, 1.0, 101)
    idx = np.searchsorted(recall, levels, side="left")
    p_at = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0)
    return float(p_at.mean())


def _match_tp(gt_by_frame: List[np.ndarray], preds: List[Tuple[int, float, np.ndarray]],
              thr: float) -> np.ndarray:
    """Greedy COCO matching at one IoU threshold.

    Predictions (already one class) are visited in descending score; each
    claims the highest-IoU unclaimed gt box in its frame if IoU >= thr.
    Returns a tp flag per prediction, aligned with ``preds`` order.
    """
    order = sorted(range(len(preds)), key=lambda i: -preds[i][1])
    claimed = [np.zeros(len(g), bool) for g in gt_by_frame]
    tp = np.zeros(len(preds), np.float64)
    for i in order:
        fi, _, box = preds[i]
        gt = gt_by_frame[fi]
        if len(gt) == 0:
            continue
        iou = _iou_matrix(box.reshape(1, 4), gt)[0]
        iou = np.where(claimed[fi], -1.0, iou)
        j = int(np.argmax(iou))
        if iou[j] >= thr:
            claimed[fi][j] = True
            tp[i] = 1.0
    return tp


def evaluate_detections(
        gt_frames: Sequence[Tuple[np.ndarray, np.ndarray]],
        pred_frames: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
        iou_thresholds: Sequence[float] = tuple(np.arange(0.5, 1.0, 0.05)),
) -> DetectionAPResult:
    """COCO-protocol detection AP over a set of frames.

    Args:
        gt_frames: per frame, (boxes_xyxy (N,4), class_ids (N,)).
        pred_frames: per frame, (boxes_xyxy (M,4), scores (M,),
            class_ids (M,)).
        iou_thresholds: IoU levels to average over (default .50:.05:.95).

    Returns:
        DetectionAPResult. Classes with no ground truth anywhere are
        excluded from the means (COCO convention); a class with gt but no
        predictions scores 0.
    """
    assert len(gt_frames) == len(pred_frames)
    gt = [(np.asarray(b, np.float32).reshape(-1, 4),
           np.asarray(i).reshape(-1).astype(int)) for b, i in gt_frames]
    pred_cls: Dict[int, List[Tuple[int, float, np.ndarray]]] = {}
    num_pred_total = 0
    for fi, (p_boxes, p_scores, p_ids) in enumerate(pred_frames):
        p_boxes = np.asarray(p_boxes, np.float32).reshape(-1, 4)
        p_scores = np.asarray(p_scores, np.float64).reshape(-1)
        p_ids = np.asarray(p_ids).reshape(-1).astype(int)
        num_pred_total += len(p_ids)
        for j in range(len(p_ids)):
            pred_cls.setdefault(int(p_ids[j]), []).append(
                (fi, float(p_scores[j]), p_boxes[j]))

    num_gt_total = sum(len(i) for _, i in gt)
    classes = sorted({int(c) for _, ids in gt for c in ids.tolist()})
    thr_keys = [round(float(t), 2) for t in iou_thresholds]
    ap: Dict[int, Dict[float, float]] = {}
    for c in classes:
        gt_by_frame = [b[i == c] for b, i in gt]
        n_gt_c = sum(len(g) for g in gt_by_frame)
        preds = pred_cls.get(c, [])
        scores = np.array([s for _, s, _ in preds], np.float64)
        ap[c] = {t: _average_precision(scores,
                                       _match_tp(gt_by_frame, preds, t),
                                       n_gt_c)
                 for t in thr_keys}

    def _mean(vals):
        """Mean over computed APs; NaN when nothing was computed (no gt
        anywhere, or the threshold was not evaluated) — consistent with
        per_class_ap50, and distinguishable from a genuine 0.0 score."""
        vals = [v for v in vals if not np.isnan(v)]
        return float(np.mean(vals)) if vals else float("nan")

    map_5095 = _mean([ap[c][t] for c in classes for t in thr_keys])
    ap50 = _mean([ap[c][0.5] for c in classes if 0.5 in ap[c]])
    ap75 = _mean([ap[c][0.75] for c in classes if 0.75 in ap[c]])
    return DetectionAPResult(
        map_5095=map_5095, ap50=ap50, ap75=ap75,
        per_class_ap50={c: ap[c].get(0.5, float("nan")) for c in classes},
        num_gt=num_gt_total, num_pred=num_pred_total)
