"""The comparison that decides ``correct``: the program's answers against
the reference's, frame by frame, stream by stream.

Tracks (every cell): in each frame the program's emitted tracks and the
reference's are paired by Hungarian matching on 1 - IoU among pairs of one
class with IoU of at least 0.5. From the pairs and the leftovers:

- ``track_miss_share``: tracks of either side left unpaired, over all
  tracks of both sides.
- ``id_switch_share``: pairs whose program id is not the one last paired
  with the same reference id in that stream (a switch, as MOT's IDSW
  counts them), over all pairs; ids are compared through the pairing, so a
  different numbering of the same tracks costs nothing.
- ``conf_gap_p99``: the 99th percentile of |conf - reference conf| over the
  pairs (the score of the detection that updated the track).
- ``box_gap_p99_px``: the 99th percentile over the pairs of the largest
  coordinate difference, in frame pixels.

Detections (where the entry point returns them): the same pairing of the
program's detections with the reference's at or above the output
threshold, giving ``det_miss_share`` and ``det_score_gap_p99``.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

MIN_IOU = 0.5


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = a.astype(np.float64).reshape(-1, 4)
    b = b.astype(np.float64).reshape(-1, 4)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(br - tl, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda x: np.clip(x[:, 2] - x[:, 0], 0, None) * np.clip(
        x[:, 3] - x[:, 1], 0, None)
    union = area(a)[:, None] + area(b)[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def pair(boxes_p, cls_p, boxes_r, cls_r):
    """Indices ``(i, j)`` of the pairs and the unpaired counts."""
    if not len(boxes_p) or not len(boxes_r):
        return [], len(boxes_p), len(boxes_r)
    iou = _iou(np.asarray(boxes_p), np.asarray(boxes_r))
    ok = (iou >= MIN_IOU) & (np.asarray(cls_p)[:, None]
                             == np.asarray(cls_r)[None, :])
    cost = np.where(ok, 1.0 - iou, 2.0)
    ri, ci = linear_sum_assignment(cost)
    pairs = [(i, j) for i, j in zip(ri, ci) if ok[i, j]]
    return pairs, len(boxes_p) - len(pairs), len(boxes_r) - len(pairs)


def _p99(xs) -> float:
    return float(np.percentile(xs, 99)) if len(xs) else 0.0


def compare_tracks(prog: list, ref: list) -> dict:
    """``prog``/``ref``: per stream, per frame, a list of ``(x1, y1, x2,
    y2, id, class, conf)``; frames aligned."""
    paired = unpaired = switches = 0
    conf_gaps, box_gaps = [], []
    for p_stream, r_stream in zip(prog, ref):
        last = {}
        for p, r in zip(p_stream, r_stream):
            bp = [t[:4] for t in p]
            br = [t[:4] for t in r]
            pairs, up, ur = pair(bp, [t[5] for t in p], br,
                                 [t[5] for t in r])
            unpaired += up + ur
            paired += len(pairs)
            for i, j in pairs:
                rid, pid = r[j][4], p[i][4]
                if rid in last and last[rid] != pid:
                    switches += 1
                last[rid] = pid
                conf_gaps.append(abs(p[i][6] - r[j][6]))
                box_gaps.append(float(np.max(np.abs(
                    np.asarray(p[i][:4], np.float64)
                    - np.asarray(r[j][:4], np.float64)))))
    total = 2 * paired + unpaired
    return {"track_miss_share": unpaired / total if total else 0.0,
            "id_switch_share": switches / paired if paired else 0.0,
            "conf_gap_p99": _p99(conf_gaps),
            "box_gap_p99_px": _p99(box_gaps),
            "tracks_paired": paired, "tracks_unpaired": unpaired}


def compare_dets(prog: list, ref: list) -> dict:
    """``prog``/``ref``: per frame ``(boxes (n, 4), scores (n,), classes
    (n,))``."""
    paired = unpaired = 0
    gaps = []
    for (bp, sp, cp), (br, sr, cr) in zip(prog, ref):
        pairs, up, ur = pair(bp, cp, br, cr)
        unpaired += up + ur
        paired += len(pairs)
        gaps += [abs(float(sp[i]) - float(sr[j])) for i, j in pairs]
    total = 2 * paired + unpaired
    return {"det_miss_share": unpaired / total if total else 0.0,
            "det_score_gap_p99": _p99(gaps),
            "dets_paired": paired, "dets_unpaired": unpaired}


def judge(numbers: dict, limits: dict):
    """``(correct, checks)``: every limited number at or below its limit;
    ``checks`` maps each to ``{"value", "limit"}``."""
    checks = {k: {"value": numbers[k], "limit": v}
              for k, v in limits.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
