"""Offline track post-processing: gap interpolation and GSI smoothing.

The port's own copy of ``aicamera_tpu/postprocess.py``: StrongSORT's GSI
stage (Du et al., 2023). After tracking, each trajectory's missing frames are
filled by linear interpolation, and each coordinate's time series is smoothed
by Gaussian-process regression with an RBF kernel. Host numpy code that runs
once a sequence on results, never on the hot path. Input and output are the
per-frame ``(boxes_xyxy (N, 4), ids (N,))`` lists of :mod:`.eval` and
:mod:`.mot`.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

Frames = Sequence[Tuple[np.ndarray, np.ndarray]]


def _to_per_track(frames: Frames):
    """-> {track_id: (ts (T,), boxes (T, 4))} sorted by frame index."""
    per = {}
    for t, (boxes, ids) in enumerate(frames):
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        ids = np.asarray(ids).reshape(-1)
        for b, i in zip(boxes, ids):
            per.setdefault(int(i), []).append((t, b))
    return {i: (np.array([t for t, _ in obs]),
                np.stack([b for _, b in obs]))
            for i, obs in per.items()}


def _to_frames(per_track, n_frames: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    out_boxes = [[] for _ in range(n_frames)]
    out_ids = [[] for _ in range(n_frames)]
    for i, (ts, boxes) in per_track.items():
        for t, b in zip(ts, boxes):
            out_boxes[int(t)].append(b)
            out_ids[int(t)].append(i)
    return [(np.stack(b) if b else np.zeros((0, 4), np.float32),
             np.asarray(i, np.int64))
            for b, i in zip(out_boxes, out_ids)]


def interpolate_tracks(frames: Frames,
                       max_gap: int = 20) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Fill each track's missing frames by linear interpolation.

    A gap between two sightings of the same id is filled only when it
    spans at most ``max_gap`` frames (longer gaps are likelier to be a
    revived id than a tracked occlusion; StrongSORT's GSI uses the same
    guard). Frame count, ids and observed boxes are preserved exactly —
    only new (frame, box) rows are added.
    """
    n_frames = len(frames)
    per = _to_per_track(frames)
    filled = {}
    for i, (ts, boxes) in per.items():
        new_ts = [ts[0]]
        new_boxes = [boxes[0]]
        for k in range(1, len(ts)):
            gap = int(ts[k] - ts[k - 1])
            if 1 < gap <= max_gap:
                for g in range(1, gap):
                    w = g / gap
                    new_ts.append(ts[k - 1] + g)
                    new_boxes.append((1 - w) * boxes[k - 1] + w * boxes[k])
            new_ts.append(ts[k])
            new_boxes.append(boxes[k])
        filled[i] = (np.asarray(new_ts), np.stack(new_boxes))
    return _to_frames(filled, n_frames)


def gsi_smooth(frames: Frames, tau: float = 10.0,
               noise: float = 1.0,
               max_gap: int = 20) -> List[Tuple[np.ndarray, np.ndarray]]:
    """GSI: gap interpolation + Gaussian-process smoothing per track.

    Each trajectory coordinate (cx, cy, w, h) is regressed on time with
    an RBF kernel ``exp(-(ti-tj)^2 / (2 tau^2))`` plus observation noise
    ``noise^2`` — the closed-form GP posterior mean at the observed
    times (StrongSORT GSI uses the same model; tau there is ~10 frames).
    Short tracks (< 4 sightings) pass through untouched — too little
    data to smooth meaningfully.
    """
    inter = interpolate_tracks(frames, max_gap=max_gap)
    per = _to_per_track(inter)
    smoothed = {}
    for i, (ts, boxes) in per.items():
        if len(ts) < 4:
            smoothed[i] = (ts, boxes)
            continue
        t = ts.astype(np.float64)
        # cx, cy, w, h are smoother targets than corner coordinates
        cx = (boxes[:, 0] + boxes[:, 2]) / 2.0
        cy = (boxes[:, 1] + boxes[:, 3]) / 2.0
        w = boxes[:, 2] - boxes[:, 0]
        h = boxes[:, 3] - boxes[:, 1]
        d2 = (t[:, None] - t[None, :]) ** 2
        k = np.exp(-d2 / (2.0 * tau * tau))
        a = k + (noise ** 2) * np.eye(len(t))
        y = np.stack([cx, cy, w, h], axis=-1).astype(np.float64)
        # a zero-mean GP prior shrinks absolute coordinates toward 0 —
        # regress on residuals of a per-track linear trend instead (the
        # sklearn GPR StrongSORT uses normalizes y the same way; the
        # linear detrend additionally keeps constant-velocity ends exact)
        design = np.stack([np.ones_like(t), t], axis=-1)
        coef, *_ = np.linalg.lstsq(design, y, rcond=None)
        trend = design @ coef
        post = k @ np.linalg.solve(a, y - trend) + trend
        scx, scy, sw, sh = post.T
        sw = np.maximum(sw, 1e-3)
        sh = np.maximum(sh, 1e-3)
        out = np.stack([scx - sw / 2, scy - sh / 2,
                        scx + sw / 2, scy + sh / 2], axis=-1)
        smoothed[i] = (ts, out.astype(np.float32))
    return _to_frames(smoothed, len(inter))
