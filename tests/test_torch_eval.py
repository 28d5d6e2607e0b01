"""Port: the tracking and detection metrics (``eval.py``) against the JAX
package's on seeded sequences, field for field and exactly: the code and
the solver (``scipy.optimize.linear_sum_assignment``) are the same."""

import math

import numpy as np
import pytest

from aicamera_tpu import eval as jeval
from aicamera_tpu_torch import eval as teval

SEEDS = range(6)


def _same(a, b):
    """Exact equality of result dicts, NaN equal to NaN."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return type(a) is type(b) and a == b


def _sequence(seed, n_frames=30, n_obj=6):
    """Per-frame (gt, hyp) lists with misses, false positives, id swaps and
    fragments, jitter, empty frames, duplicated hypotheses (tied costs) and
    two gt ids that come to share their last hyp id."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 300, (n_obj, 2))
    size = rng.uniform(20, 60, (n_obj, 2))
    vel = rng.normal(0, 4, (n_obj, 2))
    hyp_ids = np.arange(101, 101 + n_obj)
    gt, hyp = [], []
    for t in range(n_frames):
        boxes = np.concatenate([pos, pos + size], 1).astype(np.float32)
        present = rng.random(n_obj) < 0.85
        if t in (3, 4):
            present[:] = False              # empty gt frames
        if t == 10:
            hyp_ids[[0, 1]] = hyp_ids[[1, 0]]   # an id swap
        if t == 15:
            hyp_ids[2] = 500 + seed         # a fragment
        seen = present & (rng.random(n_obj) < 0.85)
        if t == 4:
            seen[:] = False                 # an empty frame on both sides
        hb = boxes[seen] + rng.normal(0, 2.5, (seen.sum(), 4))
        hid = hyp_ids[seen]
        g_b, g_i = boxes[present], np.flatnonzero(present) + 1
        if t in (20, 21, 22):
            # gt 90 and 91 sit on one box; hyp 900 follows 90, then (90
            # unseen) 91, then both are back: they share last hyp 900
            both = np.array([[400, 400, 440, 460]], np.float32)
            if t != 21:
                g_b, g_i = np.concatenate([g_b, both]), np.append(g_i, 90)
            g_b, g_i = np.concatenate([g_b, both]), np.append(g_i, 91)
            hb, hid = np.concatenate([hb, both]), np.append(hid, 900)
        if t % 7 == 5 and len(hb):
            # a duplicate of a hypothesis box under another id: tied costs
            hb, hid = np.concatenate([hb, hb[:1]]), np.append(hid, 700 + t)
        n_fp = int(rng.integers(0, 3))
        xy = rng.uniform(0, 300, (n_fp, 2))
        hb = np.concatenate([hb, np.concatenate([xy, xy + 30], 1)])
        hid = np.append(hid, 800 + 10 * t + np.arange(n_fp))
        gt.append((g_b.astype(np.float32), g_i))
        hyp.append((hb.astype(np.float32), hid.astype(np.int64)))
        pos += vel
    return gt, hyp


@pytest.mark.parametrize("iou", [0.5, 0.3])
@pytest.mark.parametrize("seed", SEEDS)
def test_evaluate_mot_matches_jax(seed, iou):
    gt, hyp = _sequence(seed)
    ours = teval.evaluate_mot(gt, hyp, iou_threshold=iou)
    ref = jeval.evaluate_mot(gt, hyp, iou_threshold=iou)
    assert _same(ours.as_dict(), ref.as_dict())
    assert ref.id_switches > 0 and ref.false_positives > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_evaluate_hota_matches_jax(seed):
    gt, hyp = _sequence(seed)
    ours = teval.evaluate_hota(gt, hyp)
    assert _same(ours.as_dict(), jeval.evaluate_hota(gt, hyp).as_dict())
    assert 0 < ours.hota < 1


@pytest.mark.parametrize("iou", [0.5, 0.3])
@pytest.mark.parametrize("seed", SEEDS)
def test_evaluate_identity_matches_jax(seed, iou):
    gt, hyp = _sequence(seed)
    ours = teval.evaluate_identity(gt, hyp, iou_threshold=iou)
    ref = jeval.evaluate_identity(gt, hyp, iou_threshold=iou)
    assert _same(ours.as_dict(), ref.as_dict())


def _detections(seed, n_frames=12):
    """Per-frame gt (boxes, class ids) and predictions (boxes, scores,
    class ids): jittered hits, misclassifications, tied scores, a class
    predicted that no gt has, and empty frames."""
    rng = np.random.default_rng(100 + seed)
    gt, pred = [], []
    for t in range(n_frames):
        n = 0 if t == 2 else int(rng.integers(1, 6))
        xy = rng.uniform(0, 400, (n, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(20, 80, (n, 2))], 1)
        cls = rng.choice([0, 2, 5], n)
        keep = rng.random(n) < 0.8
        pb = boxes[keep] + rng.normal(0, rng.uniform(1, 12), (keep.sum(), 4))
        pc = np.where(rng.random(keep.sum()) < 0.9, cls[keep], 7)
        ps = np.round(rng.uniform(0.3, 1.0, keep.sum()), 1)   # ties
        n_fp = 0 if t == 5 else int(rng.integers(0, 3))
        fxy = rng.uniform(0, 400, (n_fp, 2))
        pb = np.concatenate([pb, np.concatenate([fxy, fxy + 40], 1)])
        pc = np.append(pc, rng.choice([0, 2, 9], n_fp))
        ps = np.append(ps, rng.uniform(0.1, 0.9, n_fp))
        gt.append((boxes.astype(np.float32), cls))
        pred.append((pb.astype(np.float32), ps.astype(np.float32), pc))
    return gt, pred


@pytest.mark.parametrize("seed", SEEDS)
def test_evaluate_detections_matches_jax(seed):
    gt, pred = _detections(seed)
    ours = teval.evaluate_detections(gt, pred)
    ref = jeval.evaluate_detections(gt, pred)
    assert _same(ours.as_dict(), ref.as_dict())
    assert 0 < ours.ap50 <= 1


def test_empty_sequences_match_jax():
    """No ground truth and no hypotheses: the same NaNs and zeros."""
    empty = (np.zeros((0, 4), np.float32), np.zeros(0, np.int64))
    frames = [empty] * 3
    for fn in ("evaluate_mot", "evaluate_hota", "evaluate_identity"):
        ours = getattr(teval, fn)(frames, frames)
        assert _same(ours.as_dict(), getattr(jeval, fn)(frames,
                                                        frames).as_dict())
    dets = [(np.zeros((0, 4), np.float32), np.zeros(0, np.float32),
             np.zeros(0, np.int64))] * 3
    labels = [(np.zeros((0, 4), np.float32), np.zeros(0, np.int64))] * 3
    assert _same(teval.evaluate_detections(labels, dets).as_dict(),
                 jeval.evaluate_detections(labels, dets).as_dict())
