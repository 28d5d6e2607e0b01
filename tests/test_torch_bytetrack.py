"""Port: the ByteTrack core (and its BoT-SORT mode) against the JAX core,
frame by frame over seeded scenes of moving boxes."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from aicamera_tpu.core import bytetrack as jbt  # noqa: E402
from aicamera_tpu_torch.core import bytetrack as tbt  # noqa: E402
from aicamera_tpu_torch.core.assignment import TRACKER_SYNCS  # noqa: E402
from aicamera_tpu_torch.scenes import moving_boxes  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    PyTorch's thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_bytetrack.py's sizes (shared JAX compile cache)
SMALL = dict(max_tracks=32, max_detections=16, max_time_lost=8)
FLOAT_TOL = 1e-4  # mean, cov, score, boxes; the worst seen is printed


def _tlwh(xyxy):
    return np.concatenate([xyxy[:, :2], xyxy[:, 2:] - xyxy[:, :2]], 1)


def _features(rng, cls, dim, drop=0.15):
    """One unit direction per class plus noise; some rows zero (no
    feature)."""
    base = np.random.RandomState(99).normal(size=(8, dim))
    f = base[cls] + 0.3 * rng.normal(size=(len(cls), dim))
    f[rng.uniform(size=len(cls)) < drop] = 0.0
    return f.astype(np.float32)


def compare_states(ours, ref, worst, floors=None):
    """Bool and integer fields identical; float fields within FLOAT_TOL of
    the track's scale: the largest magnitude in that track's row or matrix,
    and at least 1 or the field's entry in ``floors``."""
    floors = floors or {}
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        assert (a is None) == (b is None), f.name
        if a is None:
            continue
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, f.name
        if a.dtype.kind != "f":
            assert a.dtype == b.dtype, (f.name, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            continue
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b),
                                      err_msg=f.name)
        mag = np.where(np.isfinite(b), np.abs(b), 0.0)
        if b.ndim >= 2:
            mag = mag.max(axis=tuple(range(1, b.ndim)), keepdims=True)
        diff = np.where(np.isfinite(b), np.abs(a - b), 0.0) \
            / np.maximum(mag, floors.get(f.name, 1.0))
        assert diff.max(initial=0.0) <= FLOAT_TOL, (f.name, diff.max())
        worst[0] = max(worst[0], float(diff.max(initial=0.0)))


def compare_outputs(ours, ref):
    tlbr, ids, cls, score, mask = (t.numpy() for t in ours)
    j_tlbr, j_ids, j_cls, j_score, j_mask = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(mask, j_mask)
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_array_equal(cls, j_cls)
    np.testing.assert_allclose(tlbr, j_tlbr, atol=FLOAT_TOL, rtol=FLOAT_TOL)
    np.testing.assert_allclose(score, j_score, atol=FLOAT_TOL)
    return int(mask.sum())


def run_both(scene, kw, seed):
    tp, jp = tbt.ByteTrackParams(**kw), jbt.ByteTrackParams(**kw)
    st, js = tbt.init_state(tp), jbt.init_state(jp)
    rng = np.random.RandomState(seed)
    worst, emitted, lost_seen = [0.0], 0, False
    for xyxy, score, cls in scene:
        n = tp.max_detections
        xyxy, score, cls = xyxy[:n], score[:n], cls[:n]
        feat = (_features(rng, cls, tp.feature_dim)
                if tp.with_appearance else None)
        st = tbt.step(st, tbt.make_detections(
            _tlwh(xyxy), score, cls, feature=feat, params=tp), tp)
        js = jbt.step(js, jbt.make_detections(
            _tlwh(xyxy), score, cls, feature=feat, params=jp), jp)
        compare_states(st, js, worst)
        emitted += compare_outputs(tbt.get_outputs(st), jbt.get_outputs(js))
        lost_seen |= bool((st.active & (st.state == tbt.LOST)).any())
    print(f"worst |diff| of a float field over its track's scale: "
          f"{worst[0]:.3g}")
    return st, emitted, lost_seen


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_matches_jax(seed):
    """Births, misses, low-score second-stage matches, lost and revived
    tracks, clutter and duplicates, 30 frames."""
    scene = moving_boxes(30, n_objects=7, seed=seed, miss=0.15, low=0.3,
                         gaps=[(0, 8, 12), (1, 15, 26)])
    before = TRACKER_SYNCS.count
    st, emitted, lost_seen = run_both(scene, SMALL, seed)
    assert emitted > 30 and lost_seen
    assert int(st.next_id) > 8          # births beyond the first frame
    assert TRACKER_SYNCS.count == before  # the step reads nothing back


def test_step_matches_jax_at_capacity():
    """More objects than track slots: the overflow is counted in
    ``dropped`` and the lowest free slots are taken, as in JAX."""
    kw = dict(max_tracks=4, max_detections=16)
    st, emitted, _ = run_both(moving_boxes(10, n_objects=9, seed=5, miss=0.0,
                                           low=0.0, clutter=0.0), kw, 5)
    assert int(st.dropped) > 0 and emitted > 0


@pytest.mark.parametrize("seed", [0, 3])
def test_botsort_step_matches_jax(seed):
    """``with_appearance=True``: the fused cost of stages 1 and 3 and the
    EMA bank, with seeded features (some detections without one)."""
    kw = dict(SMALL, with_appearance=True, feature_dim=32)
    scene = moving_boxes(24, n_objects=6, seed=seed, miss=0.15, low=0.25,
                         gaps=[(2, 6, 11)])
    st, emitted, _ = run_both(scene, kw, seed)
    assert emitted > 20 and bool(st.has_feat.any())
    norms = torch.linalg.vector_norm(st.feat[st.has_feat], dim=-1)
    np.testing.assert_allclose(norms.numpy(), 1.0, atol=1e-5)


def test_score_equal_to_the_threshold_is_in_neither_split():
    """A score of exactly ``track_thresh`` is neither high nor low: no
    track starts, in both packages."""
    tp, jp = tbt.ByteTrackParams(**SMALL), jbt.ByteTrackParams(**SMALL)
    box = np.array([[10, 10, 50, 80]], np.float32)
    args = (box, np.array([0.5], np.float32), np.array([0], np.int32))
    st = tbt.step(tbt.init_state(tp), tbt.make_detections(*args, params=tp),
                  tp)
    js = jbt.step(jbt.init_state(jp), jbt.make_detections(*args, params=jp),
                  jp)
    assert not st.active.any() and not np.asarray(js.active).any()
    assert int(st.frame_id) == int(js.frame_id) == 1


def test_make_detections_matches_jax():
    rng = np.random.RandomState(4)
    tp = tbt.ByteTrackParams(**SMALL, with_appearance=True, feature_dim=8)
    jp = jbt.ByteTrackParams(**SMALL, with_appearance=True, feature_dim=8)
    tlwh = rng.uniform(1, 90, (5, 4)).astype(np.float32)
    tlwh[2, 0] = np.nan                       # dropped: non-finite
    feat = rng.normal(size=(5, 8)).astype(np.float32)
    feat[3] = 0.0                             # no feature
    args = (tlwh, rng.uniform(size=5), np.arange(5))
    ours = tbt.make_detections(*args, feature=feat, params=tp)
    ref = jbt.make_detections(*args, feature=feat, params=jp)
    for f in dataclasses.fields(ours):
        np.testing.assert_array_equal(getattr(ours, f.name).numpy(),
                                      np.asarray(getattr(ref, f.name)),
                                      err_msg=f.name)
    assert not ours.valid[2] and not ours.has_feature[3]
    with pytest.raises(ValueError, match="exceed capacity"):
        tbt.make_detections(np.zeros((17, 4)), np.zeros(17), np.zeros(17),
                            params=tp)


def test_gmc_argument_is_not_ported():
    """The ``gmc`` argument is ported now (``tests/test_torch_gmc_tracking.py``
    holds it against JAX): the identity camera leaves a step bitwise as it
    is without one."""
    tp = tbt.ByteTrackParams(**SMALL)
    scene = moving_boxes(3, seed=5)
    st = st_gmc = tbt.init_state(tp)
    for xyxy, score, cls in scene:
        dets = tbt.make_detections(_tlwh(xyxy[:16]), score[:16], cls[:16],
                                   params=tp)
        st = tbt.step(st, dets, tp)
        st_gmc = tbt.step(st_gmc, dets, tp,
                          gmc=(torch.eye(2), torch.zeros(2)))
    assert st.active.any()
    for f in dataclasses.fields(st):
        a, b = getattr(st, f.name), getattr(st_gmc, f.name)
        assert (a is None and b is None) or torch.equal(a, b), f.name
    assert tbt.ByteTrackParams().new_track_thresh == pytest.approx(0.6)
    assert jnp.float32(jbt.ByteTrackParams().new_track_thresh) == \
        jnp.float32(tbt.ByteTrackParams().new_track_thresh)
