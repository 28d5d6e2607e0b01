"""Port: the OC-SORT core (and its Deep OC-SORT mode) against the JAX core,
frame by frame over seeded scenes of moving boxes, and its Kalman filter
alone."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from aicamera_tpu.core import ocsort as joc  # noqa: E402
from aicamera_tpu_torch.core import ocsort as toc  # noqa: E402
from aicamera_tpu_torch.scenes import moving_boxes  # noqa: E402
from test_torch_bytetrack import (_features, compare_outputs,  # noqa: E402
                                  compare_states)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    PyTorch's thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_ocsort.py's sizes (shared JAX compile cache)
SMALL = dict(max_tracks=32, max_detections=16, max_age=8, min_hits=3)


# A new track's covariance holds velocity variances of 1e4, which its first
# update cancels down to entries of a few units: the result carries the
# rounding of the 1e4 (one f32 ulp there is 1e-3; the worst seen is four). So
# the covariances are held to 1e-4 of a scale of at least 100, that is 1e-2;
# every other float field to 1e-4 of its track's own scale.
P_FLOORS = {"p": 100.0, "frozen_p": 100.0}


def T(x):
    return torch.from_numpy(np.array(x))


def run_both(scene, kw, seed, nan_at=None):
    tp, jp = toc.OCSortParams(**kw), joc.OCSortParams(**kw)
    st, js = toc.init_state(tp, device="cpu"), joc.init_state(jp)
    rng = np.random.RandomState(seed)
    worst, emitted, replays = [0.0], 0, 0
    for f, (xyxy, score, cls) in enumerate(scene):
        n = tp.max_detections
        xyxy, score, cls = xyxy[:n].copy(), score[:n], cls[:n]
        if f == nan_at:
            xyxy[0, 2] = np.nan  # a non-finite box: make_detections drops it
        feat = (_features(rng, cls, tp.feature_dim)
                if tp.with_appearance else None)
        dets = toc.make_detections(xyxy, score, cls, feature=feat, params=tp,
                                   device="cpu")
        jdets = joc.make_detections(xyxy, score, cls, feature=feat,
                                    params=jp)
        # a revival that triggers the replay: a frozen, unobserved track
        # that round 1 or 2 matches again (counted on the JAX side's input)
        pending = np.asarray(js.active & ~js.observed & js.frozen_valid)
        st = toc.step(st, dets, tp)
        js = joc.step(js, jdets, jp)
        replays += int((pending & np.asarray(js.observed)).sum())
        compare_states(st, js, worst, P_FLOORS)
        emitted += compare_outputs(toc.get_outputs(st, tp),
                                   joc.get_outputs(js, jp))
    print(f"worst |diff| of a float field over its track's scale: "
          f"{worst[0]:.3g}")
    return st, emitted, replays


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_matches_jax(seed):
    """Births, misses, OCR recoveries, revivals with the ORU replay, clutter
    and duplicates, one NaN box, 30 frames."""
    scene = moving_boxes(30, n_objects=7, seed=seed, miss=0.15, low=0.1,
                         gaps=[(0, 8, 12), (1, 15, 20)])
    st, emitted, replays = run_both(scene, SMALL, seed, nan_at=5)
    assert emitted > 30 and replays > 0
    assert int(st.next_id) > 8 and int(st.frame_count) == 30


def test_step_matches_jax_at_capacity():
    kw = dict(max_tracks=4, max_detections=16)
    st, emitted, _ = run_both(moving_boxes(10, n_objects=9, seed=5, miss=0.0,
                                           low=0.0, clutter=0.0), kw, 5)
    assert int(st.dropped) > 0 and emitted > 0


@pytest.mark.parametrize("seed", [0, 3])
def test_deepocsort_step_matches_jax(seed):
    """``with_appearance=True``: the adaptively weighted appearance term
    (crowded boxes, so the assignment solve runs) and the dynamic-alpha
    bank."""
    kw = dict(SMALL, with_appearance=True, feature_dim=32, det_thresh=0.4)
    scene = moving_boxes(24, n_objects=8, seed=seed, miss=0.15, low=0.2,
                         hw=(200, 260), gaps=[(2, 6, 11)])
    st, emitted, _ = run_both(scene, kw, seed)
    assert emitted > 20
    assert bool((st.active & (st.emb.abs().sum(-1) > 0)).any())


def test_nan_prediction_deactivates_the_track():
    """A state whose s*r went negative gives a NaN box; the step removes the
    track, in both packages, and no NaN leaks into another slot."""
    tp, jp = toc.OCSortParams(**SMALL), joc.OCSortParams(**SMALL)
    scene = moving_boxes(4, n_objects=3, seed=1, miss=0.0, low=0.0,
                         clutter=0.0)
    st, js = toc.init_state(tp, device="cpu"), joc.init_state(jp)
    for xyxy, score, cls in scene[:3]:
        st = toc.step(st, toc.make_detections(xyxy, score, cls, params=tp,
                                              device="cpu"), tp)
        js = joc.step(js, joc.make_detections(xyxy, score, cls, params=jp),
                      jp)
    x = st.x.clone()
    x[0, 3] = -1.0                       # negative aspect: sqrt(s*r) is NaN
    st = st.replace(x=x)
    js = js.replace(x=js.x.at[0, 3].set(-1.0))
    doomed = int(st.track_id[0])
    assert bool(st.active[0]) and doomed > 0
    xyxy, score, cls = scene[3]
    st = toc.step(st, toc.make_detections(xyxy, score, cls, params=tp,
                                          device="cpu"), tp)
    js = joc.step(js, joc.make_detections(xyxy, score, cls, params=jp), jp)
    # its detection starts a new track (the freed slot is the lowest)
    assert doomed not in st.track_id[st.active].tolist()
    assert doomed not in np.asarray(js.track_id)[np.asarray(js.active)]
    compare_states(st, js, [0.0], P_FLOORS)
    for out in toc.get_outputs(st, tp):
        assert torch.isfinite(out.float()).all()
    assert toc.x_to_xyxy(x[:1]).isnan().any()


# 1e-5 relative: the 7x7 products are summed in another order, and the gain
# solve is a closed-form Cholesky against JAX's LU
KF_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_kalman_filter_matches_jax(seed):
    rng = np.random.RandomState(seed)
    z = np.stack([rng.uniform(0, 900, 12), rng.uniform(0, 500, 12),
                  rng.uniform(400, 40000, 12), rng.uniform(0.3, 3, 12)],
                 1).astype(np.float32)
    x, p = joc.kf_initiate(jnp.asarray(z))
    for a, b in zip(toc.kf_initiate(T(z)), (x, p)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x, p = np.asarray(x).copy(), np.asarray(p).copy()
    x[3, 6] = -1e6                       # the area-collapse guard fires
    tx, tp_ = T(x), T(p)
    for step in range(4):
        jx, jp_ = joc.kf_predict(jnp.asarray(tx.numpy()),
                                 jnp.asarray(tp_.numpy()))
        tx, tp_ = toc.kf_predict(tx, tp_)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **KF_TOL)
        np.testing.assert_allclose(tp_.numpy(), np.asarray(jp_), **KF_TOL)
        zi = (z * rng.uniform(0.95, 1.05, z.shape)).astype(np.float32)
        jx, jp_ = joc.kf_update(jnp.asarray(tx.numpy()),
                                jnp.asarray(tp_.numpy()), jnp.asarray(zi))
        tx, tp_ = toc.kf_update(tx, tp_, T(zi))
        scale = float(np.abs(np.asarray(jp_)).max())
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **KF_TOL)
        np.testing.assert_allclose(tp_.numpy(), np.asarray(jp_), rtol=1e-5,
                                   atol=1e-5 * scale)
    assert float(tx[3, 6]) != -1e6


def test_box_helpers_match_jax():
    rng = np.random.RandomState(3)
    b = np.concatenate([rng.uniform(0, 300, (9, 2)),
                        rng.uniform(300, 600, (9, 2))], 1).astype(np.float32)
    b[1, 3] = b[1, 1]                    # zero height: the 1e-6 floor
    np.testing.assert_allclose(toc.xyxy_to_z(T(b)).numpy(),
                               np.asarray(joc.xyxy_to_z(jnp.asarray(b))),
                               rtol=1e-6)
    x = np.asarray(joc.kf_initiate(joc.xyxy_to_z(jnp.asarray(b)))[0])
    x = x.copy()
    x[2, 2] = -5.0                       # NaN box, on purpose
    ours = toc.x_to_xyxy(T(x)).numpy()
    ref = np.asarray(joc.x_to_xyxy(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    assert np.isnan(ours[2]).any()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-4,
                               equal_nan=True)
    np.testing.assert_allclose(
        toc.speed_direction(T(b[:4]), T(b[4:8])).numpy(),
        np.asarray(joc.speed_direction(jnp.asarray(b[:4]),
                                       jnp.asarray(b[4:8]))), atol=1e-6)


def test_adaptive_weights_match_jax():
    """``_aw_weight_matrix`` with ties, a zero best entry, a single
    candidate and an empty line."""
    rng = np.random.RandomState(8)
    sim = rng.uniform(-0.2, 1, (6, 5)).astype(np.float32)
    sim[1] = 0.0                         # best exactly 0
    sim[2, :2] = 0.7                     # a tie for the top
    rows = np.array([1, 1, 1, 1, 0, 1], bool)
    cols = np.array([1, 1, 1, 0, 1], bool)
    cols1 = np.array([0, 0, 1, 0, 0], bool)  # one candidate per row
    for c in (cols, cols1):
        ours = toc._aw_weight_matrix(T(sim), T(rows), T(c), 0.75, 0.5)
        ref = joc._aw_weight_matrix(jnp.asarray(sim), jnp.asarray(rows),
                                    jnp.asarray(c), 0.75, 0.5)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)


def test_gmc_argument_is_not_ported():
    """The ``gmc`` argument is ported now (``tests/test_torch_gmc_tracking.py``
    holds it against JAX): the identity camera leaves a step bitwise as it
    is without one, but for the momentum direction, which the warp
    renormalizes (the core stores ``d / (|d| + 1e-6)``): within 1e-6."""
    tp = toc.OCSortParams(**SMALL)
    st = st_gmc = toc.init_state(tp, device="cpu")
    for xyxy, score, cls in moving_boxes(4, seed=5):
        dets = toc.make_detections(xyxy[:16], score[:16], cls[:16],
                                   params=tp, device="cpu")
        st = toc.step(st, dets, tp)
        st_gmc = toc.step(st_gmc, dets, tp,
                          gmc=(torch.eye(2), torch.zeros(2)))
    assert st.active.any()
    for name, a in vars(st).items():
        b = getattr(st_gmc, name)
        if name == "velocity":
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
            continue
        assert (a is None and b is None) or torch.equal(a, b), name
    with pytest.raises(ValueError, match="exceed capacity"):
        toc.make_detections(np.zeros((17, 4)), np.zeros(17), np.zeros(17),
                            params=tp, device="cpu")
