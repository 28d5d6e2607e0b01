"""Port: Kalman filter, costs, assignment and the DeepSORT core against JAX
(and the assignment against scipy), ending in a replay of recorded clip
detections through both cores."""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy.optimize import linear_sum_assignment  # noqa: E402

from aicamera_tpu.core import assignment as jasg  # noqa: E402
from aicamera_tpu.core import costs as jcosts  # noqa: E402
from aicamera_tpu.core import kalman as jkal  # noqa: E402
from aicamera_tpu.core import state as jstate  # noqa: E402
from aicamera_tpu.core import tracker as jtrk  # noqa: E402
from aicamera_tpu_torch.core import assignment as tasg  # noqa: E402
from aicamera_tpu_torch.core import costs as tcosts  # noqa: E402
from aicamera_tpu_torch.core import kalman as tkal  # noqa: E402
from aicamera_tpu_torch.core import state as tstate  # noqa: E402
from aicamera_tpu_torch.core import tracker as ttrk  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    PyTorch's thread pool oversubscribes the cores (small convolutions then
    run ~100x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DATA = Path(__file__).parent / "data" / "clip_dets.npz"


def T(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def J(x):
    return jnp.asarray(x)


def _tlwh(rng, n):
    xy = rng.uniform(0, 900, (n, 2))
    wh = rng.uniform(8, 200, (n, 2))
    return np.concatenate([xy, wh], 1).astype(np.float32)


def _bank(seed, t=16):
    """A bank of track states after initiate + a few predicts/updates."""
    rng = np.random.RandomState(seed)
    mean, cov = jkal.initiate(jcosts.tlwh_to_xyah(J(_tlwh(rng, t))))
    for _ in range(3):
        mean, cov = jkal.predict(mean, cov)
        meas = jcosts.tlwh_to_xyah(J(_tlwh(rng, t)))
        mean, cov = jkal.update(mean, cov, meas)
    return np.asarray(mean), np.asarray(cov)


# Tolerance for the Kalman filter: the 8x8 products are summed in another
# order (XLA HIGHEST einsum vs torch matmul); values agree to f32 rounding.
KF_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_kalman_matches_jax(seed):
    rng = np.random.RandomState(100 + seed)
    mean, cov = _bank(seed)
    conf = rng.uniform(0, 1, len(mean)).astype(np.float32)
    meas = np.asarray(jcosts.tlwh_to_xyah(J(_tlwh(rng, len(mean)))))

    for a, b in zip(tkal.initiate(T(meas)), jkal.initiate(J(meas))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tkal.predict(T(mean), T(cov)),
                    jkal.predict(J(mean), J(cov))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **KF_TOL)
    for c in (None, conf):
        tc = None if c is None else T(c)
        jc = None if c is None else J(c)
        for a, b in zip(tkal.project(T(mean), T(cov), tc),
                        jkal.project(J(mean), J(cov), jc)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **KF_TOL)
        for a, b in zip(tkal.update(T(mean), T(cov), T(meas), tc),
                        jkal.update(J(mean), J(cov), J(meas), jc)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **KF_TOL)
    bad = cov.copy()
    bad[3] = -1e6 * np.eye(8, dtype=np.float32)  # not PD: +inf row
    dets = np.asarray(jcosts.tlwh_to_xyah(J(_tlwh(rng, 9))))
    for only_pos in (False, True):
        ours = tkal.gating_distance(T(mean), T(bad), T(dets), only_pos)
        ref = jkal.gating_distance(J(mean), J(bad), J(dets), only_pos)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-4)
        assert np.isinf(ours.numpy()[3]).all()


def test_closed_form_cholesky_matches_jax():
    """The unrolled recurrences, term for term. Tolerance: 2 ulp-scale."""
    _, cov = _bank(7)
    s = cov[:, :4, :4] + np.eye(4, dtype=np.float32)
    b = np.random.RandomState(7).normal(size=(len(s), 4, 8)).astype(
        np.float32)
    ours = tkal._cho_solve_small(T(s), T(b), 4).numpy()
    ref = np.asarray(jax.jit(lambda s, b: jkal._cho_solve_small(s, b, 4))(
        J(s), J(b)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)


def test_costs_match_jax():
    rng = np.random.RandomState(5)
    a, b = _tlwh(rng, 12), _tlwh(rng, 9)
    a[2, 2:] = 0.0                     # zero-area track box
    b[1, 3] = 0.0                      # zero-height detection
    np.testing.assert_allclose(tcosts.iou_cost_matrix(T(a), T(b)).numpy(),
                               np.asarray(jcosts.iou_cost_matrix(J(a), J(b))),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tcosts.tlwh_to_xyah(T(b)).numpy(),
                                  np.asarray(jcosts.tlwh_to_xyah(J(b))))
    mean = rng.normal(50, 30, (10, 8)).astype(np.float32)
    mean[0, 3] = -2.0                  # negative height
    np.testing.assert_array_equal(tcosts.mean_to_tlwh(T(mean)).numpy(),
                                  np.asarray(jcosts.mean_to_tlwh(J(mean))))
    gal = rng.normal(size=(6, 5, 16)).astype(np.float32)
    gal[1, 0] = 0.0                    # zero-norm entry
    gvalid = rng.rand(6, 5) < 0.6
    gvalid[2] = False                  # empty gallery
    feats = rng.normal(size=(7, 16)).astype(np.float32)
    has = rng.rand(7) < 0.8
    np.testing.assert_allclose(
        tcosts.appearance_cost_matrix(T(gal), T(gvalid), T(feats),
                                      T(has)).numpy(),
        np.asarray(jcosts.appearance_cost_matrix(J(gal), J(gvalid), J(feats),
                                                 J(has))),
        atol=1e-6, rtol=0)


@pytest.mark.parametrize("seed", range(8))
def test_solve_square_matches_jax_and_scipy(seed):
    """Integer costs in 0..4 make many ties: the optimum's cost equals
    scipy's, and the assignment itself equals the JAX solver's (same tie
    resolution). Tolerance: exact."""
    rng = np.random.RandomState(seed)
    n = 12
    cost = rng.randint(0, 5, (n, n)).astype(np.float32)
    mask = rng.rand(n) < 0.8
    ours = tasg.solve_square(T(cost), T(mask)).numpy()
    ref = np.asarray(jasg.solve_square(J(cost), J(mask)))
    np.testing.assert_array_equal(ours, ref)
    rows = np.nonzero(mask)[0]
    r, c = linear_sum_assignment(cost[rows])
    assert (ours[~mask] == -1).all()
    assert len(set(ours[mask])) == mask.sum()
    assert cost[rows, ours[rows]].sum() == cost[rows][r, c].sum()


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("shape", [(10, 7), (7, 10), (9, 9)])
def test_min_cost_matching_matches_jax(seed, shape):
    rng = np.random.RandomState(seed)
    cost = rng.uniform(0, 1, shape).astype(np.float32)
    cost[rng.rand(*shape) < 0.3] = jcosts.INFTY_COST
    cost[0, :] = cost[1, :]            # identical rows: ties
    rmask, cmask = rng.rand(shape[0]) < 0.85, rng.rand(shape[1]) < 0.85
    ours = tasg.min_cost_matching(T(cost), T(rmask), T(cmask), 0.5)
    ref = jasg.min_cost_matching(J(cost), J(rmask), J(cmask),
                                 jnp.float32(0.5))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", range(8))
def test_matching_cascade_matches_jax(seed):
    """Tolerance: exact (index outputs)."""
    rng = np.random.RandomState(seed)
    t, nd = 14, 9
    cost = rng.uniform(0, 0.4, (t, nd)).astype(np.float32)
    cost[rng.rand(t, nd) < 0.3] = jcosts.INFTY_COST
    level = rng.randint(1, 6, t).astype(np.int32)
    if seed == 0:
        level[:] = 2                   # a single level
    level[rng.rand(t) < 0.15] = 9      # beyond the cascade depth
    elig = rng.rand(t) < 0.8
    dvalid = rng.rand(nd) < 0.9
    if seed == 6:
        elig[:] = False                # no level at all
    if seed == 7:
        dvalid[:] = False              # several levels, no detection
    m, u = tasg.matching_cascade(T(cost), T(level), T(elig), T(dvalid),
                                 0.2, 5)
    jm, ju = jasg.matching_cascade(J(cost), J(level), J(elig), J(dvalid),
                                   0.2, 5)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))


# --- core replay -------------------------------------------------------------

# The golden test's parameters (shared JAX compile cache).
PARAMS = dict(max_tracks=32, max_detections=16, nn_budget=10,
              feature_dim=32, n_init=3, max_age=30)
START, N_FRAMES = 120, 40


def _window():
    """Recorded real-clip detections (conf >= 0.3, top 16 per frame) with
    seeded features that vary smoothly with the box, so the appearance
    cascade finds matches; every 7th detection has no feature."""
    z = np.load(DATA)
    w = np.random.RandomState(0).normal(size=(4, PARAMS["feature_dim"]))
    frames = []
    for i in range(START, START + N_FRAMES):
        n = int(z["counts"][i])
        xyxy, sc = z["boxes"][i, :n], z["scores"][i, :n]
        cls = z["class_ids"][i, :n].astype(np.int32)
        keep = np.nonzero(sc >= 0.3)[0][:PARAMS["max_detections"]]
        xyxy, sc, cls = xyxy[keep], sc[keep], cls[keep]
        tlwh = np.concatenate([xyxy[:, :2], xyxy[:, 2:] - xyxy[:, :2]], 1)
        geo = tlwh / np.array([960.0, 540.0, 960.0, 540.0])
        f = np.cos(geo @ w * 6.0)
        f = (f / np.linalg.norm(f, axis=1, keepdims=True)).astype(np.float32)
        has = np.arange(len(keep)) % 7 != 3
        frames.append((tlwh.astype(np.float32), sc.astype(np.float32), cls,
                       f, has))
    return frames


@pytest.mark.parametrize("nsa,tol", [(False, 1e-5), (True, 1e-4)])
def test_core_replay_matches_jax(nsa, tol):
    """Every frame: active, state, track_id, hits, tsu, age identical;
    mean/cov within ``tol`` of each track's largest entry (f32 products
    summed in another order; measured worst 9e-6). NSA shrinks the
    measurement noise of a confident detection towards 0, so S is nearly
    singular and the same rounding grows tenfold (measured worst 7e-5)."""
    jp = jstate.TrackerParams(**PARAMS, nsa=nsa)
    tp = tstate.TrackerParams(**PARAMS, nsa=nsa)
    js, ts = jstate.init_state(jp), tstate.init_state(tp, device="cpu")
    n_confirmed = 0
    for i, (tlwh, sc, cls, f, has) in enumerate(_window()):
        jd = jstate.make_detections(tlwh, sc, cls, f, has, params=jp)
        td = tstate.make_detections(tlwh, sc, cls, f, has, params=tp,
                                    device="cpu")
        j_pred = jtrk.predict(js, jp)
        pred_scale = {n: np.abs(np.asarray(getattr(j_pred, n))).reshape(
            jp.max_tracks, -1).max(1) for n in ("mean", "cov")}
        js = jtrk.update(j_pred, jd, jp)
        ts = ttrk.update(ttrk.predict(ts, tp), td, tp)
        for name in ("active", "state", "track_id", "hits", "tsu", "age",
                     "class_id", "gallery_count", "gallery_next", "next_id",
                     "dropped"):
            np.testing.assert_array_equal(
                getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                err_msg=f"frame {i}: {name}")
        act = ts.active.numpy()
        for name in ("mean", "cov"):
            ours_v = getattr(ts, name).numpy()[act]
            ref_v = np.asarray(getattr(js, name))[act]
            # relative to each track's largest entry before or after the
            # update: P - K S K^T cancels terms of up to ~1e4 (a track
            # coasting through misses) down to ~1, and the rounding of the
            # cancelled terms remains
            scale = np.maximum(
                np.abs(ref_v).reshape(len(ref_v), -1).max(1),
                pred_scale[name][act])
            err = np.abs(ours_v - ref_v).reshape(len(ref_v), -1).max(1)
            assert (err <= tol * scale).all(), (i, name,
                                                 (err / scale).max())
        ours = ttrk.get_outputs(ts)
        ref = jtrk.get_outputs(js)
        for a, b in zip(ours[1:], ref[1:]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        n_confirmed += int(ours[4].sum())
    assert n_confirmed > 100  # the window exercises the confirmed path
