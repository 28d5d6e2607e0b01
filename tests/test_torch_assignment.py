"""Port: the assignment dispatch and the read-free DeepSORT step.

The plain assignment against the JAX solver on the problems that
``chip_smoke.py`` holds the kernel to on the card; the wrapper's checks; the
DeepSORT step, now without host reads, against the JAX step through each of
the JAX package's skipped stages and over 32-frame replays; and the
pipeline's captured DeepSORT scan against the eager one, with no tracker
read. The kernel itself needs a card (``tests/test_torch_cuda.py``)."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from aicamera_tpu.core import assignment as jasg  # noqa: E402
from aicamera_tpu.core import state as jstate  # noqa: E402
from aicamera_tpu.core import tracker as jtrk  # noqa: E402
from aicamera_tpu_torch import config  # noqa: E402
from aicamera_tpu_torch.core import assignment as tasg  # noqa: E402
from aicamera_tpu_torch.core import bytetrack as tbt  # noqa: E402
from aicamera_tpu_torch.core import ocsort as toc  # noqa: E402
from aicamera_tpu_torch.core import state as tstate  # noqa: E402
from aicamera_tpu_torch.core import tracker as ttrk  # noqa: E402
from aicamera_tpu_torch.ops import assignment as kasg  # noqa: E402
from aicamera_tpu_torch.runtime import pipeline as pl  # noqa: E402
from aicamera_tpu_torch.scenes import moving_rectangles  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    PyTorch's thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(x):
    return torch.from_numpy(np.array(x))  # a writable copy


# --- the plain solver against JAX on the kernel's problems --------------------

CASES = chip_smoke.assignment_cases()
FAMILIES = sorted({fam for fam, _, _ in CASES})
_jax_cascade = jax.jit(jasg.matching_cascade, static_argnums=(4, 5))


@pytest.mark.parametrize("family", FAMILIES)
def test_plain_matches_jax_on_the_kernel_problems(family):
    """Every problem of the family through the port's CPU path (the plain
    version, the kernel's oracle on the card) and the JAX solver. Exact
    (index outputs)."""
    for fam, kind, args in CASES:
        if fam != family:
            continue
        if kind == "match":
            cost, rows, cols, max_d = args
            ours = tasg.min_cost_matching(T(cost), T(rows), T(cols), max_d)
            ref = jasg.min_cost_matching(jnp.asarray(cost), jnp.asarray(rows),
                                         jnp.asarray(cols),
                                         jnp.float32(max_d))
            np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
        else:
            cost, level, elig, valid, max_d, depth = args
            ours = tasg.matching_cascade(T(cost), T(level), T(elig),
                                         T(valid), max_d, depth)
            ref = _jax_cascade(jnp.asarray(cost), jnp.asarray(level),
                               jnp.asarray(elig), jnp.asarray(valid), max_d,
                               depth)
            for a, b in zip(ours, ref):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# --- the live-column argument the kernel's search rests on -------------------
#
# The kernel solves only the live part of the padded square: the rows with a
# feasible entry, and the feasible columns plus the first k clamp columns (k:
# the live rows), in ascending original index. A clamp column (padding, or a
# column with no feasible entry) holds the clamp in every live row; until a
# search first takes it as its sink it has v = 0 and the same spc as every
# other untouched one, so the lowest-indexed untouched clamp column wins
# every tie among them, and at most k are ever touched. The mirror below is
# that compacted solve in plain torch (test-only); it must reproduce
# solve_square's matches, u and v on the live entries, and v = 0 elsewhere.


def _live_solve(cost, row_mask, col_mask, max_distance):
    """The compacted solve: ``(col4row (R,) over original columns, u (R,),
    v (n,))``, each from the live (k, m) problem, NaN where not live."""
    r, c = cost.shape
    n = max(r, c)
    max_d = torch.tensor(max_distance, dtype=torch.float32)
    clamp = max_d + 1e-5
    feasible = row_mask[:, None] & col_mask[None, :] & (cost <= max_d)
    row_ok = row_mask & feasible.any(1)
    col_ok = col_mask & feasible.any(0)
    rows = torch.nonzero(row_ok)[:, 0]
    k = len(rows)
    is_clamp = torch.ones(n, dtype=torch.bool)
    is_clamp[:c] = ~col_ok
    clamp_cols = torch.nonzero(is_clamp)[:k, 0]
    cols = torch.sort(torch.cat([torch.nonzero(~is_clamp)[:, 0],
                                 clamp_cols])).values
    m = len(cols)
    live = clamp.expand(k, m).clone()
    feas_cols = ~is_clamp[cols]
    sub = cost[rows][:, cols[feas_cols]]
    live[:, feas_cols] = torch.where(sub <= max_d, sub, clamp)

    # the pre-assignment and the augmenting searches on (k, m), in f32 and
    # in solve_square's order of operations
    jmin = torch.argmin(live, dim=1) if k else torch.zeros(0, dtype=torch.long)
    rowmin = torch.gather(live, 1, jmin[:, None])[:, 0]
    winner = torch.full((m,), k, dtype=torch.int64)
    winner.scatter_reduce_(0, jmin, torch.arange(k), reduce="amin",
                           include_self=True)
    assigned = winner[jmin] == torch.arange(k)
    col4row = torch.where(assigned, jmin, -1)
    row4col = torch.full((m,), -1, dtype=torch.int64)
    row4col[jmin[assigned]] = torch.nonzero(assigned)[:, 0]
    u = torch.where(assigned, rowmin, torch.zeros_like(rowmin))
    v = torch.zeros(m, dtype=torch.float32)
    for i in torch.nonzero(~assigned)[:, 0].tolist():
        sr = torch.zeros(k, dtype=torch.bool)
        sc = torch.zeros(m, dtype=torch.bool)
        spc = torch.full((m,), float("inf"))
        path = torch.full((m,), -1, dtype=torch.int64)
        min_val = torch.zeros(())
        cur = i
        while True:
            sr[cur] = True
            reduced = min_val + live[cur] - u[cur] - v
            upd = ~sc & (reduced < spc)
            spc = torch.where(upd, reduced, spc)
            path = torch.where(upd, cur, path)
            masked = torch.where(sc, float("inf"), spc)
            j = int(torch.argmin(masked))
            min_val = masked[j]
            sc[j] = True
            if row4col[j] < 0:
                sink = j
                break
            cur = int(row4col[j])
        u = u.clone()
        u[i] += min_val
        at = spc[torch.clamp(col4row, 0, m - 1)]
        u = torch.where(sr & (torch.arange(k) != i), u + min_val - at, u)
        v = torch.where(sc, v - (min_val - spc), v)
        j = sink
        while True:
            ii = int(path[j])
            row4col[j] = ii
            jn = int(col4row[ii])
            col4row[ii] = j
            if ii == i:
                break
            j = jn
    out_c = torch.full((r,), -1, dtype=torch.int64)
    out_c[rows] = torch.where(col4row >= 0, cols[col4row], -1)
    out_u = torch.full((r,), float("nan"))
    out_u[rows] = u
    out_v = torch.zeros(n)
    out_v[cols] = v
    return out_c, out_u, out_v


def _live_problems():
    """``[(name, cost, row_mask, col_mask, max_d)]``, seeded: ties with -0.0
    beside +0.0, NaN rows, rows with nothing feasible, rows forced onto
    clamp columns, a clamp equal to max_d (so feasible costs tie with it),
    R < C, R > C and n = 256."""
    rng = np.random.RandomState(11)
    out = []

    def mask(size, live):
        m = np.zeros(size, bool)
        m[rng.choice(size, live, replace=False)] = True
        return m

    for t in range(3):
        r, c = 48, 32
        cost = (rng.randint(0, 4, (r, c)) * 0.05).astype(np.float32)
        cost[(cost == 0) & (rng.rand(r, c) < 0.5)] = -0.0
        cost[rng.rand(r, c) < 0.3] = 1e5
        out.append((f"ties {t}", cost, mask(r, 30), mask(c, 20), 0.2))
    cost = rng.uniform(0, 0.5, (40, 40)).astype(np.float32)
    rows = mask(40, 30)
    cost[np.nonzero(rows)[0][:5]] = np.nan
    cost[np.nonzero(rows)[0][5:9]] = 0.9      # eligible, nothing feasible
    out.append(("NaN and infeasible rows", cost, rows, mask(40, 25), 0.3))
    # 24 rows whose only feasible columns are 3 of them: 21 rows end on
    # clamp columns, interleaved with the infeasible columns below c
    cost = np.full((64, 64), 1.0, np.float32)
    rows = mask(64, 24)
    cost[np.ix_(rows, [5, 17, 40])] = rng.uniform(0, 0.5, (24, 3))
    out.append(("rows forced onto clamp columns", cost, rows,
                np.ones(64, bool), 0.7))
    cost = rng.uniform(0, 2, (128, 64)).astype(np.float32)
    cost[rng.rand(128, 64) < 0.7] = 1e5
    out.append(("rows forced onto padding", cost, mask(128, 60),
                mask(64, 12), 1.0))
    # max_d so large that max_d + 1e-5 rounds to max_d in f32
    assert np.float32(1e5) + np.float32(1e-5) == np.float32(1e5)
    cost = rng.choice([1e5, 5e4, 7e4, 1e5 + 8], (32, 32)).astype(np.float32)
    out.append(("clamp equal to max_d", cost, mask(32, 24), mask(32, 12),
                1e5))
    for r, c in ((20, 50), (100, 30), (256, 256), (256, 64), (64, 256)):
        cost = rng.uniform(0, 1, (r, c)).astype(np.float32)
        cost[rng.rand(r, c) < 0.5] = 1e5
        out.append((f"{r}x{c}", cost, mask(r, min(r, 60)),
                    mask(c, min(c, 60)), 0.5))
    return out


LIVE = _live_problems()


@pytest.mark.parametrize("index", range(len(LIVE)),
                         ids=[p[0] for p in LIVE])
def test_the_live_columns_reproduce_the_padded_solve(index, monkeypatch):
    """The compacted solve against ``solve_square`` on the padded square:
    the same matches, the same u on the live rows, the same v on the live
    columns and v = 0 on every other column (bitwise, f32)."""
    name, cost, rows, cols, max_d = LIVE[index]
    seen = {}
    solve, augment = tasg.solve_square, tasg._augment_row

    def spy_solve(c, m):
        seen["col4row"] = solve(c, m)
        return seen["col4row"]

    def spy_augment(*a):
        out = augment(*a)
        seen["uv"] = out[:2]
        seen["searches"] = seen.get("searches", 0) + 1
        return out

    monkeypatch.setattr(tasg, "solve_square", spy_solve)
    monkeypatch.setattr(tasg, "_augment_row", spy_augment)
    want = tasg.min_cost_matching_plain(T(cost), T(rows), T(cols), max_d)
    c4r, u, v = _live_solve(T(cost), T(rows), T(cols), max_d)
    r, c = cost.shape
    live = ~torch.isnan(u)
    full = seen["col4row"][:r]
    assert torch.equal(c4r[live], full[live]), name
    assert (full[~live] == -1).all(), name
    if "uv" in seen:   # else no search ran: u is the row minima, v is 0
        fu, fv = seen["uv"]
        assert torch.equal(u[live], fu[:r][live]), name
        assert torch.equal(v, fv), name
    else:
        assert (v == 0).all(), name
    # the accepted matches, as the kernel reports them
    j = torch.clamp(c4r, 0, c - 1)
    ok = (c4r >= 0) & (c4r < c) & T(cols)[j] & (
        T(cost)[torch.arange(r), j] <= max_d)
    got = torch.where(ok & T(rows), c4r, -1)
    assert torch.equal(got, want), name


@pytest.mark.parametrize("index", [0, 4, 6, 9], ids=[
    LIVE[i][0] for i in (0, 4, 6, 9)])
def test_the_live_columns_match_jax(index):
    """The compacted solve's accepted matches against the JAX package's
    ``min_cost_matching`` on the CPU."""
    name, cost, rows, cols, max_d = LIVE[index]
    c4r = _live_solve(T(cost), T(rows), T(cols), max_d)[0]
    r, c = cost.shape
    j = torch.clamp(c4r, 0, c - 1)
    ok = (c4r >= 0) & (c4r < c) & T(cols)[j] & (
        T(cost)[torch.arange(r), j] <= max_d)
    got = torch.where(ok & T(rows), c4r, -1)
    ref = jasg.min_cost_matching(jnp.asarray(cost), jnp.asarray(rows),
                                 jnp.asarray(cols), jnp.float32(max_d))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# --- the wrapper's checks (no card needed) -----------------------------------

def _problem(r, c, seed=0):
    rng = np.random.RandomState(seed)
    return (T(rng.uniform(0, 1, (r, c)).astype(np.float32)),
            T(np.ones(r, bool)), T(np.ones(c, bool)))


@pytest.mark.parametrize("shape", [(257, 64), (64, 257), (300, 300)])
def test_more_than_256_raises(shape):
    cost, rows, cols = _problem(*shape)
    level = torch.ones(shape[0], dtype=torch.int32)
    for call in (lambda: tasg.min_cost_matching(cost, rows, cols, 0.5),
                 lambda: tasg.matching_cascade(cost, level, rows, cols, 0.5,
                                               70),
                 lambda: kasg.KERNEL.min_cost_matching(cost, rows, cols,
                                                       0.5)):
        with pytest.raises(ValueError, match="max\\(R, C\\) <= 256"):
            call()
    # 256 is taken
    cost, rows, cols = _problem(256, 64)
    assert tasg.min_cost_matching(cost, rows, cols, 0.5).shape == (256,)


def test_bad_arguments_raise():
    cost, rows, cols = _problem(8, 6)
    with pytest.raises(TypeError, match="float32"):
        tasg.min_cost_matching(cost.double(), rows, cols, 0.5)
    with pytest.raises(ValueError, match="row_mask"):
        tasg.min_cost_matching(cost, rows[:7], cols, 0.5)
    with pytest.raises(ValueError, match="col_mask"):
        tasg.min_cost_matching(cost, rows, cols.int(), 0.5)
    with pytest.raises(ValueError, match="R, C >= 1"):
        tasg.min_cost_matching(cost[:, :0], rows, cols[:0], 0.5)


def test_the_kernel_takes_no_cpu_tensor():
    """No fallback the other way: the kernel's wrapper refuses a CPU
    tensor instead of running the plain version."""
    cost, rows, cols = _problem(8, 6)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kasg.KERNEL.min_cost_matching(cost, rows, cols, 0.5)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kasg.KERNEL.matching_cascade(cost, torch.ones(8, dtype=torch.int32),
                                     rows, cols, 0.5, 70)
    assert kasg.KERNEL.launches == 0


class _OnCuda(torch.Tensor):
    """A CPU tensor that says it lies on the card (no card here)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_the_kernel_takes_only_int32_levels():
    """The tracker's levels are int32 and the kernel reads them as they
    are: another type raises before anything is launched, on any device."""
    cost, rows, cols = (x.as_subclass(_OnCuda) for x in _problem(8, 6))
    for dtype in (torch.int64, torch.int16, torch.float32, torch.bool):
        level = torch.ones(8, dtype=dtype).as_subclass(_OnCuda)
        with pytest.raises(TypeError, match="int32"):
            kasg.KERNEL.matching_cascade(cost, level, rows, cols, 0.5, 70)
    assert kasg.KERNEL.launches == 0


def test_a_cuda_tensor_never_reaches_the_plain_version(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    calls = []
    monkeypatch.setattr(tasg, "min_cost_matching_plain", refuse)
    monkeypatch.setattr(tasg, "matching_cascade_plain", refuse)
    monkeypatch.setattr(kasg.KERNEL, "min_cost_matching",
                        lambda *a: calls.append("match") or "kernel")
    monkeypatch.setattr(kasg.KERNEL, "matching_cascade",
                        lambda *a: calls.append("cascade") or "kernel")
    cost, rows, cols = (x.as_subclass(_OnCuda) for x in _problem(8, 6))
    level = torch.ones(8, dtype=torch.int32).as_subclass(_OnCuda)
    assert tasg.min_cost_matching(cost, rows, cols, 0.5) == "kernel"
    assert tasg.matching_cascade(cost, level, rows, cols, 0.5, 70) \
        == "kernel"
    assert calls == ["match", "cascade"]


def test_replaces_points_at_the_jax_functions():
    text = (ROOT / "aicamera_tpu" / "core" / "assignment.py").read_text()
    lines = text.splitlines()
    found = re.findall(r":(\d+) (\w+)", kasg.KERNEL.replaces)
    assert kasg.KERNEL.replaces.startswith("aicamera_tpu/core/assignment.py")
    assert [name for _, name in found] == ["solve_square",
                                           "min_cost_matching",
                                           "matching_cascade"]
    for line, name in found:
        assert lines[int(line) - 1].startswith(f"def {name}("), (line, name)
    assert kasg.KERNEL.source.is_file()
    assert kasg.KERNEL.name == "assignment"


# --- the read-free DeepSORT step against JAX ---------------------------------

P = dict(max_tracks=16, max_detections=8, nn_budget=4, feature_dim=16,
         n_init=2, max_age=5)


def _feature(obj, dim=16):
    f = np.cos(np.arange(dim) * (obj + 1) * 0.7 + obj)
    return (f / np.linalg.norm(f)).astype(np.float32)


def _frame(boxes, with_feature=True, rng=None):
    """Detections (tlwh, conf, cls, feature, has_feature) of ``boxes``:
    ``[(object, x, y)]``, 40x80 boxes; the feature follows the object."""
    rng = rng or np.random.RandomState(0)
    n = len(boxes)
    tlwh = np.array([[x, y, 40.0, 80.0] for _, x, y in boxes],
                    np.float32).reshape(n, 4)
    feat = np.array([_feature(o) + rng.normal(0, 0.01, 16) for o, _, _ in
                     boxes], np.float32).reshape(n, 16)
    return (tlwh, np.full(n, 0.8, np.float32) + np.arange(n) * 0.01,
            np.zeros(n, np.int32), feat,
            np.full(n, with_feature))


def _walk(objects, t):
    return [(o, 50.0 + 120 * o + 3 * t, 60.0 + 2 * t) for o in objects]


INT_FIELDS = ("active", "state", "track_id", "hits", "tsu", "age",
              "class_id", "gallery_count", "gallery_next", "next_id",
              "dropped")


def _run_both(frames, **extra):
    """Both cores over ``frames``; after every frame the integer fields
    must be identical and mean, cov, conf and the gallery within f32
    rounding of the products' order (relative 1e-4 of each track's
    largest entry, as in tests/test_torch_tracker.py). Returns the port's
    states, the initial one first."""
    jp = jstate.TrackerParams(**P, **extra)
    tp = tstate.TrackerParams(**P, **extra)
    js, ts = jstate.init_state(jp), tstate.init_state(tp, device="cpu")
    states = [ts]
    for i, (tlwh, conf, cls, feat, has) in enumerate(frames):
        js = jtrk.update(jtrk.predict(js, jp), jstate.make_detections(
            tlwh, conf, cls, feat, has, params=jp), jp)
        ts = ttrk.update(ttrk.predict(ts, tp), tstate.make_detections(
            tlwh, conf, cls, feat, has, params=tp, device="cpu"), tp)
        for name in INT_FIELDS:
            np.testing.assert_array_equal(
                getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                err_msg=f"frame {i}: {name}")
        act = ts.active.numpy()
        for name in ("mean", "cov", "conf", "gallery"):
            width = int(np.prod(getattr(ts, name).shape[1:]))
            ours = getattr(ts, name).numpy()[act].reshape(-1, width)
            ref = np.asarray(getattr(js, name))[act].reshape(-1, width)
            scale = np.maximum(np.abs(ref).max(1, initial=0), 1.0)
            assert (np.abs(ours - ref).max(1, initial=0)
                    <= 1e-4 * scale).all(), (i, name)
        for a, b in zip(ttrk.get_outputs(ts)[1:], jtrk.get_outputs(js)[1:]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        states.append(ts)
    return states


def _skip_frames(case):
    """A short scene whose last frame takes one of the JAX step's skipped
    stages (``lax.cond``'s skip branch)."""
    confirm = [_frame(_walk([0, 1, 2], t)) for t in range(3)]  # n_init 2
    if case == "no active track":
        return [_frame([]), _frame([])]
    if case == "no confirmed track":
        return [_frame(_walk([0, 1], 0)), _frame(_walk([0, 1], 1))]
    if case == "no detection with a feature":
        return confirm + [_frame(_walk([0, 1, 2], 3), with_feature=False)]
    if case == "no match":
        far = [(5, 700.0, 400.0), (6, 800.0, 300.0)]
        return confirm + [_frame(far)]
    assert case == "no new detection"
    return confirm + [_frame(_walk([0, 1, 2], 3))]


@pytest.mark.parametrize("case", ["no active track", "no confirmed track",
                                  "no detection with a feature", "no match",
                                  "no new detection"])
def test_former_guard_skipped_matches_jax(case):
    frames = _skip_frames(case)
    *_, before, after = _run_both(frames)
    confirmed = before.active & (before.state == tstate.CONFIRMED)
    if case == "no active track":
        assert not before.active.any()
    elif case == "no confirmed track":
        assert before.active.any() and not confirmed.any()
    elif case == "no detection with a feature":
        assert confirmed.any() and not frames[-1][4].any()
    elif case == "no match":
        assert confirmed.any() and (after.tsu[after.active] != 0).sum() == 3
    else:
        assert confirmed.any() and int(after.next_id) == int(before.next_id)


def _replay_frames(n=32, seed=5):
    """Five objects walking, each missing now and then (cascade levels above
    1), one that leaves for longer than max_age, a detection without a
    feature now and then, and a spurious one."""
    rng = np.random.RandomState(seed)
    frames = []
    for t in range(n):
        objs = [o for o in range(5) if rng.rand() > 0.2
                and not (o == 4 and 8 <= t < 16)]
        boxes = [(o, x + rng.normal(0, 1.5), y + rng.normal(0, 1.5))
                 for o, x, y in _walk(objs, t)]
        if rng.rand() < 0.3:
            boxes.append((7, rng.uniform(0, 900), rng.uniform(0, 500)))
        tlwh, conf, cls, feat, has = _frame(boxes, rng=rng)
        has &= rng.rand(len(boxes)) > 0.15
        frames.append((tlwh, conf, cls, feat, has))
    return frames


@pytest.mark.parametrize("extra", [dict(nsa=True),
                                   dict(ema_alpha=0.9, nsa=True)],
                         ids=["nsa", "ema_alpha+nsa"])
def test_replay_of_32_frames_matches_jax(extra):
    """The StrongSORT settings (EMA bank, NSA Kalman) and NSA alone."""
    ts = _run_both(_replay_frames(), **extra)[-1]
    assert int(ts.next_id) > 5


# --- the pipeline's captured DeepSORT scan -----------------------------------

SMALL = dict(max_tracks=16, max_detections=8, nn_budget=4, max_age=10,
             feature_dim=config.REID_FEATURE_DIM)
KW = dict(input_shape=(128, 128), max_reid_crops=4, chunk_size=2,
          synthetic_load=8, scan_bucket=8,
          yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
          reid_weights=str(config.REID_SYNTHETIC_PATH))


def _pipeline_run(frames, **kw):
    pipe = pl.TrackingPipeline(tracker_params=tstate.TrackerParams(**SMALL),
                               device="cpu", **KW, **kw)
    before = tasg.TRACKER_SYNCS.count
    results = list(pipe.process_frames(iter(frames)))
    return pipe, results, tasg.TRACKER_SYNCS.count - before


@pytest.mark.parametrize("gmc", [False, "affine"], ids=["plain", "gmc"])
def test_captured_scan_equals_the_eager_scan(monkeypatch, gmc):
    """Through the captured chunk step (one engine; on the CPU a direct
    call) and through the eager step, frame by frame with the host skipping
    invalid frames: the same tuples and the same state, over full chunks
    and a partial one (its padding frame stepped and discarded by the
    mask), at both bucket capacities; no tracker read in either."""
    frames = list(moving_rectangles(7, (96, 128), n_objects=3, seed=3))
    made = []

    class Spy(pl.CUDAGraphEngine):
        def __init__(self, *a, **k):
            made.append(k["name"])
            super().__init__(*a, **k)

    monkeypatch.setattr(pl, "CUDAGraphEngine", Spy)
    cap, res_cap, reads_cap = _pipeline_run(frames, gmc=gmc)
    monkeypatch.setattr(pl.TrackingPipeline, "_capture_step", False)
    monkeypatch.setattr(pl.TrackingPipeline, "_capture_scans", False)
    eag, res_eag, reads_eag = _pipeline_run(frames, gmc=gmc)
    assert reads_cap == reads_eag == 0
    # full chunks and the partial last one, at 8 and 16 slots, one step
    assert made == ["deepsort chunk step 96x128 K=2"]
    assert cap.scan_stats["small"] >= 1 and cap.scan_stats["skipped"] >= 1
    assert cap.scan_stats == eag.scan_stats
    assert sum(len(r.tracks) for r in res_cap) > 0
    assert [r.tracks for r in res_cap] == [r.tracks for r in res_eag]
    for f in dataclasses.fields(cap.state):
        assert torch.equal(getattr(cap.state, f.name),
                           getattr(eag.state, f.name)), f.name


def test_one_capture_a_capacity_whatever_the_validity(monkeypatch):
    """The validity mask is an input of the capture, not part of its key:
    full, partial and empty chunks of a multi-stream dispatch share one
    engine a track capacity (the streams' stacked scan), and a masked
    stream keeps its state."""
    from aicamera_tpu_torch.parallel import MultiStreamPipeline
    made = []

    class Spy(pl.CUDAGraphEngine):
        def __init__(self, *a, **k):
            made.append(k["name"])
            super().__init__(*a, **k)

    pipe = MultiStreamPipeline(
        n_streams=2, frame_hw=(96, 128), scan_bucket=0,
        tracker_params=tstate.TrackerParams(**SMALL), device="cpu",
        **{k: KW[k] for k in ("input_shape", "max_reid_crops",
                              "yolo_weights", "reid_weights")})
    frames = np.stack([np.stack(list(moving_rectangles(
        2, (96, 128), n_objects=3, seed=s))) for s in (3, 4)])
    monkeypatch.setattr(pl, "CUDAGraphEngine", Spy)
    pipe.step_chunk(frames)
    before = [t[1].clone() for t in dataclasses.astuple(pipe.states)]
    for valid in ([[True, False], [False, False]],
                  [[False, True], [False, False]]):
        pipe.step_chunk(frames, frame_valid=np.array(valid))
    assert made == ["deepsort chunk step 96x128 K=2 over 2 streams"] \
        and bool(before[0].any())
    for a, b in zip(before, dataclasses.astuple(pipe.states)):
        assert torch.equal(a, b[1])


# every core at the synthetic grid's conf 0.5 (the motion cores'
# thresholds lowered to 0.4) and SMALL's slot counts
_MOTION = dict(max_tracks=SMALL["max_tracks"],
               max_detections=SMALL["max_detections"])
_APPEARANCE = dict(with_appearance=True, feature_dim=config.REID_FEATURE_DIM)
CORES = {
    "deepsort": {},
    "bytetrack": dict(tracker="bytetrack", bytetrack_params=tbt.ByteTrackParams(
        track_thresh=0.4, **_MOTION)),
    "botsort": dict(tracker="botsort", bytetrack_params=tbt.ByteTrackParams(
        track_thresh=0.4, **_MOTION, **_APPEARANCE)),
    "ocsort": dict(tracker="ocsort", ocsort_params=toc.OCSortParams(
        det_thresh=0.4, **_MOTION)),
    "deepocsort": dict(tracker="deepocsort", ocsort_params=toc.OCSortParams(
        det_thresh=0.4, **_MOTION, **_APPEARANCE)),
}


@pytest.mark.parametrize("tracker", sorted(CORES))
def test_deepsort_chunk_scan_reads_nothing(tracker):
    """Every core's chunk scan (DeepSORT, ByteTrack, BoT-SORT, OC-SORT, Deep
    OC-SORT) takes no tracker read: ``TRACKER_SYNCS`` stays at 0 over every
    chunk, and every chunk goes through the captured chunk step (on the CPU
    a direct call), whose decisions took the small pass in one chunk and
    the full scan (skipped or rerun) in another."""
    frames = list(moving_rectangles(6, (96, 128), n_objects=3, seed=3))
    pipe, results, reads = _pipeline_run(frames, **CORES[tracker])
    assert reads == 0 and sum(len(r.tracks) for r in results) > 0
    names = {st.engine.name for st in pipe._steps.values()}
    assert names == {f"{pipe.tracker_kind} chunk step 96x128 K=2"}
    assert not pipe._scan_engines and all(
        st.bucketed for st in pipe._steps.values())
    stats = pipe.scan_stats
    assert sum(stats.values()) == len(frames) // 2
    assert stats["small"] >= 1 and stats["skipped"] + stats["rerun"] >= 1
