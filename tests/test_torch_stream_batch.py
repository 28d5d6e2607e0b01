"""Port: the DeepSORT/StrongSORT step over a stream axis, against ``jax.vmap``
of the JAX step and against the port's own per-stream step.

Sizes: S=3 streams, T=16 track slots, N=8 detection slots, D=32 features,
``max_age`` 5, ``n_init`` 2; every input is drawn from numpy seeds.

Tolerances:

- assignment: the batched plain ``min_cost_matching`` / ``matching_cascade``
  equal the per-problem plain versions and ``jax.vmap`` of the JAX functions
  exactly (integer matches);
- the stacked step against the per-stream port step: every state field and
  every output bitwise (on the CPU, the batched ``matmul`` of the Kalman
  filter and of the gallery against the detections rounds as the
  per-stream ones do);
- the stacked step against ``jax.vmap`` of the JAX step: integer and
  boolean fields and the emitted ids, classes and masks exact; mean, cov,
  conf and the gallery of active tracks within 1e-4 of each track's largest
  entry (``tests/test_torch_assignment.py``'s rule: the two packages order
  the f32 products differently).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from aicamera_tpu.core import assignment as jasg  # noqa: E402
from aicamera_tpu.core import state as jstate  # noqa: E402
from aicamera_tpu.core import tracker as jtrk  # noqa: E402
from aicamera_tpu.ops import gmc as jgmc  # noqa: E402
from aicamera_tpu_torch.core import assignment as tasg  # noqa: E402
from aicamera_tpu_torch.core import state as tstate  # noqa: E402
from aicamera_tpu_torch.core import tracker as ttrk  # noqa: E402
from aicamera_tpu_torch.ops import assignment as kasg  # noqa: E402
from aicamera_tpu_torch.ops import gmc as tgmc  # noqa: E402
from aicamera_tpu_torch.runtime import pipeline as pl  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    PyTorch's thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S, T_SLOTS, N_DETS, DIM, MAX_AGE = 3, 16, 8, 32, 5
INFTY = 1e5


# --- the assignment over a batch of problems ---------------------------------

def _problems(seed, b=5):
    """``b`` seeded (T, N) problems: gated appearance costs, eligible rows,
    valid columns and tsu levels (stale ones on ineligible rows); problem 0
    has no eligible row, problem 1 every row eligible."""
    rng = np.random.RandomState(seed)
    cost = rng.uniform(0, 0.4, (b, T_SLOTS, N_DETS)).astype(np.float32)
    cost[rng.rand(b, T_SLOTS, N_DETS) < 0.5] = INFTY
    rows = rng.rand(b, T_SLOTS) < 0.5
    rows[0] = False
    rows[1] = True
    cols = np.arange(N_DETS)[None] < rng.randint(1, N_DETS + 1, (b, 1))
    level = np.where(rng.rand(b, T_SLOTS) < 0.6, 1,
                     rng.randint(1, MAX_AGE + 1, (b, T_SLOTS)))
    level[~rows] = rng.randint(0, 30, (~rows).sum())
    return cost, rows, cols, level.astype(np.int32)


_jax_match = jax.jit(jax.vmap(jasg.min_cost_matching,
                              in_axes=(0, 0, 0, None)))
_jax_cascade = jax.jit(jax.vmap(
    lambda c, lv, e, v: jasg.matching_cascade(c, lv, e, v, 0.2, MAX_AGE)))


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_plain_assignment_equals_per_problem_and_jax_vmap(seed):
    cost, rows, cols, level = _problems(seed)
    c, r, k, lv = (torch.from_numpy(x) for x in (cost, rows, cols, level))
    got = tasg.min_cost_matching(c, r, k, 0.7)
    want = torch.stack([tasg.min_cost_matching_plain(c[b], r[b], k[b], 0.7)
                        for b in range(len(c))])
    assert got.shape == (len(c), T_SLOTS) and torch.equal(got, want)
    ref = np.asarray(_jax_match(cost, rows, cols, jnp.float32(0.7)))
    np.testing.assert_array_equal(got.numpy(), ref)

    match, unmatched = tasg.matching_cascade(c, lv, r, k, 0.2, MAX_AGE)
    for b in range(len(c)):
        m1, u1 = tasg.matching_cascade_plain(c[b], lv[b], r[b], k[b], 0.2,
                                             MAX_AGE)
        assert torch.equal(match[b], m1) and torch.equal(unmatched[b], u1)
    j_match, j_unmatched = _jax_cascade(cost, level, rows, cols)
    np.testing.assert_array_equal(match.numpy(), np.asarray(j_match))
    np.testing.assert_array_equal(unmatched.numpy(), np.asarray(j_unmatched))
    assert (match[0] < 0).all() and (match[1:] >= 0).any()


def test_batched_arguments_are_checked():
    cost, rows, cols, level = (torch.from_numpy(x) for x in _problems(0))
    with pytest.raises(ValueError, match="row_mask"):
        tasg.min_cost_matching(cost, rows[0], cols, 0.7)
    with pytest.raises(ValueError, match="col_mask"):
        tasg.min_cost_matching(cost, rows, cols[:2], 0.7)
    with pytest.raises(ValueError, match="track_level"):
        kasg.KERNEL.matching_cascade(cost, level[0], rows, cols, 0.2,
                                     MAX_AGE)
    with pytest.raises(ValueError, match="cost"):
        tasg.min_cost_matching(cost[None], rows, cols, 0.7)


# --- the step over streams ---------------------------------------------------

def _feature(obj, rng):
    f = np.cos(np.arange(DIM) * (obj + 1) * 0.7 + obj)
    f = f / np.linalg.norm(f) + rng.normal(0, 0.01, DIM)
    return f.astype(np.float32)


def _frame(boxes, rng, no_feature=0.0):
    """Detections of ``boxes``: ``[(object, x, y)]``, 40x80 boxes whose
    feature follows the object."""
    n = len(boxes)
    tlwh = np.array([[x, y, 40.0, 80.0] for _, x, y in boxes],
                    np.float32).reshape(n, 4)
    feat = np.array([_feature(o, rng) for o, _, _ in boxes],
                    np.float32).reshape(n, DIM)
    conf = (0.6 + 0.3 * rng.rand(n)).astype(np.float32)
    return (tlwh, conf, np.zeros(n, np.int32), feat,
            rng.rand(n) >= no_feature)


def _walk(objects, t, x0=40.0, y0=60.0):
    return [(o, x0 + 110 * (o % 8) + 3 * t, y0 + 150 * (o // 8) + 2 * t)
            for o in objects]


def _stream_frames(kind, n=12, seed=0):
    """12 frames of one stream. ``steady``: three objects, one leaving for
    good at frame 4 (a death after ``max_age``), from frame 5 a spurious
    detection now and then (a tentative birth and death). ``overflow``: 4
    objects (A) for 2 frames, then 8 others (B) while A's confirmed tracks
    wait out their misses (12 tracks: more than 8 slots hold), then 8 more
    (C), of which only 4 find a free slot (``dropped``) until A's tracks
    die. ``sparse``: two objects, features missing now and then."""
    rng = np.random.RandomState(seed)
    frames = []
    for t in range(n):
        if kind == "steady":
            objs = [0, 1] + ([2] if t < 4 else [])
            boxes = _walk(objs, t)
            if t >= 5 and rng.rand() < 0.5:
                boxes.append((9, rng.uniform(0, 600), rng.uniform(300, 500)))
            frames.append(_frame(boxes, rng))
        elif kind == "overflow":
            objs = range(0, 4) if t < 2 else range(8, 16) if t < 6 \
                else range(16, 24)
            frames.append(_frame(_walk(objs, t), rng))
        else:
            frames.append(_frame(_walk([3, 5], t), rng, no_feature=0.3))
    return frames


KINDS = ("steady", "overflow", "sparse")
# (frame, stream) slots that do not advance: single streams, and frame 10
# for every stream (a frame no stream takes)
MASKED = {(3, 2), (4, 2), (8, 2), (7, 0), (2, 1), (10, 0), (10, 1), (10, 2)}
VALID = np.array([[(t, s) not in MASKED for s in range(S)]
                  for t in range(12)])
BASE = dict(max_tracks=T_SLOTS, max_detections=N_DETS, feature_dim=DIM,
            n_init=2, max_age=MAX_AGE)
PRESETS = {"deepsort": dict(nn_budget=4),
           "strongsort": dict(nn_budget=1, ema_alpha=0.9, nsa=True)}


def _affines(n=12, seed=7):
    """One camera affine a stream a frame, near the identity: (12, S, 2, 2),
    (12, S, 2)."""
    rng = np.random.RandomState(seed)
    a = np.eye(2, dtype=np.float32) + rng.normal(0, 0.01, (n, S, 2, 2))
    t = rng.normal(0, 2.0, (n, S, 2))
    return a.astype(np.float32), t.astype(np.float32)


def _stack(items):
    """Per-stream containers (dataclasses of tensors) on a stream axis."""
    return dataclasses.replace(items[0], **{
        f.name: torch.stack([getattr(x, f.name) for x in items])
        for f in dataclasses.fields(items[0])})


def _port_step(st, dets, p, warp):
    st = ttrk.predict(st, p)
    if warp is not None:
        mean, cov = tgmc.warp_xyah_bank(st.mean, st.cov, *warp, st.active)
        st = st.replace(mean=mean, cov=cov)
    return ttrk.update(st, dets, p)


def _jax_step(jp, with_gmc):
    def one(st, dets, valid, a, t):
        def do(s):
            s = jtrk.predict(s, jp)
            if with_gmc:
                mean, cov = jgmc.warp_xyah_bank(s.mean, s.cov, a, t,
                                                s.active)
                s = s.replace(mean=mean, cov=cov)
            return jtrk.update(s, dets, jp)
        return lax.cond(valid, do, lambda s: s, st)
    return jax.jit(jax.vmap(one))


INT_FIELDS = ("active", "state", "track_id", "hits", "tsu", "age",
              "class_id", "gallery_count", "gallery_next", "next_id",
              "dropped")
FLOAT_FIELDS = ("mean", "cov", "conf", "gallery")


def _assert_near_jax(ours, ref, what):
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=f"{what}: {name}")
    act = ours.active.numpy()
    for name in FLOAT_FIELDS:
        width = int(np.prod(getattr(ours, name).shape[2:]))
        a = getattr(ours, name).numpy()[act].reshape(-1, width)
        b = np.asarray(getattr(ref, name))[act].reshape(-1, width)
        scale = np.maximum(np.abs(b).max(1, initial=0), 1.0)
        assert (np.abs(a - b).max(1, initial=0) <= 1e-4 * scale).all(), \
            (what, name)
    for a, b in zip(ttrk.get_outputs(ours)[1:],
                    jax.vmap(jtrk.get_outputs)(ref)[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=what)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_stacked_step_equals_per_stream_and_jax_vmap(preset):
    """12 frames of 3 streams (births, deaths after ``max_age``, an
    overflow, features missing, single masked slots and a frame no stream
    takes); StrongSORT with its EMA bank, NSA and one camera affine a
    stream a frame. After every frame the stack equals the streams stepped
    one by one bitwise, and ``jax.vmap`` of the JAX step within the
    tolerances above."""
    extra = PRESETS[preset]
    gmc = preset == "strongsort"
    tp = tstate.TrackerParams(**BASE, **extra)
    jp = jstate.TrackerParams(**BASE, **extra)
    seqs = [_stream_frames(kind, seed=s) for s, kind in enumerate(KINDS)]
    a_all, t_all = _affines()
    step = _jax_step(jp, gmc)

    stack = tstate.init_state(tp, n_streams=S)
    singles = [tstate.init_state(tp) for _ in range(S)]
    jstack = jax.vmap(lambda _: jstate.init_state(jp))(jnp.arange(S))
    for t in range(12):
        dets = [tstate.make_detections(*seqs[s][t], params=tp)
                for s in range(S)]
        jdets = jax.tree.map(lambda *xs: jnp.stack(xs), *[
            jstate.make_detections(*seqs[s][t], params=jp)
            for s in range(S)])
        warp = (torch.from_numpy(a_all[t]), torch.from_numpy(t_all[t])) \
            if gmc else None
        keep = pl.valid_mask(VALID[t], "cpu")
        stack = pl.select_state(keep, _port_step(stack, _stack(dets), tp,
                                                 warp), stack)
        for s in range(S):
            if VALID[t, s]:
                singles[s] = _port_step(
                    singles[s], dets[s], tp,
                    None if warp is None else (warp[0][s], warp[1][s]))
        jstack = step(jstack, jdets, jnp.asarray(VALID[t]), a_all[t],
                      t_all[t])
        ref = _stack(singles)
        for f in dataclasses.fields(stack):
            assert torch.equal(getattr(stack, f.name), getattr(ref, f.name)), \
                (t, f.name)
        for a, b in zip(ttrk.get_outputs(stack), ttrk.get_outputs(ref)):
            assert torch.equal(a, b), t
        _assert_near_jax(stack, jstack, f"frame {t}")
    # the sequence took what it was made for
    assert int(stack.dropped[1]) > 0 and int(stack.dropped[0]) == 0
    assert stack.next_id.tolist()[1] > 16 and stack.active.any(-1).all()
    assert (stack.state == tstate.CONFIRMED).any(-1).all()


def test_warp_over_streams_equals_jax_vmap():
    """``warp_xyah_bank`` with one affine a stream over ``(S, T, 8)`` banks:
    within 1e-5 relative of ``jax.vmap`` of the JAX warp; each stream
    bitwise its own unbatched warp; inactive slots untouched."""
    rng = np.random.RandomState(2)
    mean = rng.normal(0, 100, (S, T_SLOTS, 8)).astype(np.float32)
    m = rng.normal(0, 1, (S, T_SLOTS, 8, 8)).astype(np.float32)
    cov = (m @ m.transpose(0, 1, 3, 2) + 8 * np.eye(8)).astype(np.float32)
    active = rng.rand(S, T_SLOTS) < 0.6
    a, tr = (x[0] for x in _affines(1, seed=3))
    args = [torch.from_numpy(x) for x in (mean, cov, a, tr, active)]
    m_o, c_o = tgmc.warp_xyah_bank(*args)
    m_r, c_r = jax.vmap(jgmc.warp_xyah_bank)(mean, cov, a, tr, active)
    for ours, ref in ((m_o, m_r), (c_o, c_r)):
        ref = np.asarray(ref)
        assert (np.abs(ours.numpy() - ref)
                <= 1e-5 * np.maximum(np.abs(ref), 1.0)).all()
    for s in range(S):
        m1, c1 = tgmc.warp_xyah_bank(*(x[s] for x in args))
        assert torch.equal(m1, m_o[s]) and torch.equal(c1, c_o[s])
    np.testing.assert_array_equal(m_o.numpy()[~active], mean[~active])


def test_stacked_init_slice_and_splice_equal_jax():
    """``init_state(n_streams=S)`` is the JAX stack of fresh states; the
    slice/splice helpers on a stack equal the JAX package's
    ``slice_stream_tracks`` / ``splice_stream_tracks``."""
    tp = tstate.TrackerParams(**BASE, nn_budget=2)
    jp = jstate.TrackerParams(**BASE, nn_budget=2)
    stack = tstate.init_state(tp, n_streams=S)
    jstack = jax.vmap(lambda _: jstate.init_state(jp))(jnp.arange(S))
    rng = np.random.RandomState(4)
    upd = {}
    for f in dataclasses.fields(stack):
        x = getattr(stack, f.name)
        if x.dtype == torch.bool:
            v = rng.rand(*x.shape) < 0.5
        elif x.dtype == torch.int32:
            v = rng.randint(0, 50, x.shape).astype(np.int32)
        else:
            v = rng.normal(0, 1, x.shape).astype(np.float32)
        np.testing.assert_array_equal(x.numpy(),
                                      np.asarray(getattr(jstack, f.name)))
        upd[f.name] = v
    ours = stack.replace(**{k: torch.from_numpy(v) for k, v in upd.items()})
    ref = jstack.replace(**{k: jnp.asarray(v) for k, v in upd.items()})
    small = tstate.slice_any_tracks(ours, 4)
    j_small = jstate.slice_stream_tracks(ref, 4)
    for f in dataclasses.fields(small):
        np.testing.assert_array_equal(getattr(small, f.name).numpy(),
                                      np.asarray(getattr(j_small, f.name)))
    small = small.replace(active=~small.active, next_id=small.next_id + 1)
    j_small = j_small.replace(active=~j_small.active,
                              next_id=j_small.next_id + 1)
    spliced = tstate.splice_any_tracks(ours, small)
    j_spliced = jstate.splice_stream_tracks(ref, j_small)
    for f in dataclasses.fields(spliced):
        np.testing.assert_array_equal(getattr(spliced, f.name).numpy(),
                                      np.asarray(getattr(j_spliced, f.name)))


# --- the capacity bucket of a stream stack ----------------------------------

def _jax_rule(states, small_dropped, t_small):
    """The JAX multi-stream decision (``aicamera_tpu/parallel/
    multistream.py:618-626``) on stacked states: ``fits`` reduced over all
    streams, then the full pass if the small pass's summed ``dropped``
    grew. Returns the way the chunk takes."""
    headroom = max(4, t_small // 4)
    fits = bool(~jnp.any(states.active[:, t_small:])
                & (jnp.max(jnp.sum(states.active, axis=1))
                   <= t_small - headroom))
    if not fits:
        return "skipped"
    return "rerun" if small_dropped > int(jnp.sum(states.dropped)) \
        else "small"


def test_stream_bucket_decision_takes_the_jax_way():
    """The bucketed scan of a stack decides once for all streams, as JAX
    does: chunk after chunk of the 12-frame sequence (chunks of 2) its way
    (small pass, skip, rerun) is the JAX rule's on the JAX states, and its
    outputs and states equal the unbucketed scan's bitwise. The overflow
    stream's load passes ``t_small`` while the others would fit alone, so
    the whole stack skips the small pass (a per-stream rule would have
    taken it for the two others)."""
    t_small = 8
    tp = tstate.TrackerParams(**BASE, nn_budget=4)
    jp = jstate.TrackerParams(**BASE, nn_budget=4)
    seqs = [_stream_frames(kind, seed=s) for s, kind in enumerate(KINDS)]
    step = _jax_step(jp, False)

    def chunk_inputs(c):
        return [_stack([tstate.make_detections(*seqs[s][t], params=tp)
                        for s in range(S)]) for t in (2 * c, 2 * c + 1)]

    def scan_of(dets, valid):
        def scan(st, pp):
            outs = []
            for d, v in zip(dets, valid):
                st = pl.select_state(torch.from_numpy(v),
                                     _port_step(st, d, pp, None), st)
                outs.append(ttrk.get_outputs(st))
            return st, tuple(torch.stack(x) for x in zip(*outs))
        return scan

    bucketed = full = tstate.init_state(tp, n_streams=S)
    jstack = jax.vmap(lambda _: jstate.init_state(jp))(jnp.arange(S))
    ways, per_stream_small = [], 0
    for c in range(6):
        dets, valid = chunk_inputs(c), VALID[2 * c:2 * c + 2]
        scan = scan_of(dets, valid)
        # the small pass's summed dropped, which the JAX rule reads
        small, _ = scan(tstate.slice_any_tracks(full, t_small),
                        dataclasses.replace(tp, max_tracks=t_small))
        want = _jax_rule(jstack, int(small.dropped.sum()), t_small)
        headroom = max(4, t_small // 4)
        per_stream_small += sum(
            int(not full.active[s, t_small:].any()
                and full.active[s].sum() <= t_small - headroom)
            for s in range(S)) if want == "skipped" else 0
        stats = dict(small=0, skipped=0, rerun=0)
        bucketed, outs_b = pl._bucketed_time_scan(bucketed, scan, tp,
                                                  t_small, stats)
        full, outs_f = scan(full, tp)
        assert stats[want] == 1 and sum(stats.values()) == 1, (c, stats)
        ways.append(want)
        for a, b in zip(outs_b, outs_f):
            assert torch.equal(a, b), c
        for f in dataclasses.fields(full):
            assert torch.equal(getattr(bucketed, f.name),
                               getattr(full, f.name)), (c, f.name)
        for t in (2 * c, 2 * c + 1):
            jdets = jax.tree.map(lambda *xs: jnp.stack(xs), *[
                jstate.make_detections(*seqs[s][t], params=jp)
                for s in range(S)])
            jstack = step(jstack, jdets, jnp.asarray(VALID[t]),
                          np.tile(np.eye(2, dtype=np.float32), (S, 1, 1)),
                          np.zeros((S, 2), np.float32))
        _assert_near_jax(full, jstack, f"chunk {c}")
    assert {"small", "skipped", "rerun"} <= set(ways), ways
    assert per_stream_small > 0   # where one stream held the others back


def test_valid_mask_is_the_host_pattern():
    """``valid_mask`` rebuilds any pattern from fills, across words."""
    rng = np.random.RandomState(0)
    for shape in ((8,), (4, 8), (16, 9), (1,)):
        v = rng.rand(*shape) < 0.5
        got = pl.valid_mask(v, "cpu")
        assert got.dtype == torch.bool and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), v)
