"""Port: the motion cores (ByteTrack, BoT-SORT, OC-SORT, Deep OC-SORT) over a
stream axis with no read of the device, against ``jax.vmap`` of the JAX
step and against the port's own per-stream step; OC-SORT's ORU replay
against the JAX step's ``do_replay``.

Sizes: S=3 streams, T=16 track slots, N=8 detection slots, D=32 features, 12
frames; every input is drawn from numpy seeds.

Tolerances:

- the stacked step against the per-stream port step: every state field and
  every output bitwise (on the CPU the batched products round as the
  per-stream ones do);
- the stacked step against ``jax.vmap`` of the JAX step, stream by stream:
  ``tests/test_torch_bytetrack.py``'s ``compare_states`` and
  ``compare_outputs`` (integer and boolean fields exact; float fields within
  1e-4 of their track's scale, OC-SORT's covariances of a scale of at least
  100 as in ``tests/test_torch_ocsort.py``: the two packages order the f32
  products differently, and JAX solves the gain by LU);
- the ORU replay: the port step from the JAX state against the JAX step,
  likewise; ``oru_replay_plain`` bitwise the loop to the frame's largest gap
  that it replaced;
- ``warp_ocsort_state`` over streams: within 1e-5 relative of ``jax.vmap``
  of the JAX warp, each stream bitwise its own unbatched warp.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from aicamera_tpu.core import bytetrack as jbt  # noqa: E402
from aicamera_tpu.core import ocsort as joc  # noqa: E402
from aicamera_tpu.core import state as jstate  # noqa: E402
from aicamera_tpu.ops import gmc as jgmc  # noqa: E402
from aicamera_tpu_torch.core import assignment as tasg  # noqa: E402
from aicamera_tpu_torch.core import bytetrack as tbt  # noqa: E402
from aicamera_tpu_torch.core import ocsort as toc  # noqa: E402
from aicamera_tpu_torch.core import state as tstate  # noqa: E402
from aicamera_tpu_torch.core import tracker as ttrk  # noqa: E402
from aicamera_tpu_torch.ops import gmc as tgmc  # noqa: E402
from aicamera_tpu_torch.ops import oru as koru  # noqa: E402
from aicamera_tpu_torch.runtime import checkpoint as ckpt  # noqa: E402
from aicamera_tpu_torch.runtime import pipeline as pl  # noqa: E402
from test_torch_bytetrack import compare_outputs, compare_states  # noqa: E402
from test_torch_ocsort import P_FLOORS  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    PyTorch's thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S, T_SLOTS, N_DETS, DIM, N_FRAMES = 3, 16, 8, 32, 12
# (tracker core, JAX core, params); OC-SORT's max_age 5: replays of gaps up
# to 6 within the 12 frames
FAMILIES = {
    "bytetrack": (tbt, jbt, dict(max_time_lost=5)),
    "botsort": (tbt, jbt, dict(max_time_lost=5, with_appearance=True,
                               feature_dim=DIM)),
    "ocsort": (toc, joc, dict(max_age=5, min_hits=2, det_thresh=0.4)),
    "deepocsort": (toc, joc, dict(max_age=5, min_hits=2, det_thresh=0.4,
                                  with_appearance=True, feature_dim=DIM)),
}
# (frame, stream) slots that do not advance: single streams, and frame 10
# for every stream (a frame no stream takes)
MASKED = {(3, 2), (4, 2), (8, 2), (7, 0), (2, 1), (10, 0), (10, 1), (10, 2)}
VALID = np.array([[(t, s) not in MASKED for s in range(S)]
                  for t in range(N_FRAMES)])


def _params(name):
    core, jcore, kw = FAMILIES[name]
    kw = dict(kw, max_tracks=T_SLOTS, max_detections=N_DETS)
    cls = "ByteTrackParams" if core is tbt else "OCSortParams"
    return core, jcore, getattr(core, cls)(**kw), getattr(jcore, cls)(**kw)


def _walker_frames(seed, hidden, n=N_FRAMES, n_objects=5, weak=0.2,
                   stray=True):
    """``n`` frames of ``n_objects`` 40x80 boxes walking 3 px a frame, each
    hidden over its ``hidden`` frame ranges (occlusions to revive from);
    with ``stray`` from frame 6 now and then a stray box; scores 0.6-0.95,
    a ``weak`` share of them 0.2-0.45 (both of ByteTrack's splits).
    Returns ``(xyxy, score, class, feature)`` per frame, the feature
    following the object."""
    rng = np.random.RandomState(seed)
    base = rng.normal(size=(n_objects + 1, DIM))
    out = []
    for t in range(n):
        rows = []
        for o in range(n_objects):
            if any(a <= t <= b for obj, a, b in hidden if obj == o):
                continue
            x, y = 20 + 60 * o + 3 * t, 30 + 25 * (o % 2) + 2 * t
            rows.append((o, [x, y, x + 40, y + 80]))
        if stray and t >= 6 and rng.rand() < 0.5:
            x, y = rng.uniform(0, 300, 2)
            rows.append((n_objects, [x, y, x + 30, y + 60]))
        xyxy = np.array([r[1] for r in rows], np.float32) \
            + rng.normal(0, 0.5, (len(rows), 4)).astype(np.float32)
        score = np.where(rng.rand(len(rows)) < weak,
                         rng.uniform(0.2, 0.45, len(rows)),
                         rng.uniform(0.6, 0.95, len(rows))).astype(np.float32)
        feat = np.stack([base[o] + 0.1 * rng.normal(size=DIM)
                         for o, _ in rows]).astype(np.float32)
        feat[rng.rand(len(rows)) < 0.15] = 0.0
        out.append((xyxy, score, np.zeros(len(rows), np.int32), feat))
    return out


STREAM_HIDDEN = ([(0, 3, 4), (2, 5, 7)], [(1, 2, 6), (3, 4, 4)],
                 [(4, 1, 5), (0, 7, 8)])


def _dets(mod, xyxy, score, cls, feat, params):
    on = {"device": "cpu"} if mod in (tbt, toc) else {}  # JAX takes none
    if mod in (tbt, jbt):
        tlwh = np.concatenate([xyxy[:, :2], xyxy[:, 2:] - xyxy[:, :2]], 1)
        return mod.make_detections(tlwh, score, cls, feature=feat,
                                   params=params, **on)
    return mod.make_detections(xyxy, score, cls, feature=feat, params=params,
                               **on)


def _stack(items):
    """Per-stream containers (dataclasses of tensors) on a stream axis."""
    return dataclasses.replace(items[0], **{
        f.name: None if getattr(items[0], f.name) is None
        else torch.stack([getattr(x, f.name) for x in items])
        for f in dataclasses.fields(items[0])})


def _stream(state, s):
    """Stream ``s`` of a stacked torch or JAX state."""
    return dataclasses.replace(state, **{
        f.name: None if getattr(state, f.name) is None
        else getattr(state, f.name)[s] for f in dataclasses.fields(state)})


def _affines(n=N_FRAMES, seed=7):
    """One camera affine a stream a frame, near the identity."""
    rng = np.random.RandomState(seed)
    a = np.eye(2, dtype=np.float32) + rng.normal(0, 0.01, (n, S, 2, 2))
    t = rng.normal(0, 2.0, (n, S, 2))
    return a.astype(np.float32), t.astype(np.float32)


def _outputs(core, st, tp):
    return core.get_outputs(st) if core is tbt else core.get_outputs(st, tp)


def _jax_outputs(jcore, js, jp):
    return jcore.get_outputs(js) if jcore is jbt \
        else jcore.get_outputs(js, jp)


def _jax_vmap_step(jcore, jp, with_gmc):
    def one(st, dets, valid, a, t):
        gmc = (a, t) if with_gmc else None
        return lax.cond(valid, lambda s: jcore.step(s, dets, jp, gmc),
                        lambda s: s, st)
    return jax.jit(jax.vmap(one))


@pytest.mark.parametrize("name,gmc", [("bytetrack", False),
                                      ("botsort", False), ("ocsort", False),
                                      ("deepocsort", False), ("ocsort", True)],
                         ids=["bytetrack", "botsort", "ocsort", "deepocsort",
                              "ocsort-gmc"])
def test_stacked_step_equals_per_stream_and_jax_vmap(name, gmc):
    """12 frames of 3 streams (births, occlusions and revivals, OC-SORT's
    replays, stray boxes, features missing, single masked slots and a frame
    no stream takes; one camera affine a stream a frame in the GMC case).
    After every frame the stack equals the streams stepped one by one
    bitwise, and ``jax.vmap`` of the JAX step within the tolerances
    above; no read of the device."""
    core, jcore, tp, jp = _params(name)
    seqs = [_walker_frames(s, STREAM_HIDDEN[s]) for s in range(S)]
    a_all, t_all = _affines()
    step = _jax_vmap_step(jcore, jp, gmc)
    floors = P_FLOORS if core is toc else None
    reads = tasg.TRACKER_SYNCS.count

    stack = core.init_state(tp, "cpu", n_streams=S)
    singles = [core.init_state(tp, "cpu") for _ in range(S)]
    jstack = jax.vmap(lambda _: jcore.init_state(jp))(jnp.arange(S))
    emitted, replays, worst = np.zeros(S, int), 0, [0.0]
    for t in range(N_FRAMES):
        dets = [_dets(core, *seqs[s][t], tp) for s in range(S)]
        jdets = jax.tree.map(lambda *xs: jnp.stack(xs), *[
            _dets(jcore, *seqs[s][t], jp) for s in range(S)])
        warp = ((torch.from_numpy(a_all[t]), torch.from_numpy(t_all[t]))
                if gmc else None)
        if core is toc:
            pending = np.asarray(jstack.active & ~jstack.observed
                                 & jstack.frozen_valid)
        keep = pl.valid_mask(VALID[t], "cpu")
        stack = pl.select_state(keep, core.step(stack, _stack(dets), tp,
                                                gmc=warp), stack)
        for s in range(S):
            if VALID[t, s]:
                singles[s] = core.step(
                    singles[s], dets[s], tp,
                    gmc=None if warp is None else (warp[0][s], warp[1][s]))
        jstack = step(jstack, jdets, jnp.asarray(VALID[t]), a_all[t],
                      t_all[t])
        if core is toc:
            replays += int((pending & np.asarray(jstack.observed)).sum())
        ref = _stack(singles)
        for f in dataclasses.fields(stack):
            a, b = getattr(stack, f.name), getattr(ref, f.name)
            assert (a is None and b is None) or torch.equal(a, b), \
                (t, f.name)
        outs = _outputs(core, stack, tp)
        for a, b in zip(outs, _outputs(core, ref, tp)):
            assert torch.equal(a, b), t
        j_outs = jax.vmap(lambda x: _jax_outputs(jcore, x, jp))(jstack)
        for s in range(S):
            compare_states(_stream(stack, s), _stream(jstack, s), worst,
                           floors)
            emitted[s] += compare_outputs(tuple(o[s] for o in outs),
                                          tuple(o[s] for o in j_outs))
    assert tasg.TRACKER_SYNCS.count == reads
    assert (emitted > 0).all() and (stack.next_id > 4).all()
    if core is toc:
        assert replays > 0


# --- the ORU replay ------------------------------------------------------------

PLAIN_REPLAY = toc.oru_replay_plain


def _gmax_loop(x, p, frozen_x, frozen_p, replay, gap, z1, z2):
    """The replay as the port ran it before: the loop to the frame's
    largest gap, read back from the tensor."""
    return PLAIN_REPLAY(x, p, frozen_x, frozen_p, replay, gap, z1, z2,
                        int(gap.max()))


def test_oru_replay_matches_the_jax_step_and_the_gmax_loop(monkeypatch):
    """A scene with occlusions of 1 to ``max_age`` frames (gaps 2 to
    ``max_age + 1``): frame by frame the port step from the JAX state
    against the JAX step (its ``do_replay`` inside), at the tolerances
    above, and every replay of the port bitwise the loop to the frame's
    largest gap that it replaced."""
    tp = toc.OCSortParams(max_tracks=T_SLOTS, max_detections=N_DETS,
                          max_age=8, min_hits=2, det_thresh=0.4)
    jp = joc.OCSortParams(**dataclasses.asdict(tp))
    hidden = [(0, 2, 2), (1, 3, 5), (2, 4, 8), (3, 5, 12), (4, 9, 10)]
    frames = _walker_frames(11, hidden, n=18, weak=0.0, stray=False)
    calls = []

    def spy(*args):
        calls.append(args)
        return PLAIN_REPLAY(*args)

    monkeypatch.setattr(toc, "oru_replay_plain", spy)
    js = joc.init_state(jp)
    gaps = set()
    for xyxy, score, cls, _ in frames:
        xyxy, score, cls = xyxy[:N_DETS], score[:N_DETS], cls[:N_DETS]
        st = toc.OCSortState(**{
            f.name: None if getattr(js, f.name) is None
            else torch.from_numpy(np.array(getattr(js, f.name)))
            for f in dataclasses.fields(js)})
        st = toc.step(st, toc.make_detections(xyxy, score, cls, params=tp,
                                              device="cpu"), tp)
        js = joc.step(js, joc.make_detections(xyxy, score, cls, params=jp),
                      jp)
        compare_states(st, js, [0.0], P_FLOORS)
        *args, max_gap = calls[-1]
        assert max_gap == tp.max_age + 1
        replay, gap = args[4], args[5]
        gaps |= set(gap[replay].tolist())
        want = _gmax_loop(*args)
        got = PLAIN_REPLAY(*args, max_gap)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert {2, 4, 6, tp.max_age + 1} <= gaps, gaps


def test_oru_wrapper_checks_and_picks_the_plain_version_on_the_cpu():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.normal(0, 10, (2, 5, 7)).astype(np.float32))
    m = rng.normal(0, 1, (2, 5, 7, 7))
    p = torch.from_numpy((m @ m.transpose(0, 1, 3, 2) + 7 * np.eye(7))
                         .astype(np.float32))
    z = torch.from_numpy(rng.uniform(10, 200, (2, 5, 4)).astype(np.float32))
    replay = torch.from_numpy(rng.rand(2, 5) < 0.6)
    gap = torch.from_numpy(rng.randint(0, 5, (2, 5)).astype(np.int32))
    args = (x, p, x + 1.0, p * 2.0, replay, gap, z, z + 3.0)
    got = toc.oru_replay(*args, 5)
    want = toc.oru_replay_plain(*args, 5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # slots without a replay keep their input
    assert torch.equal(got[0][~replay], x[~replay])
    with pytest.raises(ValueError, match="CUDA"):
        koru.KERNEL(*args, 5)
    with pytest.raises(ValueError, match="gap"):
        toc.oru_replay(*args[:5], gap.long(), *args[6:], 5)
    with pytest.raises(ValueError, match="frozen_p"):
        toc.oru_replay(*args[:3], p[:, :4], *args[4:], 5)


# --- no read of the device, and empty solves --------------------------------

CORE_PARAMS = {
    "deepsort": (ttrk, tstate.TrackerParams(
        max_tracks=T_SLOTS, max_detections=N_DETS, feature_dim=DIM,
        nn_budget=2, n_init=2, max_age=5)),
    **{name: _params(name)[::2] for name in FAMILIES},
}


def _forbid_reads(m):
    """Reading a tensor's value on the host raises, but inside the plain
    assignment solvers: on the CPU they stand in for the kernel, which
    reads nothing on the card, and read their own values."""
    allowed = [0]

    def guard(orig):
        def read(self, *a, **k):
            if not allowed[0]:
                raise AssertionError("the step read a tensor's value")
            return orig(self, *a, **k)
        return read

    def solver(orig):
        def solve(*a, **k):
            allowed[0] += 1
            try:
                return orig(*a, **k)
            finally:
                allowed[0] -= 1
        return solve

    for attr in ("item", "tolist", "__bool__", "numpy"):
        m.setattr(torch.Tensor, attr, guard(getattr(torch.Tensor, attr)))
    for name in ("min_cost_matching_plain", "matching_cascade_plain"):
        m.setattr(tasg, name, solver(getattr(tasg, name)))


@pytest.mark.parametrize("name", sorted(CORE_PARAMS))
def test_no_core_reads_the_device(monkeypatch, name):
    """Every core's step, one stream and a stack of three: ``TRACKER_SYNCS``
    unchanged and no value read back (``item``, ``tolist``, ``bool``,
    ``numpy`` raise inside)."""
    core, tp = CORE_PARAMS[name]
    seqs = [_walker_frames(s, STREAM_HIDDEN[s]) for s in range(S)]
    if core is ttrk:
        def dets_of(xyxy, score, cls, feat):
            tlwh = np.concatenate([xyxy[:, :2], xyxy[:, 2:] - xyxy[:, :2]],
                                  1)
            return tstate.make_detections(tlwh, score, cls, feat,
                                          params=tp, device="cpu")

        def step(st, d):
            return ttrk.update(ttrk.predict(st, tp), d, tp)
        init = tstate.init_state
    else:
        def dets_of(*a):
            return _dets(core, *a, tp)

        def step(st, d):
            return core.step(st, d, tp)
        init = core.init_state
    frames = [[dets_of(*seqs[s][t]) for s in range(S)]
              for t in range(N_FRAMES)]
    reads = tasg.TRACKER_SYNCS.count
    with monkeypatch.context() as m:
        _forbid_reads(m)
        single, stack = init(tp, "cpu"), init(tp, "cpu", n_streams=S)
        for d in frames:
            single = step(single, d[0])
            stack = step(stack, _stack(d))
    assert tasg.TRACKER_SYNCS.count == reads
    assert bool(single.active.any()) and bool(stack.active.any(-1).all())


@pytest.mark.parametrize("b", [1, 8])
def test_an_empty_mask_solve_matches_nothing(b):
    """``min_cost_matching`` with no eligible row, no eligible column or
    neither returns -1 everywhere, one problem and a batch (the read-free
    stages rely on it in place of JAX's skipped ``lax.cond``)."""
    rng = np.random.RandomState(b)
    cost = torch.from_numpy(rng.uniform(0, 1, (b, T_SLOTS, N_DETS))
                            .astype(np.float32))
    rows = torch.from_numpy(rng.rand(b, T_SLOTS) < 0.7)
    cols = torch.from_numpy(rng.rand(b, N_DETS) < 0.7)
    no_rows, no_cols = torch.zeros_like(rows), torch.zeros_like(cols)
    assert (tasg.min_cost_matching(cost, rows, cols, 0.9) >= 0).any()
    for r, c in ((no_rows, cols), (rows, no_cols), (no_rows, no_cols)):
        got = tasg.min_cost_matching(cost, r, c, 0.9)
        assert got.shape == (b, T_SLOTS) and (got == -1).all()
        one = tasg.min_cost_matching(cost[0], r[0], c[0], 0.9)
        assert (one == -1).all()
        match, unmatched = tasg.matching_cascade(
            cost, torch.ones((b, T_SLOTS), dtype=torch.int32), r, c, 0.9, 3)
        assert (match == -1).all() and torch.equal(unmatched, c)


# --- stacked states -----------------------------------------------------------

@pytest.mark.parametrize("name", ["botsort", "deepocsort"])
def test_stacked_init_slice_splice_and_checkpoint(name, tmp_path):
    """``init_state(n_streams=S)`` is the JAX stack of fresh states (OC-SORT's
    ring ``(S, T, K, 4)``); slice and splice on a stack equal the JAX
    package's ``slice_stream_tracks`` / ``splice_stream_tracks``; a stacked
    checkpoint loads back with ``n_streams=S``."""
    core, jcore, tp, jp = _params(name)
    stack = core.init_state(tp, "cpu", n_streams=S)
    jstack = jax.vmap(lambda _: jcore.init_state(jp))(jnp.arange(S))
    rng = np.random.RandomState(4)
    upd = {}
    for f in dataclasses.fields(stack):
        x = getattr(stack, f.name)
        np.testing.assert_array_equal(x.numpy(),
                                      np.asarray(getattr(jstack, f.name)))
        if x.dtype == torch.bool:
            v = rng.rand(*x.shape) < 0.5
        elif x.dtype == torch.int32:
            v = rng.randint(0, 50, x.shape).astype(np.int32)
        else:
            v = rng.normal(0, 1, x.shape).astype(np.float32)
        upd[f.name] = v
    if core is toc:
        assert stack.obs_ring.shape == (S, T_SLOTS, tp.delta_t + 1, 4)
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
    path = tmp_path / "stack.msgpack"
    ckpt.save_state(path, spliced)
    back = ckpt.load_state(path, tp, n_streams=S, device="cpu")
    for f in dataclasses.fields(back):
        assert torch.equal(getattr(back, f.name), getattr(spliced, f.name))
    with pytest.raises(ValueError, match="params give"):
        ckpt.load_state(path, tp, device="cpu")


def test_ocsort_warp_over_streams_equals_jax_vmap():
    """``warp_ocsort_state`` with one affine a stream over a stacked state
    (Kalman bank, frozen state, last observations, the ring, the momentum):
    within 1e-5 relative of ``jax.vmap`` of the JAX warp; each stream
    bitwise its own unbatched warp; sentinel entries untouched."""
    _, _, tp, jp = _params("ocsort")
    stack = toc.init_state(tp, n_streams=S, device="cpu")
    rng = np.random.RandomState(5)
    k = tp.delta_t + 1
    m = rng.normal(0, 1, (S, T_SLOTS, 7, 7))
    pd = (m @ m.transpose(0, 1, 3, 2) + 7 * np.eye(7)).astype(np.float32)
    last = rng.uniform(0, 300, (S, T_SLOTS, 5)).astype(np.float32)
    last[rng.rand(S, T_SLOTS) < 0.3] = -1.0
    vel = rng.normal(0, 1, (S, T_SLOTS, 2)).astype(np.float32)
    vel /= np.linalg.norm(vel, axis=-1, keepdims=True)
    vel[rng.rand(S, T_SLOTS) < 0.2] = 0.0
    fields = dict(
        active=rng.rand(S, T_SLOTS) < 0.7,
        x=np.abs(rng.normal(100, 50, (S, T_SLOTS, 7))).astype(np.float32),
        p=pd, frozen_x=rng.normal(100, 50, (S, T_SLOTS, 7)).astype(
            np.float32), frozen_p=pd * 2,
        frozen_valid=rng.rand(S, T_SLOTS) < 0.5, last_obs=last,
        obs_ring=rng.uniform(0, 300, (S, T_SLOTS, k, 4)).astype(np.float32),
        obs_age=np.where(rng.rand(S, T_SLOTS, k) < 0.6,
                         rng.randint(0, 9, (S, T_SLOTS, k)), -1).astype(
            np.int32), velocity=vel)
    ours = stack.replace(**{n: torch.from_numpy(v) for n, v in fields.items()})
    jstack = jax.vmap(lambda _: joc.init_state(jp))(jnp.arange(S))
    ref = jstack.replace(**{n: jnp.asarray(v) for n, v in fields.items()})
    a, t = (x[0] for x in _affines(1, seed=3))
    got = tgmc.warp_ocsort_state(ours, torch.from_numpy(a),
                                 torch.from_numpy(t))
    want = jax.vmap(jgmc.warp_ocsort_state)(ref, a, t)
    for name in fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if g.dtype.kind != "f":
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        assert (np.abs(g - w) <= 1e-5 * np.maximum(np.abs(w), 1.0)).all(), \
            name
    for s in range(S):
        one = tgmc.warp_ocsort_state(_stream(ours, s), torch.from_numpy(a[s]),
                                     torch.from_numpy(t[s]))
        for name in fields:
            assert torch.equal(getattr(one, name), getattr(got, name)[s]), \
                (s, name)
    idle = ~fields["active"]
    np.testing.assert_array_equal(got.x.numpy()[idle], fields["x"][idle])
    np.testing.assert_array_equal(got.obs_ring.numpy()[idle],
                                  fields["obs_ring"][idle])
