"""Port: the capacity-bucketed tracker scan. A core on a sliced state equals
the core at full capacity on the first slots; a bucketed pipeline equals an
unbucketed one through the small pass, the skip and the overflow rerun; and
both equal the JAX pipeline with the same ``scan_bucket``. All exact."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aicamera_tpu.core import state as jstate  # noqa: E402
from aicamera_tpu_torch import config  # noqa: E402
from aicamera_tpu_torch.core import bytetrack as bt  # noqa: E402
from aicamera_tpu_torch.core import ocsort as oc  # noqa: E402
from aicamera_tpu_torch.core import state as cs  # noqa: E402
from aicamera_tpu_torch.core import tracker as trk  # noqa: E402
from aicamera_tpu_torch.runtime import pipeline as pl  # noqa: E402
from aicamera_tpu_torch.scenes import moving_boxes  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    PyTorch's thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


T_FULL, T_SMALL, N_DET = 32, 16, 12


def _tlwh(xyxy):
    return np.concatenate([xyxy[:, :2], xyxy[:, 2:] - xyxy[:, :2]], 1)


def _deepsort_frame(p):
    rng = np.random.RandomState(1)

    def frame(st, xyxy, score, cls):
        feat = rng.normal(size=(len(xyxy), p.feature_dim)).astype(np.float32)
        dets = cs.make_detections(_tlwh(xyxy), score, cls, feat, params=p,
                                  device="cpu")
        return trk.update(trk.predict(st, p), dets, p)
    return frame


def _family(name, t):
    """(params, init_state, frame(st, xyxy, score, cls), outputs(st))."""
    if name == "deepsort":
        p = cs.TrackerParams(max_tracks=t, max_detections=N_DET, nn_budget=4,
                             max_age=6, n_init=2, feature_dim=16)
        return (p, cs.init_state(p, device="cpu"), _deepsort_frame(p),
                trk.get_outputs)
    if name == "bytetrack":
        p = bt.ByteTrackParams(max_tracks=t, max_detections=N_DET,
                               max_time_lost=6)
        return (p, bt.init_state(p, device="cpu"),
                lambda st, b, s, c: bt.step(st, bt.make_detections(
                    _tlwh(b), s, c, params=p, device="cpu"), p),
                bt.get_outputs)
    p = oc.OCSortParams(max_tracks=t, max_detections=N_DET, max_age=6,
                        min_hits=2)
    return (p, oc.init_state(p, device="cpu"),
            lambda st, b, s, c: oc.step(st, oc.make_detections(
                b, s, c, params=p, device="cpu"), p),
            lambda st: oc.get_outputs(st, p))


def _assert_states_equal(a, b, what=""):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert (x is None) == (y is None), f.name
        if x is not None:
            assert torch.equal(x, y), (what, f.name)


@pytest.mark.parametrize("family", ["deepsort", "bytetrack", "ocsort"])
def test_sliced_core_equals_full_core(family):
    """A scene that never needs more than T_SMALL slots: the core on the
    small table and on the full table agree exactly, frame by frame, on the
    first T_SMALL slots, the counters and the outputs; and splicing the small
    state into a fresh master gives the full state."""
    scene = moving_boxes(16, n_objects=4, seed=2, miss=0.2, low=0.2,
                         gaps=[(1, 5, 9)])
    _, full, step_full, out_full = _family(family, T_FULL)
    _, small, step_small, out_small = _family(family, T_SMALL)
    master = full
    emitted = 0
    for xyxy, score, cls in scene:
        full = step_full(full, xyxy, score, cls)
        small = step_small(small, xyxy, score, cls)
        assert int(small.dropped) == 0 and not full.active[T_SMALL:].any()
        _assert_states_equal(cs.slice_any_tracks(full, T_SMALL), small)
        for a, b in zip(out_full(full), out_small(small)):
            assert torch.equal(a[:T_SMALL], b)
            assert not a[T_SMALL:].any()      # zeros on masked lanes
        emitted += int(out_small(small)[-1].sum())
    assert emitted > 0
    spliced = cs.splice_any_tracks(master, small)
    _assert_states_equal(spliced, full)
    assert not master.active.any()            # the master was not written


def test_track_axis_field_names_match_jax():
    from aicamera_tpu.core import bytetrack as jbt
    from aicamera_tpu.core import ocsort as joc
    pairs = [
        (cs.init_state(cs.TrackerParams(max_tracks=4, nn_budget=2,
                                        feature_dim=4), device="cpu"),
         jstate.init_state(jstate.TrackerParams(max_tracks=4, nn_budget=2,
                                                feature_dim=4))),
        (bt.init_state(bt.ByteTrackParams(max_tracks=4), device="cpu"),
         jbt.init_state(jbt.ByteTrackParams(max_tracks=4))),
        (bt.init_state(bt.ByteTrackParams(max_tracks=4, with_appearance=True,
                                          feature_dim=4), device="cpu"),
         jbt.init_state(jbt.ByteTrackParams(max_tracks=4,
                                            with_appearance=True,
                                            feature_dim=4))),
        (oc.init_state(oc.OCSortParams(max_tracks=4), device="cpu"),
         joc.init_state(joc.OCSortParams(max_tracks=4))),
    ]
    for ours, ref in pairs:
        assert cs.track_axis_field_names(ours) == \
            jstate.track_axis_field_names(ref)
        sliced = cs.slice_any_tracks(ours, 2)
        assert all(getattr(sliced, f).shape[0] == 2
                   for f in cs.track_axis_field_names(ours))


# --- pipeline level ----------------------------------------------------------
# tests/test_scan_bucket_impl.py's sizes (shared JAX compile cache): noise
# frames, so the synthetic grid is the whole load.

CHUNK, N_CHUNKS, FRAME_HW = 4, 3, (96, 128)
DEEPSORT = dict(max_tracks=64, max_detections=16, nn_budget=4, max_age=10,
                n_init=2, feature_dim=512)
# (scan_bucket, synthetic_load, the ways the chunks must take)
SMALL_PATH = (16, 6, dict(small=3, skipped=0, rerun=0))
# chunk 1 overflows the small table mid-chunk and reruns; chunks 2 and 3 see
# active high slots and skip the small pass
OVERFLOW_PATH = (4, 8, dict(small=0, skipped=2, rerun=1))
CORES = {
    "deepsort": dict(tracker_params=cs.TrackerParams(**DEEPSORT)),
    "bytetrack": dict(tracker="bytetrack",
                      bytetrack_params=bt.ByteTrackParams(
                          track_thresh=0.4, max_tracks=64,
                          max_detections=16)),
    "deepocsort": dict(tracker="deepocsort",
                       ocsort_params=oc.OCSortParams(
                           det_thresh=0.4, min_hits=2, max_tracks=64,
                           max_detections=16, with_appearance=True)),
}


def _frames():
    rng = np.random.RandomState(0)
    return rng.randint(0, 255, (N_CHUNKS * CHUNK, *FRAME_HW, 3), np.uint8)


def _run_port(scan_bucket, synthetic_load, **kw):
    pipe = pl.TrackingPipeline(
        chunk_size=CHUNK, input_shape=(128, 128), max_reid_crops=4,
        synthetic_load=synthetic_load, scan_bucket=scan_bucket, device="cpu",
        yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
        reid_weights=str(config.REID_SYNTHETIC_PATH), **kw)
    before = pl.BUCKET_SYNCS.count
    results = list(pipe.process_frames(iter(_frames())))
    return pipe, results, pl.BUCKET_SYNCS.count - before


@pytest.mark.parametrize("core", sorted(CORES))
@pytest.mark.parametrize("path", [SMALL_PATH, OVERFLOW_PATH],
                         ids=["small", "overflow"])
def test_bucketed_pipeline_equals_unbucketed(core, path):
    scan_bucket, load, ways = path
    a, res_a, reads = _run_port(scan_bucket, load, **CORES[core])
    b, res_b, no_reads = _run_port(0, load, **CORES[core])
    assert a.scan_stats == ways and no_reads == 0
    # one read for ``fits``, a second after each small pass
    assert reads == N_CHUNKS + ways["small"] + ways["rerun"]
    assert sum(len(r.tracks) for r in res_a) > 0
    assert [r.tracks for r in res_a] == [r.tracks for r in res_b]
    _assert_states_equal(a.state, b.state, core)


def test_default_scan_bucket_is_the_jax_default():
    import inspect

    from aicamera_tpu.runtime.pipeline import TrackingPipeline as Jax
    ours = inspect.signature(pl.TrackingPipeline.__init__).parameters
    ref = inspect.signature(Jax.__init__).parameters
    assert ours["scan_bucket"].default == ref["scan_bucket"].default == 32
    # every argument of the JAX class, in its order, then the port's own:
    # ``detector`` (YOLOv8 by default, or RT-DETR-L), RT-DETR's
    # ``num_queries`` (its published 300 by default) and ``device``
    assert list(ours) == list(ref) + ["detector", "num_queries", "device"]
    assert ours["detector"].default == "yolov8"
    assert ours["num_queries"].default is None
    for name, p in ref.items():
        if name not in ("self", "bytetrack_params", "ocsort_params",
                        "tracker_params"):
            assert ours[name].default == p.default, name
    with pytest.raises(ValueError, match="scan_bucket"):
        pl.TrackingPipeline(device="cpu", scan_bucket=-1)


@pytest.mark.parametrize("path", [SMALL_PATH, OVERFLOW_PATH],
                         ids=["small", "overflow"])
def test_bucketed_pipeline_matches_jax(path):
    """The DeepSORT pipeline with the same ``scan_bucket`` in both packages:
    track tuples identical (the synthetic grid gives exact inputs)."""
    from aicamera_tpu.runtime.pipeline import TrackingPipeline as Jax
    scan_bucket, load, _ = path
    _, ours, _ = _run_port(scan_bucket, load, **CORES["deepsort"])
    jax_pipe = Jax(chunk_size=CHUNK, input_shape=(128, 128),
                   tracker_params=jstate.TrackerParams(**DEEPSORT),
                   max_reid_crops=4, synthetic_load=load,
                   scan_bucket=scan_bucket,
                   yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
                   reid_weights=str(config.REID_SYNTHETIC_PATH))
    ref = list(jax_pipe.process_frames(iter(_frames())))
    assert sum(len(r.tracks) for r in ref) > 0
    for a, b in zip(ours, ref, strict=True):
        assert [t[:6] for t in a.tracks] == [t[:6] for t in b.tracks]
        for ta, tb in zip(a.tracks, b.tracks):
            assert ta[6] == pytest.approx(tb[6], abs=1e-5)
