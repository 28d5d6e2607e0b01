"""Port: the serving layer (``aicamera_tpu_torch/serving.py``) on the CPU.

The cases of ``tests/test_serving.py`` (packed readback, masked isolation,
slot leasing and re-lease, validation, drain, shutdown, the eager, deadline
and full-chunk triggers, the per-request deadline, ``wait_idle``), plus the
port's: ``TrackingService`` and every tenant of the multi-tenant service
give the track tuples of ``TrackingPipeline.process_frames`` over the same
frames, a re-leased slot restarts its ids at 1, a failing dispatch
reaches its futures, and the services default to the GPU.

Sizes as in ``tests/test_serving.py``: 96x128 frames, detector input
128x128, a 16-track table, 4 ReID crops; the committed synthetic weights.
Track tuples against the single-stream pipeline: ids, classes and boxes
identical, conf within 1e-5 (a dispatch batches other frames beside a
stream's, and the convolution library may sum in another order for another
batch size, as ``tests/test_torch_pipeline.py`` allows).
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aicamera_tpu_torch import config  # noqa: E402
from aicamera_tpu_torch.core.state import TrackerParams  # noqa: E402
from aicamera_tpu_torch.parallel import MultiStreamPipeline  # noqa: E402
from aicamera_tpu_torch.runtime.pipeline import TrackingPipeline  # noqa: E402
from aicamera_tpu_torch.scenes import moving_rectangles  # noqa: E402
from aicamera_tpu_torch.serving import (MultiTenantTrackingService,  # noqa
                                        StreamFrameResult, TrackingService)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    PyTorch's thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL_TP = TrackerParams(max_tracks=16, max_detections=8, nn_budget=4,
                         max_age=10, feature_dim=config.REID_FEATURE_DIM)
FRAME_HW = (96, 128)
PIPE_KW = dict(input_shape=(128, 128), tracker_params=SMALL_TP,
               max_reid_crops=4, device="cpu",
               yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
               reid_weights=str(config.REID_SYNTHETIC_PATH))


def _frames(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (*FRAME_HW, 3), np.uint8) for _ in range(n)]


def _scene(n, seed=3):
    """Frames the committed detector finds rectangles in."""
    return list(moving_rectangles(n, FRAME_HW, n_objects=3, seed=seed))


def _reference(frames):
    """Track tuples of a single-stream pipeline over ``frames``."""
    pipe = TrackingPipeline(chunk_size=2, **PIPE_KW)
    return [r.tracks for r in pipe.process_frames(iter(frames))]


def _assert_same_tracks(got, ref):
    """Per frame: ids, classes and boxes identical, conf within 1e-5."""
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert [t[:6] for t in a] == [t[:6] for t in b]
        for ta, tb in zip(a, b):
            assert ta[6] == pytest.approx(tb[6], abs=1e-5)


def test_packed_readback_exact_for_large_track_ids():
    """The single-transfer readback packs track ids into two 16-bit f32
    lanes: ids beyond 2^24 (where one f32 lane silently rounds) must
    round-trip exactly; a long-lived service's ids grow without end."""
    ids = torch.tensor([[[0, 1, 2 ** 24 + 1, 2 ** 31 - 1, 16_777_217,
                          999_999_937, 7, 8]]], dtype=torch.int32)
    S, K, T = ids.shape
    tlbr = torch.arange(S * K * T * 4, dtype=torch.float32).reshape(
        S, K, T, 4)
    cls = torch.arange(T, dtype=torch.int32).reshape(1, 1, T)
    conf = torch.linspace(0, 1, T, dtype=torch.float32).reshape(1, 1, T)
    mask = torch.tensor([[[1, 1, 1, 1, 1, 1, 0, 0]]], dtype=torch.bool)
    packed = MultiTenantTrackingService._pack_outputs(
        (tlbr, ids, cls, conf, mask))
    host, ready = MultiTenantTrackingService._readback(packed)
    assert ready is None and host.dtype == torch.float32
    arr = host.numpy()
    assert arr.shape == (S, K, T, 9)
    got_ids = (arr[..., 4].astype(np.int64)
               | (arr[..., 5].astype(np.int64) << 16))
    np.testing.assert_array_equal(got_ids, ids.numpy())
    np.testing.assert_array_equal(arr[..., :4], tlbr.numpy())
    np.testing.assert_array_equal(arr[..., 6].astype(np.int32), cls.numpy())
    np.testing.assert_allclose(arr[..., 7], conf.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(arr[..., 8] != 0.0, mask.numpy())


def test_masked_chunk_step_leaves_invalid_stream_untouched():
    """frame_valid=False lanes must not advance that stream's tracker
    state, bitwise, while valid lanes process normally."""
    pipe = MultiStreamPipeline(n_streams=2, frame_hw=FRAME_HW, **PIPE_KW)
    before = pipe.states
    rng = np.random.RandomState(3)
    frames = rng.randint(0, 256, (2, 3, *FRAME_HW, 3), np.uint8)
    frames[0] = np.stack(_scene(3))
    valid = np.array([[True, True, True], [False, False, False]])
    pipe.step_chunk(frames, frame_valid=valid)
    after = pipe.states
    for name in ("active", "state", "mean", "cov", "hits", "age", "tsu",
                 "track_id", "gallery", "gallery_count", "next_id"):
        assert torch.equal(getattr(before, name)[1],
                           getattr(after, name)[1]), name
    assert int(after.next_id[0]) > 1


@pytest.fixture(scope="module")
def svc():
    service = MultiTenantTrackingService(
        n_streams=2, frame_hw=FRAME_HW, chunk_size=2, max_latency_ms=20.0,
        **PIPE_KW)
    yield service
    service.shutdown()


def test_multitenant_streams_resolve_independently(svc):
    s0 = svc.open_stream()
    s1 = svc.open_stream(max_latency_ms=10.0)
    futs0 = [svc.submit(s0, f) for f in _frames(5, seed=1)]
    futs1 = [svc.submit(s1, f) for f in _frames(2, seed=2)]
    r0 = [f.result(timeout=300) for f in futs0]
    r1 = [f.result(timeout=300) for f in futs1]
    assert [r.frame_index for r in r0] == list(range(5))
    assert [r.frame_index for r in r1] == list(range(2))
    assert all(r.stream_id == s0 for r in r0)
    assert all(r.stream_id == s1 for r in r1)
    for r in r0 + r1:
        assert isinstance(r, StreamFrameResult)
        assert isinstance(r.tracks, list)
    svc.close_stream(s0)
    svc.close_stream(s1)
    svc.wait_idle(timeout=60)


def test_each_tenant_equals_a_single_stream_pipeline(svc):
    """Two tenants submitting from their own threads at different paces:
    each tenant's track tuples equal a ``TrackingPipeline`` over its frames
    alone, whatever lanes and dispatches its frames rode."""
    scenes = {0: _scene(7, seed=3), 1: _scene(4, seed=5)}
    results = {}

    def tenant(key, pause):
        sid = svc.open_stream(max_latency_ms=15.0)
        futs = []
        for f in scenes[key]:
            futs.append(svc.submit(sid, f))
            time.sleep(pause)
        results[key] = [f.result(timeout=300) for f in futs]
        svc.close_stream(sid)

    threads = [threading.Thread(target=tenant, args=(0, 0.0)),
               threading.Thread(target=tenant, args=(1, 0.03))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    svc.wait_idle(timeout=60)
    n_tracks = 0
    for key, frames in scenes.items():
        got = [r.tracks for r in results[key]]
        _assert_same_tracks(got, _reference(frames))
        assert [r.frame_index for r in results[key]] == \
            list(range(len(frames)))
        n_tracks += sum(map(len, got))
    assert n_tracks > 0


def test_slot_leasing_and_release(svc):
    a = svc.open_stream()
    b = svc.open_stream()
    with pytest.raises(RuntimeError, match="leased"):
        svc.open_stream()
    # closing with no queued frames frees the slot immediately
    svc.close_stream(b)
    with pytest.raises(RuntimeError, match="not open"):
        svc.submit(b, _frames(1)[0])
    c = svc.open_stream()
    assert c == b  # re-leased
    # fresh lease: per-stream frame counter restarts at 0
    res = svc.submit(c, _frames(1)[0]).result(timeout=300)
    assert res.frame_index == 0 and res.stream_id == c
    svc.close_stream(a)
    svc.close_stream(c)
    svc.wait_idle(timeout=60)


def test_released_slot_restarts_ids_at_1(svc):
    """A slot's tracks end with its lease: the next tenant's first track is
    id 1 again, and its tuples equal a fresh single-stream pipeline's."""
    frames = _scene(6)
    for _ in range(2):
        sid = svc.open_stream()
        got = [f.result(timeout=300).tracks
               for f in [svc.submit(sid, fr) for fr in frames]]
        svc.close_stream(sid)
        svc.wait_idle(timeout=60)
        _assert_same_tracks(got, _reference(frames))
        assert min(t[4] for tr in got for t in tr) == 1


def test_submit_validates_shape_and_state(svc):
    sid = svc.open_stream()
    with pytest.raises(ValueError, match="frame shape"):
        svc.submit(sid, np.zeros((10, 10, 3), np.uint8))
    svc.close_stream(sid)
    with pytest.raises(RuntimeError, match="not open"):
        svc.submit(sid, _frames(1)[0])


def test_close_drains_queued_frames(svc):
    sid = svc.open_stream()
    futs = [svc.submit(sid, f) for f in _frames(3, seed=4)]
    svc.close_stream(sid)  # queued frames must still resolve
    for i, f in enumerate(futs):
        assert f.result(timeout=300).frame_index == i
    # slot frees after the drain; eventually re-leasable
    deadline = time.time() + 60
    while time.time() < deadline:
        try:
            again = svc.open_stream()
            break
        except RuntimeError:
            time.sleep(0.05)
    else:
        pytest.fail("slot never freed after drain")
    svc.close_stream(again)


def test_shutdown_drains_and_rejects():
    service = MultiTenantTrackingService(
        n_streams=2, frame_hw=FRAME_HW, chunk_size=2, max_latency_ms=10.0,
        **PIPE_KW)
    sid = service.open_stream()
    futs = [service.submit(sid, f) for f in _frames(3, seed=5)]
    service.shutdown()
    for f in futs:
        f.exception(timeout=300)  # resolved (result or exception), not hung
    assert all(f.done() for f in futs)
    with pytest.raises(RuntimeError, match="shut down"):
        service.open_stream()
    service.shutdown()  # idempotent


def test_eager_dispatch_under_headroom(svc):
    """A lone frame on an idle service must not burn its SLA window
    waiting for batch-mates that the arrival rate says will never come:
    the eager trigger dispatches it at once."""
    sid = svc.open_stream(max_latency_ms=8000.0)
    svc.submit(sid, _frames(1, seed=98)[0]).result(timeout=300)
    t0 = time.perf_counter()
    svc.submit(sid, _frames(1, seed=96)[0]).result(timeout=300)
    warm_step = time.perf_counter() - t0
    eager_before = svc.stats["eager_fires"]
    t0 = time.perf_counter()
    res = svc.submit(sid, _frames(1, seed=11)[0]).result(timeout=300)
    wall = time.perf_counter() - t0
    svc.close_stream(sid)
    assert svc.stats["eager_fires"] > eager_before or \
        svc.stats["deadline_fires"] > 0
    # a few warm steps, not the 8 s SLA window
    assert wall < max(4.0, 4 * warm_step), (
        f"lone frame took {wall:.2f}s against an 8s SLA "
        f"(warm step {warm_step:.2f}s)")
    assert 0 < res.arrival_ts <= res.dispatch_ts <= res.resolve_ts
    assert res.dispatch_ts - res.arrival_ts < max(2.5, 3 * warm_step)


def test_deadline_aware_dispatch_meets_sla(svc):
    """Every request is dispatched before its deadline and, on this warm
    CPU service, resolves within its SLA end to end."""
    sla_ms = 10000.0
    sid = svc.open_stream(max_latency_ms=sla_ms)
    svc.submit(sid, _frames(1, seed=99)[0]).result(timeout=300)
    futs = [svc.submit(sid, f) for f in _frames(5, seed=12)]
    results = [f.result(timeout=300) for f in futs]
    svc.close_stream(sid)
    for r in results:
        deadline = r.arrival_ts + sla_ms / 1e3
        assert r.dispatch_ts < deadline
        assert r.resolve_ts <= deadline + 0.05
        assert r.dispatch_ts - r.arrival_ts < 0.5 * sla_ms / 1e3
    s = svc.stats
    assert s["dispatches"] >= 1 and s["frames"] >= 5
    assert (s["full_fires"] + s["deadline_fires"] + s["eager_fires"]) >= 1


def test_burst_coalesces_into_batched_dispatches(svc):
    """A burst larger than one chunk rides fewer dispatches than frames."""
    before = svc.stats["dispatches"]
    sid = svc.open_stream(max_latency_ms=5000.0)
    futs = [svc.submit(sid, f) for f in _frames(6, seed=13)]
    for f in futs:
        f.result(timeout=300)
    svc.close_stream(sid)
    svc.wait_idle(timeout=60)
    n_dispatches = svc.stats["dispatches"] - before
    assert n_dispatches < 6, (
        f"6-frame burst used {n_dispatches} dispatches (no coalescing)")


def test_per_request_deadline_override(svc):
    """submit(deadline_ms=...) overrides the stream SLA for that request."""
    sid = svc.open_stream(max_latency_ms=60000.0)  # huge stream SLA
    svc.submit(sid, _frames(1, seed=97)[0],
               deadline_ms=400.0).result(timeout=300)
    t0 = time.perf_counter()
    svc.submit(sid, _frames(1, seed=95)[0],
               deadline_ms=400.0).result(timeout=300)
    warm_step = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = svc.submit(sid, _frames(1, seed=14)[0],
                     deadline_ms=400.0).result(timeout=300)
    wall = time.perf_counter() - t0
    svc.close_stream(sid)
    assert wall < max(5.0, 4 * warm_step)
    assert res.dispatch_ts - res.arrival_ts < max(0.5, 2 * warm_step)


def test_wait_idle_blocks_until_drained(svc):
    """wait_idle returns only after every submitted frame resolved and
    every slot is FREE."""
    sid = svc.open_stream()
    futs = [svc.submit(sid, f) for f in _frames(5, seed=9)]
    svc.close_stream(sid)
    svc.wait_idle(timeout=300)
    assert all(f.done() for f in futs)
    a = svc.open_stream()
    b = svc.open_stream()
    svc.close_stream(a)
    svc.close_stream(b)
    svc.wait_idle(timeout=60)


def test_concurrent_submitters_lose_no_frame():
    """Twelve threads (three per stream slot) submit at once with a short
    switch interval: every future resolves, each stream's frame indices
    are 0..n-1 exactly once, and the counters balance."""
    import sys
    service = MultiTenantTrackingService(
        n_streams=4, frame_hw=FRAME_HW, chunk_size=2, max_latency_ms=5.0,
        **PIPE_KW)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        sids = [service.open_stream() for _ in range(4)]
        frame = _frames(1)[0]
        futs = {sid: [] for sid in sids}
        lock = threading.Lock()

        def submitter(sid):
            for _ in range(4):
                fut = service.submit(sid, frame)
                with lock:
                    futs[sid].append(fut)

        threads = [threading.Thread(target=submitter, args=(sid,))
                   for sid in sids for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for sid in sids:
            got = sorted(f.result(timeout=300).frame_index
                         for f in futs[sid])
            assert got == list(range(12)), (sid, got)
            service.close_stream(sid)
        service.wait_idle(timeout=120)
        assert service.stats["frames"] == 48
        assert service._outstanding == 0 and service._inflight == 0
    finally:
        sys.setswitchinterval(interval)
        service.shutdown()


# --- TrackingService ---------------------------------------------------------


def test_tracking_service_equals_process_frames():
    """Frames submitted one by one (batched by the worker into chunks of
    up to 2, some partial) give the track tuples, detections and frame
    indices of ``process_frames`` over the same frames."""
    frames = _scene(9)
    svc = TrackingService(chunk_size=2, max_latency_ms=5.0, **PIPE_KW)
    try:
        futs = []
        for i, f in enumerate(frames):
            futs.append(svc.submit(f))
            if i % 3 == 2:
                futs[-1].result(timeout=300)  # leaves a partial chunk
        got = [f.result(timeout=300) for f in futs]
    finally:
        svc.shutdown()
    ref = list(TrackingPipeline(chunk_size=2, **PIPE_KW).process_frames(
        iter(frames)))
    assert [r.frame_index for r in got] == list(range(len(frames)))
    _assert_same_tracks([r.tracks for r in got], [r.tracks for r in ref])
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.det_boxes, b.det_boxes, atol=1e-3)
    assert sum(len(r.tracks) for r in got) > 0


def test_tracking_service_reset_runs_between_dispatches():
    """``reset()`` resolves after the frames submitted before it; the
    frames after it start fresh ids, exactly as a fresh pipeline."""
    frames = _scene(6)
    svc = TrackingService(chunk_size=2, max_latency_ms=5.0, **PIPE_KW)
    try:
        first = [svc.submit(f) for f in frames]
        done = svc.reset()
        second = [svc.submit(f) for f in frames]
        done.result(timeout=300)
        assert all(f.done() for f in first)
        got = [f.result(timeout=300).tracks for f in second]
    finally:
        svc.shutdown()
    _assert_same_tracks(got, _reference(frames))
    with pytest.raises(RuntimeError, match="shut down"):
        svc.reset()


def test_tracking_service_shutdown_drains_and_rejects():
    svc = TrackingService(chunk_size=2, max_latency_ms=5.0, **PIPE_KW)
    futs = [svc.submit(f) for f in _frames(3, seed=5)]
    svc.shutdown()
    for f in futs:
        f.exception(timeout=300)
    assert all(f.done() for f in futs)
    with pytest.raises(RuntimeError, match="shut down"):
        svc.submit(_frames(1)[0])
    svc.shutdown()  # idempotent


class _Failing:
    """A pipeline whose dispatch raises, as a device error would."""

    def __init__(self, n_streams=1):
        self.n_streams = n_streams
        self.frame_hw = FRAME_HW

    def _dispatch_chunk(self, frames, n_valid=None):
        raise RuntimeError("CUDA error: an illegal memory access")

    def step_chunk(self, frames, frame_valid=None):
        raise RuntimeError("CUDA error: an illegal memory access")

    def reset_stream(self, i):
        pass


def test_a_failing_dispatch_reaches_its_futures():
    """Both services hand a dispatch's error to the futures of its frames
    (``set_exception``) and keep serving."""
    single = TrackingService(pipeline=_Failing(), chunk_size=2,
                             max_latency_ms=5.0)
    multi = MultiTenantTrackingService(pipeline=_Failing(2), chunk_size=2,
                                       max_latency_ms=5.0)
    try:
        fut = single.submit(_frames(1)[0])
        with pytest.raises(RuntimeError, match="illegal memory"):
            fut.result(timeout=60)
        sid = multi.open_stream()
        futs = [multi.submit(sid, f) for f in _frames(3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="illegal memory"):
                f.result(timeout=60)
        multi.close_stream(sid)
        multi.wait_idle(timeout=60)
    finally:
        single.shutdown()
        multi.shutdown()


@pytest.mark.parametrize("service", [TrackingService,
                                     MultiTenantTrackingService])
def test_services_default_to_the_gpu(service):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU error cannot be shown")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        service(input_shape=(128, 128))


def test_masked_lane_is_a_black_frame_to_gmc_as_in_jax():
    """The multi-tenant gather fills a masked lane with zeros
    (``MultiTenantTrackingService._gather``, as JAX's), and the camera-motion
    estimate pairs consecutive lanes, so a valid lane after a masked one
    takes its warp from a black frame. The StrongSORT preset (affine GMC)
    over such a dispatch, port against JAX's ``MultiStreamPipeline``:
    identical outputs and states (ids, classes, rounded boxes exact; boxes
    within 1e-3 px, conf within 1e-5, state floats within 1e-3). Parity
    keeps the behaviour (``ROADMAP.md`` Queue C)."""
    from aicamera_tpu.core.state import TrackerParams as JaxParams
    from aicamera_tpu.parallel import MultiStreamPipeline as JaxMulti
    from aicamera_tpu_torch.scenes import panning_rectangles
    small = dict(max_tracks=16, max_detections=8, nn_budget=1, max_age=10,
                 feature_dim=config.REID_FEATURE_DIM, ema_alpha=0.9,
                 nsa=True)
    kw = dict(n_streams=2, frame_hw=FRAME_HW, input_shape=(128, 128),
              max_reid_crops=4, tracker="strongsort",
              yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
              reid_weights=str(config.REID_SYNTHETIC_PATH))
    scenes = np.stack([panning_rectangles(4, FRAME_HW, n_objects=3, seed=s,
                                          pan=8)[0] for s in (3, 5)])
    second = scenes[:, 2:4].copy()
    second[1, 0] = 0                  # stream 1's lane 0: masked, zeros
    mask = np.array([[True, True], [False, True]])
    every = np.ones((2, 2), bool)
    runs = []
    for pipe in (MultiStreamPipeline(
            device="cpu", tracker_params=TrackerParams(**small), **kw),
            JaxMulti(tracker_params=JaxParams(**small), **kw)):
        pipe.step_chunk(scenes[:, :2], frame_valid=every)
        outs = pipe.step_chunk(second, frame_valid=mask)
        st = pipe.states
        runs.append(([np.asarray(o) for o in outs],
                     {f: np.asarray(getattr(st, f)) for f in
                      ("mean", "cov", "track_id", "active", "next_id")}))
    (o_out, o_st), (r_out, r_st) = runs
    tlbr, ids, cls, conf, live = o_out
    np.testing.assert_array_equal(live, r_out[4])
    np.testing.assert_array_equal(ids, r_out[1])
    np.testing.assert_array_equal(cls, r_out[2])
    np.testing.assert_array_equal(np.round(tlbr[live]),
                                  np.round(r_out[0][live]))
    np.testing.assert_allclose(tlbr, r_out[0], atol=1e-3)
    np.testing.assert_allclose(conf, r_out[3], atol=1e-5)
    for f, a in o_st.items():
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, r_st[f], rtol=1e-4, atol=1e-3,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(a, r_st[f], err_msg=f)
    assert live[1].any()   # stream 1 has tracks the black-frame warp moved
