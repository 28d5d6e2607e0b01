"""Port: the whole slice (letterbox -> YOLOv8 -> NMS -> crops -> ReID ->
tracker) on the CPU against the JAX ``TrackingPipeline``, for every tracker
core."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aicamera_tpu import config as jconfig  # noqa: E402
from aicamera_tpu.core import bytetrack as jbt  # noqa: E402
from aicamera_tpu.core import ocsort as joc  # noqa: E402
from aicamera_tpu.core import state as jstate  # noqa: E402
from aicamera_tpu_torch import config  # noqa: E402
from aicamera_tpu_torch.core import bytetrack as tbt  # noqa: E402
from aicamera_tpu_torch.core import ocsort as toc  # noqa: E402
from aicamera_tpu_torch.core import state as tstate  # noqa: E402
from aicamera_tpu_torch.core.state import TrackerParams  # noqa: E402
from aicamera_tpu_torch.runtime.pipeline import TrackingPipeline  # noqa: E402
from aicamera_tpu_torch.scenes import moving_rectangles  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    PyTorch's thread pool oversubscribes the cores (small convolutions then
    run ~100x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_pipeline.py's sizes (shared JAX compile cache)
SMALL = dict(max_tracks=16, max_detections=8, nn_budget=4, max_age=10,
             feature_dim=jconfig.REID_FEATURE_DIM)
FRAME_HW = (96, 128)
INPUT_HW = (128, 128)
KW = dict(input_shape=INPUT_HW, max_reid_crops=4, chunk_size=2,
          synthetic_load=8, yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
          reid_weights=str(config.REID_SYNTHETIC_PATH))


def _frames(n=6, seed=3):
    # seed 3: three rectangles the committed detector finds at this size
    return list(moving_rectangles(n, FRAME_HW, n_objects=3, seed=seed))


@pytest.fixture(scope="module")
def port():
    return TrackingPipeline(tracker_params=TrackerParams(**SMALL),
                            device="cpu", **KW)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX pipeline's results on the six test frames (its chunk 2; its
    f32 output does not depend on the chunk size)."""
    from aicamera_tpu.runtime.pipeline import TrackingPipeline as JaxPipeline
    jax_pipe = JaxPipeline(tracker_params=jstate.TrackerParams(**SMALL), **KW)
    return list(jax_pipe.process_frames(iter(_frames())))


def _assert_matches_jax(ours, ref):
    """Detections: counts and labels identical, boxes within 1e-3 px and
    scores within 1e-5 (two f32 convolution stacks round differently).
    Track tuples identical, conf within 1e-5 for the same reason."""
    assert [r.frame_index for r in ours] == list(range(len(ref)))
    n_tracks = n_dets = 0
    for a, b in zip(ours, ref, strict=True):
        assert len(a.det_boxes) == len(b.det_boxes), a.frame_index
        np.testing.assert_array_equal(a.det_labels, b.det_labels)
        np.testing.assert_allclose(a.det_boxes, b.det_boxes, atol=1e-3)
        np.testing.assert_allclose(a.det_scores, b.det_scores, atol=1e-5)
        assert len(a.tracks) == len(b.tracks), a.frame_index
        for ta, tb in zip(a.tracks, b.tracks):
            assert ta[:6] == tb[:6]
            assert ta[6] == pytest.approx(tb[6], abs=1e-5)
        n_tracks += len(a.tracks)
        n_dets += len(a.det_boxes)
    assert n_dets > 0 and n_tracks > 0
    # the synthetic grid (exact inputs) gives bitwise-identical tuples
    assert ours[-1].tracks[-1] == ref[-1].tracks[-1]


def test_pipeline_matches_jax(port, jax_ref):
    """Detections: counts and labels identical, boxes within 1e-3 px and
    scores within 1e-5 (two f32 convolution stacks round differently).
    Track tuples identical, conf within 1e-5 for the same reason."""
    port.reset()
    _assert_matches_jax(list(port.process_frames(iter(_frames()))), jax_ref)


# The synthetic grid's boxes carry conf 0.5: in neither of ByteTrack's score
# splits at its default threshold and below OC-SORT's det_thresh, so both
# sides get thresholds of 0.4 and the grid starts tracks.
CAP = dict(max_tracks=16, max_detections=8)
BT = dict(CAP, track_thresh=0.4)
OC = dict(CAP, det_thresh=0.4)
APP = dict(with_appearance=True, feature_dim=jconfig.REID_FEATURE_DIM)
# tracker: (port keywords, JAX keywords)
TRACKERS = {
    "bytetrack": (dict(bytetrack_params=tbt.ByteTrackParams(**BT)),
                  dict(bytetrack_params=jbt.ByteTrackParams(**BT))),
    "botsort": (dict(bytetrack_params=tbt.ByteTrackParams(**BT, **APP)),
                dict(bytetrack_params=jbt.ByteTrackParams(**BT, **APP))),
    "ocsort": (dict(ocsort_params=toc.OCSortParams(**OC)),
               dict(ocsort_params=joc.OCSortParams(**OC))),
    "deepocsort": (dict(ocsort_params=toc.OCSortParams(**OC, **APP)),
                   dict(ocsort_params=joc.OCSortParams(**OC, **APP))),
    # the preset's own TrackerParams (EMA bank, NSA) at full capacity
    "strongsort": (dict(gmc="off"), dict(gmc="off")),
}


@pytest.mark.parametrize("tracker", sorted(TRACKERS))
def test_tracker_pipeline_matches_jax(tracker):
    """Each tracker core through the whole slice, with the tolerances of
    :func:`_assert_matches_jax`; tracks must be emitted."""
    from aicamera_tpu.runtime.pipeline import TrackingPipeline as JaxPipeline
    ours_kw, jax_kw = TRACKERS[tracker]
    ours = TrackingPipeline(tracker=tracker, device="cpu", **ours_kw, **KW)
    ref = JaxPipeline(tracker=tracker, **jax_kw, **KW)
    _assert_matches_jax(list(ours.process_frames(iter(_frames()))),
                        list(ref.process_frames(iter(_frames()))))
    assert ours.with_reid == ref.with_reid
    assert ours._nms_score_floor == pytest.approx(ref._nms_score_floor)
    assert ours.max_reid_crops == ref.max_reid_crops


def test_pipeline_chunk_3_matches_jax(port, jax_ref):
    """The same frames in chunks of 3 against the same JAX results, with the
    tolerances of the chunk-2 comparison."""
    port.reset()
    _assert_matches_jax(list(port.process_frames(iter(_frames()),
                                                 chunk_size=3)), jax_ref)


def test_f32_output_is_chunk_size_stable(port):
    """The same 6 frames at chunk 1, 2 and 3 on the CPU in f32: detection
    counts and labels identical; track tuples identical in id, class and
    box; detection boxes within 1e-3 px, scores and track conf within 1e-5
    (the convolution library may pick another f32 summation order for
    another batch size)."""
    frames = _frames()
    runs = {}
    for k in (1, 2, 3):
        port.reset()
        runs[k] = list(port.process_frames(iter(frames), chunk_size=k))
        assert len(runs[k]) == len(frames)
    worst = dict(box=0.0, score=0.0, conf=0.0)
    for k in (1, 3):
        for a, b in zip(runs[k], runs[2], strict=True):
            assert len(a.det_boxes) == len(b.det_boxes), (k, a.frame_index)
            np.testing.assert_array_equal(a.det_labels, b.det_labels)
            np.testing.assert_allclose(a.det_boxes, b.det_boxes, atol=1e-3)
            np.testing.assert_allclose(a.det_scores, b.det_scores, atol=1e-5)
            assert [t[:6] for t in a.tracks] == [t[:6] for t in b.tracks], \
                (k, a.frame_index)
            for ta, tb in zip(a.tracks, b.tracks):
                assert ta[6] == pytest.approx(tb[6], abs=1e-5)
                worst["conf"] = max(worst["conf"], abs(ta[6] - tb[6]))
            if len(a.det_boxes):
                worst["box"] = max(worst["box"], float(np.abs(
                    a.det_boxes - b.det_boxes).max()))
                worst["score"] = max(worst["score"], float(np.abs(
                    a.det_scores - b.det_scores).max()))
    assert sum(len(r.tracks) for r in runs[2]) > 0
    print(f"chunk 1 and 3 against chunk 2, worst |diff|: {worst}")


def test_padding_and_chunk_api(port):
    """A padded last chunk leaves no trace; process_chunks and process_frame
    agree with process_frames (same chunk size)."""
    frames = _frames(5, seed=2)
    port.reset()
    a = list(port.process_frames(iter(frames)))
    state_a = {k: v.clone() for k, v in vars(port.state).items()}
    port.reset()
    b = list(port.process_chunks(iter([np.stack(frames[:2]),
                                       np.stack(frames[2:4]),
                                       np.stack(frames[4:])])))
    assert [r.tracks for r in a] == [r.tracks for r in b]
    for k, v in vars(port.state).items():
        assert torch.equal(v, state_a[k]), k
    with pytest.raises(ValueError):
        list(port.process_chunks(iter([np.stack(frames[:3])])))
    port.reset()
    single = port.process_frame(frames[0])
    assert single.frame_index == 0 and single.det_boxes.shape[1] == 4


def test_warm_up_resets_state(port):
    port.warm_up(FRAME_HW)
    assert not port.state.active.any() and int(port.state.next_id) == 1


def test_entry_point_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU error cannot be shown")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrackingPipeline(input_shape=INPUT_HW)


CORES = {"deepsort": (tstate, TrackerParams(max_tracks=4, max_detections=4,
                                            feature_dim=8)),
         "bytetrack": (tbt, tbt.ByteTrackParams(max_tracks=4,
                                                max_detections=4)),
         "ocsort": (toc, toc.OCSortParams(max_tracks=4, max_detections=4))}


@pytest.mark.parametrize("fn", ["init_state", "make_detections"])
@pytest.mark.parametrize("core", sorted(CORES))
def test_core_state_defaults_to_the_gpu(core, fn):
    """The cores' public constructors take the device rule of every entry
    point (``device.resolve_device``): left out, the GPU, which raises
    where there is none; ``device="cpu"`` places every tensor on the
    CPU."""
    mod, params = CORES[core]
    box = np.array([[10.0, 20.0, 30.0, 60.0]], np.float32)

    def make(**kw):
        if fn == "init_state":
            return mod.init_state(params, **kw)
        return mod.make_detections(box, np.array([0.9], np.float32),
                                   np.array([0], np.int32), params=params,
                                   **kw)

    def devices(obj):
        return {getattr(obj, f.name).device.type
                for f in dataclasses.fields(obj)
                if getattr(obj, f.name) is not None}

    assert devices(make(device="cpu")) == {"cpu"}
    if torch.cuda.is_available():
        assert devices(make()) == {"cuda"}
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# (strongsort's default gmc="affine" and gmc= itself run now:
# tests/test_torch_gmc_tracking.py)
# (reid_quant and yolo_quant "int8" run now: tests/test_torch_quant.py)
@pytest.mark.parametrize("kw", [dict(yolo_weights="m.onnx"),
                                dict(reid_weights="m.onnx")])
def test_unported_options_raise(kw, tmp_path):
    """``.onnx`` weights load now (they raised before ONNX import was
    ported): a file written from the committed checkpoint gives the
    checkpoint's weights, bitwise."""
    from test_torch_onnx_import import checkpoint_onnx
    (arg, _), = kw.items()
    name = "yolo" if arg == "yolo_weights" else "reid"
    onnx = TrackingPipeline(device="cpu", **dict(
        KW, **{arg: str(checkpoint_onnx(name, tmp_path / "m.onnx"))}))
    ref = TrackingPipeline(device="cpu", **KW)
    for net in ("yolo", "reid"):
        ours, want = (getattr(p, net).state_dict() for p in (onnx, ref))
        assert all(torch.equal(ours[k], want[k]) for k in want)


def test_argument_checks():
    with pytest.raises(ValueError):
        TrackingPipeline(device="cpu", detect_dtype="f16")
    with pytest.raises(ValueError):
        TrackingPipeline(device="cpu", nsa=True,
                         tracker_params=TrackerParams(**SMALL))


@pytest.mark.parametrize("ours,theirs", [
    (dict(tracker="sort"), None),
    (dict(tracker="bytetrack", nsa=True), None),
    (dict(tracker="ocsort", bytetrack_params=tbt.ByteTrackParams()),
     dict(tracker="ocsort", bytetrack_params=jbt.ByteTrackParams())),
    (dict(ocsort_params=toc.OCSortParams()),
     dict(ocsort_params=joc.OCSortParams())),
    (dict(tracker="bytetrack",
          bytetrack_params=tbt.ByteTrackParams(with_appearance=True)),
     dict(tracker="bytetrack",
          bytetrack_params=jbt.ByteTrackParams(with_appearance=True))),
    (dict(tracker="botsort", bytetrack_params=tbt.ByteTrackParams()),
     dict(tracker="botsort", bytetrack_params=jbt.ByteTrackParams())),
    (dict(tracker="ocsort",
          ocsort_params=toc.OCSortParams(with_appearance=True)),
     dict(tracker="ocsort",
          ocsort_params=joc.OCSortParams(with_appearance=True))),
    (dict(tracker="deepocsort", ocsort_params=toc.OCSortParams()),
     dict(tracker="deepocsort", ocsort_params=joc.OCSortParams())),
    (dict(gmc="rotation"), None),
    (dict(reid_quant="int4"), None),
    (dict(scan_bucket=-1), None),
], ids=lambda kw: "-".join(kw) if kw else "same")
def test_argument_validation_raises_as_jax(ours, theirs):
    """The argument checks of the JAX constructor: the same exception type
    and the same message."""
    from aicamera_tpu.runtime.pipeline import TrackingPipeline as JaxPipeline
    with pytest.raises(ValueError) as ref:
        JaxPipeline(**(ours if theirs is None else theirs))
    with pytest.raises(ValueError) as e:
        TrackingPipeline(device="cpu", **ours)
    assert str(e.value) == str(ref.value)
