"""Port: the six reference-API tracker facades (DeepSORT, StrongSORT,
ByteTrack, BoT-SORT, OC-SORT, Deep OC-SORT) on the CPU against the JAX
facades, with and without camera-motion compensation, plus their host-side
contract: feature capture, the capacity counter and warning, the live-track
list and the errors."""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import aicamera_tpu as J  # noqa: E402
import aicamera_tpu_torch as T  # noqa: E402
from aicamera_tpu_torch import config  # noqa: E402
from aicamera_tpu_torch.scenes import panning_rectangles  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    PyTorch's thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REID = str(config.REID_SYNTHETIC_PATH)
CAP = dict(max_tracks=16, max_detections=8)
APP = dict(reid_model_path=REID, max_reid_crops=4)
# facade: its keywords (small capacities; thresholds 0.4 so that every
# detection of the scene starts tracks; n_init / min_hits 2)
FACADES = {
    "DeepSORT": dict(APP, nn_budget=4, max_age=10, n_init=2, **CAP),
    "StrongSORT": dict(APP, max_age=10, n_init=2, **CAP),
    "ByteTrack": dict(track_thresh=0.4, **CAP),
    "BoTSORT": dict(APP, track_thresh=0.4, **CAP),
    "OCSort": dict(det_thresh=0.4, min_hits=2, **CAP),
    "DeepOCSort": dict(APP, det_thresh=0.4, min_hits=2, **CAP),
}


@pytest.fixture(scope="module")
def scene():
    """Ten panning frames and the detector's detections on them (the port's
    detector in f32; both facades get the same)."""
    frames, _ = panning_rectangles(10, (128, 192), n_objects=3, seed=3,
                                   pan=8)
    det = T.YOLODetector(str(config.YOLO_SYNTHETIC_PATH),
                         input_shape=(128, 128), detect_dtype="f32",
                         device="cpu")
    dets = [det.detect(f)[:3] for f in frames]
    assert sum(len(d[0]) for d in dets) > 10
    return frames, dets


def _run(tracker, frames, dets):
    return [tracker.update(*d, f) for f, d in zip(frames, dets)]


@pytest.mark.parametrize("gmc", [False, "affine"], ids=["off", "gmc"])
@pytest.mark.parametrize("name", sorted(FACADES))
def test_facade_matches_jax(scene, name, gmc):
    """The same frames and detections through both facades: identical
    ``(x1, y1, x2, y2, id, class_name, conf)`` tuples on every frame (conf
    is the detection's own score), and the same live tracks at the end."""
    frames, dets = scene
    ours = getattr(T, name)(gmc=gmc, device="cpu", **FACADES[name])
    ref = getattr(J, name)(gmc=gmc, **FACADES[name])
    assert (ours._gmc is None) == (ref._gmc is None)
    out_ours, out_ref = _run(ours, frames, dets), _run(ref, frames, dets)
    assert out_ours == out_ref
    assert sum(map(len, out_ours)) > 0
    live_ours, live_ref = ours.get_active_tracks(), ref.get_active_tracks()
    assert [t[:6] + t[7:] for t in live_ours] == \
        [t[:6] + t[7:] for t in live_ref]
    for a, b in zip(live_ours, live_ref):
        assert a[6] == pytest.approx(b[6], abs=1e-6)
    assert ours.dropped_detections == ref.dropped_detections == 0
    ours.reset()
    assert ours.frame_count == 0 and not ours.state.active.any()
    assert _run(ours, frames[:3], dets[:3]) == out_ref[:3]


def test_strongsort_preset():
    ours = T.StrongSORT(device="cpu", **FACADES["StrongSORT"])
    assert ours._gmc is not None and ours._gmc.method == "affine"
    assert ours.params.ema_alpha == 0.9 and ours.params.nsa
    assert ours.params.nn_budget == 1


def test_capture_features_matches_jax(scene):
    """``last_tlwh``, ``last_conf``, ``last_class_id`` and
    ``last_has_feature`` identical; ``last_features`` within 1e-4 (the two
    f32 ReID stacks round differently)."""
    frames, dets = scene
    kw = dict(FACADES["DeepSORT"], capture_features=True, reid_dtype="f32")
    ours = T.DeepSORT(device="cpu", **kw)
    ref = J.DeepSORT(**kw)
    for f, d in list(zip(frames, dets))[:3]:
        assert ours.update(*d, f) == ref.update(*d, f)
        for name in ("last_tlwh", "last_conf", "last_class_id",
                     "last_has_feature"):
            np.testing.assert_array_equal(getattr(ours, name),
                                          getattr(ref, name), err_msg=name)
        assert len(ours.last_features) == len(d[0])
        np.testing.assert_allclose(ours.last_features, ref.last_features,
                                   atol=1e-4)


@pytest.mark.parametrize("name", ["DeepSORT", "ByteTrack", "OCSort"])
def test_capacity_truncation_warns_once_and_counts(name):
    """More filtered detections than ``max_detections``: the extras are
    dropped and counted, the warning comes once, as in the JAX facade."""
    kw = dict(FACADES[name], max_detections=2)
    frame = np.full((96, 128, 3), 90, np.uint8)
    boxes = np.array([[5, 5, 30, 40], [40, 5, 70, 40], [80, 5, 110, 40],
                      [5, 50, 30, 90]], np.float32)
    confs, clss = np.full(4, 0.9, np.float32), np.zeros(4, np.int32)
    outs = []
    for tracker in (getattr(T, name)(device="cpu", **kw),
                    getattr(J, name)(**kw)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            outs.append([tracker.update(boxes, confs, clss, frame)
                         for _ in range(2)])
        assert len([w for w in caught if "exceed max_detections=2" in
                    str(w.message)]) == 1
        assert tracker.dropped_detections == 4
    assert outs[0] == outs[1]


def test_class_and_confidence_filter():
    """Untracked classes, out-of-range class ids and low scores never reach
    the tracker: the same tuples as the JAX facade."""
    frame = np.full((96, 128, 3), 90, np.uint8)
    boxes = np.array([[5, 5, 30, 40], [40, 5, 70, 40], [80, 5, 110, 40],
                      [5, 50, 30, 90]], np.float32)
    confs = np.array([0.9, 0.9, 0.2, 0.9], np.float32)
    clss = np.array([0, 16, 2, 99], np.int32)      # person, dog, car, ?
    kw = dict(FACADES["ByteTrack"])
    ours, ref = T.ByteTrack(device="cpu", **kw), J.ByteTrack(**kw)
    out = ours.update(boxes, confs, clss, frame)
    assert out == ref.update(boxes, confs, clss, frame)
    assert [t[5] for t in out] == ["person"]


def test_nn_budget_none_warns_and_rings_100():
    with pytest.warns(UserWarning, match="nn_budget=None"):
        ours = T.DeepSORT(device="cpu", reid_model_path=REID, nn_budget=None)
    assert ours.params.nn_budget == 100


@pytest.mark.parametrize("name", ["ByteTrack", "OCSort"])
def test_gmc_needs_the_frame(name):
    tr = getattr(T, name)(gmc=True, device="cpu")
    assert tr._gmc.method == "affine"
    with pytest.raises(ValueError, match="needs the frame"):
        tr.update(np.zeros((1, 4), np.float32), np.array([0.9]),
                  np.array([0]), None)
    plain = getattr(T, name)(device="cpu")   # no gmc: the frame is optional
    assert plain.update(np.zeros((0, 4)), np.zeros(0), np.zeros(0),
                        None) == []


@pytest.mark.parametrize("kw", [dict(gallery_strategy="lru"),
                                dict(gallery_strategy="ema", ema_alpha=1.0),
                                dict(gmc="homography")])
def test_deepsort_argument_checks(kw):
    with pytest.raises(ValueError):
        T.DeepSORT(device="cpu", reid_model_path=REID, **kw)


def test_deepsort_reid_quant_not_ported():
    """``reid_quant="int8"`` is ported now: the facade's ReID model is the
    W8A8 twin (held to JAX in tests/test_torch_quant.py); a bad value
    raises."""
    from aicamera_tpu_torch.models.quant import QuantReIDNet
    ds = T.DeepSORT(REID, device="cpu", reid_quant="int8")
    assert isinstance(ds.reid_model.model, QuantReIDNet)
    with pytest.raises(ValueError, match="quant"):
        T.DeepSORT(REID, device="cpu", reid_quant="int4")


def test_facades_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU error cannot be shown")
    for make in (T.ByteTrack, T.OCSort, lambda: T.DeepSORT(
            reid_model_path=REID), T.ReIDModel):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_lazy_exports():
    """The names of the JAX package's facades, pipelines and engines (its
    ``XLAEngine`` is the port's ``CUDAGraphEngine``)."""
    import aicamera_tpu_torch
    names = {"YOLODetector", "DeepSORT", "ReIDModel", "ByteTrack", "BoTSORT",
             "StrongSORT", "OCSort", "DeepOCSort", "TrackingPipeline",
             "MultiStreamPipeline", "CUDAGraphEngine", "SerializedEngine",
             "load_engine", "export_engine"}
    assert names <= set(aicamera_tpu_torch.__all__)
    assert names <= set(dir(aicamera_tpu_torch))
    for n in names:
        assert getattr(aicamera_tpu_torch, n).__name__ == n
    with pytest.raises(AttributeError):
        aicamera_tpu_torch.XLAEngine


def test_engine_exports_resolve():
    """``from aicamera_tpu_torch import ...`` gives ``runtime.engine``'s
    objects, as the JAX package's top level gives its engine's."""
    from aicamera_tpu_torch import (CUDAGraphEngine, SerializedEngine,
                                    export_engine, load_engine)
    from aicamera_tpu_torch.runtime import engine
    assert CUDAGraphEngine is engine.CUDAGraphEngine
    assert SerializedEngine is engine.SerializedEngine
    assert load_engine is engine.load_engine
    assert export_engine is engine.export_engine
