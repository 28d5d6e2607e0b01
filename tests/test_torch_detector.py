"""Port: the reference-API ``YOLODetector`` (``detect``, ``detect_tiled``,
``warm_up``) and ``ReIDModel`` (its host resize and batched features) on the
CPU against the JAX facades."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aicamera_tpu import detector as jdet  # noqa: E402
from aicamera_tpu import tracker_api as japi  # noqa: E402
from aicamera_tpu_torch import config  # noqa: E402
from aicamera_tpu_torch import detector as tdet  # noqa: E402
from aicamera_tpu_torch import tracker_api as tapi  # noqa: E402
from aicamera_tpu_torch.scenes import moving_rectangles  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    PyTorch's thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


YOLO = str(config.YOLO_SYNTHETIC_PATH)
REID = str(config.REID_SYNTHETIC_PATH)
KW = dict(input_shape=(128, 128), detect_dtype="f32")
# seed 3: three rectangles the committed detector finds at this size
FRAMES = moving_rectangles(4, (96, 128), n_objects=3, seed=3)


@pytest.fixture(scope="module")
def detectors():
    return (tdet.YOLODetector(YOLO, device="cpu", **KW),
            jdet.YOLODetector(YOLO, **KW))


def _assert_same(ours, ref):
    """Counts, labels and kept indices identical, boxes within 1e-2 px,
    scores within 1e-4 (two f32 convolution stacks round differently)."""
    boxes, scores, labels, idx = ours
    assert len(boxes) == len(ref[0]) and boxes.shape[1:] == (4,)
    assert labels.dtype == np.int32
    np.testing.assert_array_equal(labels, ref[2])
    np.testing.assert_array_equal(idx, ref[3])
    np.testing.assert_allclose(boxes, ref[0], atol=1e-2)
    np.testing.assert_allclose(scores, ref[1], atol=1e-4)
    return len(boxes)


def test_detect_matches_jax(detectors):
    ours, ref = detectors
    n = sum(_assert_same(ours.detect(f), ref.detect(f)) for f in FRAMES)
    assert n > 0


@pytest.mark.parametrize("kw", [
    dict(), dict(merge_criterion="ios", overlap=0.0),
    dict(grid=(1, 3), include_full_frame=False)],
    ids=["iou", "ios-no-overlap", "1x3-tiles-only"])
def test_detect_tiled_matches_jax(detectors, kw):
    ours, ref = detectors
    n = sum(_assert_same(ours.detect_tiled(f, **kw), ref.detect_tiled(f, **kw))
            for f in FRAMES[:2])
    assert n > 0


def test_low_conf_threshold_lowers_the_nms_floor():
    """``min(0.25, conf_threshold)``: a detector at 0.1 keeps boxes the
    default floor drops, as the JAX facade does."""
    ours = tdet.YOLODetector(YOLO, device="cpu", conf_threshold=0.1, **KW)
    ref = jdet.YOLODetector(YOLO, conf_threshold=0.1, **KW)
    assert ours._nms_floor == pytest.approx(0.1)
    _assert_same(ours.detect(FRAMES[0]), ref.detect(FRAMES[0]))


def test_warm_up_and_empty_frame(detectors):
    ours, _ = detectors
    ours.warm_up((96, 128), iters=1)
    boxes, scores, labels, idx = ours.detect(np.zeros((96, 128, 3),
                                                      np.uint8))
    assert boxes.shape == (len(idx), 4) and len(scores) == len(labels)


@pytest.mark.parametrize("kw", [dict(engine_path="det.onnx"),
                                dict(engine_path="det.xlae")])
def test_detector_not_ported_raises(kw, detectors, tmp_path):
    """A JAX ``.xlae`` engine cannot be ported (an XLA executable): a
    ValueError naming the format. ONNX weights load now (they raised before
    ONNX import was ported): the committed checkpoint written as ONNX
    detects bitwise what the checkpoint does. (``quant="int8"`` runs now:
    tests/test_torch_quant.py.)"""
    if kw["engine_path"].endswith(".xlae"):
        with pytest.raises(ValueError, match=r"\.xlae.*XLA executable"):
            tdet.YOLODetector(device="cpu", **kw)
    else:
        from test_torch_onnx_import import checkpoint_onnx
        onnx = tdet.YOLODetector(
            str(checkpoint_onnx("yolo", tmp_path / kw["engine_path"])),
            device="cpu", **KW)
        for f in FRAMES:
            for a, b in zip(onnx.detect(f), detectors[0].detect(f)):
                np.testing.assert_array_equal(a, b)


def test_detector_engine_methods_not_ported(detectors):
    """``get_engine`` and ``export_engine`` run now (tests/test_torch_
    engine.py); the port writes ``.cudae`` files, never a ``.xlae``."""
    ours, _ = detectors
    eng = ours.get_engine((96, 128))
    assert eng.get_input_details()[0].shape == (96, 128, 3)
    with pytest.raises(ValueError, match=r"\.xlae"):
        ours.export_engine((96, 128), "x.xlae")


def test_detector_argument_checks():
    for kw in (dict(quant="int4"), dict(detect_dtype="f16"),
               dict(detect_dtype="f32", quant="int8")):
        with pytest.raises(ValueError):
            tdet.YOLODetector(device="cpu", **kw)


def test_detector_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU error cannot be shown")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdet.YOLODetector(YOLO)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reid_host_resize_equals_cv2(seed):
    """OpenCV's ``INTER_LINEAR`` for uint8 crops, copied: held to at most one
    level, and the share of pixels equal to ``cv2.resize`` printed (every
    pixel of these 200 seeded crops, sizes 1 to 400, equals it)."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(seed)
    exact = total = 0
    for _ in range(200):
        h, w = rng.randint(1, 400), rng.randint(1, 250)
        crop = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        ref = cv2.resize(crop, (64, 128), interpolation=cv2.INTER_LINEAR)
        ours = tapi.resize_linear_u8(crop, (128, 64))
        d = np.abs(ours.astype(int) - ref.astype(int))
        assert d.max() <= 1, (h, w)
        exact += int((d == 0).sum())
        total += d.size
    print(f"resize_linear_u8 equals cv2.resize on {exact / total:.6f} of "
          f"{total} values")
    assert exact == total


@pytest.fixture(scope="module")
def reid_models():
    return (tapi.ReIDModel(REID, device="cpu", reid_dtype="f32"),
            japi.ReIDModel(REID, reid_dtype="f32"))


@pytest.mark.parametrize("n", [0, 1, 3, 5])
def test_reid_features_match_jax(reid_models, n):
    """Features within 1e-4 (f32 convolution stacks), empty crops give
    zero rows, the batch pads to a power-of-two bucket."""
    ours, ref = reid_models
    rng = np.random.RandomState(n)
    crops = [rng.randint(0, 256, (rng.randint(20, 200), rng.randint(10, 90),
                                  3)).astype(np.uint8) for _ in range(n)]
    if n >= 3:
        crops[1] = np.zeros((0, 5, 3), np.uint8)   # empty: a zero row
    f_ours = ours.extract_features_batched(crops)
    f_ref = ref.extract_features_batched(crops)
    assert f_ours.shape == (n, config.REID_FEATURE_DIM)
    assert f_ours.dtype == np.float32
    np.testing.assert_allclose(f_ours, f_ref, atol=1e-4)
    if n >= 3:
        assert not f_ours[1].any()
        np.testing.assert_allclose(np.linalg.norm(f_ours[0]), 1.0,
                                   atol=1e-5)


def test_reid_device_apply_and_not_ported(reid_models):
    """``device_apply``; a JAX ``.xlae`` is refused on export and load
    (``export_engine`` to ``.cudae`` and ``quant="int8"`` run now:
    tests/test_torch_engine.py, tests/test_torch_quant.py)."""
    ours, _ = reid_models
    x = torch.zeros((2, 128, 64, 3))
    assert ours.device_apply(x).shape == (2, config.REID_FEATURE_DIM)
    with pytest.raises(ValueError, match=r"\.xlae"):
        ours.export_engine("reid.xlae")
    with pytest.raises(ValueError, match=r"\.xlae.*XLA executable"):
        tapi.ReIDModel(device="cpu", engine_path="reid.xlae")
