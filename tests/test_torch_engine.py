"""Port: ``runtime/engine.py`` (the engine on the CPU device, ``.cudae``
files, the refusal of JAX's ``.xlae``), the capture-safe NMS keep,
``runtime/profiler.py``'s ``device_cost`` and ``trace``, on the CPU against
the JAX package. Capture and replay on a GPU are in ``test_torch_cuda.py``.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from aicamera_tpu import detector as jdet  # noqa: E402
from aicamera_tpu.ops import nms as jnms  # noqa: E402
from aicamera_tpu.runtime import engine as jeng  # noqa: E402
from aicamera_tpu.runtime import params as jparams  # noqa: E402
from aicamera_tpu_torch import config  # noqa: E402
from aicamera_tpu_torch import detector as tdet  # noqa: E402
from aicamera_tpu_torch import tracker_api as tapi  # noqa: E402
from aicamera_tpu_torch.ops import cuda_build  # noqa: E402
from aicamera_tpu_torch.ops import letterbox as lb  # noqa: E402
from aicamera_tpu_torch.ops import nms as tnms  # noqa: E402
from aicamera_tpu_torch.ops.preprocess import letterbox_spec  # noqa: E402
from aicamera_tpu_torch.runtime import engine as teng  # noqa: E402
from aicamera_tpu_torch.runtime import params as tparams  # noqa: E402
from aicamera_tpu_torch.runtime import profiler  # noqa: E402
from aicamera_tpu_torch.scenes import moving_rectangles  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _dynamo_importable():
    """A ``TorchDispatchMode`` (``device_cost``) imports ``torch._dynamo``,
    which looks up the spec of any ``tensorrt`` module; collecting
    ``tests/test_facade_oracle.py`` leaves a stub without one in
    ``sys.modules``. Import dynamo once with the stub set aside."""
    stub = sys.modules.pop("tensorrt", None)
    try:
        import torch._dynamo  # noqa: F401
    finally:
        if stub is not None:
            sys.modules["tensorrt"] = stub
    yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


YOLO = str(config.YOLO_SYNTHETIC_PATH)
REID = str(config.REID_SYNTHETIC_PATH)
FRAME_HW = (96, 128)
INPUT_HW = (128, 128)
# seed 3: three rectangles the committed detector finds at this size
FRAMES = moving_rectangles(4, FRAME_HW, n_objects=3, seed=3)


# --- the engine on the CPU device ---------------------------------------------

def test_engine_calls_fn_bitwise_with_its_details():
    rng = np.random.RandomState(0)
    w = torch.from_numpy(rng.rand(8, 4).astype(np.float32))

    def fn(x):
        return torch.tanh(x @ w), torch.sum(x, dim=-1)

    x = torch.from_numpy(rng.rand(3, 8).astype(np.float32))
    eng = teng.CUDAGraphEngine(fn, [x], name="tiny", device="cpu")
    got, want = eng(x), fn(x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    ins, outs = eng.get_input_details(), eng.get_output_details()
    assert ins == [teng.TensorInfo("input_0", (3, 8), torch.float32)]
    assert outs == [teng.TensorInfo("output_0", (3, 4), torch.float32),
                    teng.TensorInfo("output_1", (3,), torch.float32)]
    # a new shape runs too; a wrong dtype or arity raises
    assert eng(x[:2])[0].shape == (2, 4)
    with pytest.raises(TypeError):
        eng(x.double())
    with pytest.raises(TypeError):
        eng(x, x)


def test_enable_persistent_cache_moves_the_build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    teng.enable_persistent_cache(str(tmp_path / "a"))
    assert cuda_build.BUILD_DIR == tmp_path / "a"
    monkeypatch.setenv("AICAMERA_COMPILE_CACHE", str(tmp_path / "b"))
    teng.enable_persistent_cache()
    assert cuda_build.BUILD_DIR == tmp_path / "b"


# --- .cudae files --------------------------------------------------------------

@pytest.fixture(scope="module")
def detector():
    return tdet.YOLODetector(YOLO, input_shape=INPUT_HW, device="cpu")


@pytest.fixture(scope="module")
def jax_xlae(tmp_path_factory):
    """A real ``.xlae`` from the JAX package's ``export_engine``, and its
    loaded engine."""
    path = tmp_path_factory.mktemp("xla") / "yolo.xlae"
    jdet.YOLODetector(YOLO, input_shape=INPUT_HW).export_engine(FRAME_HW,
                                                               path)
    return path, jeng.SerializedEngine.load(path)


def test_detector_engine_roundtrip_bitwise(tmp_path, detector):
    """Counterpart of ``test_engine_serialized.py``'s round trip: a detector
    loaded from its exported ``.cudae`` detects bitwise as the one built from
    weights, enforces its baked shape and cannot re-export."""
    path = tmp_path / "yolo.cudae"
    detector.export_engine(FRAME_HW, path)
    assert teng.is_engine_file(path)
    with pytest.warns(UserWarning, match="baked"):
        det2 = tdet.YOLODetector(str(path), input_shape=(64, 64),
                                 device="cpu")
    assert det2.input_shape == INPUT_HW   # baked metadata wins
    assert det2.conf_threshold == detector.conf_threshold
    n = 0
    for f in FRAMES:
        a, b = detector.detect(f), det2.detect(f)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        n += len(a[0])
    assert n > 0
    assert det2.get_engine(FRAME_HW).get_input_details()[0].shape == \
        (*FRAME_HW, 3)
    with pytest.raises(ValueError, match="frame shape"):
        det2.detect(np.zeros((64, 64, 3), np.uint8))
    with pytest.raises(ValueError, match="loaded from a serialized"):
        det2.export_engine(FRAME_HW, tmp_path / "again.cudae")
    with pytest.raises(ValueError, match="detect_tiled"):
        det2.detect_tiled(FRAMES[0])


def test_detector_details_equal_jax_serialized_engine(detector, jax_xlae):
    """The port's detect engine has the JAX artifact's inputs and outputs:
    names, shapes and dtypes."""
    _, ref = jax_xlae
    eng = detector.get_engine(FRAME_HW)

    def norm(infos):
        return [(t.name, tuple(t.shape),
                 str(t.dtype).replace("torch.", "")) for t in infos]

    def norm_jax(infos):
        return [(t.name, tuple(t.shape), np.dtype(t.dtype).name)
                for t in infos]

    assert norm(eng.get_input_details()) == norm_jax(ref.get_input_details())
    assert norm(eng.get_output_details()) == \
        norm_jax(ref.get_output_details())


def test_xlae_is_refused_by_every_loader(tmp_path, jax_xlae):
    path, _ = jax_xlae
    for load in (lambda p: tdet.YOLODetector(str(p), device="cpu"),
                 lambda p: tapi.ReIDModel(str(p), device="cpu"),
                 lambda p: teng.load_engine(p, device="cpu"),
                 lambda p: tparams.resolve_yolo_params(weights_path=str(p),
                                                       device="cpu")):
        with pytest.raises(ValueError, match=r"\.xlae.*XLA executable"):
            load(path)
    # the same bytes under the port's suffix: refused by their magic
    renamed = tmp_path / "renamed.cudae"
    renamed.write_bytes(path.read_bytes())
    with pytest.raises(ValueError, match="XLA executable"):
        teng.load_engine(renamed, device="cpu")
    # and the port does not write a .xlae
    with pytest.raises(ValueError, match=r"\.xlae"):
        teng.export_engine(tmp_path / "x.xlae", "reid_embed", {}, [], [])


def test_file_without_magic_raises_as_jax(tmp_path):
    bad = tmp_path / "bad.cudae"
    bad.write_bytes(b"definitely not an engine")
    with pytest.raises(ValueError) as ours:
        teng.SerializedEngine.load(bad, device="cpu")
    bad_x = tmp_path / "bad.xlae"
    bad_x.write_bytes(b"definitely not an engine")
    with pytest.raises(ValueError) as ref:
        jeng.SerializedEngine.load(bad_x)
    assert str(ours.value) == str(ref.value).replace(str(bad_x), str(bad))


def test_weights_path_refuses_an_engine_file_as_jax(tmp_path):
    """An engine file where weights are needed raises JAX's error (with
    the port's suffix) and is never read as weights."""
    with pytest.raises(ValueError) as ref:
        jparams.resolve_yolo_params(weights_path=str(tmp_path / "m.xlae"))
    with pytest.raises(ValueError) as ours:
        tparams.resolve_yolo_params(weights_path=str(tmp_path / "m.cudae"),
                                    device="cpu")
    assert str(ours.value) == str(ref.value).replace(".xlae", ".cudae")
    with pytest.raises(ValueError, match="serialized engine"):
        tparams.resolve_reid_params(str(tmp_path / "r.cudae"), device="cpu")


def test_engine_file_layout(tmp_path, detector):
    path = detector.export_engine(FRAME_HW, tmp_path / "d.cudae", name="d")
    data = path.read_bytes()
    assert data.startswith(b"AICAMCUDA1")
    (hlen,) = np.frombuffer(data[10:14], "<u4")
    header = json.loads(data[14:14 + hlen])
    assert header["name"] == "d" and header["kind"] == "yolo_detect"
    assert header["platforms"] == ["cuda", "cpu"] and header["dtype"] == "f32"
    assert header["metadata"] == {
        "frame_hw": list(FRAME_HW), "input_shape": list(INPUT_HW),
        "conf_threshold": detector.conf_threshold,
        "nms_threshold": detector.nms_threshold, "variant": "n"}
    # the weights follow: the committed checkpoint's tree, self-contained
    tree = tparams.read_flax_msgpack(data[14 + hlen:])
    ref = tparams.load_flax_msgpack(YOLO)
    np.testing.assert_array_equal(
        tree["params"]["backbone"]["stem"]["conv"]["kernel"],
        ref["params"]["backbone"]["stem"]["conv"]["kernel"])


@pytest.fixture(scope="module")
def reid_engine(tmp_path_factory):
    path = tmp_path_factory.mktemp("reid") / "reid.cudae"
    tapi.ReIDModel(REID, device="cpu").export_engine(path)
    return path


@pytest.fixture(scope="module")
def reid_models(reid_engine):
    return (tapi.ReIDModel(REID, device="cpu"),
            tapi.ReIDModel(str(reid_engine), device="cpu"))


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_reid_engine_dynamic_batch(reid_models, batch):
    """The dynamic-batch engine equals the weights path bitwise at each
    batch (on the CPU both run the same forward)."""
    rm, rm2 = reid_models
    assert rm2.feature_dim == rm.feature_dim
    assert rm2.input_shape == rm.input_shape
    rng = np.random.RandomState(batch)
    x = torch.from_numpy(rng.rand(batch, *rm.input_shape, 3)
                         .astype(np.float32))
    out = rm2.device_apply(x)
    assert out.shape == (batch, rm.feature_dim)
    assert torch.equal(out, rm.device_apply(x))


def test_reid_engine_features_match_jax(reid_models):
    """The engine's host-crop features against the JAX ``ReIDModel``'s:
    within 1e-4 (f32 convolution stacks), an empty crop a zero row."""
    from aicamera_tpu.tracker_api import ReIDModel as JaxReID
    _, rm2 = reid_models
    rng = np.random.RandomState(3)
    crops = [rng.randint(0, 256, (50, 20, 3), np.uint8) for _ in range(3)]
    crops.insert(1, np.zeros((0, 0, 3), np.uint8))
    got = rm2.extract_features_batched(crops)
    want = JaxReID(REID, reid_dtype="f32").extract_features_batched(crops)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert not got[1].any()


def test_deepsort_with_serialized_reid_matches_weights(reid_engine):
    """The JAX package's scenario: DeepSORT through a ``.cudae`` ReID engine
    gives the tuples of DeepSORT with the weights."""

    def scenario(ds):
        frame = np.zeros((*FRAME_HW, 3), np.uint8)
        frame[20:60, 30:70] = 128
        box = np.array([[30.0, 20.0, 70.0, 60.0]], np.float32)
        return [ds.update(box + 2 * k, np.array([0.9]), np.array([0]), frame)
                for k in range(4)]

    kw = dict(n_init=2, max_age=5, max_tracks=16, max_detections=8,
              max_reid_crops=4, device="cpu")
    ref = scenario(tapi.DeepSORT(REID, **kw))
    assert scenario(tapi.DeepSORT(str(reid_engine), **kw)) == ref
    assert any(len(o) == 1 for o in ref)  # the scenario tracks


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_a_dtype_given_with_an_engine_file_warns(tmp_path, detector,
                                                 reid_engine, reid_models,
                                                 dtype):
    """A ``.cudae`` engine's dtype is baked in: a ``detect_dtype`` or
    ``reid_dtype`` given with the file is ignored with a warning, and the
    outputs stay the engine's."""
    path = tmp_path / "yolo.cudae"
    detector.export_engine(FRAME_HW, path)
    with pytest.warns(UserWarning, match=f"detect_dtype='{dtype}' is "
                      f"ignored"):
        det = tdet.YOLODetector(str(path), input_shape=INPUT_HW,
                                device="cpu", detect_dtype=dtype)
    for x, y in zip(det.detect(FRAMES[0]), detector.detect(FRAMES[0])):
        np.testing.assert_array_equal(x, y)
    with pytest.warns(UserWarning, match=f"reid_dtype='{dtype}' is ignored"):
        rm = tapi.ReIDModel(str(reid_engine), device="cpu", reid_dtype=dtype)
    x = torch.from_numpy(np.random.RandomState(0).rand(
        2, *rm.input_shape, 3).astype(np.float32))
    assert torch.equal(rm.device_apply(x), reid_models[1].device_apply(x))


def test_an_engine_file_without_a_dtype_does_not_warn(tmp_path, detector,
                                                      reid_engine):
    import warnings
    path = tmp_path / "yolo.cudae"
    detector.export_engine(FRAME_HW, path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tdet.YOLODetector(str(path), input_shape=INPUT_HW, device="cpu")
        tapi.ReIDModel(str(reid_engine), device="cpu")


def test_reid_export_refusals(reid_models, tmp_path):
    _, rm2 = reid_models
    with pytest.raises(ValueError, match="loaded from a serialized"):
        rm2.export_engine(tmp_path / "again.cudae")
    with pytest.raises(ValueError, match="quant='int8' needs weights"):
        tapi.ReIDModel(str(tmp_path / "r.cudae"), device="cpu",
                       quant="int8")


def test_export_engines_module(tmp_path):
    from aicamera_tpu_torch import export_engines
    assert export_engines.main(["--out_dir", str(tmp_path), "--frame_hw",
                                "96x128", "--input_size", "128", "--device",
                                "cpu"]) == 0
    yolo = tmp_path / "yolov8n_128_frame96x128.cudae"
    reid = tmp_path / "reid_dynamic.cudae"
    assert yolo.exists() and reid.exists()
    det = tdet.YOLODetector(str(yolo), device="cpu")
    assert det.input_shape == INPUT_HW
    assert tapi.ReIDModel(str(reid), device="cpu").feature_dim == \
        config.REID_FEATURE_DIM


# --- capture-safe NMS ----------------------------------------------------------

def _overlaps(seed):
    rng = np.random.RandomState(seed)
    b, k = 4, 80
    xy = rng.uniform(0, 100, (b, k, 2)).astype(np.float32)
    wh = rng.uniform(5, 40, (b, k, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    iou = tnms._pairwise_iou_xyxy(torch.from_numpy(boxes))
    return iou > float(rng.uniform(0.1, 0.5)), \
        torch.from_numpy(rng.rand(b, k) < 0.9)


@pytest.mark.parametrize("seed", range(4))
def test_fixed_iteration_keep_equals_early_exit(seed):
    overlap, valid = _overlaps(seed)
    fixed = tnms._greedy_keep(overlap, valid, fixed_iters=True)
    assert torch.equal(fixed, tnms._greedy_keep(overlap, valid))
    for i in range(overlap.shape[0]):
        np.testing.assert_array_equal(
            fixed[i].numpy(), np.asarray(jnms._greedy_keep(
                jnp.asarray(overlap[i].numpy()),
                jnp.asarray(valid[i].numpy()))))


def test_fixed_iteration_keep_on_a_long_chain():
    """Each box overlaps only its neighbour: the early exit needs ~K steps,
    the fixed loop runs exactly K."""
    k = 40
    x = np.arange(k, dtype=np.float32) * 6.0
    boxes = np.stack([x, np.zeros(k), x + 10.0, np.full(k, 10.0)], -1)
    overlap = tnms._pairwise_iou_xyxy(torch.from_numpy(
        boxes.astype(np.float32)[None])) > 0.2
    valid = torch.ones((1, k), dtype=torch.bool)
    fixed = tnms._greedy_keep(overlap, valid, fixed_iters=True)
    assert fixed[0].tolist() == [i % 2 == 0 for i in range(k)]
    assert torch.equal(fixed, tnms._greedy_keep(overlap, valid))


def test_fixed_iteration_keep_on_the_clip_detections():
    """Every frame of ``tests/data/clip_dets.npz`` (the reference clip's
    detections), batched, score-ordered and class-shifted as the NMS does."""
    d = np.load(Path(__file__).parent / "data" / "clip_dets.npz")
    order = np.argsort(-d["scores"], axis=1, kind="stable")
    boxes = np.take_along_axis(d["boxes"], order[..., None], 1)
    cls = np.take_along_axis(d["class_ids"], order, 1)
    valid = np.arange(boxes.shape[1])[None] < d["counts"][:, None]
    shifted = torch.from_numpy((boxes + cls[..., None] * 8192.0)
                               .astype(np.float32))
    overlap = tnms._pairwise_iou_xyxy(shifted) > config.YOLO_NMS_THRESHOLD
    valid = torch.from_numpy(valid)
    early = tnms._greedy_keep(overlap, valid)
    assert torch.equal(tnms._greedy_keep(overlap, valid, fixed_iters=True),
                       early)
    assert int(early.sum()) > 0


def test_fused_decode_nms_fixed_iters_same_outputs():
    rng = np.random.RandomState(5)
    levels = [(torch.from_numpy(rng.randn(2, h, h, 64).astype(np.float32)),
               torch.from_numpy(rng.randn(2, h, h, 80).astype(np.float32)
                                - 1.0)) for h in (8, 4, 2)]
    a = tnms.fused_decode_nms(levels, top_k=60, max_det=20)
    b = tnms.fused_decode_nms(levels, top_k=60, max_det=20, fixed_iters=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # the anchor tables are uploaded once per shape and device
    hw = ((8, 8), (4, 4), (2, 2))
    assert tnms._anchor_tables(hw, (8, 16, 32), torch.device("cpu")) is \
        tnms._anchor_tables(hw, (8, 16, 32), torch.device("cpu"))


# --- device_cost and trace -----------------------------------------------------

def _conv_flops(model, x_shape):
    """2 x the multiply-adds of every Conv2d of ``model`` at ``x_shape``
    (the layer shapes, from one forward with hooks)."""
    total = []

    def hook(m, inp, out):
        b, cout, ho, wo = out.shape
        cin, kh, kw = m.weight.shape[1:]
        total.append(2 * b * cout * ho * wo * cin * kh * kw)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        model(torch.zeros(x_shape))
    for h in hooks:
        h.remove()
    return sum(total), len(total)


@pytest.mark.parametrize("net", ["yolov8n", "reid"])
def test_device_cost_counts_conv_flops(net):
    if net == "yolov8n":
        model = tparams.resolve_yolo_params(weights_path=YOLO, device="cpu")
        shape = (1, 3, 64, 64)
        n_convs = 63
    else:
        model = tparams.resolve_reid_params(REID, device="cpu")
        shape = (2, 128, 64, 3)
        n_convs = 20
    want, n = _conv_flops(model, shape)
    assert n == n_convs
    eng = teng.CUDAGraphEngine(model, [torch.zeros(shape)], device="cpu")
    cost = eng.cost_analysis()
    assert set(cost) == {"flops", "bytes accessed"}
    assert cost["flops"] == want   # no other op counts FLOPs here
    assert cost["bytes accessed"] > 0


def test_device_cost_counts_the_letterbox_as_its_kernel():
    """The letterbox counts the kernel's traffic (``ops.letterbox.
    traffic``), not its plain version's ops, on either device."""
    spec = letterbox_spec(FRAME_HW, INPUT_HW)
    frames = torch.from_numpy(np.stack(FRAMES[:2]))
    mode = profiler.CostMode()
    with mode:
        lb.letterbox(frames, spec)
    in_b, out_b, rows = lb.traffic(spec, 2, torch.float32)
    assert rows == FRAME_HW[0]
    assert in_b == 2 * FRAME_HW[0] * FRAME_HW[1] * 3
    assert out_b == 2 * 3 * INPUT_HW[0] * INPUT_HW[1] * 4
    assert mode.bytes == in_b + out_b
    assert mode.opaque_bytes == {"letterbox": in_b + out_b}
    assert mode.flops == 0


def test_device_cost_of_the_detect_engine_includes_the_letterbox(detector):
    cost = detector.get_engine(FRAME_HW).cost_analysis()
    in_b, out_b, _ = lb.traffic(detector._spec(FRAME_HW), 1, torch.float32)
    model_flops, _ = _conv_flops(detector.model, (1, 3, *INPUT_HW))
    assert cost["bytes accessed"] > in_b + out_b
    assert cost["flops"] >= model_flops   # convs plus the NMS products


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiler.trace(str(tmp_path / "tr")) as d:
        torch.ones(4) + 1
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert d == str(tmp_path / "tr") and len(files) == 1
    assert "traceEvents" in json.loads(files[0].read_text())
