"""Port: W8A8 quantization (``models/quant.py``, ``models/quant_yolo.py``)
and its surfaces (the facades, the pipelines, the CLI), on the CPU against
the JAX package.

The int8 products are exact (int32 accumulation) on both sides; the f32
epilogues copy the multiply-adds XLA's CPU backend fuses, so the quantized
tensors come out bitwise JAX's here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aicamera_tpu.models import quant as jq  # noqa: E402
from aicamera_tpu.models import quant_yolo as jqy  # noqa: E402
from aicamera_tpu_torch import config  # noqa: E402
from aicamera_tpu_torch.models import quant as tq  # noqa: E402
from aicamera_tpu_torch.models import quant_yolo as tqy  # noqa: E402
from aicamera_tpu_torch.ops import nms as tnms  # noqa: E402
from aicamera_tpu_torch.runtime import params as tparams  # noqa: E402
from aicamera_tpu_torch.scenes import moving_rectangles  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


YOLO = str(config.YOLO_SYNTHETIC_PATH)
REID = str(config.REID_SYNTHETIC_PATH)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _norm_crops(n, seed=0):
    """ImageNet-normalized random crops, the embed stage's input domain."""
    rng = np.random.RandomState(seed)
    u8 = rng.randint(0, 256, (n, *config.REID_INPUT_SHAPE, 3), np.uint8)
    x = u8.astype(np.float32) / 255.0
    return ((x - np.array([0.485, 0.456, 0.406], np.float32))
            / np.array([0.229, 0.224, 0.225], np.float32)).astype(np.float32)


# --- ReID: W8A8, dynamic activation scales ------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_quantize_conv_bitwise_equals_jax(seed):
    rng = np.random.RandomState(seed)
    w = rng.randn(3, 3, 16, 32).astype(np.float32) * \
        rng.rand(32).astype(np.float32)
    b = rng.randn(32).astype(np.float32)
    ours, ref = tq.quantize_conv(w, b), jq.quantize_conv(w, b)
    assert ours["w"].dtype == torch.int8
    for k in ("w", "scale", "bias"):
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))


@pytest.fixture(scope="module")
def reid_pair():
    """The committed ReID weights quantized by both packages (the JAX side
    from the checkpoint's Flax tree: its own loader spends ~15 s compiling
    a random init that the weights then replace)."""
    tm = tparams.resolve_reid_params(REID, device="cpu",
                                     dtype=torch.float32)
    return (tq.quantize_reid_params(tm),
            jq.quantize_reid_params(tparams.load_flax_msgpack(REID)))


def test_quantize_reid_params_bitwise_equals_jax(reid_pair):
    ours, ref = (dict(_leaves(t)) for t in reid_pair)
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    for i in (2, 4, 6):   # projections where the channel count changes
        assert f"block{i}/proj/w" in ours


def test_quant_reid_net_matches_jax(reid_pair):
    """Features within 1e-6 of JAX's (measured 1.2e-7: every int8 tensor is
    equal; only the final mean and norm sum in another order), unit norm.
    Activations are quantized per crop, so the batch does not matter."""
    ours, ref = reid_pair
    net = tq.QuantReIDNet(ours)
    x = _norm_crops(4)
    got = net(torch.from_numpy(x)).detach().numpy()
    want = np.asarray(jax.jit(jq.QuantReIDNet(512).apply)(ref,
                                                         jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    # the module gives its tree back, equal to what built it
    back = dict(_leaves(net.qparams()))
    for k, v in _leaves(ours):
        np.testing.assert_array_equal(back[k], v.numpy())


def test_int8_conv_equals_a_float_reference():
    """The im2col product against an exact float convolution of the same
    int8 values (int32 sums of at most 27 products of 127s fit f64),
    strided and padded, with a depth padded to a multiple of 8."""
    rng = np.random.RandomState(0)
    xq = torch.from_numpy(rng.randint(-127, 128, (2, 9, 7, 3)).astype(
        np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, (3, 3, 3, 5)).astype(
        np.int8))
    got = tq.int8_conv(xq, tq.gemm_weight(w), 3, 3, 2, 1, 5)
    ref = torch.nn.functional.conv2d(
        xq.permute(0, 3, 1, 2).double(), w.permute(3, 2, 0, 1).double(),
        stride=2, padding=1).permute(0, 2, 3, 1)
    assert got.dtype == torch.int32 and got.shape == ref.shape
    assert torch.equal(got.double(), ref)
    assert tq.gemm_weight(w).shape == (8, 32)


def test_reid_model_facade_int8(reid_pair):
    """The int8 facade's host-crop features: unit norm, and equal (within
    1e-6) to ``QuantReIDNet`` on the same preprocessed crops, which the
    test above holds to JAX."""
    from aicamera_tpu_torch.tracker_api import ReIDModel
    m = ReIDModel(REID, device="cpu", quant="int8")
    assert m.quant == "int8" and m.dtype == torch.float32
    rng = np.random.RandomState(1)
    crops = [rng.randint(0, 256, (60, 30, 3), np.uint8) for _ in range(3)]
    feats = m.extract_features_batched(crops)
    assert feats.shape == (3, config.REID_FEATURE_DIM)
    np.testing.assert_allclose(np.linalg.norm(feats, axis=-1), 1.0,
                               atol=1e-4)
    x = torch.from_numpy(np.stack([m._preprocess(c) for c in crops]))
    want = tq.QuantReIDNet(reid_pair[0])(x).detach().numpy()
    np.testing.assert_allclose(feats, want, atol=1e-6)
    with pytest.raises(ValueError, match="quant"):
        ReIDModel(device="cpu", quant="fp4")


# --- YOLOv8: static calibration -----------------------------------------------

@pytest.fixture(scope="module")
def yolo_pair():
    """Calibration, then build from JAX's scales, on both sides: 64x64
    inputs as ``tests/test_quant_yolo.py``."""
    jp = tparams.load_flax_msgpack(YOLO)   # the checkpoint's Flax tree
    tm = tparams.resolve_yolo_params("n", weights_path=YOLO, device="cpu",
                                     dtype=torch.float32)
    calib = np.random.RandomState(0).rand(4, 64, 64, 3).astype(np.float32)
    jqm = jqy.QuantYOLOv8("n")
    j_scales = jqm.calibrate(jp, calib, batch=2)
    j_qparams = jqm.build(jp, j_scales)
    tqm = tqy.QuantYOLOv8("n")
    t_scales = tqm.calibrate(tm, torch.from_numpy(calib).permute(0, 3, 1, 2),
                             batch=2)
    t_qparams = tqm.build(tm, j_scales)
    return dict(jq=jqm, j_scales=j_scales, j_qparams=j_qparams, tq=tqm,
                t_scales=t_scales, t_qparams=t_qparams, model=tm,
                j_run=_jax_recorded(jqm, j_qparams))


def test_calibration_scales_match_jax(yolo_pair):
    """Within 1e-5 relative (two f32 convolution stacks; measured 9e-7)."""
    ours, ref = yolo_pair["t_scales"], yolo_pair["j_scales"]
    assert ours.keys() == ref.keys() and len(ref) == 58
    for k in ref:
        assert abs(ours[k] - ref[k]) <= 1e-5 * ref[k], k


def test_build_from_jax_scales_is_bitwise_jax(yolo_pair):
    ours, ref = yolo_pair["t_qparams"], yolo_pair["j_qparams"]
    assert ours.keys() == ref.keys() and len(ref) == 63
    for k in ref:
        for f in ("w", "wscale", "bias"):
            np.testing.assert_array_equal(ours[k][f].numpy(),
                                          np.asarray(ref[k][f]),
                                          err_msg=f"{k}/{f}")


def _jax_recorded(jqm, qparams):
    """JAX's int8 program (jitted), returning its levels and every conv
    output."""

    class Rec(jqy._RunCtx):
        def conv(self, path, *a, **kw):
            out = super().conv(path, *a, **kw)
            self.rec[jqy._key(path)] = out.data
            return out

    def run(x):
        ctx = Rec(qparams, jqm.scales)
        ctx.rec = {}
        outs = jqy._traverse(ctx, x, "n")
        return [(r.data, c.data) for r, c in outs], ctx.rec

    return jax.jit(run)


def test_apply_matches_jax(yolo_pair):
    """Every int8 activation of the run pass and the output levels against
    JAX's. Stated tolerance: at most 1e-4 of the int8 activations a level
    off (an f32 ulp at a .5 requantize can move one), levels within 1e-3.
    Measured here: 0 activations differ and the levels are bitwise."""
    tqm, jqm = yolo_pair["tq"], yolo_pair["jq"]
    x = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)
    record = {}
    ours = tqm.apply(tqm.qparams, torch.from_numpy(x).permute(0, 3, 1, 2),
                     record=record)
    ref, ref_rec = yolo_pair["j_run"](jnp.asarray(x))
    flips = total = 0
    for k, v in ref_rec.items():
        v = np.asarray(v)
        if v.dtype == np.int8:
            d = record[k].numpy() != v
            assert np.abs(record[k].numpy().astype(int) - v).max() <= 1
            flips += int(d.sum())
            total += v.size
    print(f"int8 activations that differ from JAX's: {flips} of {total}")
    assert flips <= 1e-4 * total
    for (r, c), (jr, jc) in zip(ours, ref):
        assert r.shape == jr.shape and c.shape == jc.shape
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-3)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-3)


def test_detections_after_decode_nms_match_jax(yolo_pair):
    """The int8 levels through both packages' ``fused_decode_nms`` on a
    seeded scene: counts and labels identical, boxes within 1e-3 px, scores
    within 1e-5."""
    from aicamera_tpu.ops.nms import fused_decode_nms as jnms
    from aicamera_tpu_torch.ops.preprocess import letterbox_plain, \
        letterbox_spec
    tqm = yolo_pair["tq"]
    frames = torch.from_numpy(np.stack(moving_rectangles(
        2, (48, 64), n_objects=3, seed=3)))
    x = letterbox_plain(frames, letterbox_spec((48, 64), (64, 64)))
    ours = tnms.fused_decode_nms(tqm(x), score_threshold=0.01, top_k=64,
                                 max_det=16)
    levels, _ = yolo_pair["j_run"](jnp.asarray(x.permute(0, 2, 3, 1).numpy()))
    ref = [np.asarray(a) for a in jnms(levels, score_threshold=0.01,
                                       top_k=64, max_det=16)]
    np.testing.assert_array_equal(ours[0].numpy(), ref[0])
    assert ref[0].sum() > 0
    np.testing.assert_allclose(ours[1].numpy(), ref[1], atol=1e-3)
    np.testing.assert_allclose(ours[2].numpy(), ref[2], atol=1e-5)
    np.testing.assert_array_equal(ours[3].numpy(), ref[3])


def test_calibration_frames_bitwise_equal_jax():
    """``quantize_yolo_synthetic``'s calibration set: six synthetic-world
    scenes and two noise frames, letterboxed (here to 64x64)."""
    from aicamera_tpu.ops.preprocess import letterbox_spec, preprocess_yolo
    from aicamera_tpu.synthetic import WorldSpec, random_scene
    spec = WorldSpec(max_objects=12, presence=1.0)
    keys = jax.random.split(jax.random.PRNGKey(7), 6)
    frames = [np.asarray(random_scene(k, spec)[0]) for k in keys]
    rng = np.random.RandomState(7)
    frames += [rng.randint(0, 256, (*spec.hw, 3), np.uint8)
               for _ in range(2)]
    lspec = letterbox_spec(spec.hw, (64, 64))
    ref = np.stack([np.asarray(preprocess_yolo(
        jnp.asarray(f), lspec, out_dtype=jnp.float32)[0], np.float32)
        for f in frames])
    ours = tqy.calibration_frames((64, 64), device="cpu")
    np.testing.assert_array_equal(ours.permute(0, 2, 3, 1).numpy(), ref)


def test_build_requires_then_binds_scales():
    q = tqy.QuantYOLOv8("n")
    with pytest.raises(RuntimeError, match="build"):
        q.apply({}, torch.zeros((1, 3, 64, 64)))


# --- the slice as a whole ------------------------------------------------------

def test_int8_detector_then_int8_deepsort_match_jax(yolo_pair):
    """``YOLODetector(quant="int8", input_shape=(160, 160)).detect`` ->
    ``DeepSORT(reid_quant="int8").update`` on seeded frames, both
    packages, the port's detector bound to JAX's calibration scales (its
    own differ by up to 1e-5 relative: ``test_calibration_scales_match_jax``;
    independently calibrated, 21 of 3.1M int8 weights differed, boxes by up
    to 0.21 px and one track box by a pixel). Detections: counts, labels and
    indices identical, boxes within 1e-3 px, scores within 1e-5; track
    tuples identical, conf within 1e-5."""
    from aicamera_tpu.detector import YOLODetector as JDet
    from aicamera_tpu.tracker_api import DeepSORT as JDeepSORT
    from aicamera_tpu_torch.detector import YOLODetector
    from aicamera_tpu_torch.tracker_api import DeepSORT
    frames = moving_rectangles(4, (120, 160), n_objects=3, seed=3)
    kw = dict(n_init=2, max_tracks=16, max_detections=8, max_reid_crops=4)
    det = YOLODetector(YOLO, input_shape=(160, 160), quant="int8",
                       device="cpu")
    jdet = JDet(YOLO, input_shape=(160, 160), quant="int8")
    det.model.build(yolo_pair["model"], jdet.model.scales)
    trk = DeepSORT(REID, reid_quant="int8", device="cpu", **kw)
    jtrk = JDeepSORT(REID, reid_quant="int8", **kw)
    n_tracks = 0
    for f in frames:
        ours, ref = det.detect(f), jdet.detect(f)
        np.testing.assert_array_equal(ours[2], ref[2])
        np.testing.assert_array_equal(ours[3], ref[3])
        np.testing.assert_allclose(ours[0], ref[0], atol=1e-3)
        np.testing.assert_allclose(ours[1], ref[1], atol=1e-5)
        got, want = trk.update(*ours[:3], f), jtrk.update(*ref[:3], f)
        assert [t[:6] for t in got] == [t[:6] for t in want]
        assert all(abs(a[6] - b[6]) <= 1e-5 for a, b in zip(got, want))
        n_tracks += len(got)
    assert n_tracks > 0


# --- surfaces, port only (JAX's are slow-marked: tests/test_quant.py) ---------

@pytest.fixture(scope="module")
def clip():
    return moving_rectangles(4, (96, 128), n_objects=3, seed=3)


@pytest.mark.parametrize("kw", [dict(reid_quant="int8"),
                                dict(yolo_quant="int8")])
def test_pipeline_quant_surface(clip, kw):
    from aicamera_tpu_torch.models.quant import QuantReIDNet
    from aicamera_tpu_torch.models.quant_yolo import QuantYOLOv8
    from aicamera_tpu_torch.runtime.pipeline import TrackingPipeline
    pipe = TrackingPipeline(device="cpu", chunk_size=2, input_shape=(128, 128),
                            yolo_weights=YOLO, reid_weights=REID,
                            synthetic_load=4, **kw)
    if "reid_quant" in kw:
        assert pipe.reid_quant == "int8" and isinstance(pipe.reid,
                                                        QuantReIDNet)
    else:
        assert pipe.yolo_quant == "int8" and isinstance(pipe.yolo,
                                                        QuantYOLOv8)
        assert pipe.detect_dtype == torch.float32
    results = list(pipe.process_frames(iter(clip)))
    assert len(results) == 4
    assert sum(len(r.tracks) for r in results) > 0


@pytest.mark.parametrize("ours", [
    dict(detect_dtype="f32", yolo_quant="int8"),
    dict(reid_dtype="f32", reid_quant="int8"),
    dict(yolo_quant="fp4")])
def test_pipeline_quant_conflicts_raise_as_jax(ours):
    from aicamera_tpu.runtime.pipeline import TrackingPipeline as JaxPipe
    from aicamera_tpu_torch.runtime.pipeline import TrackingPipeline
    with pytest.raises(ValueError) as ref:
        JaxPipe(**ours)
    with pytest.raises(ValueError) as e:
        TrackingPipeline(device="cpu", **ours)
    assert str(e.value) == str(ref.value)


def test_facade_quant_conflicts_raise_as_jax():
    from aicamera_tpu.detector import YOLODetector as JDet
    from aicamera_tpu.tracker_api import ReIDModel as JReID
    from aicamera_tpu_torch.detector import YOLODetector
    from aicamera_tpu_torch.tracker_api import ReIDModel
    for ours, ref in ((lambda: YOLODetector(device="cpu", quant="int8",
                                            detect_dtype="f32"),
                       lambda: JDet(quant="int8", detect_dtype="f32")),
                      (lambda: ReIDModel(device="cpu", quant="int8",
                                         reid_dtype="f32"),
                       lambda: JReID(quant="int8", reid_dtype="f32"))):
        with pytest.raises(ValueError) as a:
            ours()
        with pytest.raises(ValueError) as b:
            ref()
        assert str(a.value) == str(b.value)
    with pytest.raises(ValueError, match="calibration happens at load"):
        YOLODetector("d.cudae", device="cpu", quant="int8")


def test_multistream_reid_quant_surface(clip):
    """Identical frames on both streams give identical outputs."""
    from aicamera_tpu_torch.parallel import MultiStreamPipeline
    with pytest.raises(ValueError, match="reid_quant"):
        MultiStreamPipeline(n_streams=2, frame_hw=(96, 128), device="cpu",
                            reid_quant="fp4")
    pipe = MultiStreamPipeline(n_streams=2, frame_hw=(96, 128),
                               input_shape=(128, 128), reid_quant="int8",
                               max_reid_crops=4, yolo_weights=YOLO,
                               reid_weights=REID, device="cpu")
    assert pipe.reid_quant == "int8"
    one = np.stack(clip[:2])
    outs = pipe.step_chunk(np.stack([one, one]))
    for o in outs:
        assert torch.equal(o[0], o[1])


def test_cli_quant_flags_run(tmp_path, clip, capsys):
    from aicamera_tpu_torch import cli
    path = tmp_path / "clip.npy"
    np.save(path, np.stack(clip))
    cli.main(["--input", str(path), "--device", "cpu", "--no_save",
              "--input_shape", "128", "--chunk_size", "2", "--yolo_weights",
              YOLO, "--reid_weights", REID, "--reid_quant", "int8",
              "--yolo_quant", "int8"])
    out = capsys.readouterr().out
    assert "Processed 4 frames" in out
