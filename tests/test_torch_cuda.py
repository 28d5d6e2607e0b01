"""Port: tests that need an NVIDIA GPU (the CUDA kernels have no CPU mode).

They skip on a host without one. On the GPU host, which has no JAX (and
``tests/conftest.py`` imports the JAX package, hence ``--noconftest``):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q \
        -p no:cacheprovider
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from aicamera_tpu_torch.ops import letterbox as lb  # noqa: E402
from aicamera_tpu_torch.ops.preprocess import letterbox_spec  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    PyTorch's thread pool oversubscribes the cores (small convolutions then
    run ~100x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("src,dst,auto", [((540, 960), (640, 640), False),
                                          ((1080, 1920), (640, 640), False),
                                          ((640, 640), (640, 640), False),
                                          ((240, 320), (640, 640), False),
                                          ((540, 960), (640, 640), True),
                                          ((37, 1999), (128, 96), False),
                                          # source rows off the 16-byte grid
                                          ((101, 333), (640, 640), False),
                                          ((360, 636), (640, 640), False),
                                          # a left pad that splits groups
                                          ((100, 48), (128, 120), False),
                                          # an odd Dh: a ragged last tile
                                          ((37, 64), (31, 40), False),
                                          # ratio 3: one staged row a row
                                          ((108, 192), (64, 64), False),
                                          # a band beyond 48 KB
                                          ((16, 8208), (64, 640), False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_bitwise_equals_plain_version(cuda, src, dst, auto, dtype):
    spec = letterbox_spec(src, dst, auto=auto)
    gen = torch.Generator(device=cuda).manual_seed(0)
    frames = torch.randint(0, 256, (3, *src, 3), dtype=torch.uint8,
                           device=cuda, generator=gen)
    launches = lb.KERNEL.launches
    out = lb.letterbox(frames, spec, dtype)
    assert lb.KERNEL.launches == launches + 1
    # the variant that ran is the one the plan names for these shapes
    assert lb.KERNEL.last_plan == lb.launch_plan(spec, 3, dtype)
    assert lb.KERNEL.last_plan.variant == \
        ("vector" if src[1] % 16 == 0 else "scalar")
    ref = lb.letterbox_plain(frames, spec, dtype)
    torch.cuda.synchronize()
    assert out.shape == (3, 3, *spec.out_hw) and out.dtype == dtype
    assert torch.equal(out, ref)  # tolerance: bitwise


@pytest.mark.parametrize("variant", ["scalar", "vector"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_both_variants_agree(cuda, variant, dtype):
    """An aligned shape through each variant by name. Tolerance: bitwise."""
    spec = letterbox_spec((540, 960), (640, 640))
    gen = torch.Generator(device=cuda).manual_seed(1)
    frames = torch.randint(0, 256, (2, 540, 960, 3), dtype=torch.uint8,
                           device=cuda, generator=gen)
    out = lb.KERNEL(frames, spec, dtype, variant=variant)
    assert lb.KERNEL.last_plan.variant == variant
    ref = lb.letterbox_plain(frames, spec, dtype)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def test_unaligned_pointer_takes_the_scalar_variant(cuda):
    spec = letterbox_spec((54, 96), (64, 64))
    buf = torch.randint(0, 256, (2 * 54 * 96 * 3 + 1,), dtype=torch.uint8,
                        device=cuda)
    frames = buf[1:].view(2, 54, 96, 3)
    assert frames.data_ptr() % 16 != 0
    out = lb.letterbox(frames, spec)
    assert lb.KERNEL.last_plan.variant == "scalar"
    torch.cuda.synchronize()
    assert torch.equal(out, lb.letterbox_plain(frames, spec))
    with pytest.raises(ValueError, match="vector variant"):
        lb.KERNEL(frames, spec, torch.float32, variant="vector")


def test_kernel_rejects_bad_input(cuda):
    spec = letterbox_spec((54, 96), (64, 64))
    frames = torch.zeros((2, 54, 96, 3), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        lb.letterbox(frames.transpose(1, 2).contiguous().transpose(1, 2),
                     spec)
    with pytest.raises(TypeError):
        lb.letterbox(frames.float(), spec)


def test_pipeline_launches_the_kernel_once_per_chunk(cuda):
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.core.state import TrackerParams
    from aicamera_tpu_torch.runtime.pipeline import TrackingPipeline
    from aicamera_tpu_torch.scenes import moving_rectangles
    pipe = TrackingPipeline(
        input_shape=(256, 256), chunk_size=2, synthetic_load=8,
        max_reid_crops=4,
        tracker_params=TrackerParams(max_tracks=16, max_detections=8,
                                     nn_budget=4, max_age=10),
        yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
        reid_weights=str(config.REID_SYNTHETIC_PATH))
    frames = moving_rectangles(6, (180, 320), n_objects=3, seed=3)
    launches = lb.KERNEL.launches
    results = list(pipe.process_frames(iter(frames)))
    assert lb.KERNEL.launches == launches + 3
    assert len(results) == 6
    assert all(np.isfinite(r.det_boxes).all() for r in results)
    assert len(results[-1].tracks) > 0


ASSIGNMENT_FAMILIES = sorted({f for f, _, _ in
                              chip_smoke.assignment_cases()})


@pytest.mark.parametrize("family", ASSIGNMENT_FAMILIES)
def test_assignment_kernel_bitwise_equals_plain_version(cuda, family):
    """``chip_smoke.assignment_cases``: realistic DeepSORT loads at 128 and
    32 track slots, ties (with -0.0), nothing feasible, one row, R < C and
    R > C, n = 256 (staged and in device memory), cascades over 1, 2, 5 and
    70 levels, the OC-SORT and ByteTrack costs. The public functions launch
    the kernel once each; the outputs equal the plain version's on the same
    card tensors bitwise."""
    from aicamera_tpu_torch.core import assignment as asg
    from aicamera_tpu_torch.ops.assignment import KERNEL
    public = {"match": asg.min_cost_matching,
              "cascade": asg.matching_cascade}
    plain = {"match": asg.min_cost_matching_plain,
             "cascade": asg.matching_cascade_plain}
    for fam, kind, args in chip_smoke.assignment_cases():
        if fam != family:
            continue
        a = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
             if isinstance(x, np.ndarray) else x for x in args]
        launches = KERNEL.launches
        got = public[kind](*a)
        assert KERNEL.launches == launches + 1
        want = plain[kind](*a)
        got, want = (got, want) if kind == "cascade" else ((got,), (want,))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_deepsort_scan_on_the_card_reads_nothing_and_replays(cuda,
                                                             monkeypatch):
    """The DeepSORT pipeline on the card: no tracker read, a cascade and an
    IoU solve a frame through the kernel, and the captured scans' tracks
    equal to the eager scans' (frame by frame, invalid frames skipped on
    the host). A capture's eager warm-up pass and its padding frames launch
    too, so only the eager run's count is exact."""
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.core.assignment import TRACKER_SYNCS
    from aicamera_tpu_torch.core.state import TrackerParams
    from aicamera_tpu_torch.ops.assignment import KERNEL
    from aicamera_tpu_torch.runtime import pipeline as pl
    from aicamera_tpu_torch.scenes import moving_rectangles

    def run():
        pipe = pl.TrackingPipeline(
            input_shape=(256, 256), chunk_size=2, synthetic_load=8,
            max_reid_crops=4, scan_bucket=0, detect_dtype="f32",
            reid_dtype="f32",
            tracker_params=TrackerParams(max_tracks=16, max_detections=8,
                                         nn_budget=4, max_age=10),
            yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
            reid_weights=str(config.REID_SYNTHETIC_PATH))
        reads, launches = TRACKER_SYNCS.count, KERNEL.launches
        out = [r.tracks for r in pipe.process_frames(iter(frames))]
        return out, TRACKER_SYNCS.count - reads, KERNEL.launches - launches

    frames = moving_rectangles(7, (180, 320), n_objects=3, seed=3)
    captured, reads, launches = run()
    assert reads == 0 and launches >= 2 * len(frames)
    monkeypatch.setattr(pl.TrackingPipeline, "_capture_scans", False)
    eager, reads, launches = run()
    assert reads == 0 and launches == 2 * len(frames)
    assert sum(map(len, captured)) > 0 and captured == eager


@pytest.mark.parametrize("tracker", ["bytetrack", "botsort", "ocsort",
                                     "deepocsort", "strongsort"])
def test_tracker_on_the_card_matches_the_cpu_path(cuda, tracker):
    """Each tracker core, card f32 (TF32 off) against the CPU path on the
    same frames: counts, labels and track tuples identical, boxes within
    1e-2 px, conf within 1e-4; the kernel runs once per chunk. StrongSORT
    runs its preset's camera-motion compensation."""
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.core.bytetrack import ByteTrackParams
    from aicamera_tpu_torch.core.ocsort import OCSortParams
    from aicamera_tpu_torch.runtime.pipeline import TrackingPipeline
    from aicamera_tpu_torch.scenes import moving_rectangles
    cap = dict(max_tracks=16, max_detections=8)
    app = dict(with_appearance=tracker in ("botsort", "deepocsort"))
    kw = dict(input_shape=(256, 256), chunk_size=2, synthetic_load=8,
              max_reid_crops=4, tracker=tracker,
              yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
              reid_weights=str(config.REID_SYNTHETIC_PATH))
    if tracker in ("bytetrack", "botsort"):
        kw["bytetrack_params"] = ByteTrackParams(track_thresh=0.4, **cap,
                                                 **app)
    elif tracker in ("ocsort", "deepocsort"):
        kw["ocsort_params"] = OCSortParams(det_thresh=0.4, **cap, **app)
    frames = moving_rectangles(6, (180, 320), n_objects=3, seed=3)
    launches = lb.KERNEL.launches
    gpu = list(TrackingPipeline(detect_dtype="f32", reid_dtype="f32",
                                **kw).process_frames(iter(frames)))
    assert lb.KERNEL.launches == launches + 3
    cpu = list(TrackingPipeline(device="cpu", **kw).process_frames(
        iter(frames)))
    assert sum(len(r.tracks) for r in gpu) > 0
    for g, c in zip(gpu, cpu, strict=True):
        assert len(g.det_boxes) == len(c.det_boxes)
        np.testing.assert_array_equal(g.det_labels, c.det_labels)
        np.testing.assert_allclose(g.det_boxes, c.det_boxes, atol=1e-2)
        assert [t[:6] for t in g.tracks] == [t[:6] for t in c.tracks]
        for tg, tc in zip(g.tracks, c.tracks):
            assert abs(tg[6] - tc[6]) <= 1e-4


def test_preprocess_yolo_launches_the_kernel(cuda):
    """The public single-frame preprocess on a CUDA tensor is the kernel (one
    launch), bitwise equal to the plain version in the JAX layout."""
    from aicamera_tpu_torch.ops.preprocess import preprocess_yolo
    spec = letterbox_spec((540, 960), (640, 640))
    gen = torch.Generator(device=cuda).manual_seed(2)
    frame = torch.randint(0, 256, (540, 960, 3), dtype=torch.uint8,
                          device=cuda, generator=gen)
    launches = lb.KERNEL.launches
    out = preprocess_yolo(frame, spec)
    assert lb.KERNEL.launches == launches + 1
    ref = lb.letterbox_plain(frame[None], spec).permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    assert out.shape == (1, 640, 640, 3) and torch.equal(out, ref)


def test_detector_launches_the_kernel_per_call(cuda):
    """``detect``: one launch (K=1); ``detect_tiled``: two (the tiles, then
    the full frame), counted through the replays of their captured engines
    (the first call of each builds and captures it); card f32 against the
    CPU facade: identical counts and labels, boxes within 1e-2 px, scores
    within 1e-4."""
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.detector import YOLODetector
    from aicamera_tpu_torch.scenes import moving_rectangles
    kw = dict(input_shape=(256, 256), detect_dtype="f32")
    gpu = YOLODetector(str(config.YOLO_SYNTHETIC_PATH), **kw)
    cpu = YOLODetector(str(config.YOLO_SYNTHETIC_PATH), device="cpu", **kw)
    frame = moving_rectangles(1, (180, 320), n_objects=3, seed=3)[0]
    for call, n in (("detect", 1), ("detect_tiled", 2)):
        getattr(gpu, call)(frame)   # builds and captures the engine
        launches = lb.KERNEL.launches
        g = getattr(gpu, call)(frame)
        assert lb.KERNEL.launches == launches + n
        c = getattr(cpu, call)(frame)
        assert len(g[0]) == len(c[0]) > 0
        np.testing.assert_array_equal(g[2], c[2])
        np.testing.assert_allclose(g[0], c[0], atol=1e-2)
        np.testing.assert_allclose(g[1], c[1], atol=1e-4)


def test_gmc_on_the_card_matches_the_cpu_without_a_sync(cuda):
    """``estimate_chunk`` on the card reads nothing back (sync debug mode
    "error" raises on any synchronizing call) and agrees with the CPU: A
    within 1e-4, t within 1e-2 px."""
    from aicamera_tpu_torch.ops import gmc
    from aicamera_tpu_torch.scenes import panning_rectangles
    frames, _ = panning_rectangles(5, (540, 960), seed=1)
    spec = gmc.gmc_spec((540, 960))
    f_gpu = torch.from_numpy(frames).to(cuda)
    gmc.estimate_chunk(f_gpu[0], f_gpu, spec)  # plans and workspaces
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a, t = gmc.estimate_chunk(f_gpu[0], f_gpu, spec)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    a_cpu, t_cpu = gmc.estimate_chunk(torch.from_numpy(frames[0]),
                                      torch.from_numpy(frames), spec)
    np.testing.assert_allclose(a.cpu().numpy(), a_cpu.numpy(), atol=1e-4)
    np.testing.assert_allclose(t.cpu().numpy(), t_cpu.numpy(), atol=1e-2)


def test_multistream_on_the_card_matches_single_streams_and_the_cpu(cuda):
    """``MultiStreamPipeline`` on the card: one letterbox launch per
    dispatch for all S*K frames; in f32 (TF32 off) each stream's track
    tuples equal a single-stream ``TrackingPipeline`` on the card (ids,
    classes, boxes identical, conf within 1e-4) and the CPU path's; a
    masked stream's state is bitwise unchanged."""
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.core.state import TrackerParams
    from aicamera_tpu_torch.parallel import MultiStreamPipeline
    from aicamera_tpu_torch.runtime.pipeline import (TrackingPipeline,
                                                     _format_tracks)
    from aicamera_tpu_torch.scenes import moving_rectangles
    kw = dict(input_shape=(256, 256), max_reid_crops=4,
              tracker_params=TrackerParams(max_tracks=16, max_detections=8,
                                           nn_budget=4, max_age=10),
              yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
              reid_weights=str(config.REID_SYNTHETIC_PATH),
              detect_dtype="f32", reid_dtype="f32")
    frames = np.stack([moving_rectangles(4, (180, 320), n_objects=3,
                                         seed=s) for s in (3, 5)])
    pipes = {d: MultiStreamPipeline(2, (180, 320), device=d, **kw)
             for d in ("cuda", "cpu")}
    launches = lb.KERNEL.launches
    outs = {d: [p.step_chunk(frames[:, :2]), p.step_chunk(frames[:, 2:])]
            for d, p in pipes.items()}
    assert lb.KERNEL.launches == launches + 2
    before = pipes["cuda"].states
    pipes["cuda"].step_chunk(frames[:, 2:], frame_valid=np.array(
        [[True, True], [False, False]]))
    after = pipes["cuda"].states
    assert torch.equal(before.gallery[1], after.gallery[1])
    assert torch.equal(before.mean[1], after.mean[1])

    def tuples(o, si):
        return [_format_tracks(*(x[si, t].cpu().numpy() for x in o[c]))
                for c in range(2) for t in range(2)]

    n = 0
    for si in range(2):
        single = TrackingPipeline(chunk_size=2, device="cuda", **kw)
        want = [r.tracks for r in single.process_frames(iter(frames[si]))]
        for ref in (want, tuples(outs["cpu"], si)):
            for g, w in zip(tuples(outs["cuda"], si), ref, strict=True):
                assert [t[:6] for t in g] == [t[:6] for t in w]
                assert all(abs(a[6] - b[6]) <= 1e-4 for a, b in zip(g, w))
        n += sum(map(len, want))
    assert n > 0


def test_synthetic_world_on_the_card_matches_the_cpu(cuda):
    """The threefry draws, the rendering and the ground truth give the same
    bits on the card as on the CPU (integer hash, float64 multiply-adds)."""
    from aicamera_tpu_torch import prng
    from aicamera_tpu_torch.synthetic import TemporalWorld, WorldSpec
    kd = prng.PRNGKey(5)
    for lo, hi in ((0.0, 1.0), (-12.0, 12.0)):
        assert torch.equal(prng.uniform(kd, (1000,), lo, hi, cuda).cpu(),
                           prng.uniform(kd, (1000,), lo, hi, "cpu"))
    assert torch.equal(prng.randint(kd, (64,), 6, 18, cuda).cpu(),
                       prng.randint(kd, (64,), 6, 18, "cpu"))
    spec = WorldSpec(max_objects=10, presence=1.0)
    card = TemporalWorld(spec, seed=4, speed=3.0, device=cuda)
    host = TemporalWorld(spec, seed=4, speed=3.0, device="cpu")
    for _ in range(4):
        for a, b in zip(card.step(), host.step()):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tiled", [False, True])
def test_captured_detect_equals_the_eager_step(cuda, tiled):
    """The detect (or tiled) engine replayed from its CUDA graph against the
    eager step with the early-exit NMS, f32 with TF32 off: bitwise; each
    replay counts the letterbox launches it repeats (1, or 2 tiled)."""
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.detector import (YOLODetector, detect_step,
                                             tiled_step)
    from aicamera_tpu_torch.scenes import moving_rectangles
    det = YOLODetector(str(config.YOLO_SYNTHETIC_PATH),
                       input_shape=(256, 256), detect_dtype="f32")
    hw = (180, 320)
    if tiled:
        eng = det._tiled_engine(hw, (2, 2), 0.2, True, "iou")
        eager = tiled_step(det.model, det._dtype, hw, det.input_shape,
                           (2, 2), 0.2, True, "iou", det.conf_threshold,
                           det.nms_threshold, False)
    else:
        eng = det.get_engine(hw)
        eager = detect_step(det.model, det._dtype, det._spec(hw),
                            det.conf_threshold, det.nms_threshold, False)
    n = 0
    for f in moving_rectangles(3, hw, n_objects=3, seed=3):
        frame = torch.from_numpy(f).to(cuda)
        launches = lb.KERNEL.launches
        got = eng(frame)
        assert lb.KERNEL.launches == launches + (2 if tiled else 1)
        with torch.no_grad():
            want = eager(frame)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        n += int(got[3].sum())
    assert n > 0 and eng.replays == 3


def test_a_capture_that_reads_the_gpu_raises(cuda):
    """The eager step reads the GPU (its NMS's early exit): capturing it
    raises, with no eager fallback, and the card keeps working."""
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.detector import YOLODetector, detect_step
    from aicamera_tpu_torch.runtime.engine import CUDAGraphEngine
    det = YOLODetector(str(config.YOLO_SYNTHETIC_PATH),
                       input_shape=(256, 256))
    eager = detect_step(det.model, det._dtype, det._spec((180, 320)),
                        det.conf_threshold, det.nms_threshold, False)
    frame = torch.zeros((180, 320, 3), dtype=torch.uint8, device=cuda)
    with pytest.raises(RuntimeError, match="capture failed"):
        CUDAGraphEngine(eager, [frame], warmup_iters=1)
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    assert det.get_engine((180, 320))(frame)[0].shape == (100, 4)


@pytest.mark.parametrize("shape,k,stride", [
    ((2, 128, 64, 3), 3, 1), ((8, 64, 32, 64), 3, 2),
    ((8, 32, 16, 128), 1, 2), ((1, 4, 2, 256), 3, 1),   # 8 rows < 17
    ((1, 80, 80, 40), 1, 1)])
def test_int8_conv_on_the_card_equals_the_cpu(cuda, shape, k, stride):
    """``torch._int_mm`` (cuBLASLt) int32 accumulators of the int8 im2col
    convolution, card against CPU: bitwise (integer sums are exact)."""
    from aicamera_tpu_torch.models.quant import gemm_weight, int8_conv
    rng = np.random.RandomState(sum(shape) + k)
    xq = torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, (k, k, shape[-1], 48))
                         .astype(np.int8))
    wm = gemm_weight(w)
    cpu = int8_conv(xq, wm, k, k, stride, k // 2, 48)
    gpu = int8_conv(xq.to(cuda), wm.to(cuda), k, k, stride, k // 2, 48)
    assert torch.equal(gpu.cpu(), cpu)


# --- a world on the card: NCCL, one rank ------------------------------------

_MESH_KW = dict(input_shape=(256, 256), max_reid_crops=4,
                detect_dtype="f32", reid_dtype="f32")


def _mesh_frames():
    from aicamera_tpu_torch.scenes import moving_rectangles
    return np.stack([moving_rectangles(4, (180, 320), n_objects=3, seed=s)
                     for s in (3, 5)])


def _mesh_pipeline(**kw):
    from aicamera_tpu_torch import config
    from aicamera_tpu_torch.core.state import TrackerParams
    from aicamera_tpu_torch.parallel import MultiStreamPipeline
    return MultiStreamPipeline(
        2, (180, 320), tracker_params=TrackerParams(
            max_tracks=16, max_detections=8, nn_budget=4, max_age=10),
        yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
        reid_weights=str(config.REID_SYNTHETIC_PATH), **_MESH_KW, **kw)


def _nccl_rank(rank, device):
    """The two streams on make_stream_mesh(1) and on make_mesh(1, 1)."""
    from aicamera_tpu_torch.parallel import make_mesh, make_stream_mesh
    from aicamera_tpu_torch.parallel.distributed import COLLECTIVES
    frames, out = _mesh_frames(), {}
    out["backend"] = torch.distributed.get_backend()
    for name, mesh in (("stream", make_stream_mesh(1)),
                       ("2d", make_mesh(1, 1))):
        pipe = _mesh_pipeline(mesh=mesh)
        COLLECTIVES.reset()
        launches = lb.KERNEL.launches
        out[name] = [tuple(t.cpu() for t in
                           pipe.step_chunk(frames[:, c:c + 2]))
                     for c in (0, 2)]
        out[name + "_counts"] = (COLLECTIVES.count,
                                 lb.KERNEL.launches - launches)
    out["device"] = str(device)
    return out


def test_stream_mesh_of_one_nccl_rank_equals_the_single_device(cuda):
    """A world of one rank on the card (NCCL): the mesh pipelines' outputs
    bitwise the single-device pipeline's in f32; one gather and one
    letterbox launch a dispatch."""
    from aicamera_tpu_torch.parallel import distributed
    [out] = distributed.spawn(_nccl_rank, 1, timeout=180.0)
    assert out["backend"] == "nccl" and out["device"] == "cuda:0"
    pipe = _mesh_pipeline(device="cuda")
    frames = _mesh_frames()
    want = [tuple(t.cpu() for t in pipe.step_chunk(frames[:, c:c + 2]))
            for c in (0, 2)]
    for name in ("stream", "2d"):
        assert out[name + "_counts"] == (2, 2)
        for got, ref in zip(out[name], want):
            for a, b in zip(got, ref):
                assert torch.equal(a, b)
    assert want[-1][4].any()
