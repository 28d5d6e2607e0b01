"""Port: camera-motion compensation through the tracker cores and the
pipeline, against the JAX package.

The cores' scenario is the JAX package's own (``tests/test_gmc_tracking.py``):
a static world object filmed by an oscillating camera, which jumps ``PAN``
pixels every frame on the screen, a motion no constant-velocity Kalman
filter learns. The same camera estimates go into both packages' cores; the
pipelines estimate their own on a panning scene of moving rectangles."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from aicamera_tpu import config as jconfig  # noqa: E402
from aicamera_tpu.core import bytetrack as jbt  # noqa: E402
from aicamera_tpu.core import ocsort as joc  # noqa: E402
from aicamera_tpu.core import state as jstate  # noqa: E402
from aicamera_tpu.core import tracker as jtracker  # noqa: E402
from aicamera_tpu.ops import gmc as jg  # noqa: E402
from aicamera_tpu_torch import config  # noqa: E402
from aicamera_tpu_torch.core import bytetrack as tbt  # noqa: E402
from aicamera_tpu_torch.core import ocsort as toc  # noqa: E402
from aicamera_tpu_torch.core import state as tstate  # noqa: E402
from aicamera_tpu_torch.core import tracker as ttracker  # noqa: E402
from aicamera_tpu_torch.ops import gmc as tg  # noqa: E402
from aicamera_tpu_torch.runtime.pipeline import TrackingPipeline  # noqa: E402
from aicamera_tpu_torch.scenes import (_smooth_noise,  # noqa: E402
                                       panning_rectangles)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    PyTorch's thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


H, W = 256, 384
PAN = 28          # px per flip; the box is 40 px, so IoU drops to ~0.18
BOX = 40.0
N_FRAMES = 12


def _scene():
    """Frames of a textured world panned by an oscillating camera, the
    screen box of one static world object per frame, and the camera
    estimates (the port's; the first frame the identity)."""
    rng = np.random.RandomState(7)
    world = np.clip(np.round(128 + 40 * _smooth_noise(rng, H, W)), 0,
                    255).astype(np.uint8)[..., None].repeat(3, -1)
    frames, boxes = [], []
    pan = 0
    for _ in range(N_FRAMES):
        frames.append(np.roll(world, shift=pan, axis=1))
        x1, y1 = 150.0 + pan, 100.0
        boxes.append(np.array([x1, y1, x1 + BOX, y1 + BOX], np.float32))
        pan = PAN if pan == 0 else 0
    est = tg.GMCEstimator(device="cpu")
    affines = [tuple(v.numpy() for v in est.step(f)) for f in frames]
    return frames, boxes, affines


SCENE = _scene()


def _one_det(box, n):
    valid = np.zeros(n, bool)
    valid[0] = True
    xyxy = np.zeros((n, 4), np.float32)
    xyxy[0] = box
    return xyxy, np.full(n, 0.9, np.float32), np.zeros(n, np.int32), valid


def _tlwh(xyxy):
    return np.concatenate([xyxy[:, :2], xyxy[:, 2:] - xyxy[:, :2]], 1)


def _on_cpu(mod):
    """The port's constructors are told the CPU; JAX's take no device."""
    return ({"device": "cpu"} if mod.__name__.startswith("aicamera_tpu_torch")
            else {})


def _run_deepsort(pkg, use_gmc):
    core, st_mod, tracker, gmc_mod, arr = pkg
    p = st_mod.TrackerParams(max_tracks=16, max_detections=8, feature_dim=8,
                             n_init=2)
    s = st_mod.init_state(p, **_on_cpu(st_mod))
    outs = []
    for box, (a, t) in zip(SCENE[1], SCENE[2]):
        s = tracker.predict(s, p)
        if use_gmc:
            m, c = gmc_mod.warp_xyah_bank(s.mean, s.cov, arr(a), arr(t),
                                          s.active)
            s = s.replace(mean=m, cov=c)
        xyxy, score, cls, valid = _one_det(box, 8)
        d = st_mod.make_detections(_tlwh(xyxy), score, cls, valid=valid,
                                   params=p, **_on_cpu(st_mod))
        s = tracker.update(s, d, p)
        outs.append(tracker.get_outputs(s))
    return outs


def _run_bytetrack(pkg, use_gmc):
    core, _, _, _, arr = pkg
    p = core.ByteTrackParams(max_tracks=16, max_detections=8)
    s = core.init_state(p, **_on_cpu(core))
    outs = []
    for box, (a, t) in zip(SCENE[1], SCENE[2]):
        xyxy, score, cls, valid = _one_det(box, 8)
        d = core.make_detections(_tlwh(xyxy), score, cls, valid=valid,
                                 params=p, **_on_cpu(core))
        s = core.step(s, d, p, gmc=(arr(a), arr(t)) if use_gmc else None)
        outs.append(core.get_outputs(s))
    return outs


def _run_ocsort(pkg, use_gmc):
    core, _, _, _, arr = pkg
    p = core.OCSortParams(max_tracks=16, max_detections=8, min_hits=2)
    s = core.init_state(p, **_on_cpu(core))
    outs = []
    for box, (a, t) in zip(SCENE[1], SCENE[2]):
        xyxy, score, cls, valid = _one_det(box, 8)
        d = core.make_detections(xyxy, score, cls, valid=valid, params=p,
                                 **_on_cpu(core))
        s = core.step(s, d, p, gmc=(arr(a), arr(t)) if use_gmc else None)
        outs.append(core.get_outputs(s, p))
    return outs


PORT = {"deepsort": (None, tstate, ttracker, tg, torch.from_numpy),
        "bytetrack": (tbt, None, None, None, torch.from_numpy),
        "ocsort": (toc, None, None, None, torch.from_numpy)}
JAX = {"deepsort": (None, jstate, jtracker, jg, jnp.asarray),
       "bytetrack": (jbt, None, None, None, jnp.asarray),
       "ocsort": (joc, None, None, None, jnp.asarray)}
RUNNERS = {"deepsort": _run_deepsort, "bytetrack": _run_bytetrack,
           "ocsort": _run_ocsort}


def _tracks(outs):
    """Per frame: (integer box, id, class) of every emitted track."""
    frames = []
    for tlbr, ids, cls, _, mask in outs:
        tlbr, ids, cls, mask = (np.asarray(x) for x in (tlbr, ids, cls,
                                                        mask))
        frames.append([(tuple(int(round(float(v))) for v in b), int(i),
                        int(c)) for b, i, c in zip(tlbr[mask], ids[mask],
                                                   cls[mask])])
    return frames


@pytest.mark.parametrize("use_gmc", [True, False], ids=["gmc", "off"])
@pytest.mark.parametrize("core", sorted(RUNNERS))
def test_core_step_with_gmc_matches_jax(core, use_gmc):
    """The same camera estimates into both cores on the oscillating pan:
    ids, classes and integer boxes identical on every frame. With GMC one
    identity survives on most frames; without it the oscillation defeats
    the IoU gate (as the JAX package's own test asserts)."""
    ours = _tracks(RUNNERS[core](PORT[core], use_gmc))
    ref = _tracks(RUNNERS[core](JAX[core], use_gmc))
    assert ours == ref
    ids = [t[1] for f in ours for t in f]
    if use_gmc:
        assert len(set(ids)) == 1 and len(ids) >= N_FRAMES - 4, ids
    else:
        with_gmc = [t[1] for f in _tracks(RUNNERS[core](PORT[core], True))
                    for t in f]
        assert len(set(ids)) > 1 or len(ids) < len(with_gmc), ids


# the pipelines: test_torch_pipeline.py's sizes
FRAME_HW = (96, 128)
KW = dict(input_shape=(128, 128), max_reid_crops=4, chunk_size=2,
          synthetic_load=8, yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
          reid_weights=str(config.REID_SYNTHETIC_PATH))
SMALL = dict(max_tracks=16, max_detections=8, nn_budget=4, max_age=10,
             feature_dim=jconfig.REID_FEATURE_DIM)
CAP = dict(max_tracks=16, max_detections=8)
# tracker: (port keywords, JAX keywords); thresholds 0.4 so that the
# synthetic grid (conf 0.5) starts ByteTrack and OC-SORT tracks
PIPES = {
    "deepsort": (dict(tracker_params=tstate.TrackerParams(**SMALL)),
                 dict(tracker_params=jstate.TrackerParams(**SMALL))),
    "bytetrack": (dict(bytetrack_params=tbt.ByteTrackParams(
        track_thresh=0.4, **CAP)), dict(bytetrack_params=jbt.ByteTrackParams(
            track_thresh=0.4, **CAP))),
    "ocsort": (dict(ocsort_params=toc.OCSortParams(det_thresh=0.4, **CAP)),
               dict(ocsort_params=joc.OCSortParams(det_thresh=0.4, **CAP))),
}


def _pan_frames():
    return list(panning_rectangles(6, FRAME_HW, n_objects=3, seed=3,
                                   pan=8)[0])


@pytest.mark.parametrize("tracker", sorted(PIPES))
def test_pipeline_with_gmc_matches_jax(tracker):
    """``TrackingPipeline(gmc="affine")`` against the JAX pipeline on a
    panning scene, chunks of 2 (the frame before each chunk carried over):
    detections as in ``test_torch_pipeline.py``; track tuples identical,
    conf within 1e-4."""
    from aicamera_tpu.runtime.pipeline import TrackingPipeline as JaxPipeline
    ours_kw, jax_kw = PIPES[tracker]
    frames = _pan_frames()
    ours = list(TrackingPipeline(tracker=tracker, gmc="affine", device="cpu",
                                 **ours_kw, **KW).process_frames(
        iter(frames)))
    ref = list(JaxPipeline(tracker=tracker, gmc="affine", **jax_kw,
                           **KW).process_frames(iter(frames)))
    n_tracks = 0
    for a, b in zip(ours, ref, strict=True):
        assert len(a.det_boxes) == len(b.det_boxes), a.frame_index
        np.testing.assert_array_equal(a.det_labels, b.det_labels)
        np.testing.assert_allclose(a.det_boxes, b.det_boxes, atol=1e-3)
        assert [t[:6] for t in a.tracks] == [t[:6] for t in b.tracks], \
            a.frame_index
        for ta, tb in zip(a.tracks, b.tracks):
            assert ta[6] == pytest.approx(tb[6], abs=1e-4)
        n_tracks += len(a.tracks)
    assert n_tracks > 0


def test_pipeline_gmc_carries_the_previous_frame():
    """The frame before each chunk is the last valid frame of the one
    before; ``reset()`` clears it; the translation mode runs too."""
    frames = _pan_frames()[:5]
    pipe = TrackingPipeline(gmc="affine", device="cpu", scan_bucket=0,
                            tracker_params=tstate.TrackerParams(**SMALL),
                            **dict(KW, chunk_size=3))
    assert pipe.gmc_method == "affine"
    results = list(pipe.process_frames(iter(frames)))
    assert len(results) == 5
    np.testing.assert_array_equal(pipe._gmc_prev_frame.numpy(), frames[4])
    pipe.reset()
    assert pipe._gmc_prev_frame is None
    pipe2 = TrackingPipeline(gmc="translation", tracker="ocsort",
                             device="cpu", **KW)
    assert pipe2.gmc_method == "translation"
    assert pipe2.process_frame(frames[0]).frame_index == 0


def _blurred(seed, n):
    rng = np.random.RandomState(seed)
    return [np.clip(np.round(128 + 50 * _smooth_noise(rng, *FRAME_HW)), 0,
                    255).astype(np.uint8)[..., None].repeat(3, -1)
            for _ in range(n)]


def test_bucketed_scan_with_gmc_equals_full():
    """The warp is masked to active slots, so the bucketed scan under GMC
    gives outputs and a final state bitwise equal to the unbucketed run."""
    frames = _pan_frames()

    def run(bucket):
        pipe = TrackingPipeline(
            gmc="affine", scan_bucket=bucket, device="cpu",
            tracker_params=tstate.TrackerParams(
                max_tracks=64, max_detections=16, n_init=2, nn_budget=4),
            **dict(KW, chunk_size=3))
        outs = [r.tracks for r in pipe.process_frames(iter(frames))]
        return outs, pipe.state, dict(pipe.scan_stats)

    outs_b, state_b, stats = run(16)
    outs_f, state_f, _ = run(0)
    assert stats["small"] > 0, stats
    assert outs_b == outs_f and sum(map(len, outs_f)) > 0
    for f in dataclasses.fields(state_f):
        assert torch.equal(getattr(state_b, f.name),
                           getattr(state_f, f.name)), f.name


def test_pipeline_gmc_static_scene_matches_off():
    """On a still camera the estimate is the identity within rounding:
    GMC on and off give the same track ids on every frame."""
    frame = _blurred(3, 1)[0]
    frames = [frame.copy() for _ in range(6)]

    def run(gmc_mode):
        pipe = TrackingPipeline(
            gmc=gmc_mode, scan_bucket=0, device="cpu",
            tracker_params=tstate.TrackerParams(**SMALL),
            **dict(KW, chunk_size=3))
        return [sorted(t[4] for t in r.tracks)
                for r in pipe.process_frames(iter(frames))]

    off = run(False)
    assert off == run("affine") and sum(map(len, off)) > 0


def test_strongsort_preset_defaults_to_affine():
    """As the JAX preset: unset (``False``/``None``) means ``"affine"``; an
    explicit choice wins."""
    from aicamera_tpu.runtime.pipeline import TrackingPipeline as JaxPipeline
    for gmc, method in ((False, "affine"), (None, "affine"),
                        ("translation", "translation"), ("off", None)):
        ours = TrackingPipeline(tracker="strongsort", gmc=gmc, device="cpu",
                                **KW)
        assert ours.gmc_method == method
        assert ours.tracker_params.ema_alpha == 0.9
        assert ours.tracker_params.nsa
    ref = JaxPipeline(tracker="strongsort", **KW)
    assert ref.gmc_method == "affine"
