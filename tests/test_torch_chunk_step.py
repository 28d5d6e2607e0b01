"""Port: the chunk step as one function of tensors
(``runtime/pipeline.py::TrackingPipeline._make_step``), the JAX package's
jitted step, its branches decided by ``runtime/branches.py`` (on the CPU by
a counted read; on the card by CUDA-graph conditional nodes,
``tests/test_torch_cuda.py``).

- the decisions equal the JAX package's expressions on the same seeded
  arrays: the ReID bucket index at every bucket boundary, ``fits`` and
  ``use_full`` for one stream and for a stack;
- the step equals the JAX pipeline (``_make_chunk_step``) for DeepSORT,
  ByteTrack, OC-SORT and StrongSORT with GMC: track tuples exact, conf
  within 1e-5, detections within 1e-4 px;
- every branch body writes only into buffers allocated before the branch:
  with the unchosen bodies run first, the step's outputs and state are
  bitwise the same, over chunks that take the small, skipped and rerun
  ways and several ReID buckets;
- chunk by chunk, the step takes the eager step's decisions.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from aicamera_tpu.core import bytetrack as jbt  # noqa: E402
from aicamera_tpu.core import ocsort as joc  # noqa: E402
from aicamera_tpu.core import state as jstate  # noqa: E402
from aicamera_tpu_torch import config  # noqa: E402
from aicamera_tpu_torch.core import bytetrack as tbt  # noqa: E402
from aicamera_tpu_torch.core import ocsort as toc  # noqa: E402
from aicamera_tpu_torch.core import state as tstate  # noqa: E402
from aicamera_tpu_torch.runtime import branches  # noqa: E402
from aicamera_tpu_torch.runtime import pipeline as pl  # noqa: E402
from aicamera_tpu_torch.scenes import panning_rectangles  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    PyTorch's thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_bucket_index(d_valid, buckets, n_crops):
    """``aicamera_tpu/runtime/pipeline.py:607, 628``."""
    n_needed = jnp.max(jnp.sum(d_valid[:, :n_crops], axis=1))
    return int(sum(jnp.int32(n_needed > b) for b in buckets[:-1]))


@pytest.mark.parametrize("n_crops", [32, 20])
def test_reid_bucket_index_equals_jax(n_crops):
    """Every load 0..n_crops (the busiest of 4 frames) and the boundaries
    of every bucket: the device index equals the JAX expression."""
    buckets = [0] + [b for b in (4, 8, 12, 16, 24) if b < n_crops] \
        + [n_crops]
    rng = np.random.RandomState(0)
    for n_needed in range(n_crops + 1):
        d_valid = np.zeros((4, 64), bool)
        d_valid[rng.randint(4), :n_needed] = True
        for f in range(4):       # other frames: no busier than n_needed
            d_valid[f, :rng.randint(n_needed + 1)] = True
        d_valid[:, n_crops:] = rng.rand(4, 64 - n_crops) < 0.5
        got = pl.reid_bucket_index(torch.from_numpy(d_valid), buckets,
                                   n_crops)
        assert got.dtype == torch.int32 and got.shape == ()
        assert int(got) == _jax_bucket_index(jnp.asarray(d_valid), buckets,
                                             n_crops), n_needed


def _active(t, n, high=False, s=None, seed=0):
    """Seeded active masks: ``n`` live slots among the first 16 (one
    stream, or each of ``s``), one more at slot 20 if ``high``."""
    rng = np.random.RandomState(seed)
    shape = (t,) if s is None else (s, t)
    act = np.zeros(shape, bool)
    for row in act.reshape(-1, t):
        row[rng.permutation(16)[:n]] = True
        if high:
            row[20] = True
    return act


@pytest.mark.parametrize("streams", [None, 3])
def test_scan_decisions_equal_jax(streams):
    """``fits`` on states built for the small pass (loads within the
    headroom) and for the skip (at the headroom's edge, or a live slot past
    the small table), and ``use_full`` on candidate ``dropped`` counts that
    grew (the overflow, the skip's ``+ 1``) or did not: the device's bools
    equal the JAX package's (one stream ``aicamera_tpu/runtime/pipeline.
    py:106-113``, a stack ``aicamera_tpu/parallel/multistream.py:620-
    626``)."""
    t, t_small = 32, 16
    headroom = max(4, t_small // 4)
    for n, high, want in ((0, False, True), (5, False, True),
                          (12, False, True), (13, False, False),
                          (3, True, False)):
        act = _active(t, n, high, streams)
        got = pl.bucket_fits(torch.from_numpy(act), t_small)
        a = jnp.asarray(act)
        if streams is None:
            ref = (~jnp.any(a[t_small:])
                   & (jnp.sum(a) <= t_small - headroom))
        else:
            ref = (~jnp.any(a[:, t_small:])
                   & (jnp.max(jnp.sum(a, axis=1)) <= t_small - headroom))
        assert bool(got) == bool(ref) == want, (n, high)
    rng = np.random.RandomState(1)
    shape = () if streams is None else (streams,)
    for grow in (0, 1, 3):
        dropped = rng.randint(0, 5, shape).astype(np.int32)
        cand = dropped + (grow if streams is None else
                          np.eye(streams, dtype=np.int32)[0] * grow)
        got = pl.bucket_rerun(torch.from_numpy(np.asarray(cand)),
                              torch.from_numpy(np.asarray(dropped)))
        ref = (jnp.asarray(cand) > jnp.asarray(dropped)) if streams is None \
            else jnp.sum(jnp.asarray(cand)) > jnp.sum(jnp.asarray(dropped))
        assert bool(got) == bool(ref) == (grow > 0)


# --- the step against the JAX pipeline ---------------------------------------

FRAME_HW = (96, 128)
KW = dict(input_shape=(128, 128), chunk_size=2, max_reid_crops=4,
          synthetic_load=6, scan_bucket=8,
          yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
          reid_weights=str(config.REID_SYNTHETIC_PATH))
_SLOTS = dict(max_tracks=16, max_detections=8)
_DEEP = dict(_SLOTS, nn_budget=2, max_age=6, n_init=2,
             feature_dim=config.REID_FEATURE_DIM)
_STRONG = dict(_DEEP, nn_budget=1, ema_alpha=0.9, nsa=True)
# tracker -> (port keywords, JAX keywords)
TRACKERS = {
    "deepsort": (dict(tracker_params=tstate.TrackerParams(**_DEEP)),
                 dict(tracker_params=jstate.TrackerParams(**_DEEP))),
    "bytetrack": (
        dict(bytetrack_params=tbt.ByteTrackParams(track_thresh=0.4,
                                                  **_SLOTS)),
        dict(bytetrack_params=jbt.ByteTrackParams(track_thresh=0.4,
                                                  **_SLOTS))),
    "ocsort": (
        dict(ocsort_params=toc.OCSortParams(det_thresh=0.4, **_SLOTS)),
        dict(ocsort_params=joc.OCSortParams(det_thresh=0.4, **_SLOTS))),
    "strongsort": (dict(tracker_params=tstate.TrackerParams(**_STRONG)),
                   dict(tracker_params=jstate.TrackerParams(**_STRONG))),
}


def _frames(n=5):
    return list(panning_rectangles(n, FRAME_HW, n_objects=3, seed=3,
                                   pan=8)[0])


@pytest.mark.parametrize("tracker", sorted(TRACKERS))
def test_step_matches_jax(tracker):
    """The one-function step (StrongSORT with its preset's GMC) against the
    JAX pipeline's ``_make_chunk_step`` on the same frames, two full
    chunks and a partial one: track tuples identical, conf within 1e-5;
    detections within 1e-4 px and conf 1e-5."""
    from aicamera_tpu.runtime.pipeline import TrackingPipeline as Jax
    ours_kw, jax_kw = TRACKERS[tracker]
    frames = _frames()
    pipe = pl.TrackingPipeline(tracker=tracker, device="cpu", **ours_kw,
                               **KW)
    ours = list(pipe.process_frames(iter(frames)))
    assert list(pipe._steps) and not pipe._stages
    assert (pipe.gmc_method == "affine") == (tracker == "strongsort")
    ref = list(Jax(tracker=tracker, **jax_kw, **KW).process_frames(
        iter(frames)))
    assert sum(len(r.tracks) for r in ref) > 0
    for a, b in zip(ours, ref, strict=True):
        assert [t[:6] for t in a.tracks] == [t[:6] for t in b.tracks]
        for ta, tb in zip(a.tracks, b.tracks):
            assert ta[6] == pytest.approx(tb[6], abs=1e-5)
        np.testing.assert_allclose(a.det_boxes, b.det_boxes, atol=1e-4)
        np.testing.assert_allclose(a.det_scores, b.det_scores, atol=1e-5)
        np.testing.assert_array_equal(a.det_labels, b.det_labels)


# --- the branch bodies --------------------------------------------------------

# (tracker keywords, scan_bucket, synthetic load, the ways the chunks take):
# test_torch_scan_bucket.py's paths, at 4 frames a chunk over 3 chunks
_BIG = dict(max_tracks=64, max_detections=16, nn_budget=4, max_age=10,
            n_init=2, feature_dim=config.REID_FEATURE_DIM)
PATHS = {
    "small": (16, 6, dict(small=3, skipped=0, rerun=0)),
    "overflow": (4, 8, dict(small=0, skipped=2, rerun=1)),
}


def _noise(n):
    rng = np.random.RandomState(0)
    return rng.randint(0, 255, (n, *FRAME_HW, 3), np.uint8)


def _run(bucket, load, max_reid_crops=8, every=False, capture=True,
         chunks=3):
    pipe = pl.TrackingPipeline(
        chunk_size=4, input_shape=(128, 128), max_reid_crops=max_reid_crops,
        synthetic_load=load, scan_bucket=bucket, device="cpu",
        tracker_params=tstate.TrackerParams(**_BIG),
        yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
        reid_weights=str(config.REID_SYNTHETIC_PATH))
    pipe._capture_step = capture
    steps = []
    with branches.every_body() if every else _nothing():
        for c, chunk in enumerate(np.split(_noise(4 * chunks), chunks)):
            res = list(pipe.process_chunks(iter([chunk])))
            steps.append((res, dict(pipe.scan_stats),
                          dict(pipe.reid_buckets)))
    return pipe, steps


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("path", sorted(PATHS))
def test_every_body_writes_only_its_buffers(path):
    """With every unchosen body run before the chosen one (the ReID
    bucket's switch and both scan conds), the step's detections, tracks,
    ways, buckets and final state are bitwise those of the chosen bodies
    alone, over chunks that take the small, the skipped and the rerun way
    and two ReID buckets."""
    bucket, load, ways = PATHS[path]
    a, steps_a = _run(bucket, load)
    b, steps_b = _run(bucket, load, every=True)
    assert a.scan_stats == b.scan_stats == ways
    assert a.reid_buckets == b.reid_buckets and a.reid_buckets
    for (ra, *da), (rb, *db) in zip(steps_a, steps_b, strict=True):
        assert da == db
        for x, y in zip(ra, rb, strict=True):
            assert x.tracks == y.tracks
            np.testing.assert_array_equal(x.det_boxes, y.det_boxes)
    assert sum(len(r.tracks) for res, *_ in steps_a for r in res) > 0
    for f in dataclasses.fields(a.state):
        assert torch.equal(getattr(a.state, f.name),
                           getattr(b.state, f.name)), f.name


def test_step_takes_the_eager_steps_decisions():
    """Chunk by chunk, the captured step's ways and ReID buckets (read from
    its decisions) are the eager step's (read by the host), and so are its
    tracks; the loads reach buckets 4 and 8 of ``max_reid_crops=8``."""
    bucket, load, _ = PATHS["overflow"]
    _, cap = _run(bucket, load)
    _, eager = _run(bucket, load, capture=False)
    for (rc, wc, bc), (re_, we, _) in zip(cap, eager, strict=True):
        assert wc == we
        assert [r.tracks for r in rc] == [r.tracks for r in re_]
    assert cap[-1][2] == {8: 3}
    _, light = _run(0, 3, chunks=1)
    assert light[-1][2] == {4: 1} and light[-1][1] == dict(
        small=0, skipped=0, rerun=0)
