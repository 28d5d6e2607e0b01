"""Port: ``parallel.MultiStreamPipeline`` on the CPU against the JAX
``MultiStreamPipeline``, and the port's own invariants.

Sizes: S=2 streams of 96x128 frames, detector input 128x128, T=16 track
slots, N=8 detection slots, 4 ReID crops, the committed synthetic weights;
each stream is a seeded scene of moving rectangles (a panning one for GMC).

Tolerances (those of ``tests/test_torch_pipeline.py``): track ids, classes,
masks and the integer (rounded) boxes exact; output boxes within 1e-3 px
and conf within 1e-5 (the two packages' f32 convolution stacks round
differently, and the tracker carries the difference); state fields: integer
and boolean ones exact, appearance features within 1e-4, every other float
(Kalman means and covariances, boxes, scores) within 1e-3 or 1e-4 relative.
The port's own invariants
(identical streams, a stream alone, the bucketed scan, a masked stream) are
bitwise.
"""

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
from aicamera_tpu_torch.core.state import TrackerParams  # noqa: E402
from aicamera_tpu_torch.parallel import (MultiStreamPipeline,  # noqa: E402
                                         make_mesh, make_stream_mesh)
from aicamera_tpu_torch.runtime import checkpoint  # noqa: E402
from aicamera_tpu_torch.runtime.pipeline import TrackingPipeline  # noqa: E402
from aicamera_tpu_torch.scenes import (moving_rectangles,  # noqa: E402
                                       panning_rectangles)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    PyTorch's thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S = 2
FRAME_HW = (96, 128)
SMALL = dict(max_tracks=16, max_detections=8, nn_budget=4, max_age=10,
             feature_dim=jconfig.REID_FEATURE_DIM)
KW = dict(n_streams=S, frame_hw=FRAME_HW, input_shape=(128, 128),
          max_reid_crops=4, yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
          reid_weights=str(config.REID_SYNTHETIC_PATH))
CAP = dict(max_tracks=16, max_detections=8)
# tracker: (port keywords, JAX keywords); the detector's rectangles score
# above 0.4, so thresholds of 0.4 start ByteTrack and OC-SORT tracks
TRACKERS = {
    "deepsort": (dict(tracker_params=TrackerParams(**SMALL)),
                 dict(tracker_params=jstate.TrackerParams(**SMALL))),
    "bytetrack": (dict(tracker="bytetrack",
                       bytetrack_params=tbt.ByteTrackParams(
                           track_thresh=0.4, **CAP)),
                  dict(tracker="bytetrack",
                       bytetrack_params=jbt.ByteTrackParams(
                           track_thresh=0.4, **CAP))),
    "ocsort": (dict(tracker="ocsort",
                    ocsort_params=toc.OCSortParams(det_thresh=0.4, **CAP)),
               dict(tracker="ocsort",
                    ocsort_params=joc.OCSortParams(det_thresh=0.4, **CAP))),
}
# the StrongSORT preset's EMA bank and NSA at the small capacities; its
# camera-motion compensation defaults to affine
STRONG = dict(SMALL, nn_budget=1, ema_alpha=0.9, nsa=True)
GMC = (dict(tracker="strongsort", tracker_params=TrackerParams(**STRONG)),
       dict(tracker="strongsort",
            tracker_params=jstate.TrackerParams(**STRONG)))


def _scenes(n=6):
    """(S, n, H, W, 3): each stream a different seeded scene."""
    return np.stack([moving_rectangles(n, FRAME_HW, n_objects=3, seed=s)
                     for s in (3, 5)])


def _pan_scenes(n=4):
    return np.stack([panning_rectangles(n, FRAME_HW, n_objects=3, seed=s,
                                        pan=8)[0] for s in (3, 5)])


MASK = np.array([[True, False], [False, False]])  # stream 1 fully masked

# the deepsort sequence: (name, call(pipe, frames))
SEQUENCE = (
    ("chunk", lambda p, f: p.step_chunk(f[:, 0:2])),
    ("masked", lambda p, f: p.step_chunk(f[:, 2:4], frame_valid=MASK)),
    ("step", lambda p, f: p.step(f[:, 4])),
    ("reset_stream", lambda p, f: (p.reset_stream(1),
                                   p.step_chunk(f[:, 4:6]))[1]),
)


def _host(tree):
    """Outputs (a tuple) or a state (a dataclass) as numpy."""
    if isinstance(tree, tuple):
        return tuple(np.asarray(a.numpy() if torch.is_tensor(a) else a)
                     for a in tree)
    return {f.name: None if getattr(tree, f.name) is None
            else np.asarray(getattr(tree, f.name).numpy()
                            if torch.is_tensor(getattr(tree, f.name))
                            else getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def _run(pipe, frames, calls):
    """Each call's outputs and the states after it, on the host."""
    out = []
    for call in calls:
        outs = call(pipe, frames)
        out.append((_host(tuple(outs)), _host(pipe.states)))
    return out


def _jax_pipe(**kw):
    from aicamera_tpu.parallel import MultiStreamPipeline as JaxMulti
    return JaxMulti(**KW, **kw)


@pytest.fixture(scope="module")
def deepsort_runs():
    frames = _scenes()
    calls = [c for _, c in SEQUENCE]
    ours = _run(MultiStreamPipeline(device="cpu", **KW,
                                    **TRACKERS["deepsort"][0]),
                frames, calls)
    ref = _run(_jax_pipe(**TRACKERS["deepsort"][1]), frames, calls)
    return ours, ref


# appearance features (unit vectors); every other float field (Kalman
# means and covariances, boxes, scores) within 1e-3 or 1e-4 relative
FEATURE_FIELDS = ("gallery", "emb")


def _assert_outputs_match(ours, ref):
    tlbr, ids, cls, conf, mask = ours
    r_tlbr, r_ids, r_cls, r_conf, r_mask = ref
    np.testing.assert_array_equal(mask, r_mask)
    np.testing.assert_array_equal(ids, r_ids)
    np.testing.assert_array_equal(cls, r_cls)
    np.testing.assert_array_equal(np.round(tlbr[mask]), np.round(
        r_tlbr[r_mask]))
    np.testing.assert_allclose(tlbr, r_tlbr, atol=1e-3)
    np.testing.assert_allclose(conf, r_conf, atol=1e-5)


def _assert_states_match(ours, ref):
    assert ours.keys() == ref.keys()
    for name, a in ours.items():
        b = ref[name]
        assert (a is None) == (b is None), name
        if a is None:
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype.kind == "f":
            tol = (dict(atol=1e-4) if name in FEATURE_FIELDS
                   else dict(rtol=1e-4, atol=1e-3))
            np.testing.assert_allclose(a, b, err_msg=name, **tol)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("i", range(len(SEQUENCE)),
                         ids=[n for n, _ in SEQUENCE])
def test_deepsort_matches_jax(deepsort_runs, i):
    """The DeepSORT core through ``step_chunk``, a masked ``step_chunk``,
    ``step`` and ``reset_stream`` + ``step_chunk``: every output and every
    state field after each call against the JAX pipeline's."""
    ours, ref = deepsort_runs
    _assert_outputs_match(ours[i][0], ref[i][0])
    _assert_states_match(ours[i][1], ref[i][1])
    if i == len(SEQUENCE) - 1:
        assert ours[i][0][4].any(), "no track emitted"


def test_masked_stream_state_is_bitwise_unchanged(deepsort_runs):
    """The masked call: stream 1 (every frame masked) keeps its state bit
    for bit; stream 0 advanced one frame."""
    ours, _ = deepsort_runs
    before, after = ours[0][1], ours[1][1]
    for name, a in before.items():
        np.testing.assert_array_equal(a[1], after[name][1], err_msg=name)
    assert (after["age"][0] != before["age"][0]).any() \
        or int(after["next_id"][0]) > int(before["next_id"][0])


@pytest.mark.parametrize("tracker", ["bytetrack", "ocsort"])
def test_motion_cores_match_jax(tracker):
    """ByteTrack and OC-SORT: two chunks of two frames, outputs and states
    against the JAX pipeline's; tracks must be emitted."""
    frames = _scenes(4)
    calls = [lambda p, f: p.step_chunk(f[:, 0:2]),
             lambda p, f: p.step_chunk(f[:, 2:4])]
    ours_kw, jax_kw = TRACKERS[tracker]
    ours = _run(MultiStreamPipeline(device="cpu", **KW, **ours_kw), frames,
                calls)
    ref = _run(_jax_pipe(**jax_kw), frames, calls)
    for (o_out, o_st), (r_out, r_st) in zip(ours, ref):
        _assert_outputs_match(o_out, r_out)
        _assert_states_match(o_st, r_st)
    assert ours[-1][0][4].any(), "no track emitted"


def test_gmc_matches_jax():
    """The StrongSORT preset (EMA bank, NSA, affine GMC by default) on a
    panning scene: two chunks, the second with stream 1's last frame
    masked, so that the frame carried into the next dispatch is the last
    valid one; then a third chunk that uses it."""
    frames = _pan_scenes(6)
    every = np.ones((S, 2), bool)   # one masked program for all three
    mask = np.array([[True, True], [True, False]])
    calls = [lambda p, f: p.step_chunk(f[:, 0:2], frame_valid=every),
             lambda p, f: p.step_chunk(f[:, 2:4], frame_valid=mask),
             lambda p, f: p.step_chunk(f[:, 4:6], frame_valid=every)]
    ours_pipe = MultiStreamPipeline(device="cpu", **KW, **GMC[0])
    assert ours_pipe.gmc_method == "affine"
    ours = _run(ours_pipe, frames, calls)
    np.testing.assert_array_equal(ours_pipe._gmc_prev.numpy(),
                                  frames[:, 5])
    ref = _run(_jax_pipe(**GMC[1]), frames, calls)
    for (o_out, o_st), (r_out, r_st) in zip(ours, ref):
        _assert_outputs_match(o_out, r_out)
        _assert_states_match(o_st, r_st)
    assert ours[-1][0][4].any(), "no track emitted"


def test_released_slot_keeps_the_old_tenants_gmc_frame():
    """``reset_stream`` resets only the tracker state, as JAX's does
    (``parallel/multistream.py::reset_stream``): the stream's carried GMC
    frame stays the old tenant's, so the new tenant's first warp is taken
    against the old tenant's last frame. Port against JAX; parity keeps the
    behaviour (``ROADMAP.md`` Queue C)."""
    old = _pan_scenes(2)
    new = np.stack([_pan_scenes(4)[0, 2:4],
                    moving_rectangles(2, FRAME_HW, n_objects=3, seed=9)])
    every = np.ones((S, 2), bool)
    runs = []
    for pipe in (MultiStreamPipeline(device="cpu", **KW, **GMC[0]),
                 _jax_pipe(**GMC[1])):
        pipe.step_chunk(old, frame_valid=every)
        pipe.reset_stream(1)
        np.testing.assert_array_equal(np.asarray(pipe._gmc_prev[1]),
                                      old[1, -1])
        outs = pipe.step_chunk(new, frame_valid=every)
        runs.append((_host(tuple(outs)), _host(pipe.states)))
    (o_out, o_st), (r_out, r_st) = runs
    _assert_outputs_match(o_out, r_out)
    _assert_states_match(o_st, r_st)
    assert o_st["next_id"][1] > 1   # the new tenant's tracks started


# --- the port's own invariants (no JAX) ------------------------------------

ALL_TRACKERS = {
    **{k: v[0] for k, v in TRACKERS.items()},
    "botsort": dict(tracker="botsort", bytetrack_params=tbt.ByteTrackParams(
        track_thresh=0.4, with_appearance=True, **CAP)),
    "deepocsort": dict(tracker="deepocsort", ocsort_params=toc.OCSortParams(
        det_thresh=0.4, with_appearance=True, **CAP)),
    "strongsort": GMC[0],
}


def _single_stream_pipeline(**kw):
    single = {k: v for k, v in dict(KW, **kw).items()
              if k not in ("n_streams", "frame_hw")}
    return TrackingPipeline(chunk_size=2, device="cpu", **single)


@pytest.mark.parametrize("tracker", sorted(ALL_TRACKERS))
def test_each_stream_equals_a_single_stream_pipeline(tracker):
    """Every stream of a dispatch equals a ``TrackingPipeline`` run on that
    stream's frames alone (chunk 2, the same stages): track tuples and the
    final state bitwise. Stream 1's frames go in a frame at a time, masked
    in the other lane, for the single pipeline's padded chunks."""
    kw = ALL_TRACKERS[tracker]
    frames = _pan_scenes(4) if tracker == "strongsort" else _scenes(4)
    pipe = MultiStreamPipeline(device="cpu", **KW, **kw)
    outs = [pipe.step_chunk(frames[:, :2]),
            pipe.step_chunk(frames[:, 2:4])]
    from aicamera_tpu_torch.runtime.pipeline import _format_tracks
    n_tracks = 0
    for si in range(S):
        single = _single_stream_pipeline(**kw)
        ref = list(single.process_frames(iter(frames[si])))
        got = [_format_tracks(*(o[si, t].numpy() for o in outs[c]))
               for c in range(2) for t in range(2)]
        assert got == [r.tracks for r in ref], si
        n_tracks += sum(map(len, got))
        for f in dataclasses.fields(single.state):
            a = getattr(pipe.states, f.name)
            if a is not None:
                assert torch.equal(a[si], getattr(single.state, f.name)), \
                    f.name
    assert n_tracks > 0


@pytest.mark.parametrize("tracker", ["deepsort", "bytetrack", "ocsort"])
def test_identical_streams_give_identical_outputs(tracker):
    one = _scenes(4)[0]
    frames = np.stack([one, one])
    pipe = MultiStreamPipeline(device="cpu", **KW, **ALL_TRACKERS[tracker])
    for c in range(2):
        for a in pipe.step_chunk(frames[:, 2 * c:2 * c + 2]):
            assert torch.equal(a[0], a[1])
    st = pipe.states
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if v is not None:
            assert torch.equal(v[0], v[1]), f.name


def test_scan_bucket_32_equals_0():
    """The capacity-bucketed scan, decided once a dispatch for the stream
    stack, against the unbucketed one at T=64: outputs and states bitwise;
    the small pass ran."""
    tp = TrackerParams(**dict(SMALL, max_tracks=64))
    frames = _scenes(4)
    runs = {}
    for bucket in (32, 0):
        pipe = MultiStreamPipeline(device="cpu", scan_bucket=bucket,
                                   tracker_params=tp, **KW)
        outs = [pipe.step_chunk(frames[:, :2]),
                pipe.step_chunk(frames[:, 2:], frame_valid=MASK)]
        runs[bucket] = (outs, pipe.states, dict(pipe.scan_stats))
    assert runs[32][2]["small"] > 0 and not any(runs[0][2].values())
    for a, b in zip(runs[32][0], runs[0][0]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    for f in dataclasses.fields(runs[0][1]):
        assert torch.equal(getattr(runs[32][1], f.name),
                           getattr(runs[0][1], f.name)), f.name


def test_eager_stack_equals_the_captured_stack(monkeypatch):
    """The stream stack stepped frame by frame on the host (no capture: a
    frame no stream takes is skipped, one some take steps the stack and
    keeps the others') equals the captured scan's masked steps bitwise."""
    frames = _scenes(4)
    runs = []
    for capture in (True, False):
        monkeypatch.setattr(TrackingPipeline, "_capture_scans", capture)
        pipe = MultiStreamPipeline(device="cpu", **KW,
                                   **TRACKERS["deepsort"][0])
        assert pipe.stacked
        outs = [pipe.step_chunk(frames[:, :2]),
                pipe.step_chunk(frames[:, 2:], frame_valid=MASK)]
        runs.append((outs, pipe.states))
    (o_cap, st_cap), (o_eag, st_eag) = runs
    for a, b in zip(o_cap, o_eag):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    for f in dataclasses.fields(st_cap):
        assert torch.equal(getattr(st_cap, f.name), getattr(st_eag, f.name))


def test_states_assign_and_checkpoint_round_trip(tmp_path):
    """``states`` stacks into the JAX layout; a stacked checkpoint assigned
    to a fresh pipeline goes on exactly as the original."""
    frames = _scenes(4)
    a = MultiStreamPipeline(device="cpu", **KW, **TRACKERS["deepsort"][0])
    a.step_chunk(frames[:, :2])
    path = tmp_path / "streams.msgpack"
    checkpoint.save_state(path, a.states)
    b = MultiStreamPipeline(device="cpu", **KW, **TRACKERS["deepsort"][0])
    b.states = checkpoint.load_state(path, b.core_params, n_streams=S,
                                     device="cpu")
    for x, y in zip(a.step_chunk(frames[:, 2:]), b.step_chunk(frames[:, 2:])):
        assert torch.equal(x, y)
    assert int(b.states.next_id[0]) > 1
    with pytest.raises(ValueError, match="field"):
        b.states = checkpoint.load_state(path, b.core_params, n_streams=S,
                                         device="cpu").replace(
            next_id=torch.ones(S + 1, dtype=torch.int32))
    with pytest.raises(TypeError):
        b.states = tbt.init_state(tbt.ByteTrackParams(**CAP), device="cpu")


def test_step_chunk_checks_its_inputs():
    pipe = MultiStreamPipeline(device="cpu", **KW, **TRACKERS["bytetrack"][0])
    frames = _scenes(2)
    with pytest.raises(ValueError, match="frames"):
        pipe.step_chunk(frames[:1])
    with pytest.raises(ValueError, match="frames"):
        pipe.step_chunk(frames[:, :, :64])
    with pytest.raises(ValueError, match="frame_valid"):
        pipe.step_chunk(frames, frame_valid=np.ones((S, 3), bool))


@pytest.mark.parametrize("kw", [
    dict(tracker="nope"),
    dict(bytetrack_params=jbt.ByteTrackParams()),
    dict(ocsort_params=joc.OCSortParams()),
    dict(tracker="bytetrack",
         bytetrack_params=jbt.ByteTrackParams(with_appearance=True)),
    dict(gmc="rotation"),
    dict(scan_bucket=-1),
], ids=lambda kw: "-".join(f"{k}" for k in kw))
def test_argument_validation_raises_as_jax(kw):
    """The argument checks of the JAX constructor
    (``tests/test_parallel.py``): the same exception type and message."""
    from aicamera_tpu.parallel import MultiStreamPipeline as JaxMulti
    ours_kw = {k: (tbt.ByteTrackParams(**dataclasses.asdict(v))
                   if isinstance(v, jbt.ByteTrackParams)
                   else toc.OCSortParams(**dataclasses.asdict(v))
                   if isinstance(v, joc.OCSortParams) else v)
               for k, v in kw.items()}
    with pytest.raises(ValueError) as ref:
        JaxMulti(n_streams=S, frame_hw=FRAME_HW, **kw)
    with pytest.raises(ValueError) as e:
        MultiStreamPipeline(n_streams=S, frame_hw=FRAME_HW, device="cpu",
                            **ours_kw)
    assert str(e.value) == str(ref.value)


def _stream_mesh_world(rank, device):
    """A rank of a 2-rank world: the two streams on make_stream_mesh()."""
    torch.set_num_threads(1)
    pipe = MultiStreamPipeline(mesh=make_stream_mesh(), device="cpu", **KW,
                               **TRACKERS["deepsort"][0])
    frames = _scenes(4)
    return [_host(tuple(pipe.step_chunk(frames[:, c:c + 2])))
            for c in (0, 2)], _host(pipe.states)


def test_unported_options_raise():
    """The mesh options, once not ported, run: the two streams on a
    2-rank stream mesh (gloo ranks on the CPU) give every rank the
    single-device pipeline's outputs and states. Without a world the
    meshes still raise, naming the launcher."""
    from aicamera_tpu_torch.parallel import distributed
    with pytest.raises(RuntimeError, match="spawn"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="spawn"):
        make_stream_mesh()
    single = MultiStreamPipeline(device="cpu", **KW,
                                 **TRACKERS["deepsort"][0])
    frames = _scenes(4)
    want = [_host(tuple(single.step_chunk(frames[:, c:c + 2])))
            for c in (0, 2)]
    want_states = _host(single.states)
    for outs, states in distributed.spawn(_stream_mesh_world, 2,
                                          device="cpu", timeout=120.0):
        for got, ref in zip(outs, want):
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a, b)
        for name, a in states.items():
            if a is not None:
                np.testing.assert_array_equal(a, want_states[name], name)


def test_entry_point_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU error cannot be shown")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiStreamPipeline(n_streams=S, frame_hw=FRAME_HW)
