"""Port: the pipeline's tracer, ``runtime.profiler.CudaStageTimer``.

On the CPU (the step is a direct call, and its stamps are the host's
clock): the stamps of every dispatch are monotone and its stages sum to its
entry-to-``tracker`` span, the host spans nest under ``dispatch`` and carry
their chunk's id, the outputs are bitwise the untimed pipeline's, and with
no timer the step's key and packed layout are the untimed ones. On the card
(``-m cuda``; this file imports no JAX, so on the GPU host:
``python -m pytest tests/test_torch_tracing.py -m cuda --noconftest -q -p
no:cacheprovider``): a replay's stamps are the device's clock, monotone and
nonzero, the stamped graph's node count is the unstamped one's, and the
captured path records its spans with no wait.

Sizes: 96x128 frames, detector input 128x128, chunks of 2, T=16 track
slots, N=8 detection slots, 4 ReID crops, the committed synthetic weights.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aicamera_tpu_torch import cli, config  # noqa: E402
from aicamera_tpu_torch.core import bytetrack as tbt  # noqa: E402
from aicamera_tpu_torch.core.state import TrackerParams  # noqa: E402
from aicamera_tpu_torch.parallel import MultiStreamPipeline  # noqa: E402
from aicamera_tpu_torch.runtime import pipeline as pl  # noqa: E402
from aicamera_tpu_torch.runtime.profiler import CudaStageTimer  # noqa: E402
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


FRAME_HW = (96, 128)
SMALL = dict(max_tracks=16, max_detections=8, nn_budget=4, max_age=10)
KW = dict(input_shape=(128, 128), max_reid_crops=4, chunk_size=2,
          synthetic_load=8, yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
          reid_weights=str(config.REID_SYNTHETIC_PATH))
STAGES = ["letterbox", "yolo", "nms", "crops_reid", "tracker"]


def _frames(n=8):
    # seed 3: three rectangles the committed detector finds at this size
    return moving_rectangles(n, FRAME_HW, n_objects=3, seed=3)


def _pipeline(device="cpu", **kw):
    return pl.TrackingPipeline(tracker_params=TrackerParams(**SMALL),
                               device=device, **dict(KW, **kw))


def _run(timer, frames, device="cpu", **kw):
    pipe = _pipeline(device, **kw)
    pipe.stage_timer = timer
    out = list(pipe.process_frames(iter(frames)))
    pipe.settle()
    return pipe, out


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.frame_index == y.frame_index
        assert x.tracks == y.tracks
        for f in ("det_boxes", "det_scores", "det_labels"):
            u, v = getattr(x, f), getattr(y, f)
            assert u.dtype == v.dtype and u.tobytes() == v.tobytes(), f


@pytest.fixture(scope="module")
def timed():
    """A timed run of 4 chunks (after the pipeline's warm-up) and an
    untimed one of the same frames."""
    frames = _frames()
    timer = CudaStageTimer()
    pipe = _pipeline()
    pipe.stage_timer = timer
    pipe.warm_up(FRAME_HW)
    out = list(pipe.process_frames(iter(frames)))
    pipe.settle()
    return pipe, timer, out, _run(None, frames)


@pytest.mark.parametrize("gmc", [False, "affine"])
def test_stamps_of_every_dispatch_are_monotone(gmc):
    frames = (panning_rectangles(8, FRAME_HW, n_objects=3, seed=3)[0] if gmc
              else _frames())
    timer = CudaStageTimer()
    _run(timer, frames, gmc=gmc)
    recs = timer.records()
    assert len(recs) == 4 and timer.chunks == 4
    names = (["gmc"] if gmc else []) + STAGES
    for rec in recs:
        assert list(rec["stages"]) == names
        assert all(ms >= 0 for ms in rec["stages"].values())
        assert rec["first"] <= rec["last"]
        assert rec["t0"] <= rec["first"] <= rec["last"] <= rec["t1"]
    for a, b in zip(recs, recs[1:]):
        assert a["last"] <= b["first"]
        assert b["gap"] == pytest.approx((b["first"] - a["last"]) * 1e-6)
    assert recs[0]["gap"] is None


def test_stage_durations_sum_to_the_entry_to_tracker_span(timed):
    _, timer, _, _ = timed
    recs = timer.records()
    assert recs
    for rec in recs:
        assert sum(rec["stages"].values()) == pytest.approx(
            (rec["last"] - rec["first"]) * 1e-6, abs=1e-6)
    s = timer.summary()
    assert s["chunks"] == len(recs)
    assert sum(s["stage_ms"].values()) == pytest.approx(
        np.mean([(r["last"] - r["first"]) * 1e-6 for r in recs]))


def test_host_spans_nest_under_dispatch_and_carry_the_chunk_id(timed):
    _, timer, _, _ = timed
    spans = timer.spans()
    disp = {d: (t0, t1) for name, t0, t1, d, _ in spans
            if name == "dispatch"}
    assert sorted(disp) == [r["id"] for r in timer.records()]
    for name, t0, t1, d, parent in spans:
        if name in ("upload.copy", "replay"):
            assert parent == "dispatch"
            assert disp[d][0] <= t0 <= t1 <= disp[d][1]
    # a chunk's outputs are waited for and formatted once each, under its
    # own id, after its dispatch
    for name in ("readback.wait", "readback.count", "emit"):
        ids = sorted(d for n, _, _, d, _ in spans if n == name)
        assert ids == sorted(disp), name
        for n, t0, _, d, parent in spans:
            if n == name:
                assert t0 >= disp[d][1]
                assert parent in (None, "dispatch")
    # the wait of a chunk read inside the next dispatch nests there
    inner = [(d, t0) for n, t0, _, d, p in spans
             if n == "readback.wait" and p == "dispatch"]
    for d, t0 in inner:
        assert disp[d + 1][0] <= t0 <= disp[d + 1][1]
    per = timer.summary()["span_ms"]
    assert {"dispatch", "upload.copy", "replay", "readback.wait",
            "readback.count", "emit"} <= set(per)


def test_outputs_are_bitwise_equal_with_and_without_a_timer(timed):
    pipe, _, out, (plain, plain_out) = timed
    _same(out, plain_out)
    for f in pipe.state.__dataclass_fields__:
        a, b = getattr(pipe.state, f), getattr(plain.state, f)
        if a is not None:
            assert torch.equal(a, b), f


def test_multistream_outputs_and_stamps_with_a_timer():
    kw = dict(n_streams=2, frame_hw=FRAME_HW, input_shape=(128, 128),
              tracker="bytetrack", yolo_weights=KW["yolo_weights"],
              reid_weights=KW["reid_weights"],
              bytetrack_params=tbt.ByteTrackParams(
                  track_thresh=0.4, max_tracks=16, max_detections=8),
              device="cpu")
    frames = np.stack([_frames(4), _frames(4)[::-1]])
    outs = []
    for timer in (None, CudaStageTimer()):
        pipe = MultiStreamPipeline(**kw)
        pipe.stage_timer = timer
        outs.append([pipe.step_chunk(frames[:, i:i + 2]) for i in (0, 2)])
        pipe.settle()
    for a, b in zip(*outs):
        for u, v in zip(a, b):
            assert torch.equal(u, v)
    recs = timer.records()
    assert [list(r["stages"]) for r in recs] == [STAGES] * 2
    assert all(r["slots"] == 0 for r in recs)   # no ReID stage
    assert "upload.copy" in recs[0]["spans"] \
        and "readback.wait" in recs[0]["spans"]


def test_without_a_timer_the_step_key_and_layout_are_the_untimed_ones(timed):
    timed_pipe, _, _, (plain, _) = timed
    (key, step), = plain._steps.items()
    assert key == (FRAME_HW, 2, None, plain.scan_bucket)
    assert step.stamps is None
    shape, dtype, _, words = step.layout.meta[-1]
    assert (shape, dtype, words) == ((3,), torch.int32, 3)
    stamped = timed_pipe._steps[key + ("stamped",)]
    assert stamped.stamps == ["entry"] + STAGES
    shape, _, _, words = stamped.layout.meta[-1]
    assert shape == (3 + 1 + 2 * pl._Stamps.SLOTS,) and words == shape[0]
    # every other output where the untimed step has it
    assert stamped.layout.meta[:-1] == step.layout.meta[:-1]


def test_crop_counts_and_the_timers_reset(timed):
    pipe, timer, _, _ = timed
    recs = timer.records()
    for rec in recs:
        assert 0 <= rec["crops"] <= rec["slots"]
        assert rec["slots"] % 2 == 0          # a bucket's slots, 2 frames
    assert timer.crops == [sum(r["crops"] for r in recs),
                           sum(r["slots"] for r in recs)]
    # the warm-up's chunks were cleared by its reset; the calibration kept
    assert len(recs) == 4 and timer.calibrations
    assert timer.summary()["clock"]["error_ns"] == 0


def test_span_api_nesting_callback_and_ring():
    seen = []
    timer = CudaStageTimer(on_span=lambda *a: seen.append(a))
    timer.KEEP = 2
    for _ in range(3):
        d = timer.open("dispatch")
        timer.open("upload.copy")
        timer.open("inner")           # left open: dropped with its parent
        timer.close("upload.copy")
        timer.close("dispatch")
        timer.open("emit", d)
        timer.close("emit")
    assert [r["id"] for r in timer.records()] == [1, 2]
    assert [n for n, _, _ in seen] == ["upload.copy", "dispatch",
                                       "emit"] * 3
    assert all(t0 <= t1 for _, t0, t1 in seen)
    names = [(n, d, p) for n, _, _, d, p in timer.spans()]
    assert names[:3] == [("upload.copy", 0, "dispatch"),
                         ("dispatch", 0, None), ("emit", 0, None)]
    assert timer.span_totals["dispatch"][1] == 3


def test_a_gap_goes_to_the_innermost_span_open_at_its_middle():
    timer = CudaStageTimer()
    timer.calibrate("cpu")
    d0 = timer.open("dispatch")
    timer.close("dispatch")
    t = time.time_ns()
    timer.arrive(d0, ["entry", "tracker"], [t - 2_000_000, t])
    d1 = timer.open("dispatch")
    timer.open("upload.copy")
    time.sleep(0.004)
    timer.close("upload.copy")
    timer.close("dispatch")
    copy = next(s for s in timer.spans() if s[0] == "upload.copy")
    # the gap from t to a first stamp 2 * (middle of the copy - t) later
    mid = (copy[1] + copy[2]) // 2
    timer.arrive(d1, ["entry", "tracker"], [2 * mid - t, 2 * mid - t + 10])
    rec = timer.records()[-1]
    assert rec["gap_at"] == "upload.copy"
    assert rec["gap"] == pytest.approx((2 * mid - 2 * t) * 1e-6)
    assert timer.summary()["gap_ms"] == {"upload.copy": rec["gap"]}
    # nothing of the program open there (a second on): the caller's time
    d2 = timer.open("dispatch")
    timer.close("dispatch")
    last = 2 * mid - t + 10
    timer.arrive(d2, ["entry", "tracker"], [last + 2 * 10 ** 9,
                                            last + 2 * 10 ** 9 + 10])
    assert timer.records()[-1]["gap_at"] == "caller"


def test_cli_profile_prints_the_timers_report(tmp_path, capsys):
    clip = tmp_path / "tiny.npy"
    np.save(clip, _frames(6))
    cli.main(["--input", str(clip), "--device", "cpu", "--no_save",
              "--input_shape", "128", "--chunk_size", "2",
              "--yolo_weights", KW["yolo_weights"],
              "--reid_weights", KW["reid_weights"], "--profile"])
    text = capsys.readouterr().out
    assert "stage ms a chunk (the step's stamps, 3 chunks): letterbox" \
        in text
    assert "host span ms a chunk (3 dispatches):" in text
    assert "step gap ms a chunk" in text
    assert "ReID crop slots holding a real crop:" in text


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the stamp kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_replay_stamps_are_monotone_and_nonzero(cuda):
    frames = _frames()
    timer = CudaStageTimer()
    pipe, out = _run(timer, frames, device=cuda)
    recs = [r for r in timer.records() if r["stages"] is not None]
    assert len(recs) == 4
    for rec in recs:
        assert rec["first"] > 0 and list(rec["stages"]) == STAGES
        assert all(ms >= 0 for ms in rec["stages"].values())
        assert 0 < sum(rec["stages"].values()) < 1e3
    for a, b in zip(recs, recs[1:]):
        assert a["last"] <= b["first"]
    # the device's clock put on the host's: within a second of it
    cal = timer.calibrations
    assert len(cal) >= 2 and all(0 <= e < 1e6 for _, _, e in cal)
    assert abs(recs[-1]["first"] - recs[-1]["t0"]) < 1e9
    # and the outputs are bitwise the untimed pipeline's
    _same(out, _run(None, frames, device=cuda)[1])


@pytest.mark.cuda
@pytest.mark.parametrize("streams", [None, 2])
def test_card_graph_nodes_equal_with_tracing_on_and_off(cuda, streams):
    nodes = {}
    for timer in (None, CudaStageTimer()):
        if streams is None:
            pipe = _pipeline(cuda)
            pipe.stage_timer = timer
            pipe.warm_up(FRAME_HW)
            steps = pipe._steps
        else:
            pipe = MultiStreamPipeline(
                n_streams=streams, frame_hw=FRAME_HW,
                tracker_params=TrackerParams(**SMALL), device=cuda,
                **{k: v for k, v in KW.items()
                   if k not in ("chunk_size", "synthetic_load")})
            pipe.stage_timer = timer
            pipe.step_chunk(np.zeros((streams, 2, *FRAME_HW, 3), np.uint8))
            steps = pipe._engine._steps
        (step,) = steps.values()
        nodes[timer is not None] = (step.engine.graph_nodes(),
                                    step.engine.aside_nodes())
    assert nodes[True][0] == nodes[False][0] and nodes[False][1] == 0
    # seven stamps, the crop count and the trailer's concatenation at least
    assert nodes[True][1] >= 8


@pytest.mark.cuda
def test_card_captured_path_records_spans_without_a_wait(cuda, monkeypatch):
    timer = CudaStageTimer()
    pipe = _pipeline(cuda)
    pipe.stage_timer = timer
    pipe.warm_up(FRAME_HW)
    frames = _frames()

    def no_sync(*a, **k):
        raise AssertionError("torch.cuda.synchronize on the captured path")

    def no_wait(ev):
        if not ev.query():
            raise AssertionError("a wait for the device in a dispatch")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    monkeypatch.setattr(torch.cuda.Event, "synchronize", no_wait)
    torch.cuda.set_sync_debug_mode("error")
    try:
        # three chunks: the upload ring's three buffers, none waited for
        outs = [pipe._dispatch_chunk(frames[i:i + 2]) for i in (0, 2, 4)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
        monkeypatch.undo()
    names = {n for n, *_ in timer.spans()}
    assert {"dispatch", "upload.ring_wait", "upload.copy",
            "replay"} <= names
    for o in outs:
        o.arrays()
    assert timer.chunks == 3
