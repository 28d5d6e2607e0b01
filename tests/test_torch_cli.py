"""Port: the CLI on the CPU. Flags as in the JAX parser, the headless run end
to end on a ``.npy`` of seeded frames, checkpoint and resume, and the exits
for what is not ported."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aicamera_tpu import cli as jcli  # noqa: E402
from aicamera_tpu_torch import cli, config  # noqa: E402
from aicamera_tpu_torch.runtime.pipeline import TrackingPipeline  # noqa: E402
from aicamera_tpu_torch.scenes import moving_rectangles  # noqa: E402
from aicamera_tpu_torch.utils import video_io  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    PyTorch's thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_FRAMES, FRAME_HW = 7, (96, 128)
WEIGHTS = ["--yolo_weights", str(config.YOLO_SYNTHETIC_PATH),
           "--reid_weights", str(config.REID_SYNTHETIC_PATH)]


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    # seed 3: three rectangles the committed detector finds at this size
    path = tmp_path_factory.mktemp("clip") / "tiny.npy"
    np.save(path, moving_rectangles(N_FRAMES, FRAME_HW, n_objects=3, seed=3))
    return path


def _run(clip, *flags):
    return ["--input", str(clip), "--device", "cpu", "--no_save",
            "--input_shape", "128", "--chunk_size", "2", *WEIGHTS, *flags]


def _actions(parse):
    """{dest: action} of a parser, taken from the function that builds it."""
    import argparse
    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def spy(self, argv=None):
        seen.update({a.dest: a for a in self._actions if a.dest != "help"})
        return orig(self, argv)
    argparse.ArgumentParser.parse_args = spy
    try:
        parse([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return seen


def test_every_flag_of_the_jax_parser_with_its_default_and_aliases():
    ours, ref = _actions(cli.parse_arguments), _actions(jcli.parse_arguments)
    assert list(ours) == list(ref)
    for dest, a in ref.items():
        b = ours[dest]
        assert b.option_strings == a.option_strings, dest   # aliases too
        assert b.type == a.type and b.choices == a.choices, dest
        assert type(b) is type(a), dest                     # store_true etc.
        if dest != "device":
            assert b.default == a.default, dest
    assert ours["device"].default == "cuda" and ref["device"].default == "tpu"
    args = cli.parse_arguments(["--yolo_engine", "a.msgpack",
                                "--reid_engine", "b.msgpack",
                                "--conf_thresh", "0.4"])
    assert (args.yolo_weights, args.reid_weights) == ("a.msgpack",
                                                      "b.msgpack")
    assert args.conf_thresh == pytest.approx(0.4)


@pytest.mark.parametrize("tracker", ["deepsort", "bytetrack", "botsort",
                                     "ocsort", "deepocsort", "strongsort"])
def test_main_prints_what_the_pipeline_gives(clip, capsys, tracker):
    """"Processed N frames" and the same "Average tracks per frame" as the
    port's pipeline driven directly."""
    extra = ["--gmc", "off"] if tracker == "strongsort" else []
    cli.main(_run(clip, "--tracker", tracker, *extra))
    text = capsys.readouterr().out
    pipe = TrackingPipeline(
        input_shape=(128, 128), chunk_size=2, tracker=tracker, gmc="off",
        yolo_weights=WEIGHTS[1], reid_weights=WEIGHTS[3], device="cpu")
    frames = np.load(clip)
    n_tracks = sum(len(r.tracks) for r in pipe.process_frames(iter(frames)))
    assert n_tracks > 0
    assert f"Processed {N_FRAMES} frames in" in text
    assert f"Average tracks per frame: {n_tracks / N_FRAMES:.1f}\n" in text
    assert f"Input: tiny ({FRAME_HW[1]}x{FRAME_HW[0]} @ 30.0 fps, " \
           f"{N_FRAMES} frames)" in text


@pytest.mark.parametrize("flags,tracker,gmc", [
    (["--tracker", "strongsort"], "strongsort", None),
    (["--gmc", "affine"], "deepsort", "affine"),
    (["--tracker", "ocsort", "--gmc", "translation"], "ocsort",
     "translation")])
def test_gmc_and_strongsort_default_run(clip, capsys, flags, tracker, gmc):
    """Camera-motion compensation is ported: ``--gmc affine|translation``
    and a bare ``--tracker strongsort`` (its preset turns on ``affine``) run
    and print what the pipeline gives with the same ``gmc``."""
    cli.main(_run(clip, *flags))
    text = capsys.readouterr().out
    pipe = TrackingPipeline(
        input_shape=(128, 128), chunk_size=2, tracker=tracker, gmc=gmc,
        yolo_weights=WEIGHTS[1], reid_weights=WEIGHTS[3], device="cpu")
    assert pipe.gmc_method == (gmc or "affine")
    frames = np.load(clip)
    n_tracks = sum(len(r.tracks) for r in pipe.process_frames(iter(frames)))
    assert f"Processed {N_FRAMES} frames in" in text
    assert f"Average tracks per frame: {n_tracks / N_FRAMES:.1f}\n" in text


@pytest.mark.parametrize("tracker", ["deepsort", "bytetrack", "deepocsort"])
def test_checkpoint_then_resume(clip, tmp_path, capsys, tracker):
    """As the JAX package's CLI test: periodic and final snapshots, then a
    resumed run whose ids go on where the first run stopped."""
    from aicamera_tpu_torch.runtime.checkpoint import load_state
    ckpt = tmp_path / "ck" / "state.msgpack"
    cli.main(_run(clip, "--tracker", tracker, "--checkpoint", str(ckpt),
                  "--checkpoint_interval", "4", "--profile"))
    text = capsys.readouterr().out
    assert f"Processed {N_FRAMES} frames" in text
    assert f"Final tracker state saved to {ckpt}" in text
    assert "detect+track" in text and "checkpoint" in text   # --profile
    assert ckpt.exists() and not ckpt.with_name("state.msgpack.tmp").exists()
    ref = TrackingPipeline(input_shape=(128, 128), chunk_size=2,
                           tracker=tracker, device="cpu",
                           yolo_weights=WEIGHTS[1], reid_weights=WEIGHTS[3])
    first = load_state(ckpt, ref.core_params, device="cpu")
    assert int(first.next_id) > 1

    again = tmp_path / "again.msgpack"
    cli.main(_run(clip, "--tracker", tracker, "--resume", str(ckpt),
                  "--max_frames", "3", "--checkpoint", str(again)))
    text = capsys.readouterr().out
    assert f"Resumed tracker state from {ckpt}" in text
    assert "Processed 3 frames" in text
    second = load_state(again, ref.core_params, device="cpu")
    assert int(second.next_id) >= int(first.next_id)
    kept = set(first.track_id[first.active].tolist()) \
        & set(second.track_id[second.active].tolist())
    assert kept   # tracks of the first run live on under their ids


@pytest.mark.parametrize("flags,named", [
    ([], "--no_save"),
    (["--no_save", "--show_display"], "--show_display"),
    (["--no_save", "--draw_detections"], "--draw_detections"),
    (["--no_save", "--native_io"], "--native_io"),
    # (--gmc affine|translation and a bare --tracker strongsort run now:
    # test_gmc_and_strongsort_default_run)
    # (.onnx weights load now: test_onnx_weights_run)
    (["--no_save", "--native_io", "--draw_detections"],
     "--draw_detections"),
    # (--reid_quant/--yolo_quant int8 run now: tests/test_torch_quant.py)
])
def test_flags_not_ported_exit_naming_themselves(clip, flags, named):
    with pytest.raises(SystemExit) as e:
        cli.main(["--input", str(clip), "--device", "cpu", *flags])
    assert e.value.code not in (0, None)
    assert named in str(e.value.code) and "ROADMAP.md" in str(e.value.code)


def test_inputs_not_ported_exit(tmp_path, clip):
    with pytest.raises(SystemExit) as e:          # no --input: the webcam
        cli.main(["--device", "cpu", "--no_save"])
    assert "--input" in str(e.value.code) and "webcam" in str(e.value.code)
    with pytest.raises(SystemExit) as e:
        cli.main(["--input", str(tmp_path / "clip.mp4"), "--device", "cpu",
                  "--no_save"])
    assert "OpenCV" in str(e.value.code) and "ROADMAP.md" in str(e.value.code)
    with pytest.raises(FileNotFoundError):
        cli.main(["--input", str(tmp_path / "none.npy"), "--device", "cpu",
                  "--no_save"])
    with pytest.raises(FileNotFoundError):        # an explicit weights file
        cli.main(["--input", str(clip), "--device", "cpu", "--no_save",
                  "--yolo_weights", str(tmp_path / "w.onnx")])


@pytest.mark.parametrize("flag", ["--yolo_weights", "--reid_weights"])
def test_onnx_weights_run(clip, tmp_path, capsys, flag):
    """``.onnx`` weights load (they exited before ONNX import was ported):
    the committed checkpoint written as ONNX gives the checkpoint's run,
    its final tracker state bit for bit."""
    from test_torch_onnx_import import checkpoint_onnx
    name = "yolo" if flag == "--yolo_weights" else "reid"
    onnx = str(checkpoint_onnx(name, tmp_path / "w.onnx"))
    states = []
    for extra in ([flag, onnx], []):
        ckpt = tmp_path / f"state{len(states)}.msgpack"
        cli.main(_run(clip, "--checkpoint", str(ckpt), *extra))
        assert f"Processed {N_FRAMES} frames" in capsys.readouterr().out
        states.append(ckpt.read_bytes())
    assert states[0] == states[1]


@pytest.mark.parametrize("flags,message", [
    (["--gallery_strategy", "ema", "--tracker", "bytetrack"],
     "--gallery_strategy ema requires --tracker deepsort"),
    (["--nsa", "--tracker", "ocsort"], "--nsa requires --tracker deepsort"),
])
def test_motion_only_trackers_refuse_appearance_flags(clip, flags, message):
    """The same exits, in the same words, as the JAX CLI."""
    with pytest.raises(SystemExit) as e:
        cli.main(_run(clip, *flags))
    assert message in str(e.value.code)
    with pytest.raises(SystemExit) as ref:
        jcli.main(["--input", str(clip), "--device", "cpu", "--no_save",
                   *flags])
    assert str(ref.value.code) == str(e.value.code)


def test_ema_gallery_and_nsa_reach_the_tracker(clip, capsys):
    cli.main(_run(clip, "--gallery_strategy", "ema", "--ema_alpha", "0.8",
                  "--nsa", "--auto_input", "--detect_dtype", "f32",
                  "--reid_dtype", "f32", "--max_frames", "4"))
    assert "Processed 4 frames" in capsys.readouterr().out


def test_video_reader_surface(clip, tmp_path):
    r = video_io.VideoReader(str(clip), queue_depth=2, max_frames=5)
    try:
        assert (r.width, r.height, r.frame_count) == (128, 96, N_FRAMES)
        assert r.fps == 30.0 and not r.is_webcam and r.max_frames == 5
        chunks = list(r.chunks(2))   # through the bounded queue of 2
    finally:
        r.release()
    assert [len(c) for c in chunks] == [2, 2, 1]
    np.testing.assert_array_equal(np.concatenate(chunks), np.load(clip)[:5])
    r = video_io.VideoReader(str(clip), queue_depth=1)
    assert len(next(r.frames()).shape) == 3
    r.release()                      # with the thread blocked on a full queue
    assert not r._thread.is_alive()
    bad = tmp_path / "bad.npy"
    np.save(bad, np.zeros((3, 4, 4), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        video_io.VideoReader(str(bad))
    for make in (lambda: video_io.VideoReader(0),
                 lambda: video_io.NativeVideoReader(str(clip)),
                 lambda: video_io.VideoWriter("o.mp4", 30.0, FRAME_HW)):
        with pytest.raises(NotImplementedError, match="OpenCV"):
            make()


def test_stage_timer_report():
    from aicamera_tpu_torch.runtime.profiler import StageTimer
    t = StageTimer()
    with t.stage("a"):
        pass
    t.add("b", 0.002)
    t.add("b", 0.004)
    s = t.summary()
    assert s["a"]["count"] == 1 and s["b"]["count"] == 2
    assert s["b"]["mean_ms"] == pytest.approx(3.0)
    lines = t.report().splitlines()
    assert lines[0].split() == ["stage", "count", "mean", "p50", "p95"]
    assert [ln.split()[0] for ln in lines[1:]] == ["a", "b"]
