"""Port: the CLI on the CPU. Flags as in the JAX parser, the headless run end
to end on a ``.npy`` of seeded frames, checkpoint and resume, the saved runs
(the annotated MJPEG ``.avi``, ``--draw_detections``, ``--native_io``)
against what the JAX CLI draws, and the exits for what is not ported."""

from pathlib import Path

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
    (["--no_save", "--show_display"], "--show_display"),
    (["--show_display"], "--show_display"),
    (["--show_display", "--draw_detections", "--native_io"],
     "--show_display"),
    # (saving, --draw_detections and --native_io run now:
    # test_saved_runs_write_the_drawn_video)
    # (--gmc affine|translation and a bare --tracker strongsort run now:
    # test_gmc_and_strongsort_default_run)
    # (.onnx weights load now: test_onnx_weights_run)
    # (--reid_quant/--yolo_quant int8 run now: tests/test_torch_quant.py)
])
def test_flags_not_ported_exit_naming_themselves(clip, flags, named):
    with pytest.raises(SystemExit) as e:
        cli.main(["--input", str(clip), "--device", "cpu", *flags])
    assert e.value.code not in (0, None)
    assert named in str(e.value.code) and "ROADMAP.md" in str(e.value.code)


AVI_HW = (240, 320)   # room outside the info panel (it is 122 rows high)


@pytest.fixture(scope="module")
def avi_clip(tmp_path_factory):
    """A seeded clip as an MJPEG .avi written by the port, and its frames
    as the port decodes them (what the CLI sees)."""
    from aicamera_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg
    path = tmp_path_factory.mktemp("avi") / "tiny.avi"
    frames = moving_rectangles(N_FRAMES, AVI_HW, n_objects=3, seed=3)
    w = video_io.VideoWriter(str(path), 30.0, AVI_HW)
    for f in frames:
        w.write(f)
    w.release()
    return path, [decode_jpeg(encode_jpeg(f)) for f in frames]


# A file name beyond ASCII: OpenCV draws it in the JAX CLI's panel, the port
# draws Latin-1 as OpenCV does and the CJK character as "?"
ODD_NAME = "caf\u00e9_\u00fc\u4e2d"


@pytest.fixture(scope="module")
def jax_cli_run(avi_clip):
    """The JAX CLI on the same decoded frames (its reader and writer
    replaced by stand-ins: it reads video through FFmpeg, whose MJPEG
    decoder differs from libjpeg by a few levels), its input named
    ``ODD_NAME``: per frame, the tracks and detections it draws and the
    frame it would write (every frame: it draws the name)."""
    from aicamera_tpu.utils import visualization as jvis
    _, decoded = avi_clip
    seen = {"tracks": [], "dets": [], "written": []}

    class Reader:
        fps, width, height = 30.0, AVI_HW[1], AVI_HW[0]
        frame_count, is_webcam = len(decoded), False

        def __init__(self, *a, **k):
            pass

        def frames(self):
            return iter([f.copy() for f in decoded])

        def release(self):
            pass

    class Writer:
        def __init__(self, path, fps, hw):
            self.path = path

        def write(self, frame):
            seen["written"].append(frame.copy())

        def release(self):
            pass

    draw_tracks, draw_dets = jvis.draw_tracks, jvis.draw_detections

    def spy_tracks(frame, tracks, *a, **k):
        seen["tracks"].append(list(tracks))
        return draw_tracks(frame, tracks, *a, **k)

    def spy_dets(frame, boxes, scores, labels, *a, **k):
        seen["dets"].append((np.array(boxes), np.array(scores),
                             np.array(labels)))
        return draw_dets(frame, boxes, scores, labels, *a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(jcli, "VideoReader", Reader)
    mp.setattr(jcli, "VideoWriter", Writer)
    mp.setattr(jvis, "draw_tracks", spy_tracks)
    mp.setattr(jvis, "draw_detections", spy_dets)
    try:
        jcli.main(["--input", f"{ODD_NAME}.avi", "--device", "cpu",
                   "--input_shape",
                   "128", "--chunk_size", "2", "--draw_detections", *WEIGHTS])
    finally:
        mp.undo()
    assert len(seen["written"]) == len(decoded)
    assert sum(map(len, seen["tracks"])) > 0
    return seen


@pytest.mark.parametrize("flags,name", [
    ([], "tiny"), (["--draw_detections"], "tiny"), (["--native_io"], "tiny"),
    (["--native_io", "--draw_detections"], "tiny"),
    (["--draw_detections"], ODD_NAME)])
def test_saved_runs_write_the_drawn_video(avi_clip, jax_cli_run, tmp_path,
                                          capsys, monkeypatch, flags, name):
    """Without ``--no_save`` the CLI writes the annotated MJPEG ``.avi``
    (a ``.mp4`` name becomes ``.avi``): one frame per processed frame, each
    bitwise the port's drawing of the tracks (and, with
    ``--draw_detections``, the detections) that the JAX CLI draws on the
    same frames, under the info panel's lines as the CLI formed them (its
    FPS is live), JPEG-encoded. Outside the panel (which holds the package
    name and the live FPS) the JAX CLI's own frames equal the port's
    drawing too. An input named beyond ASCII is drawn and saved whole, as
    the JAX CLI draws and writes every frame of it."""
    import shutil

    from aicamera_tpu_torch.utils import visualization as vis
    from aicamera_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg
    path, decoded = avi_clip
    if name != path.stem:
        path = Path(shutil.copy(path, tmp_path / f"{name}.avi"))
    panel = []
    draw_info_panel = vis.draw_info_panel

    def spy(frame, lines, *a, **k):
        panel.append(list(lines))
        return draw_info_panel(frame, lines, *a, **k)
    monkeypatch.setattr(vis, "draw_info_panel", spy)
    out_dir = tmp_path / "out"
    cli.main(["--input", str(path), "--device", "cpu", "--input_shape",
              "128", "--chunk_size", "2", "--output_dir", str(out_dir),
              "--output_filename", "run.mp4", "--profile", *WEIGHTS, *flags])
    text = capsys.readouterr().out
    written = out_dir / "run.avi"
    assert f"Saving to: {written}" in text
    assert f"Saved {N_FRAMES} frames to {written}" in text
    assert f"Processed {N_FRAMES} frames in" in text
    assert "Presentation errors: 0 frames skipped" in text
    assert "draw+write" in text
    assert ("Using native C++ video decoder" in text) == \
        ("--native_io" in flags)
    r = video_io.VideoReader(str(written))
    got = list(r.frames())
    r.release()
    assert len(got) == N_FRAMES and r.fps == 30.0
    assert len(panel) == N_FRAMES
    for i, (frame, tracks) in enumerate(zip(decoded, jax_cli_run["tracks"])):
        assert panel[i][0] == "AICamera" and panel[i][1] == f"Input: {name}"
        assert panel[i][3] == f"Tracks: {len(tracks)}"
        want = frame.copy()
        if "--draw_detections" in flags:
            vis.draw_detections(want, *jax_cli_run["dets"][i])
        vis.draw_tracks(want, tracks)
        if "--draw_detections" in flags:   # as the JAX CLI drew it
            below = slice(10 + 26 * 4 + 8 + 1, None)   # under its panel
            np.testing.assert_array_equal(
                want[below], jax_cli_run["written"][i][below])
        draw_info_panel(want, panel[i])
        np.testing.assert_array_equal(got[i], decode_jpeg(encode_jpeg(want)),
                                      err_msg=f"frame {i}")


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
    for make in (lambda: video_io.VideoReader(0),):     # the webcam
        with pytest.raises(NotImplementedError, match="V4L2"):
            make()
    # the native reader and the writer are ported: an .avi round trip
    w = video_io.VideoWriter(str(tmp_path / "o.mp4"), 30.0, FRAME_HW)
    for f in np.load(clip):
        w.write(f)
    w.release()
    assert w.path == tmp_path / "o.avi" and w.frames_written == N_FRAMES
    n = video_io.NativeVideoReader(str(w.path), n_threads=2)
    assert [len(c) for c in n.chunks(3)] == [3, 3, 1]
    n.release()


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
