"""Port: the twelve runnable examples of ``examples_torch/`` on the CPU.

Each example runs as a user runs it, a subprocess with ``--device cpu`` at a
small size (one intra-op thread, a time limit of its own), and must exit 0
with its closing line. The video examples read an MJPEG ``.avi`` written by
the port's ``VideoWriter`` from ``TemporalWorld`` frames; ``multistream.py``
runs a world of 2 gloo ranks.

``detect_image.py`` is held against the JAX package's ``YOLODetector`` at
f32 with the committed detector, on a JPEG of a ``TemporalWorld`` frame (the
JAX facade given the frame as ``read_jpeg`` decodes it): the same count and
classes; boxes within ``BOX_TOL`` px and scores within ``SCORE_TOL``, the
precision the example prints them at.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aicamera_tpu_torch.synthetic import TemporalWorld, WorldSpec  # noqa: E402
from aicamera_tpu_torch.utils.jpeg import encode_jpeg, read_jpeg  # noqa: E402
from aicamera_tpu_torch.utils.video_io import VideoWriter  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples_torch"
YOLO = ROOT / "models" / "detection" / "yolov8n_synthetic.msgpack"
CLIP_FRAMES = 2
BOX_TOL = 0.5     # px: the example prints boxes to the pixel
SCORE_TOL = 1e-3  # the example prints scores to three decimals


def _world():
    """The synthetic world of ``synthetic_eval.py``."""
    return TemporalWorld(WorldSpec(max_objects=8, presence=1.0), seed=3,
                         speed=2.0, device="cpu")


def run_example(script, *args, timeout=150):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, str(EXAMPLES / script), *map(str, args)], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = tmp_path_factory.mktemp("clip") / "world.avi"
    world = _world()
    writer = VideoWriter(str(path), 30.0, world.spec.hw)
    try:
        for _ in range(CLIP_FRAMES):
            writer.write(world.step()[0])
    finally:
        writer.release()
    return path


LAST = CLIP_FRAMES - 1
# script -> (arguments after --device cpu, its closing line); "{clip}" is
# the .avi. The closing line is the last one printed, track lines aside.
CASES = {
    "detect_image.py": ((), r"\(random weights .*"),
    "track_video.py": (("--input", "{clip}", "--frames", CLIP_FRAMES),
                       rf"frame +{LAST}: \d+ detections, \d+ confirmed "
                       r"tracks"),
    "bytetrack_video.py": (("--input", "{clip}", "--frames", CLIP_FRAMES),
                           rf"frame +{LAST}: \d+ detections, \d+ active "
                           r"tracks"),
    "ocsort_video.py": (("--input", "{clip}", "--frames", CLIP_FRAMES),
                        rf"frame +{LAST}: \d+ detections, \d+ emitted "
                        r"tracks"),
    "fused_pipeline.py": (("--frames", 4, "--chunk", 2),
                          r"restored tracker state from "
                          r"tracker_state\.msgpack; next_id=\d+"),
    "synthetic_eval.py": (("--frames", 4, "--chunk", 2),
                          r"tracking : MOTA=-?[\d.]+ MOTP=[\d.]+ IDsw=\d+ "
                          r"FP=\d+ FN=\d+"),
    "quantized_pipeline.py": (("--frames", 4), r"ok"),
    "serialized_engines.py": ((), r"serialized engine output == "
                                  r"weight-based output \(bitwise\)"),
    "serving_async.py": ((), r"cam B frame 1: \d+ tracks"),
    "multitenant_serving.py": ((), r"ok"),
    "multistream.py": (("--ranks", 2, "--streams", 4, "--steps", 2),
                       r"step 1: confirmed tracks per stream = "
                       r"\[\d+, \d+, \d+, \d+\]"),
    "pipeline_parallel.py": (("--batch", 4),
                             r"staged forward == unsplit YOLOv8 forward on "
                             r"cpu \(bitwise, microbatches of 1\)"),
}


def test_every_example_has_a_case():
    scripts = {p.name for p in EXAMPLES.glob("*.py")} - {"_common.py"}
    assert scripts == set(CASES)
    assert scripts == {p.name for p in (ROOT / "examples").glob("*.py")} \
        - {"_common.py"}


@pytest.mark.parametrize("script", sorted(CASES))
def test_example_runs_on_the_cpu(script, clip):
    args, closing = CASES[script]
    args = [str(clip) if a == "{clip}" else a for a in args]
    out = run_example(script, "--device", "cpu", *args)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines()
             if ln.strip() and not ln.startswith("    ID:")]
    assert lines and re.fullmatch(closing, lines[-1]), out.stdout[-2000:]
    if script == "multistream.py":
        assert "4 streams over a 2-rank mesh (gloo)" in lines


def test_an_example_without_a_device_needs_the_gpu():
    """No ``--device`` means the GPU: on a host without one the example
    exits non-zero with ``resolve_device``'s message, and never runs on the
    CPU in silence."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU error cannot be shown")
    out = run_example("detect_image.py")
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    assert "detections above threshold" not in out.stdout


LINE = re.compile(r"  class=\s*(\d+) conf=([\d.]+) "
                  r"box=\((-?\d+),(-?\d+),(-?\d+),(-?\d+)\)")


def test_detect_image_matches_the_jax_facade(tmp_path):
    from aicamera_tpu.detector import YOLODetector
    image = tmp_path / "world.jpg"
    image.write_bytes(encode_jpeg(_world().step()[0]))
    out = run_example("detect_image.py", "--device", "cpu", "--detect_dtype",
                      "f32", "--weights", YOLO, "--image", image)
    assert out.returncode == 0, out.stderr[-3000:]
    got = [LINE.fullmatch(ln) for ln in out.stdout.splitlines()
           if ln.startswith("  class=")]
    assert all(got)
    got = np.array([[float(v) for v in m.groups()] for m in got])

    boxes, scores, classes, keep = YOLODetector(
        engine_path=str(YOLO), detect_dtype="f32",
        conf_threshold=0.3).detect(read_jpeg(image))
    assert f"{len(keep)} detections above threshold" in out.stdout
    assert len(got) == len(keep) >= 1
    np.testing.assert_array_equal(got[:, 0], classes[keep])
    np.testing.assert_allclose(got[:, 1], scores[keep], rtol=0,
                               atol=SCORE_TOL)
    np.testing.assert_allclose(got[:, 2:], boxes[keep], rtol=0, atol=BOX_TOL)
