"""A later change adds a cell, a metric and a detector by adding files
alone: a new traffic mix, a new cell's limits, a new metric's reader and a
new detector family, found by the names in the manifest and the
configuration, with no file of the harness edited."""

import json
import re
import shutil

import numpy as np
import pytest

from portbench import harness
from portbench.families import yolov8
from portbench.reference import run as reference
from portbench.tests import small
from portbench.yardstick import kernels


def test_a_cell_and_a_metric_from_new_files(tmp_path):
    bench, cell, config, traffic, limits = small.cell("n540-deepsort-1x8")
    root = tmp_path
    for sub in ("configs", "traffic", "workloads", "metrics", "families"):
        (root / "portbench" / sub).mkdir(parents=True)
    shutil.copy(harness.ROOT / "portbench/families/yolov8.py",
                root / "portbench/families/yolov8.py")
    # a configuration file of its own
    config["weights"] = {k: str(harness.ROOT / v)
                         for k, v in config["weights"].items()}
    (root / "portbench/configs/tiny.json").write_text(json.dumps(config))
    # a new traffic mix: data only, read by an existing driver
    traffic = dict(traffic, chunk=4, world=dict(traffic["world"], seed=77))
    (root / "portbench/traffic/tiny-chunk4.json").write_text(
        json.dumps(traffic))
    (root / "portbench/workloads/tiny-cell.json").write_text(
        json.dumps(limits))
    # a new metric: a reader of its own
    (root / "portbench/metrics/frames_compared.py").write_text(
        "def read(ctx):\n    return float(ctx.frames_compared)\n")
    shutil.copy(harness.ROOT / "portbench/metrics/setup_s.py",
                root / "portbench/metrics/setup_s.py")
    new_cell = {"name": "tiny-cell", "config": "tiny",
                "traffic": "tiny-chunk4", "chips": 1, "why": "a test"}
    bench = {"configs": [{"name": "tiny", "source": "x",
                          "file": "portbench/configs/tiny.json",
                          "reduced": [], "why": "a test"}],
             "workloads": [new_cell],
             "end_to_end": [{"name": "frames_compared", "unit": "frames",
                             "better": "higher", "bound": 0.1,
                             "source": "host_clock"},
                            {"name": "setup_s", "unit": "s",
                             "better": "lower", "bound": 0.25,
                             "source": "host_clock"}],
             "per_layer": []}
    cfg, trf, lim = harness.cell_files(bench, new_cell, root)
    line = harness.run_cell(bench, new_cell, cfg, trf, lim, 11, 1.5, False,
                            device="cpu", root=root)
    assert set(line["checks"]) >= set(lim["limits"])
    assert line["metrics"]["frames_compared"]["value"] > 0
    assert set(line["metrics"]) == {"frames_compared", "setup_s"}


# a family of its own: the program side and the reference are YOLOv8's, the
# weights and the FLOP count its own
TOY = """
from portbench.families import yolov8
from portbench.reference import msgpack_io

FLOPS = 123_456_789_000
MADE = []
program_kwargs = yolov8.program_kwargs
Reference = yolov8.Reference


def make_weights(spec, config, seed, device):
    MADE.append(seed)
    return msgpack_io.load_flax_msgpack(spec["copy_of"])


def flops(config):
    return FLOPS
"""


def test_a_detector_family_from_one_new_file(tmp_path):
    bench, cell, config, traffic, limits = small.cell("n540-deepsort-1x8")
    root = tmp_path
    for sub in ("families", "metrics"):
        (root / "portbench" / sub).mkdir(parents=True)
    (root / "portbench/families/toy.py").write_text(TOY)
    for name in ("setup_s", "step_mfu"):
        shutil.copy(harness.ROOT / f"portbench/metrics/{name}.py",
                    root / f"portbench/metrics/{name}.py")
    config["model"]["family"] = "toy"
    config["weights"] = {
        "yolo": {"copy_of": str(harness.ROOT / config["weights"]["yolo"])},
        "reid": str(harness.ROOT / config["weights"]["reid"])}
    bench = dict(bench, end_to_end=[
        {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
         "source": "host_clock"}])
    keep = {}
    line = harness.run_cell(bench, cell, config, traffic, limits, 2 ** 31 + 9,
                            1.5, False, device="cpu", root=root, keep=keep)
    ctx = keep["ctx"]
    assert ctx.family.__file__ == str(root / "portbench/families/toy.py")
    assert ctx.family.MADE == [2 ** 31 + 9]
    assert not list((root / "portbench/.work").iterdir())
    assert line["correct"] is True, line["checks"]
    # step_mfu's reader over a window of 2 s in which 8 frames arrived (the
    # CPU run's own window may see none), with the toy's count and YOLOv8's
    ctx.window, ctx.arrivals = (0.0, 2.0), [(1.0, 8)]
    read = harness.metric_reader("step_mfu", root)
    toy = read(ctx)
    ctx.family = yolov8
    extra = yolov8.flops(config) - 123_456_789_000
    assert read(ctx) - toy == pytest.approx(
        100.0 * 8 * extra / (2.0 * kernels.PEAK_BF16_FLOPS), rel=1e-9)


# two boxes of one class that overlap by IoU 0.905, which the YOLOv8
# family's NMS would merge
FIXED = """
import numpy as np

BOXES = np.array([[100, 100, 150, 200], [100, 105, 150, 205]], np.float32)


class Reference:
    def __init__(self, config, frame_hw, tree, device, precision="f32"):
        pass

    def __call__(self, frames):
        return [(BOXES.copy(), np.array([0.9, 0.8], np.float32),
                 np.zeros(2, np.int32)) for _ in range(len(frames))]
"""


def test_post_processing_belongs_to_the_family(tmp_path):
    """An NMS-free family's overlapping detections all reach the tracker's
    slots: ``Perception`` suppresses nothing of its own."""
    _, _, config, _, _ = small.cell("m720-bytetrack-8x4")
    (tmp_path / "portbench/families").mkdir(parents=True)
    (tmp_path / "portbench/families/fixed.py").write_text(FIXED)
    config["model"]["family"] = "fixed"
    boxes = np.array([[100, 100, 150, 200], [100, 105, 150, 205]])
    iou = 50 * 95 / (2 * 50 * 100 - 50 * 95)
    assert iou > 0.9 > config["pipeline"]["nms_iou"]
    assert len(yolov8.greedy_nms(boxes, np.zeros(2), config["pipeline"][
        "nms_iou"], config["pipeline"]["max_det"])) == 1
    clips = {0: np.zeros((4, 240, 320, 3), np.uint8)}
    streams = [[(0, i) for i in range(4)]]
    family = harness.family_module(config, tmp_path)
    tracks, dets = reference.run(config, family, (240, 320), clips, streams,
                                 {"yolo": None, "reid": None}, "cpu",
                                 want_dets=True)
    for frame_tracks, (b, sc, cl) in zip(tracks[0], dets[0]):
        assert len(b) == 2
        assert sorted(t[1] for t in frame_tracks) == [100, 105]


def test_the_harness_names_no_detector():
    """What is YOLOv8's lives in its family (and the nets, shapes and
    weights it uses), not in the harness, the reference's shared half, the
    metrics or the drivers."""
    names = re.compile(r"\b(YOLOv8Ref|decode|greedy_nms|yolo_flops|"
                       r"yolo_shapes|embedded_yolo|port_variant)\b")
    b = harness.ROOT / "portbench"
    files = ([b / "harness.py", b / "reference/run.py",
              b / "reference/perception.py"]
             + sorted((b / "metrics").glob("*.py"))
             + sorted((b / "drivers").glob("*.py")))
    for path in files:
        found = names.findall(path.read_text())
        assert not found, f"{path} names {sorted(set(found))}"
