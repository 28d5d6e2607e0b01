"""The reference against the program's CPU path (f32), at small sizes, and
the weights the benchmark makes."""

import numpy as np
import pytest
import torch

from portbench.reference import msgpack_io
from portbench.reference.nets import YOLOv8Ref, tree_to_device
from portbench.tests import small
from portbench.weights import embedded_yolo
from portbench.yardstick import arch


@pytest.mark.parametrize("name", small.CELLS)
def test_reference_agrees_with_the_programs_cpu_path(name):
    keep = {}
    line = small.run(name, seconds=2.0, keep=keep)
    n = keep["numbers"]
    assert line["correct"] is True
    assert n["tracks_reference"] > 0 and n["tracks_paired"] > 0
    assert n["track_miss_share"] == 0.0
    assert n["id_switch_share"] == 0.0
    assert n["conf_gap_p99"] < 1e-5
    assert n["box_gap_p99_px"] <= 0.5 + 1e-4   # the program rounds to pixels
    if "det_miss_share" in n:
        assert n["det_miss_share"] == 0.0 and n["det_score_gap_p99"] < 1e-5


def _f64(tree):
    return {k: _f64(v) if isinstance(v, dict) else v.double()
            for k, v in tree.items()}


def test_embedded_yolov8m_computes_the_trained_yolov8n():
    small_tree = msgpack_io.load_flax_msgpack(
        small.harness.ROOT / "models/detection/yolov8n_synthetic.msgpack")
    shapes = arch.yolo_shapes(0.67, 0.75, 768, 80)
    big = embedded_yolo(small_tree, shapes, seed=2 ** 40 + 3, device="cpu")
    arch.check_tree(big, shapes)
    x = torch.rand(1, 3, 96, 128, generator=torch.Generator().manual_seed(0))
    a = YOLOv8Ref(_f64(tree_to_device(small_tree, "cpu")))(x.double())
    b = YOLOv8Ref(_f64(tree_to_device(big, "cpu")))(x.double())
    for (ra, ca), (rb, cb) in zip(a, b):
        assert torch.allclose(ra, rb, atol=1e-9)
        assert torch.allclose(ca, cb, atol=1e-9)
    again = embedded_yolo(small_tree, shapes, seed=2 ** 40 + 3, device="cpu")
    k = ("params", "backbone", "c2f2", "m3", "cv1", "conv", "kernel")
    node_a, node_b = big, again
    for key in k:
        node_a, node_b = node_a[key], node_b[key]
    assert np.array_equal(node_a, node_b) and np.abs(node_a).sum() > 0


def test_msgpack_round_trip():
    path = small.harness.ROOT / "models/reid/deepsort_reid_synthetic.msgpack"
    raw = path.read_bytes()
    assert msgpack_io.write_flax_msgpack(
        msgpack_io.read_flax_msgpack(raw)) == raw
