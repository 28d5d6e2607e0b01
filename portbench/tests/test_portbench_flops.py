"""The FLOP counter against Ultralytics' published totals at 640x640."""

import pytest

from portbench.yardstick import arch

# yolov8.yaml's scales and the GFLOPs Ultralytics publishes for them
PUBLISHED = {"n": ((0.33, 0.25, 1024), 8.7), "m": ((0.67, 0.75, 768), 78.9)}


@pytest.mark.parametrize("scale", sorted(PUBLISHED))
def test_yolo_flops_match_the_published(scale):
    (d, w, mc), gflops = PUBLISHED[scale]
    got = arch.yolo_flops(dict(depth_multiple=d, width_multiple=w,
                               max_channels=mc, num_classes=80), (640, 640))
    print(f"YOLOv8{scale}: {got / 1e9:.4f} GFLOPs counted, "
          f"{gflops} published")
    assert abs(got / 1e9 - gflops) < 0.05


def test_reid_flops_count_every_conv():
    got = arch.reid_flops(512, (128, 64))
    print(f"ReID: {got / 1e9:.4f} GFLOPs a crop")
    assert 2.0e9 < got < 2.5e9


def test_the_ports_depth_multiple_gives_the_same_layers():
    assert arch.yolo_widths(0.34, 0.25, 1024) == \
        arch.yolo_widths(0.33, 0.25, 1024)
