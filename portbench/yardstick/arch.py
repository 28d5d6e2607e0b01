"""Layer shapes of YOLOv8 and the ReID net, and the FLOPs they imply.

Written from Ultralytics' ``yolov8.yaml`` (depth, width and max-channel
multiples, C2f repeats 3-6-6-3 in the backbone and 3 in the neck, the
decoupled head with ``c2 = max(16, ch0 // 4, 64)`` box and ``c3 = max(ch0,
min(nc, 100))`` class channels) and DeepSORT's ReID net, as the Flax trees
of the checkpoints name their layers. The FLOPs count two per multiply-add
of every convolution and dense layer at the given input, as Ultralytics and
thop report them (a BN folded into its conv adds none).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

REG_MAX = 16


def make_divisible(v: float, divisor: int = 8) -> int:
    return max(divisor, int(v + divisor / 2) // divisor * divisor)


def yolo_widths(depth: float, width: float, max_channels: int):
    ch = [make_divisible(min(c, max_channels) * width)
          for c in (64, 128, 256, 512, 1024)]
    dep = [max(1, int(round(n * depth))) for n in (3, 6, 6, 3)]
    return ch, dep, max(1, int(round(3 * depth)))


def _conv(cin, cout, k=1, block=True):
    node = {"kernel": (k, k, cin, cout), "bias": (cout,)}
    return {"conv": node} if block else node


def _c2f(cin, cout, n):
    c = cout // 2
    out = {"cv1": _conv(cin, 2 * c), "cv2": _conv((2 + n) * c, cout)}
    for i in range(n):
        out[f"m{i}"] = {"cv1": _conv(c, c, 3), "cv2": _conv(c, c, 3)}
    return out


def yolo_shapes(depth: float, width: float, max_channels: int,
                num_classes: int = 80) -> dict:
    """``{"params": tree}`` of kernel (HWIO) and bias shapes."""
    ch, dep, n = yolo_widths(depth, width, max_channels)
    backbone = {
        "stem": _conv(3, ch[0], 3), "down1": _conv(ch[0], ch[1], 3),
        "c2f1": _c2f(ch[1], ch[1], dep[0]), "down2": _conv(ch[1], ch[2], 3),
        "c2f2": _c2f(ch[2], ch[2], dep[1]), "down3": _conv(ch[2], ch[3], 3),
        "c2f3": _c2f(ch[3], ch[3], dep[2]), "down4": _conv(ch[3], ch[4], 3),
        "c2f4": _c2f(ch[4], ch[4], dep[3]),
        "sppf": {"cv1": _conv(ch[4], ch[4] // 2),
                 "cv2": _conv(4 * (ch[4] // 2), ch[4])},
    }
    neck = {
        "up_c2f1": _c2f(ch[4] + ch[3], ch[3], n),
        "up_c2f2": _c2f(ch[3] + ch[2], ch[2], n),
        "down_conv1": _conv(ch[2], ch[2], 3),
        "down_c2f1": _c2f(ch[2] + ch[3], ch[3], n),
        "down_conv2": _conv(ch[3], ch[3], 3),
        "down_c2f2": _c2f(ch[3] + ch[4], ch[4], n),
    }
    c_reg = max(16, ch[2] // 4, REG_MAX * 4)
    c_cls = max(ch[2], min(num_classes, 100))
    head = {}
    for i, c_in in enumerate((ch[2], ch[3], ch[4])):
        head[f"reg{i}_cv1"] = _conv(c_in, c_reg, 3)
        head[f"reg{i}_cv2"] = _conv(c_reg, c_reg, 3)
        head[f"reg{i}_out"] = _conv(c_reg, 4 * REG_MAX, block=False)
        head[f"cls{i}_cv1"] = _conv(c_in, c_cls, 3)
        head[f"cls{i}_cv2"] = _conv(c_cls, c_cls, 3)
        head[f"cls{i}_out"] = _conv(c_cls, num_classes, block=False)
    return {"params": {"backbone": backbone, "neck": neck, "head": head}}


def reid_shapes(feature_dim: int = 512) -> dict:
    stages = [(64, False), (64, False), (128, True), (128, False),
              (256, True), (256, False), (512, True), (512, False)]
    tree = {"stem": _conv(3, 64, 3)}
    c_in = 64
    for i, (c, down) in enumerate(stages):
        blk = {"cv1": _conv(c_in, c, 3), "cv2": _conv(c, c, 3, block=False)}
        if down or c_in != c:
            blk["proj"] = _conv(c_in, c, 1, block=False)
        tree[f"block{i}"] = blk
        c_in = c
    if feature_dim != c_in:
        tree["fc"] = {"kernel": (c_in, feature_dim), "bias": (feature_dim,)}
    return {"params": tree}


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _meta_tree(shapes: dict) -> dict:
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict):
            out[k] = _meta_tree(v)
        else:
            shape = (tuple(v[i] for i in (3, 2, 0, 1)) if len(v) == 4
                     else tuple(reversed(v)))
            out[k] = torch.empty(shape, device="meta")
    return out


def _count(net, x) -> int:
    with FlopCounterMode(display=False) as counter:
        net(x)
    return int(counter.get_total_flops())


def yolo_flops(arch: dict, input_hw) -> int:
    """FLOPs of one frame through YOLOv8 at ``input_hw``."""
    from ..reference.nets import YOLOv8Ref
    shapes = yolo_shapes(arch["depth_multiple"], arch["width_multiple"],
                         arch["max_channels"], arch["num_classes"])
    return _count(YOLOv8Ref(_meta_tree(shapes)),
                  torch.empty((1, 3, *input_hw), device="meta"))


def reid_flops(feature_dim: int, input_hw) -> int:
    """FLOPs of one crop through the ReID net."""
    from ..reference.nets import ReIDRef
    return _count(ReIDRef(_meta_tree(reid_shapes(feature_dim))),
                  torch.empty((1, 3, *input_hw), device="meta"))


def check_tree(tree: dict, shapes: dict) -> None:
    """Raise unless ``tree`` has exactly the leaves and shapes of
    ``shapes``."""
    got = {k: tuple(np.shape(v)) for k, v in leaves(tree)}
    want = {k: tuple(v) for k, v in leaves(shapes)}
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))[:6]
        raise ValueError(f"weights do not match the configuration's "
                         f"architecture: {diff}")
