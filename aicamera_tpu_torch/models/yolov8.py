"""YOLOv8 detector family (n/s/m/l/x) in PyTorch, anchor-free with DFL.

The port of ``aicamera_tpu/models/yolov8.py``. Convolutions run NCHW; the
public output keeps the JAX package's layout: per level ``(box_bins
(B, h, w, 64), cls_logits (B, h, w, C))`` in NHWC at strides 8/16/32, so that
``ops/nms.py`` builds anchors row-major over ``(h, w)``.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import C2f, ConvBlock, SPPF, scale_channels, upsample2x

# variant: (depth_multiple, width_multiple, max_channels)
YOLOV8_VARIANTS = {
    "n": (0.34, 0.25, 1024),
    "s": (0.34, 0.50, 1024),
    "m": (0.67, 0.75, 768),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.25, 512),
}

_BASE_CHANNELS = [64, 128, 256, 512, 1024]
_BASE_DEPTHS = [3, 6, 6, 3]

REG_MAX = 16
STRIDES = (8, 16, 32)


def _depth(n: int, d: float) -> int:
    return max(1, int(round(n * d)))


def _widths(variant: str):
    d, w, mc = YOLOV8_VARIANTS[variant]
    return d, scale_channels(_BASE_CHANNELS, w, mc)


class Backbone(nn.Module):
    def __init__(self, variant: str = "n"):
        super().__init__()
        d, ch = _widths(variant)
        dep = [_depth(n, d) for n in _BASE_DEPTHS]
        self.stem = ConvBlock(3, ch[0], 3, 2)            # P1
        self.down1 = ConvBlock(ch[0], ch[1], 3, 2)       # P2
        self.c2f1 = C2f(ch[1], ch[1], dep[0], True)
        self.down2 = ConvBlock(ch[1], ch[2], 3, 2)       # P3
        self.c2f2 = C2f(ch[2], ch[2], dep[1], True)
        self.down3 = ConvBlock(ch[2], ch[3], 3, 2)       # P4
        self.c2f3 = C2f(ch[3], ch[3], dep[2], True)
        self.down4 = ConvBlock(ch[3], ch[4], 3, 2)       # P5
        self.c2f4 = C2f(ch[4], ch[4], dep[3], True)
        self.sppf = SPPF(ch[4], ch[4])

    def forward(self, x):
        x = self.c2f1(self.down1(self.stem(x)))
        p3 = self.c2f2(self.down2(x))
        p4 = self.c2f3(self.down3(p3))
        p5 = self.sppf(self.c2f4(self.down4(p4)))
        return p3, p4, p5


class Neck(nn.Module):
    """PAN-FPN: top-down then bottom-up feature fusion."""

    def __init__(self, variant: str = "n"):
        super().__init__()
        d, ch = _widths(variant)
        n = _depth(3, d)
        self.up_c2f1 = C2f(ch[4] + ch[3], ch[3], n, False)
        self.up_c2f2 = C2f(ch[3] + ch[2], ch[2], n, False)
        self.down_conv1 = ConvBlock(ch[2], ch[2], 3, 2)
        self.down_c2f1 = C2f(ch[2] + ch[3], ch[3], n, False)
        self.down_conv2 = ConvBlock(ch[3], ch[3], 3, 2)
        self.down_c2f2 = C2f(ch[3] + ch[4], ch[4], n, False)

    def forward(self, p3, p4, p5):
        t1 = self.up_c2f1(torch.cat([upsample2x(p5), p4], dim=1))
        n3 = self.up_c2f2(torch.cat([upsample2x(t1), p3], dim=1))
        n4 = self.down_c2f1(torch.cat([self.down_conv1(n3), t1], dim=1))
        n5 = self.down_c2f2(torch.cat([self.down_conv2(n4), p5], dim=1))
        return n3, n4, n5


class DetectHead(nn.Module):
    """Decoupled anchor-free head: DFL box bins + class logits per level."""

    def __init__(self, variant: str = "n", num_classes: int = 80):
        super().__init__()
        _, ch = _widths(variant)
        c_reg = max(16, ch[2] // 4, REG_MAX * 4)
        c_cls = max(ch[2], min(num_classes, 100))
        for i, c_in in enumerate((ch[2], ch[3], ch[4])):
            self.add_module(f"reg{i}_cv1", ConvBlock(c_in, c_reg, 3))
            self.add_module(f"reg{i}_cv2", ConvBlock(c_reg, c_reg, 3))
            self.add_module(f"reg{i}_out", nn.Conv2d(c_reg, 4 * REG_MAX, 1))
            self.add_module(f"cls{i}_cv1", ConvBlock(c_in, c_cls, 3))
            self.add_module(f"cls{i}_cv2", ConvBlock(c_cls, c_cls, 3))
            self.add_module(f"cls{i}_out", nn.Conv2d(c_cls, num_classes, 1))

    def forward(self, feats):
        outs = []
        for i, x in enumerate(feats):
            # the Flax order (box branch, then class branch): the order an
            # ONNX export lists the convs in (models/onnx_import.py)
            r, c = x, x
            for part in ("cv1", "cv2", "out"):
                r = getattr(self, f"reg{i}_{part}")(r)
            for part in ("cv1", "cv2", "out"):
                c = getattr(self, f"cls{i}_{part}")(c)
            outs.append((r.permute(0, 2, 3, 1).contiguous(),
                         c.permute(0, 2, 3, 1).contiguous()))
        return outs


class YOLOv8(nn.Module):
    """Full detector. Input NCHW float in [0, 1] (B, 3, H, W), as the
    letterbox kernel writes it; returns per-level NHWC
    ``(box_bins, cls_logits)`` at strides 8/16/32."""

    def __init__(self, variant: str = "n", num_classes: int = 80):
        super().__init__()
        self.variant = variant
        self.num_classes = num_classes
        self.backbone = Backbone(variant)
        self.neck = Neck(variant)
        self.head = DetectHead(variant, num_classes)

    def forward(self, x):
        x = x.to(self.head.reg0_out.weight.dtype)
        return self.head(self.neck(*self.backbone(x)))
