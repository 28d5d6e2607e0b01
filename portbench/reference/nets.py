"""YOLOv8 and the DeepSORT ReID embedder as plain functions of a Flax tree.

The published architectures written out once more in plain PyTorch, with no
code of the program: YOLOv8 (Ultralytics' ``yolov8.yaml``: the CSP backbone
of C2f blocks and SPPF, the PAN-FPN neck, the decoupled head with DFL box
bins), batch norms folded into the conv biases as in the checkpoints; the
ReID net of DeepSORT's ``deep_sort`` feature extractor (a 3x3 stem, a 3x3/s2
max-pool, four residual stages of two basic blocks, global average pool, L2
norm with a 1e-7 floor). The block counts and widths are read from the tree.

``precision``: ``"f32"`` (TF32 off; the reference) or ``"fp8"`` (the
control: every conv's weights, per output channel, and its input, per
sample, rounded to float8 e4m3 with their scales, products summed in f32).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def tree_to_device(tree: dict, device) -> dict:
    """Nested numpy tree -> nested tensors in f32 on ``device``: conv
    kernels HWIO -> OIHW, Dense ``(in, out)`` -> ``(out, in)``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = tree_to_device(v, device)
            continue
        a = np.asarray(v, np.float32)
        if k == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def _fp8(x: torch.Tensor, dims) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a scale that maps its largest
    magnitude over ``dims`` to the format's largest, back in f32."""
    amax = x.abs().amax(dim=dims, keepdim=True).clamp_min(1e-12)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def conv(p: dict, x: torch.Tensor, stride: int = 1,
         precision: str = "f32") -> torch.Tensor:
    w, b = p["kernel"], p["bias"]
    if precision == "fp8":
        w = _fp8(w, (1, 2, 3))
        x = _fp8(x, (1, 2, 3))
    return F.conv2d(x, w, b, stride=stride, padding=w.shape[-1] // 2)


class _Net:
    def __init__(self, tree: dict, precision: str = "f32"):
        if set(tree) == {"params"}:
            tree = tree["params"]
        self.p = tree
        self.precision = precision

    def block(self, p, x, stride=1, act=F.silu):
        """Conv + bias (+ activation): a ``{"conv": ...}`` node or a bare
        conv node."""
        y = conv(p.get("conv", p), x, stride, self.precision)
        return act(y) if act is not None else y


class YOLOv8Ref(_Net):
    """``(B, 3, 640, 640)`` RGB in [0, 1] -> per level ``(box_bins (B, h,
    w, 64), cls_logits (B, h, w, C))``, strides 8, 16, 32."""

    def c2f(self, p, x, shortcut):
        y = self.block(p["cv1"], x)
        c = y.shape[1] // 2
        chunks = [y[:, :c], y[:, c:]]
        n = sum(1 for k in p if k.startswith("m") and k[1:].isdigit())
        for i in range(n):
            m = p[f"m{i}"]
            z = self.block(m["cv2"], self.block(m["cv1"], chunks[-1]))
            chunks.append(chunks[-1] + z if shortcut else z)
        return self.block(p["cv2"], torch.cat(chunks, 1))

    def sppf(self, p, x):
        outs = [self.block(p["cv1"], x)]
        for _ in range(3):
            outs.append(F.max_pool2d(outs[-1], 5, stride=1, padding=2))
        return self.block(p["cv2"], torch.cat(outs, 1))

    def __call__(self, x: torch.Tensor):
        b, n, h = self.p["backbone"], self.p["neck"], self.p["head"]
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
        x = self.block(b["stem"], x, 2)
        x = self.c2f(b["c2f1"], self.block(b["down1"], x, 2), True)
        p3 = self.c2f(b["c2f2"], self.block(b["down2"], x, 2), True)
        p4 = self.c2f(b["c2f3"], self.block(b["down3"], p3, 2), True)
        p5 = self.sppf(b["sppf"], self.c2f(
            b["c2f4"], self.block(b["down4"], p4, 2), True))
        t1 = self.c2f(n["up_c2f1"], torch.cat([up(p5), p4], 1), False)
        n3 = self.c2f(n["up_c2f2"], torch.cat([up(t1), p3], 1), False)
        n4 = self.c2f(n["down_c2f1"], torch.cat(
            [self.block(n["down_conv1"], n3, 2), t1], 1), False)
        n5 = self.c2f(n["down_c2f2"], torch.cat(
            [self.block(n["down_conv2"], n4, 2), p5], 1), False)
        outs = []
        for i, f in enumerate((n3, n4, n5)):
            r = self.block(h[f"reg{i}_cv2"], self.block(h[f"reg{i}_cv1"], f))
            r = self.block(h[f"reg{i}_out"], r, act=None)
            c = self.block(h[f"cls{i}_cv2"], self.block(h[f"cls{i}_cv1"], f))
            c = self.block(h[f"cls{i}_out"], c, act=None)
            outs.append((r.permute(0, 2, 3, 1), c.permute(0, 2, 3, 1)))
        return outs


class ReIDRef(_Net):
    """``(B, 3, 128, 64)`` normalized RGB -> ``(B, D)`` unit features."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        p = self.p
        x = F.max_pool2d(self.block(p["stem"], x, act=F.relu), 3, stride=2,
                         padding=1)
        i = 0
        while f"block{i}" in p:
            blk = p[f"block{i}"]
            w = blk["cv1"]["conv"]["kernel"]
            s = 2 if w.shape[0] != w.shape[1] else 1   # a stage's first
            y = self.block(blk["cv1"], x, s, act=F.relu)
            y = self.block(blk["cv2"], y, act=None)
            if "proj" in blk:
                x = self.block(blk["proj"], x, s, act=None)
            x = F.relu(x + y)
            i += 1
        x = x.mean(dim=(2, 3))
        if "fc" in p:
            x = F.linear(x, p["fc"]["kernel"], p["fc"]["bias"])
        return x / torch.clamp(torch.linalg.vector_norm(
            x, dim=-1, keepdim=True), min=1e-7)
