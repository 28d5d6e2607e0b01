"""Static-calibrated int8 (W8A8) quantization of the YOLOv8 detector.

The port of ``aicamera_tpu/models/quant_yolo.py``, the same scheme: every
conv output gets one scale (its calibration-time max-abs), a constant of the
program; input-tensor scales are folded into the consumer's kernel per input
channel at build time, so the epilogue applies only the per-output-channel
weight scale; max-pool, nearest upsample, channel slices and concats run on
int8 directly (they commute with a positive per-tensor scale).

Three passes share one walk of the architecture (:func:`_traverse`, the JAX
package's, over the port's module paths, which are the Flax paths:
``backbone.stem.conv``, ``head.reg0_out``, ...):

* **calibrate**: an f32 forward (TF32 off) over calibration inputs, NCHW as
  the letterbox writes them, recording each quantize point's max-abs; one
  read per batch, a running max on the host.
* **build**: numpy on the host, the JAX package's arithmetic copied, so the
  int8 kernels and weight scales are bitwise JAX's from the same weights and
  scales.
* **run**: the int8 program, NHWC, convolutions through
  ``models.quant.int8_conv`` (``torch._int_mm``). The constants
  ``127 / scale`` and ``scale / 127`` are Python doubles rounded once to
  f32, as JAX rounds them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import prng
from ..runtime.pipeline import full_f32
from .layers import scale_channels
from .quant import QConv, fma
from .yolov8 import _BASE_CHANNELS, _BASE_DEPTHS, _depth, YOLOV8_VARIANTS

__all__ = ["QuantYOLOv8", "quantize_yolo_synthetic", "calibration_frames"]

_I8_MIN = -127  # symmetric; -128 unused


def _key(path: Tuple[str, ...]) -> str:
    return "/".join(path)


def _f32(v: float) -> float:
    """A Python double rounded to f32, as JAX rounds a weak constant."""
    return float(np.float32(v))


class _T:
    """A traversal tensor: payload + provenance. ``parts`` lists
    ``(scale_key, n_channels)`` spans of the channel axis: a conv output
    has one span, a concat one per source."""

    __slots__ = ("data", "parts")

    def __init__(self, data, parts: List[Tuple[str, int]]):
        self.data = data
        self.parts = parts

    @property
    def channels(self) -> int:
        return sum(c for _, c in self.parts)


def _conv_module(model: nn.Module, path) -> nn.Conv2d:
    """The conv at a Flax path (a ConvBlock nests it under ``conv``; the
    head's out convs are bare)."""
    mod = model.get_submodule(".".join(path))
    return mod.conv if hasattr(mod, "conv") else mod


class _CalibCtx:
    """f32 forward (NCHW); records every quantize point's max-abs."""

    def __init__(self, model):
        self.model = model
        self.maxes: Dict[str, torch.Tensor] = {}

    def input(self, x):
        # the model input is [0, 1] by the preprocess contract
        return _T(x.float(), [("__input__", x.shape[1])])

    def conv(self, path, t, k, s, act=True, residual=None,
             quantize_out=True):
        m = _conv_module(self.model, path)
        # conv, then the bias, as two roundings (the JAX package's order)
        y = F.conv2d(t.data, m.weight.float(), stride=s, padding=k // 2) \
            + m.bias.float()[:, None, None]
        if act:
            y = y * torch.sigmoid(y)   # jax.nn.silu's form
        if residual is not None:
            y = y + residual.data
        kk = _key(path)
        if quantize_out:
            self.maxes[kk] = torch.amax(torch.abs(y))
        return _T(y, [(kk, y.shape[1])])

    def concat(self, ts):
        return _T(torch.cat([t.data for t in ts], dim=1),
                  [p for t in ts for p in t.parts])

    def slice2(self, t, c):
        kk = t.parts[0][0]
        return (_T(t.data[:, :c], [(kk, c)]),
                _T(t.data[:, c:], [(kk, t.channels - c)]))

    def maxpool(self, t, k):
        return _T(F.max_pool2d(t.data, k, stride=1, padding=k // 2),
                  list(t.parts))

    def upsample(self, t):
        d = t.data.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return _T(d, list(t.parts))


class _BuildCtx:
    """Host pass: folds input scales into kernels, quantizes weights
    (numpy, the JAX package's arithmetic)."""

    def __init__(self, model, scales: Dict[str, float]):
        self.model = model
        self.scales = scales
        self.qparams: Dict[str, dict] = {}

    def input(self, x):
        return _T(int(x.shape[1]), [("__input__", int(x.shape[1]))])

    def conv(self, path, t, k, s, act=True, residual=None,
             quantize_out=True):
        m = _conv_module(self.model, path)
        kern = m.weight.detach().float().cpu().numpy().transpose(2, 3, 1, 0)
        bias = m.bias.detach().float().cpu().numpy()
        # per-input-channel dequant factor = part_scale / 127, folded in
        sx = np.concatenate([
            np.full(c, self.scales[kk] / 127.0, np.float32)
            for kk, c in t.parts])
        wf = kern * sx[None, None, :, None]
        wmax = np.maximum(np.max(np.abs(wf), axis=(0, 1, 2)), 1e-12)
        wq = np.clip(np.round(wf * (127.0 / wmax)), _I8_MIN, 127)
        kk = _key(path)
        self.qparams[kk] = {
            "w": torch.from_numpy(wq.astype(np.int8)),
            "wscale": torch.from_numpy(np.asarray(wmax / 127.0, np.float32)),
            "bias": torch.from_numpy(np.array(bias, np.float32))}
        o = kern.shape[-1]
        return _T(o, [(kk, o)])

    def concat(self, ts):
        return _T(sum(t.data for t in ts), [p for t in ts for p in t.parts])

    def slice2(self, t, c):
        kk = t.parts[0][0]
        return _T(c, [(kk, c)]), _T(t.data - c, [(kk, t.data - c)])

    def maxpool(self, t, k):
        return _T(t.data, list(t.parts))

    def upsample(self, t):
        return _T(t.data, list(t.parts))


class _RunCtx:
    """The int8 inference program, NHWC. ``record``, when a dict, receives
    every conv's output (int8, or f32 for the head's out convs)."""

    def __init__(self, convs: nn.ModuleDict, scales: Dict[str, float],
                 record: dict | None = None):
        self.convs = convs
        self.scales = scales
        self.record = record

    def input(self, x):
        q = torch.clamp(torch.round(x.float() * 127.0), _I8_MIN, 127)
        q = q.to(torch.int8).permute(0, 2, 3, 1).contiguous()
        return _T(q, [("__input__", x.shape[1])])

    def conv(self, path, t, k, s, act=True, residual=None,
             quantize_out=True):
        kk = _key(path)
        q = self.convs[kk]
        y = q.accumulate(t.data, s)
        # epilogue: dequant + bias (+SiLU) (+residual) (+requant)
        y = fma(y.float(), q.scale, q.bias)
        if act:
            y = y * torch.sigmoid(y)   # jax.nn.silu's form
        if residual is not None:
            # dequant per provenance span (a concat has one per source)
            r = residual.data.float()
            segs, off = [], 0
            for rk, c in residual.parts:
                segs.append(r[..., off:off + c]
                            * _f32(self.scales[rk] / 127.0))
                off += c
            y = y + (segs[0] if len(segs) == 1 else torch.cat(segs, dim=-1))
        if quantize_out:
            y = torch.clamp(torch.round(y * _f32(127.0 / self.scales[kk])),
                            _I8_MIN, 127).to(torch.int8)
        if self.record is not None:
            self.record[kk] = y
        return _T(y, [(kk, y.shape[-1])])

    def concat(self, ts):
        return _T(torch.cat([t.data for t in ts], dim=-1),
                  [p for t in ts for p in t.parts])

    def slice2(self, t, c):
        kk = t.parts[0][0]
        return (_T(t.data[..., :c], [(kk, c)]),
                _T(t.data[..., c:], [(kk, t.channels - c)]))

    def maxpool(self, t, k):
        # max commutes with the (positive) per-tensor scale: pool the int8
        # values, exactly, in f32 (the window always holds its centre, so
        # -inf padding acts as the JAX package's -128)
        x = t.data.permute(0, 3, 1, 2).float()
        p = F.max_pool2d(x, k, stride=1, padding=k // 2)
        return _T(p.to(torch.int8).permute(0, 2, 3, 1).contiguous(),
                  list(t.parts))

    def upsample(self, t):
        d = t.data.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return _T(d, list(t.parts))


def _bottleneck(ctx, path, t, c, shortcut):
    y = ctx.conv(path + ("cv1",), t, 3, 1)
    res = t if (shortcut and t.channels == c) else None
    return ctx.conv(path + ("cv2",), y, 3, 1, residual=res)


def _c2f(ctx, path, t, features, n, shortcut):
    c = features // 2
    y = ctx.conv(path + ("cv1",), t, 1, 1)
    a, b = ctx.slice2(y, c)
    chunks = [a, b]
    for i in range(n):
        chunks.append(_bottleneck(ctx, path + (f"m{i}",), chunks[-1], c,
                                  shortcut))
    return ctx.conv(path + ("cv2",), ctx.concat(chunks), 1, 1)


def _sppf(ctx, path, t, features):
    x = ctx.conv(path + ("cv1",), t, 1, 1)
    outs = [x]
    for _ in range(3):
        outs.append(ctx.maxpool(outs[-1], 5))
    return ctx.conv(path + ("cv2",), ctx.concat(outs), 1, 1)


def _traverse(ctx, x, variant: str, num_classes: int = 80):
    """One shared walk of the YOLOv8 architecture (``models/yolov8.py``'s
    channel plan and module paths)."""
    d, w, mc = YOLOV8_VARIANTS[variant]
    ch = scale_channels(_BASE_CHANNELS, w, mc)
    dep = [_depth(n, d) for n in _BASE_DEPTHS]

    t = ctx.input(x)
    B = lambda *p: ("backbone",) + p  # noqa: E731
    t = ctx.conv(B("stem"), t, 3, 2)
    t = ctx.conv(B("down1"), t, 3, 2)
    t = _c2f(ctx, B("c2f1"), t, ch[1], dep[0], True)
    t = ctx.conv(B("down2"), t, 3, 2)
    p3 = _c2f(ctx, B("c2f2"), t, ch[2], dep[1], True)
    t = ctx.conv(B("down3"), p3, 3, 2)
    p4 = _c2f(ctx, B("c2f3"), t, ch[3], dep[2], True)
    t = ctx.conv(B("down4"), p4, 3, 2)
    t = _c2f(ctx, B("c2f4"), t, ch[4], dep[3], True)
    p5 = _sppf(ctx, B("sppf"), t, ch[4])

    N = lambda *p: ("neck",) + p  # noqa: E731
    n = _depth(3, d)
    t = ctx.concat([ctx.upsample(p5), p4])
    t1 = _c2f(ctx, N("up_c2f1"), t, ch[3], n, False)
    t = ctx.concat([ctx.upsample(t1), p3])
    n3 = _c2f(ctx, N("up_c2f2"), t, ch[2], n, False)
    t = ctx.conv(N("down_conv1"), n3, 3, 2)
    n4 = _c2f(ctx, N("down_c2f1"), ctx.concat([t, t1]), ch[3], n, False)
    t = ctx.conv(N("down_conv2"), n4, 3, 2)
    n5 = _c2f(ctx, N("down_c2f2"), ctx.concat([t, p5]), ch[4], n, False)

    H = lambda *p: ("head",) + p  # noqa: E731
    outs = []
    for i, feat in enumerate((n3, n4, n5)):
        r = ctx.conv(H(f"reg{i}_cv1"), feat, 3, 1)
        r = ctx.conv(H(f"reg{i}_cv2"), r, 3, 1)
        r = ctx.conv(H(f"reg{i}_out"), r, 1, 1, act=False,
                     quantize_out=False)
        c = ctx.conv(H(f"cls{i}_cv1"), feat, 3, 1)
        c = ctx.conv(H(f"cls{i}_cv2"), c, 3, 1)
        c = ctx.conv(H(f"cls{i}_out"), c, 1, 1, act=False,
                     quantize_out=False)
        outs.append((r, c))
    return outs


def _convs(qparams: dict, device=None) -> nn.ModuleDict:
    """The run pass's ``QConv`` per conv key (the walk gives the strides)."""
    return nn.ModuleDict({k: QConv(q["w"], q["wscale"], q["bias"]).to(device)
                          for k, q in qparams.items()})


class QuantYOLOv8(nn.Module):
    """The int8 twin of ``models.yolov8.YOLOv8``.

    Usage (the JAX package's, with the float module in place of its
    params)::

        q = QuantYOLOv8(variant="n")
        scales = q.calibrate(model, x01)   # (N, 3, H, W) f32 in [0, 1]
        qparams = q.build(model, scales)   # int8 tree, binds the scales
        levels = q(x01)                    # = q.apply(qparams, x01)

    ``apply``/``forward`` take the letterbox's ``(K, 3, H, W)`` f32 and
    return the float model's per-level NHWC ``(box_bins, cls_logits)``, so
    ``ops.nms.fused_decode_nms`` reads them unchanged.
    """

    def __init__(self, variant: str = "n", num_classes: int = 80):
        super().__init__()
        self.variant = variant
        self.num_classes = num_classes
        self.scales: Dict[str, float] | None = None
        self.qparams: Dict[str, dict] | None = None
        self.convs = nn.ModuleDict()
        # the input dtype callers prepare (int8 lives only inside)
        self.dtype = torch.float32

    def calibrate(self, model, frames: torch.Tensor, batch: int = 8,
                  margin: float = 1.0) -> Dict[str, float]:
        """Per-tensor max-abs over calibration inputs (``frames`` f32 in
        [0, 1], NCHW: post-letterbox model inputs) with ``model``'s f32
        weights, TF32 off; a running max across batches on the host;
        ``margin`` scales the result."""
        acc: Dict[str, float] = {}
        frames = frames.float()
        with torch.no_grad(), full_f32():
            for i in range(0, frames.shape[0], batch):
                ctx = _CalibCtx(model)
                _traverse(ctx, frames[i:i + batch], self.variant,
                          self.num_classes)
                keys = list(ctx.maxes)
                vals = torch.stack([ctx.maxes[k] for k in keys]).tolist()
                for k, v in zip(keys, vals):
                    acc[k] = max(acc.get(k, 0.0), float(v))
        scales = {k: max(v, 1e-6) * margin for k, v in acc.items()}
        scales["__input__"] = 1.0  # preprocess contract: [0, 1]
        return scales

    def build(self, model, scales: Dict[str, float]) -> Dict[str, dict]:
        """Fold + quantize ``model``'s weights against ``scales``; binds
        this instance to them and returns the int8 tree (CPU tensors, the
        JAX package's keys and values)."""
        ctx = _BuildCtx(model, dict(scales))
        _traverse(ctx, torch.zeros((1, 3, 32, 32)), self.variant,
                  self.num_classes)
        device = next(model.parameters()).device
        self.bind(ctx.qparams, scales, device)
        return ctx.qparams

    def bind(self, qparams: Dict[str, dict], scales: Dict[str, float],
             device=None) -> "QuantYOLOv8":
        """Use ``qparams`` and ``scales`` (from :meth:`build`, or an engine
        file) on ``device``."""
        self.scales = dict(scales)
        self.qparams = qparams
        self.convs = _convs(qparams, device)
        return self

    def apply(self, qparams, x, record: dict | None = None):
        if self.scales is None:
            raise RuntimeError("call build(params, scales) first")
        convs = self.convs if qparams is self.qparams \
            else _convs(qparams, x.device)
        outs = _traverse(_RunCtx(convs, self.scales, record), x,
                         self.variant, self.num_classes)
        return [(r.data, c.data) for r, c in outs]

    def forward(self, x):
        return self.apply(self.qparams, x)


def calibration_frames(input_shape: Tuple[int, int] = (640, 640),
                       letterbox_auto: bool = False, seed: int = 7,
                       device=None) -> torch.Tensor:
    """The calibration set of :func:`quantize_yolo_synthetic`, letterboxed
    to ``input_shape``: ``(8, 3, H, W)`` f32. Six synthetic-world scenes
    (``synthetic.random_scene`` with ``prng.split(prng.PRNGKey(seed), 6)``,
    bitwise the JAX package's) and two uniform-noise frames from
    ``np.random.RandomState(seed)``."""
    from ..ops.letterbox import letterbox
    from ..ops.preprocess import letterbox_spec
    from ..synthetic import WorldSpec, random_scene

    spec = WorldSpec(max_objects=12, presence=1.0)
    frames = [random_scene(k, spec, device)[0]
              for k in prng.split(prng.PRNGKey(seed), 6)]
    rng = np.random.RandomState(seed)
    frames += [torch.from_numpy(rng.randint(0, 256, (*spec.hw, 3),
                                            np.uint8)).to(frames[0].device)
               for _ in range(2)]
    lspec = letterbox_spec(spec.hw, tuple(input_shape), auto=letterbox_auto)
    return letterbox(torch.stack(frames), lspec, torch.float32)


def quantize_yolo_synthetic(model, variant: str = "n",
                            num_classes: int = 80,
                            input_shape: Tuple[int, int] = (640, 640),
                            letterbox_auto: bool = False, seed: int = 7):
    """Calibrate + build against deterministic synthetic scenes
    (:func:`calibration_frames`, on ``model``'s device; ``model`` holds f32
    weights). Returns ``(bound QuantYOLOv8, qparams)``."""
    device = next(model.parameters()).device
    x = calibration_frames(input_shape, letterbox_auto, seed, device)
    q = QuantYOLOv8(variant, num_classes)
    scales = q.calibrate(model, x, batch=4, margin=1.05)
    qparams = q.build(model, scales)
    return q, qparams
