"""YOLOv8 building blocks in PyTorch.

Tensors are indexed NCHW, as PyTorch's convolutions take them. In bf16 and
f16 the weights and activations are held channels-last (NHWC in memory, the
Flax convs' own layout), so that cuDNN's NHWC engines take every conv's
input and weight as they are, with no transposes around the conv; in f32
they stay NCHW, which cuDNN runs faster without TF32 (:func:`layout`).
Batch norms are folded into conv biases, as in the Flax checkpoints, so every
block is conv + bias + SiLU. Submodule names follow the Flax module names
(``conv``, ``cv1``, ``m0``, ...), so a Flax params path maps one-to-one onto a
PyTorch state-dict key (``runtime/params.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

#: The dtypes whose convolutions run channels-last. On an H100, YOLOv8's
#: bf16 forwards ran 4-24% faster channels-last than NCHW, its f32 forward
#: (TF32 off) 19% slower and its f32 forward and backward 40% slower
#: (PERF.md).
CHANNELS_LAST_DTYPES = (torch.bfloat16, torch.float16)


def layout(dtype: torch.dtype) -> torch.memory_format:
    """The memory format of weights and activations in ``dtype``."""
    return torch.channels_last if dtype in CHANNELS_LAST_DTYPES \
        else torch.contiguous_format


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with a bias whose weight is held in the
    :func:`layout` of its dtype: a conversion (``.to(device, dtype)``,
    ``.float()``) lays it out anew; loading a state dict and a seeded init
    copy into it and keep its layout."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: int = 1, strides: int = 1, padding: int = 0):
        super().__init__(in_features, features, kernel_size, strides,
                         padding=padding, bias=True)

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        w = self.weight
        w.data = w.data.contiguous(memory_format=layout(w.dtype))
        return self


def to_layout(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype`` and its :func:`layout`: one copy, or none where it
    already is."""
    return x.to(dtype, memory_format=layout(dtype))


def cat_channels(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The concatenation over channels, in the tensors' :func:`layout`.
    ``torch.cat`` makes its output contiguous (NCHW) where an input's
    strides are ambiguous, as a channel slice's can be; the copy back is
    then made here, and it is none otherwise."""
    return torch.cat(tensors, dim=1).contiguous(
        memory_format=layout(tensors[0].dtype))


class ConvBlock(nn.Module):
    """Conv2d + bias + SiLU ("Conv" in YOLOv8 terms, BN pre-folded)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 1,
                 strides: int = 1, use_act: bool = True):
        super().__init__()
        self.conv = Conv2d(in_features, features, kernel_size, strides,
                           kernel_size // 2)
        self.use_act = use_act

    def forward(self, x):
        x = self.conv(x)
        return F.silu(x) if self.use_act else x


class Bottleneck(nn.Module):
    """Two 3x3 convs with optional residual."""

    def __init__(self, in_features: int, features: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvBlock(in_features, features, 3)
        self.cv2 = ConvBlock(features, features, 3)
        self.add = shortcut and in_features == features

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """Cross-stage partial block with 2 splits and n bottlenecks: cv1 expands
    to 2c channels, each bottleneck takes the latest chunk, and the concat of
    all chunks feeds cv2 (the JAX package's default ``concat`` form)."""

    def __init__(self, in_features: int, features: int, n: int = 1,
                 shortcut: bool = False):
        super().__init__()
        c = features // 2
        self.c = c
        self.cv1 = ConvBlock(in_features, 2 * c, 1)
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(c, c, shortcut))
        self.n = n
        self.cv2 = ConvBlock((2 + n) * c, features, 1)

    def forward(self, x):
        y = self.cv1(x)
        # channel slices of y: the first bottleneck's conv copies its half
        # dense (the block's one relayout); the concat reads them in place
        chunks = [y[:, :self.c], y[:, self.c:]]
        for i in range(self.n):
            chunks.append(getattr(self, f"m{i}")(chunks[-1]))
        return self.cv2(cat_channels(chunks))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained 5x5/s1 max-pools. PyTorch
    pads with -inf, as Flax ``max_pool(padding="SAME")`` does."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        c = in_features // 2
        self.cv1 = ConvBlock(in_features, c, 1)
        self.cv2 = ConvBlock(4 * c, features, 1)

    def forward(self, x):
        outs = [self.cv1(x)]
        for _ in range(3):
            outs.append(F.max_pool2d(outs[-1], 5, stride=1, padding=2))
        return self.cv2(cat_channels(outs))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (keeps the input's memory format)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def make_divisible(v: float, divisor: int = 8) -> int:
    """Round channel counts the way YOLO scaling does."""
    return max(divisor, int(v + divisor / 2) // divisor * divisor)


def scale_channels(base: Sequence[int], width: float, max_channels: int):
    """YOLOv8 channel scaling: the max-channel cap applies before the width
    multiple."""
    return [make_divisible(min(c, max_channels) * width) for c in base]
