"""DeepSORT ReID appearance embedder in PyTorch.

The port of ``aicamera_tpu/models/reid.py``: a 3x3 stem conv, a 3x3/s2/p1
max-pool, four residual stages (64, 128/2, 256/2, 512/2; two blocks each),
global average pool and an L2 norm with a 1e-7 floor. Batch norm is folded
into the conv biases. Input is NHWC ``(B, 128, 64, 3)`` normalized RGB, as
``ops/crops.py`` writes it; output ``(B, 512)`` f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class _ConvBNRelu(nn.Module):
    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 strides: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, kernel, strides,
                              padding=kernel // 2, bias=True)

    def forward(self, x):
        return F.relu(self.conv(x))


class _BasicBlock(nn.Module):
    """Residual block; 1x1 projection shortcut when downsampling."""

    def __init__(self, in_features: int, features: int,
                 downsample: bool = False):
        super().__init__()
        s = 2 if downsample else 1
        self.cv1 = _ConvBNRelu(in_features, features, 3, s)
        self.cv2 = nn.Conv2d(features, features, 3, padding=1, bias=True)
        self.proj = (nn.Conv2d(in_features, features, 1, stride=s, bias=True)
                     if downsample or in_features != features else None)

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        if self.proj is not None:
            x = self.proj(x)
        return F.relu(x + y)


class _F32Linear(nn.Linear):
    """The embedding head in f32 whatever the module's dtype, as the Flax
    ``Dense`` (f32 params) runs on the f32 pooled features."""

    def forward(self, x):
        return F.linear(x.float(), self.weight.float(), self.bias.float())


_STAGES = [(64, False), (64, False), (128, True), (128, False),
           (256, True), (256, False), (512, True), (512, False)]


class ReIDNet(nn.Module):
    """ReID feature extractor: (B, 128, 64, 3) -> (B, feature_dim)."""

    def __init__(self, feature_dim: int = 512):
        super().__init__()
        self.stem = _ConvBNRelu(3, 64, 3, 1)
        c_in = 64
        for i, (feats, down) in enumerate(_STAGES):
            self.add_module(f"block{i}", _BasicBlock(c_in, feats, down))
            c_in = feats
        self.fc = (_F32Linear(c_in, feature_dim)
                   if feature_dim != c_in else None)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.stem.conv.weight.dtype)
        x = F.max_pool2d(self.stem(x), 3, stride=2, padding=1)
        for i in range(len(_STAGES)):
            x = getattr(self, f"block{i}")(x)
        x = x.mean(dim=(2, 3)).float()
        if self.fc is not None:
            x = self.fc(x)
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return x / torch.clamp(norm, min=1e-7)
