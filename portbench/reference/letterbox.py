"""Ultralytics' letterbox, as the reference and the letterbox kernel's byte
count take it."""

from __future__ import annotations

import numpy as np
import torch

PAD = 114.0


def _taps(dst: int, src: int):
    """Half-pixel bilinear taps of a resize from ``src`` to ``dst``:
    ``(i0, i1, w0, w1)`` with edge clamping."""
    c = np.clip((np.arange(dst) + 0.5) * (src / dst) - 0.5, 0.0, src - 1)
    i0 = np.floor(c).astype(np.int64)
    w0 = np.maximum(0.0, 1.0 - np.abs(c - i0))
    w1 = np.where(i0 + 1 < src, np.maximum(0.0, 1.0 - np.abs(c - i0 - 1)),
                  0.0)
    return i0, np.minimum(i0 + 1, src - 1), w0, w1


class Letterbox:
    """Ultralytics' letterbox to ``dst_hw`` without scale-up: the min ratio,
    the content rounded, half-side padding with the +-0.1 rounding, pad 114,
    bilinear resize rounded to whole levels, BGR -> RGB, / 255."""

    def __init__(self, src_hw, dst_hw, device):
        sh, sw = src_hw
        dh, dw = dst_hw
        self.src_hw, self.dst_hw = tuple(src_hw), tuple(dst_hw)
        self.r = min(dh / sh, dw / sw, 1.0)
        self.unpad = (int(round(sh * self.r)), int(round(sw * self.r)))
        self.pad_w = (dw - self.unpad[1]) / 2.0
        self.pad_h = (dh - self.unpad[0]) / 2.0
        self.top = int(round(self.pad_h - 0.1))
        self.left = int(round(self.pad_w - 0.1))
        self.resize = self.unpad != (sh, sw)
        ty = _taps(self.unpad[0], sh)
        tx = _taps(self.unpad[1], sw)
        self.ty = [torch.as_tensor(a, device=device) for a in ty]
        self.tx = [torch.as_tensor(a, device=device) for a in tx]
        self.device = device

    def __call__(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """``(B, H, W, 3)`` uint8 BGR -> ``(B, 3, Dh, Dw)`` f32 RGB."""
        x = frames_u8.permute(0, 3, 1, 2).float()
        if self.resize:
            y0, y1, wy0, wy1 = self.ty
            x0, x1, wx0, wx1 = self.tx
            rows = (x[:, :, y0] * wy0.float()[:, None]
                    + x[:, :, y1] * wy1.float()[:, None])
            v = rows[..., x0] * wx0.float() + rows[..., x1] * wx1.float()
            x = torch.clamp(torch.round(v), 0.0, 255.0)
        b = x.shape[0]
        canvas = torch.full((b, 3, *self.dst_hw), PAD, device=self.device)
        uh, uw = self.unpad
        canvas[:, :, self.top:self.top + uh, self.left:self.left + uw] = x
        return canvas.flip(1) / 255.0

    def unscale(self, boxes: torch.Tensor) -> torch.Tensor:
        sh, sw = self.src_hw
        out = boxes.clone()
        out[..., 0::2] = torch.clamp((boxes[..., 0::2] - self.pad_w)
                                     / self.r, 0, sw)
        out[..., 1::2] = torch.clamp((boxes[..., 1::2] - self.pad_h)
                                     / self.r, 0, sh)
        return out
