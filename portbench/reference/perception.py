"""The per-frame half of the reference that every detector shares: the
tracker's detection slots, crops and ReID over the detections of the
configuration's detector family (``portbench/families``).

Plain PyTorch in f32 (TF32 off), written from the published algorithms
(DeepSORT's crop and embed) and the values the configuration states.
Nothing here depends on the batch a frame came in.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .nets import ReIDRef, tree_to_device

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass
class FrameDets:
    """One frame: the detector's kept boxes in score order (frame pixels),
    their scores and classes; ``slots`` the indices of those that fill the
    tracker's detection slots, in order; ``feats`` (len(slots), D) unit
    features or None where a slot has none."""
    boxes: np.ndarray
    scores: np.ndarray
    classes: np.ndarray
    slots: np.ndarray
    feats: list


def crops(frame: torch.Tensor, boxes: np.ndarray, out_hw=(128, 64)):
    """DeepSORT's crops of one ``(H, W, 3)`` uint8 BGR frame: each box's
    truncated, frame-clamped extent resized bilinearly (half-pixel centres,
    clamped to the extent) to ``out_hw``, RGB, ImageNet-normalized:
    ``(n, 3, oh, ow)`` f32, and which boxes had a non-empty extent."""
    h, w = frame.shape[:2]
    oh, ow = out_hw
    img = frame.float()
    out = torch.zeros((len(boxes), 3, oh, ow), device=frame.device)
    ok = np.zeros(len(boxes), bool)
    mean = torch.tensor(IMAGENET_MEAN, device=frame.device)
    std = torch.tensor(IMAGENET_STD, device=frame.device)
    for n, bx in enumerate(boxes):
        x1, y1, x2, y2 = (int(np.clip(np.trunc(v), 0, lim))
                          for v, lim in zip(bx, (w, h, w, h)))
        if not (x1 < x2 and y1 < y2):
            continue
        ok[n] = True

        def axis(lo, hi, size, limit):
            c = lo + (np.arange(size) + 0.5) * ((hi - lo) / size) - 0.5
            c = np.clip(c, lo, max(hi - 1.0, lo))
            j0 = np.floor(c)
            return c, j0

        cx, jx = axis(x1, x2, ow, w)
        wx0 = np.where(jx < w, np.maximum(0, 1 - np.abs(cx - jx)), 0)
        wx1 = np.where(jx + 1 < w, np.maximum(0, 1 - np.abs(cx - jx - 1)), 0)
        jx0 = np.minimum(jx, w - 1).astype(np.int64)
        jx1 = np.minimum(jx + 1, w - 1).astype(np.int64)
        cy, jy = axis(y1, y2, oh, h)
        fy = cy - jy
        jy0 = np.minimum(jy, h - 1).astype(np.int64)
        jy1 = np.minimum(jy + 1, h - 1).astype(np.int64)
        t = lambda a: torch.as_tensor(a, device=frame.device)
        cols = (img[:, t(jx0)] * t(wx0).float()[None, :, None]
                + img[:, t(jx1)] * t(wx1).float()[None, :, None])
        fy_t = t(fy).float()[:, None, None]
        crop = cols[t(jy0)] * (1 - fy_t) + cols[t(jy1)] * fy_t
        crop = crop.flip(-1) / 255.0                       # RGB
        out[n] = ((crop - mean) / std).permute(2, 0, 1)
    return out, ok


class Perception:
    """The reference's per-frame work for one configuration.

    ``config``: the configuration file's dict. ``detector``: the family's
    ``Reference`` (``portbench/families``). ``reid_tree``: the Flax tree read
    from the same file the program loads (None: no appearance).
    ``precision``: ``"f32"`` or the control's ``"fp8"`` (:mod:`.nets`)."""

    def __init__(self, config: dict, detector, reid_tree=None,
                 device="cuda", precision: str = "f32"):
        self.c = config["pipeline"]
        self.device = torch.device(device)
        self.detector = detector
        self.reid = (ReIDRef(tree_to_device(reid_tree, self.device),
                             precision) if reid_tree is not None else None)
        self.tracked = np.asarray(self.c["tracked_class_ids"])

    @torch.no_grad()
    def __call__(self, frames_u8: np.ndarray, batch: int = 16) -> list:
        """``(B, H, W, 3)`` uint8 frames -> ``[FrameDets, ...]``."""
        out = []
        for lo in range(0, len(frames_u8), batch):
            fr = torch.from_numpy(np.ascontiguousarray(
                frames_u8[lo:lo + batch])).to(self.device)
            for f, dets in enumerate(self.detector(fr)):
                out.append(self._slots(fr[f], *dets))
        return out

    def _slots(self, frame, boxes, scores, classes) -> FrameDets:
        c = self.c
        trackable = np.isin(classes, self.tracked)
        if c["tracker"] == "bytetrack":
            elig = trackable & (scores > c["low_thresh"])
        else:
            elig = (trackable & (scores >= c["conf_threshold"])
                    & (scores >= c["min_confidence"]))
        slots = np.flatnonzero(elig)[:c["max_detections"]]
        feats = [None] * len(slots)
        if self.reid is not None and len(slots):
            n = min(len(slots), c["reid_crops"])
            cr, ok = crops(frame, boxes[slots[:n]], tuple(c["reid_hw"]))
            f = self.reid(cr).cpu().numpy()
            for j in range(n):
                if ok[j]:
                    feats[j] = f[j]
        return FrameDets(boxes, scores, classes, slots, feats)
