"""The per-frame half of the reference: letterbox, YOLOv8, DFL decode, NMS,
box unscaling, the tracker's detection slots, crops and ReID.

Plain PyTorch in f32 (TF32 off), one frame's detections at a time where the
algorithm is sequential (the greedy NMS), written from the published
algorithms (Ultralytics' letterbox, DFL decode and class-aware greedy NMS;
DeepSORT's crop and embed) and the values the configuration states.
Nothing here depends on the batch a frame came in.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .nets import ReIDRef, YOLOv8Ref

PAD = 114.0
CLASS_OFFSET = 8192.0
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


def decode(levels, score_floor: float, top_k: int, strides=(8, 16, 32)):
    """Per frame of the batch: the ``top_k`` best anchors by their best
    class score (ties: lower anchor first), those at or above
    ``score_floor``, with DFL-decoded boxes in letterboxed pixels:
    ``[(boxes (k, 4), scores (k,), classes (k,)), ...]``."""
    b = levels[0][0].shape[0]
    bins = torch.cat([bb.reshape(b, -1, bb.shape[-1]) for bb, _ in levels], 1)
    logits = torch.cat([cl.reshape(b, -1, cl.shape[-1]) for _, cl in levels],
                       1)
    centers, st = [], []
    for (bb, _), s in zip(levels, strides):
        h, w = bb.shape[1:3]
        ys, xs = torch.meshgrid(torch.arange(h, device=bb.device) + 0.5,
                                torch.arange(w, device=bb.device) + 0.5,
                                indexing="ij")
        centers.append(torch.stack([xs.reshape(-1), ys.reshape(-1)], -1))
        st.append(torch.full((h * w,), float(s), device=bb.device))
    centers, st = torch.cat(centers), torch.cat(st)
    reg = bins.shape[-1] // 4
    best, cls = logits.max(-1)          # the first maximum
    score = torch.sigmoid(best)
    out = []
    for f in range(b):
        ok = score[f] >= score_floor
        cand = torch.where(ok, score[f], torch.full_like(score[f], -1.0))
        order = torch.sort(cand, descending=True, stable=True).indices
        order = order[:top_k]
        order = order[cand[order] > 0]
        d = torch.softmax(bins[f, order].reshape(-1, 4, reg), -1) @ \
            torch.arange(reg, dtype=torch.float32, device=bins.device)
        c, s = centers[order], st[order][:, None]
        boxes = torch.cat([c - d[:, :2], c + d[:, 2:]], -1) * s
        out.append((boxes, score[f, order], cls[f, order]))
    return out


def greedy_nms(boxes: np.ndarray, classes: np.ndarray, iou_thr: float,
               max_det: int) -> np.ndarray:
    """Class-aware greedy NMS over score-ordered boxes: a box is kept
    unless a kept box before it overlaps it by IoU above ``iou_thr``.
    Returns the first ``max_det`` kept indices."""
    b = boxes.astype(np.float64) + (classes.astype(np.float64)
                                    * CLASS_OFFSET)[:, None]
    area = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1],
                                                         0, None)
    keep = []
    alive = np.ones(len(b), bool)
    for i in range(len(b)):
        if not alive[i]:
            continue
        keep.append(i)
        if len(keep) == max_det:
            break
        iw = np.clip(np.minimum(b[i, 2], b[:, 2])
                     - np.maximum(b[i, 0], b[:, 0]), 0, None)
        ih = np.clip(np.minimum(b[i, 3], b[:, 3])
                     - np.maximum(b[i, 1], b[:, 1]), 0, None)
        inter = iw * ih
        iou = inter / np.maximum(area[i] + area - inter, 1e-7)
        alive &= ~(iou > iou_thr)
    return np.asarray(keep, np.int64)


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

    ``config``: the configuration file's dict. ``yolo_tree``/``reid_tree``:
    the Flax trees read from the same files the program loads (``reid_tree``
    None: no appearance). ``precision``: ``"f32"`` or the control's
    ``"fp8"`` (:mod:`.nets`)."""

    def __init__(self, config: dict, frame_hw, yolo_tree, reid_tree=None,
                 device="cuda", precision: str = "f32"):
        from .nets import tree_to_device
        self.c = config["pipeline"]
        self.device = torch.device(device)
        self.yolo = YOLOv8Ref(tree_to_device(yolo_tree, self.device),
                              precision)
        self.reid = (ReIDRef(tree_to_device(reid_tree, self.device),
                             precision) if reid_tree is not None else None)
        self.lb = Letterbox(frame_hw, self.c["input_hw"], self.device)
        self.tracked = np.asarray(self.c["tracked_class_ids"])

    @torch.no_grad()
    def __call__(self, frames_u8: np.ndarray, batch: int = 16) -> list:
        """``(B, H, W, 3)`` uint8 frames -> ``[FrameDets, ...]``."""
        out = []
        for lo in range(0, len(frames_u8), batch):
            fr = torch.from_numpy(np.ascontiguousarray(
                frames_u8[lo:lo + batch])).to(self.device)
            levels = self.yolo(self.lb(fr))
            for f, (bx, sc, cl) in enumerate(decode(
                    levels, self.c["nms_score_floor"], self.c["nms_top_k"])):
                keep = greedy_nms(bx.cpu().numpy(), cl.cpu().numpy(),
                                  self.c["nms_iou"], self.c["max_det"])
                boxes = self.lb.unscale(bx[keep]).cpu().numpy()
                scores = sc[keep].cpu().numpy()
                classes = cl[keep].cpu().numpy().astype(np.int32)
                out.append(self._slots(fr[f], boxes, scores, classes))
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
