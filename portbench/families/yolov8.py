"""YOLOv8 (Ultralytics' ``yolov8.yaml``, every scale): the program's
arguments, the seeded weights, the reference's letterbox, DFL decode and
class-aware greedy NMS, and the FLOP count. See ``portbench/families``."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from portbench import weights
from portbench.reference import msgpack_io
from portbench.reference.letterbox import Letterbox
from portbench.reference.nets import YOLOv8Ref, tree_to_device
from portbench.yardstick import arch

ROOT = Path(__file__).resolve().parents[2]
CLASS_OFFSET = 8192.0


def program_kwargs(config: dict) -> dict:
    p = config["pipeline"]
    return dict(variant=config["port_variant"],
                input_shape=tuple(p["input_hw"]),
                conf_threshold=p["conf_threshold"],
                nms_threshold=p["nms_iou"])


def make_weights(spec: dict, config: dict, seed: int, device):
    """``{"embed": <trained checkpoint, relative to the checkout>}``: the
    configuration's scale drawn from the seed with the trained model written
    into it (:func:`portbench.weights.embedded_yolo`)."""
    small = msgpack_io.load_flax_msgpack(ROOT / spec["embed"])
    m = config["model"]
    shapes = arch.yolo_shapes(m["depth_multiple"], m["width_multiple"],
                              m["max_channels"], m["num_classes"])
    return weights.embedded_yolo(small, shapes, seed, device)


def flops(config: dict) -> int:
    return arch.yolo_flops(config["model"], config["pipeline"]["input_hw"])


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


class Reference:
    """Letterbox, YOLOv8 (:class:`~portbench.reference.nets.YOLOv8Ref`), DFL
    decode, greedy NMS, boxes back to frame pixels."""

    def __init__(self, config: dict, frame_hw, tree, device,
                 precision: str = "f32"):
        self.c = config["pipeline"]
        device = torch.device(device)
        self.net = YOLOv8Ref(tree_to_device(tree, device), precision)
        self.lb = Letterbox(frame_hw, self.c["input_hw"], device)

    def __call__(self, frames_u8: torch.Tensor) -> list:
        c = self.c
        out = []
        for bx, sc, cl in decode(self.net(self.lb(frames_u8)),
                                 c["nms_score_floor"], c["nms_top_k"]):
            keep = greedy_nms(bx.cpu().numpy(), cl.cpu().numpy(),
                              c["nms_iou"], c["max_det"])
            out.append((self.lb.unscale(bx[keep]).cpu().numpy(),
                        sc[keep].cpu().numpy(),
                        cl[keep].cpu().numpy().astype(np.int32)))
        return out
