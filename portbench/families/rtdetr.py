"""RT-DETR-L (arXiv:2304.08069; Ultralytics' ``rtdetr-l.yaml``): the
program's arguments, the seeded weights, the reference's letterbox,
forward and NMS-free post-process, and the FLOP count. See
``portbench/families``."""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.letterbox import Letterbox
from portbench.reference.rtdetr import RTDETRRef, tree_to_device

NUM_CLASSES = 80
HIDDEN = 256


def program_kwargs(config: dict) -> dict:
    p = config["pipeline"]
    return dict(detector=config["port_detector"],
                num_queries=config["model"]["num_queries"],
                input_shape=tuple(p["input_hw"]),
                conf_threshold=p["conf_threshold"])


# --- the tree's shapes ---------------------------------------------------------

def _conv(cin, cout, k=1, groups=1):
    return {"conv": {"kernel": (k, k, cin // groups, cout)},
            "bn": {"scale": (cout,), "bias": (cout,), "mean": (cout,),
                   "var": (cout,)}}


def _dense(cin, cout):
    return {"kernel": (cin, cout), "bias": (cout,)}


def _norm(d=HIDDEN):
    return {"scale": (d,), "bias": (d,)}


def _mlp(din, dh, dout, n):
    dims = [din] + [dh] * (n - 1) + [dout]
    return {f"l{i}": _dense(dims[i], dims[i + 1]) for i in range(n)}


def _hgblock(c1, cm, c2, k, light, n=6):
    out = {}
    for i in range(n):
        cin = c1 if i == 0 else cm
        out[f"m{i}"] = ({"conv1": _conv(cin, cm), "conv2": _conv(cm, cm, k,
                                                                 cm)}
                        if light else _conv(cin, cm, k))
    out["sc"] = _conv(c1 + n * cm, c2 // 2)
    out["ec"] = _conv(c2 // 2, c2)
    return out


def _repc3(c1, c2, n=3):
    out = {"cv1": _conv(c1, c2), "cv2": _conv(c1, c2)}
    for i in range(n):
        out[f"m{i}"] = {"conv1": _conv(c2, c2, 3), "conv2": _conv(c2, c2)}
    return out


def _attention(d=HIDDEN):
    return {k: _dense(d, d) for k in ("q", "k", "v", "out")}


def shapes(num_classes: int = NUM_CLASSES, d: int = HIDDEN) -> dict:
    """``{"params": tree}`` of RT-DETR-L's leaf shapes at the published
    widths, under the program's module names (conv kernels HWIO, Dense
    kernels ``(in, out)``)."""
    backbone = {
        "stem": {"stem1": _conv(3, 32, 3), "stem2a": _conv(32, 16, 2),
                 "stem2b": _conv(16, 32, 2), "stem3": _conv(64, 32, 3),
                 "stem4": _conv(32, 48)},
        "stage1": _hgblock(48, 48, 128, 3, False),
        "down1": _conv(128, 128, 3, 128),
        "stage2": _hgblock(128, 96, 512, 3, False),
        "down2": _conv(512, 512, 3, 512),
        "stage3a": _hgblock(512, 192, 1024, 5, True),
        "stage3b": _hgblock(1024, 192, 1024, 5, True),
        "stage3c": _hgblock(1024, 192, 1024, 5, True),
        "down3": _conv(1024, 1024, 3, 1024),
        "stage4": _hgblock(1024, 384, 2048, 5, True),
    }
    encoder = {"proj0": _conv(512, d), "proj1": _conv(1024, d),
               "proj2": _conv(2048, d),
               "aifi": {"attn": _attention(d), "norm1": _norm(d),
                        "fc1": _dense(d, 1024), "fc2": _dense(1024, d),
                        "norm2": _norm(d)},
               "lat0": _conv(d, d), "fpn0": _repc3(2 * d, d),
               "lat1": _conv(d, d), "fpn1": _repc3(2 * d, d),
               "down0": _conv(d, d, 3), "pan0": _repc3(2 * d, d),
               "down1": _conv(d, d, 3), "pan1": _repc3(2 * d, d)}
    decoder = {f"proj{i}": _conv(d, d) for i in range(3)}
    decoder.update(enc_linear=_dense(d, d), enc_norm=_norm(d),
                   enc_score=_dense(d, num_classes),
                   enc_bbox=_mlp(d, d, 4, 3), query_pos=_mlp(4, 2 * d, d, 2))
    for i in range(6):
        decoder[f"layer{i}"] = {
            "attn": _attention(d), "norm1": _norm(d),
            "msda": {"offsets": _dense(d, 8 * 3 * 4 * 2),
                     "weights": _dense(d, 8 * 3 * 4), "value": _dense(d, d),
                     "out": _dense(d, d)},
            "norm2": _norm(d), "fc1": _dense(d, 1024), "fc2": _dense(1024, d),
            "norm3": _norm(d)}
        decoder[f"score{i}"] = _dense(d, num_classes)
        decoder[f"bbox{i}"] = _mlp(d, d, 4, 3)
    return {"params": {"backbone": backbone, "encoder": encoder,
                       "decoder": decoder}}


def _draw(node, rng, name=""):
    if isinstance(node, dict) and not all(isinstance(v, tuple)
                                          for v in node.values()):
        return {k: _draw(v, rng, k) for k, v in node.items()}
    out = {}
    for leaf, shape in node.items():
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            a = rng.normal(0.0, fan_in ** -0.5, shape)
        elif leaf in ("scale",):
            a = rng.uniform(0.5, 1.5, shape)
        elif leaf == "var":
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = rng.normal(0.0, 0.1, shape)
        out[leaf] = a.astype(np.float32)
    return out


def make_weights(spec: dict, config: dict, seed: int, device):
    """``{"seeded": true}``: every leaf drawn from ``seed`` (kernels
    N(0, 1/fan-in), norms' scales and BatchNorm variances U(0.5, 1.5),
    other terms N(0, 0.1)): weights for the CPU tests, whose detections
    are not the trained model's."""
    rng = np.random.default_rng(np.random.SeedSequence(int(seed)
                                                       & (2 ** 64 - 1)))
    return _draw(shapes(), rng)


def flops(config: dict) -> int:
    """Two a multiply-add of every convolution, dense layer and attention
    product of one frame at ``input_hw``, counted from the layer shapes by
    running the reference on the meta device (no arithmetic runs); the
    bilinear sampling, norms and activations are not counted."""
    h, w = config["pipeline"]["input_hw"]
    tree = _meta(shapes()["params"])
    net = RTDETRRef(tree)
    x = torch.zeros(1, 3, h, w, device="meta")
    with FlopCounterMode(display=False) as fc:
        net(x)
    return int(fc.get_total_flops())


def _meta(node):
    if isinstance(node, tuple):
        return torch.zeros(node, device="meta")
    return {k: _meta(v) for k, v in node.items()}


# --- the reference -------------------------------------------------------------

def post_process(boxes, logits, input_hw, score_floor: float, max_det: int):
    """Per frame of the batch, RT-DETR's NMS-free post-process in f32:
    each query's best class probability and that class (the first of
    equals), the ``max_det`` best queries by it (equal scores keep the
    query order), those at or above ``score_floor``, boxes cxcywh ->
    xyxy in input pixels: ``[(boxes (k, 4), scores (k,), classes (k,)),
    ...]``."""
    ih, iw = input_hw
    out = []
    for f in range(boxes.shape[0]):
        prob = torch.sigmoid(logits[f].float())
        score, cls = prob.max(-1)
        order = sorted(range(len(score)),
                       key=lambda i: (-float(score[i]), i))[:max_det]
        order = [i for i in order if float(score[i]) >= score_floor]
        idx = torch.as_tensor(order, dtype=torch.long,
                              device=boxes.device)
        b = boxes[f, idx].float()
        xyxy = torch.stack([(b[:, 0] - b[:, 2] / 2) * iw,
                            (b[:, 1] - b[:, 3] / 2) * ih,
                            (b[:, 0] + b[:, 2] / 2) * iw,
                            (b[:, 1] + b[:, 3] / 2) * ih], -1)
        out.append((xyxy, score[idx], cls[idx]))
    return out


class Reference:
    """Letterbox, RT-DETR-L (:class:`~portbench.reference.rtdetr.RTDETRRef`),
    the NMS-free post-process, boxes back to frame pixels."""

    def __init__(self, config: dict, frame_hw, tree, device,
                 precision: str = "f32"):
        self.c = config["pipeline"]
        device = torch.device(device)
        self.net = RTDETRRef(tree_to_device(tree, device), precision,
                             config["model"]["num_queries"])
        self.lb = Letterbox(frame_hw, self.c["input_hw"], device)

    @torch.no_grad()
    def __call__(self, frames_u8: torch.Tensor) -> list:
        c = self.c
        boxes, logits = self.net(self.lb(frames_u8))
        out = []
        for bx, sc, cl in post_process(boxes, logits, c["input_hw"],
                                       c["nms_score_floor"], c["max_det"]):
            out.append((self.lb.unscale(bx).cpu().numpy(), sc.cpu().numpy(),
                        cl.cpu().numpy().astype(np.int32)))
        return out
