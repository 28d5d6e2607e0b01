"""Train YOLOv8n (or the ReID embedder, or RT-DETR-L) on the synthetic
world on the card and save a checkpoint that passes the quality gate.

The port of ``scripts/train_synthetic.py``. Scenes are rendered on the
device (:mod:`.synthetic`), the trainer is :mod:`.train`, and the result is
evaluated through the real detect path (letterbox kernel, DFL decode, NMS):
precision and recall at IoU 0.5 with the class matched, and COCO AP. It is
saved only if it clears the gate, as Flax-layout msgpack that the JAX
package loads as well.

    python -m aicamera_tpu_torch.train_synthetic --out /tmp/yolo.msgpack
        [--steps 3000] [--batch 8] [--scan 25] [--lr 2e-3] [--crowd]
        [--reid] [--eval-only] [--device cuda|cpu]
    python -m aicamera_tpu_torch.train_synthetic --detector rtdetr-l
        [--steps 6000] [--batch 16] [--lr 2e-4] [--pool 2048] [--refresh 16]
        [--vfl-alpha 0.75] [--init W.msgpack] [--minutes M]
        [--candidate PATH] [--eval-only]

Without ``--out`` it writes over the committed checkpoint
(``models/detection/yolov8n_synthetic.msgpack``; ``--reid``:
``models/reid/deepsort_reid_synthetic.msgpack``; ``--detector rtdetr-l``:
``models/detection/rtdetr_l_synthetic.msgpack``), as the JAX script does.

RT-DETR-L (``train.train_rtdetr``) trains on pools of scenes of the default
world and of 1280x720 frames, and is saved in float16 (its trained form,
BatchNorms unfolded) only if its precision and recall come within 0.05 of
the committed YOLOv8n's, evaluated on the same scenes in the same run;
``--init`` continues from earlier weights, ``--candidate`` keeps weights
that miss the gate for that.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import config, prng
from .device import resolve_device
from .eval import _iou_matrix, evaluate_detections
from .models.rtdetr import postprocess as rtdetr_postprocess
from .ops.crops import extract_reid_crops
from .ops.letterbox import letterbox
from .ops.nms import fused_decode_nms
from .ops.preprocess import letterbox_spec, scale_boxes_back
from .runtime.params import (compute_dtype, flax_tree,
                             resolve_reid_params,
                             resolve_yolo_params, write_flax_msgpack)
from .runtime.pipeline import precision
from .synthetic import WorldSpec, ground_truth, random_objects, render
from .train import _forward

DEFAULT_OUT = config.YOLO_SYNTHETIC_PATH
RTDETR_OUT = config.RTDETR_SYNTHETIC_PATH
#: how far RT-DETR-L's precision and recall may lie below YOLOv8n's
RTDETR_GATE = 0.05
CROWD_OUT = config.YOLO_SYNTHETIC_CROWD_PATH


def _crowd_world():
    # occlusion_aware_gt: training and eval only on >=25%-visible objects
    # (MOTChallenge-style) keep the targets learnable. size_scale 0.45 and
    # 128 slots: at the default size the objects carry ~1.8x the frame's
    # area and mutual occlusion buries most of them; at 0.45 ~83 stay
    # visible at once, the density the crowd benchmark scores.
    return WorldSpec(max_objects=128, presence=0.9, size_scale=0.45,
                     occlusion_aware_gt=True)


def _yolo_detect(model, x, dtype):
    with precision(dtype):
        levels = _forward(model, x, dtype)
    return fused_decode_nms(levels, score_threshold=0.25, iou_threshold=0.5)


def _rtdetr_detect(model, x, dtype):
    with precision(dtype):
        boxes, logits = model(x)
    return rtdetr_postprocess(boxes, logits, x.shape[-2:], 0.25)


@torch.no_grad()
def evaluate(model, world, input_hw, n_scenes=48, conf=0.3, iou_match=0.5,
             seed=7777, dtype=None, detector="yolov8"):
    """Precision and recall of the full detect path on fresh scenes:
    ``(prec, rec, tp, fp, fn, ap)``. ``model`` runs on its own device,
    in ``dtype`` (default bf16 on the GPU, f32 on the CPU). ``detector``:
    ``"yolov8"`` (DFL decode and NMS) or ``"rtdetr"`` (an RT-DETR in its
    inference form, ``RTDETR.to_inference``, and its NMS-free
    post-process); either keeps scores down to 0.25."""
    detect = _rtdetr_detect if detector == "rtdetr" else _yolo_detect
    device = next(model.parameters()).device
    dtype = dtype or compute_dtype(device)
    spec = letterbox_spec(world.hw, input_hw)
    b = 8
    tp = fp = fn = 0
    gt_frames, pred_frames = [], []   # for COCO AP (eval.py)
    keys = prng.split(prng.PRNGKey(seed), n_scenes)
    for i in range(0, n_scenes, b):
        frames, gtb, gtc, gtv = [], [], [], []
        for k in keys[i:i + b]:
            ko, kr = prng.split(k)
            obj = random_objects(ko, world, device)
            frames.append(render(obj, world, kr))
            for lst, t in zip((gtb, gtc, gtv), ground_truth(obj, world)):
                lst.append(t)
        num, boxes, scores, labels = detect(
            model, letterbox(torch.stack(frames), spec, dtype), dtype)
        out = (num, scale_boxes_back(boxes, spec), scores, labels,
               torch.stack(gtb), torch.stack(gtc), torch.stack(gtv))
        num, boxes, scores, labels, gtb_, gtc_, gtv_ = (
            t.cpu().numpy() for t in out)
        for j in range(len(num)):
            # AP scores the full PR curve: every decoded detection (down to
            # the NMS score floor of 0.25), not only those above the
            # precision/recall threshold `conf`
            keep = list(range(int(num[j])))
            pred_frames.append((boxes[j, keep], scores[j, keep],
                                labels[j, keep]))
            gt_frames.append((gtb_[j][gtv_[j]], gtc_[j][gtv_[j]]))
            det = [(boxes[j, d], labels[j, d], scores[j, d])
                   for d in range(num[j]) if scores[j, d] >= conf]
            det.sort(key=lambda t: -t[2])
            gt = [(gtb_[j, g], gtc_[j, g]) for g in range(len(gtv_[j]))
                  if gtv_[j, g]]
            used = [False] * len(gt)
            iou = _iou_matrix(
                np.array([d[0] for d in det], np.float32).reshape(-1, 4),
                np.array([g[0] for g in gt], np.float32).reshape(-1, 4))
            for di, (_, dcls, _s) in enumerate(det):
                best, bi = 0.0, -1
                for g, (_, gcls) in enumerate(gt):
                    if used[g] or gcls != dcls:
                        continue
                    if iou[di, g] > best:
                        best, bi = float(iou[di, g]), g
                if best >= iou_match:
                    used[bi] = True
                    tp += 1
                else:
                    fp += 1
            fn += used.count(False)
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    ap = evaluate_detections(gt_frames, pred_frames)
    return prec, rec, tp, fp, fn, ap


@torch.no_grad()
def evaluate_reid(model, world, n_scenes=24, seed=5555, dtype=None):
    """Identity separation of the embedder: same-instance and
    different-instance cosine distance across two views per scene,
    ``(intra_mean, inter_mean, intra_p95, inter_p5)``."""
    device = next(model.parameters()).device
    dtype = dtype or compute_dtype(device)
    intra, inter = [], []
    for k in prng.split(prng.PRNGKey(seed), n_scenes):
        ko, ka, kb = prng.split(k, 3)
        obj = random_objects(ko, world, device)
        boxes, _, valid = ground_truth(obj, world)
        frames = torch.stack([render(obj, world, ka), render(obj, world, kb)])
        crops, ok = extract_reid_crops(frames, torch.stack([boxes, boxes]),
                                       compute_dtype=dtype)
        with precision(dtype):
            z = _forward(model, crops.flatten(0, 1), dtype).float()
        za, zb = z.view(2, -1, z.shape[-1])
        d = (1.0 - za @ zb.T).cpu().numpy()
        v = (valid & ok[0] & ok[1]).cpu().numpy()
        for i in range(len(v)):
            if not v[i]:
                continue
            intra.append(d[i, i])
            inter.extend(d[i, v & (np.arange(len(v)) != i)])
    return float(np.mean(intra)), float(np.mean(inter)), \
        float(np.percentile(intra, 95)), float(np.percentile(inter, 5))


def _save(model, path: Path):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(write_flax_msgpack(flax_tree(model)))
    print(f"saved {path} ({path.stat().st_size / 1e6:.1f} MB)")


def parse_arguments(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reid", action="store_true",
                    help="train the ReID embedder instead of the detector")
    # None = per-mode default (detector: 3000 steps / batch 8 / lr 2e-3;
    # reid: ReIDTrainConfig's). Explicit values are always honored.
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None,
                    help="images per step (detector) / scenes per step "
                         "(reid)")
    ap.add_argument("--scan", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--out", type=str, default=str(DEFAULT_OUT))
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--min-prec", type=float, default=0.85)
    # None = per-mode default (0.85; crowd: 0.6)
    ap.add_argument("--min-rec", type=float, default=None)
    ap.add_argument("--crowd", action="store_true",
                    help="fine-tune a crowd-density detector (128-slot "
                         "world at size_scale 0.45, ~83 visible objects a "
                         "scene) warm-started from the base synthetic "
                         "checkpoint; saves to "
                         "yolov8n_synthetic_crowd.msgpack")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--detector", default="yolov8n",
                    choices=("yolov8n", "rtdetr-l"))
    ap.add_argument("--pool", type=int, default=None,
                    help="rtdetr-l: scenes rendered a world size")
    ap.add_argument("--refresh", type=int, default=None,
                    help="rtdetr-l: scenes rendered anew a pool a dispatch")
    ap.add_argument("--vfl-alpha", type=float, default=None,
                    help="rtdetr-l: the varifocal loss's weight of an "
                         "unmatched query (Ultralytics' 0.75)")
    ap.add_argument("--init", type=str, default=None,
                    help="rtdetr-l: continue from these weights (the "
                         "trained form's .msgpack) with a fresh schedule")
    ap.add_argument("--minutes", type=float, default=None,
                    help="rtdetr-l: stop stepping after this many minutes")
    ap.add_argument("--candidate", type=str, default=None,
                    help="rtdetr-l: where to write the weights when they "
                         "miss the gate (for inspection; never the "
                         "committed path)")
    return ap.parse_args(argv)


def _rtdetr_trained(path):
    """RT-DETR-L in its trained form, from a ``.msgpack`` of it."""
    from .models.rtdetr import RTDETR
    from .runtime.params import (load_flax_msgpack, load_state_strict,
                                 rtdetr_state_dict_from_flax)
    model = RTDETR()
    load_state_strict(model, rtdetr_state_dict_from_flax(
        load_flax_msgpack(path)))
    return model


def _rtdetr_save(model, path: Path):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(write_flax_msgpack(flax_tree(model.float(), np.float16)))
    print(f"saved {path} ({path.stat().st_size / 1e6:.1f} MB)",
          file=sys.stderr)


def _rtdetr_main(args, device):
    """Train (or evaluate) RT-DETR-L; gate it on the committed YOLOv8n's
    precision and recall on the same scenes; save it in float16."""
    from .train import DetrTrainConfig, train_rtdetr
    import copy
    world = WorldSpec()
    input_hw = (640, 640)
    out = RTDETR_OUT if args.out == str(DEFAULT_OUT) else Path(args.out)
    if args.eval_only:
        trained = _rtdetr_trained(out)
    else:
        base = DetrTrainConfig()
        cfg = DetrTrainConfig(**{
            k: getattr(args, k) if getattr(args, k) is not None
            else getattr(base, k) for k in ("steps", "batch", "scan", "lr",
                                            "pool", "refresh", "vfl_alpha")})
        init = None
        if args.init:
            init = _rtdetr_trained(args.init)
            print(f"continuing from {args.init}")
        t0 = time.time()
        trained = train_rtdetr(
            input_hw=input_hw, cfg=cfg, model=init, device=device,
            max_seconds=None if args.minutes is None else 60 * args.minutes)
        print(f"trained in {time.time() - t0:.0f}s")
    model = copy.deepcopy(trained).to_inference(device, compute_dtype(device))
    yolo = resolve_yolo_params("n", weights_path=str(DEFAULT_OUT),
                               device=device, dtype=compute_dtype(device))
    rows = {}
    for name, m, kind in (("rtdetr-l", model, "rtdetr"),
                          ("yolov8n_synthetic", yolo, "yolov8")):
        prec, rec, tp, fp, fn, ap = evaluate(m, world, input_hw,
                                             detector=kind)
        rows[name] = {"precision": round(prec, 4), "recall": round(rec, 4),
                      "tp": tp, "fp": fp, "fn": fn,
                      "ap50": round(ap.ap50, 4), "ap75": round(ap.ap75, 4),
                      "map_5095": round(ap.map_5095, 4)}
    print(json.dumps(rows))
    if args.eval_only:
        return
    r, y = rows["rtdetr-l"], rows["yolov8n_synthetic"]
    if r["precision"] < y["precision"] - RTDETR_GATE \
            or r["recall"] < y["recall"] - RTDETR_GATE:
        print(f"more than {RTDETR_GATE} below YOLOv8n — NOT saving",
              file=sys.stderr)
        if args.candidate:
            _rtdetr_save(trained, Path(args.candidate))
        sys.exit(1)
    _rtdetr_save(trained, out)


def main(argv=None):
    args = parse_arguments(argv)
    device = resolve_device(args.device)
    if args.detector == "rtdetr-l":
        return _rtdetr_main(args, device)
    from .train import (ReIDTrainConfig, TrainConfig, train_detector,
                        train_reid)

    world = WorldSpec()
    input_hw = (640, 640)
    out = Path(args.out)
    if args.crowd:
        world = _crowd_world()
        if args.out == str(DEFAULT_OUT):
            out = CROWD_OUT
        if not args.reid:
            # crowd detector fine-tune defaults: fewer steps, a gentler lr
            # (warm start), a smaller batch (the 128-slot renderer's
            # ownership masks are ~10x the default world's memory)
            if args.steps is None:
                args.steps = 2000
            if args.lr is None:
                args.lr = 5e-4
            if args.batch is None:
                args.batch = 4
            # occlusion-heavy scenes cap attainable recall
            if args.min_rec is None:
                args.min_rec = 0.6
    if args.min_rec is None:
        args.min_rec = 0.85
    print(f"device={device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))

    if args.reid:
        base_reid = config.REID_SYNTHETIC_PATH
        if args.out != str(DEFAULT_OUT):
            reid_out = Path(args.out)
        elif args.crowd:
            reid_out = config.REID_SYNTHETIC_CROWD_PATH
        else:
            reid_out = base_reid
        if args.eval_only:
            model = resolve_reid_params(weights_path=str(reid_out),
                                        device=device, dtype=torch.float32)
        else:
            base = ReIDTrainConfig()
            init = None
            if args.crowd:
                # warm start, gentler lr, fewer steps: the base embedder's
                # features transfer; the margins on small occluded crops
                # are what is retrained
                if args.steps is None:
                    args.steps = 1500
                if args.lr is None:
                    args.lr = 5e-4
                if base_reid.exists():
                    print(f"warm-starting from {base_reid.name}")
                    init = resolve_reid_params(weights_path=str(base_reid),
                                               device=device,
                                               dtype=torch.float32)
            cfg = ReIDTrainConfig(
                steps=args.steps if args.steps is not None else base.steps,
                scenes=args.batch if args.batch is not None else base.scenes,
                scan=args.scan if args.scan is not None else base.scan,
                lr=args.lr if args.lr is not None else base.lr)
            t0 = time.time()
            model = train_reid(world=world, cfg=cfg, model=init,
                               device=device)
            print(f"trained reid in {time.time() - t0:.0f}s")
        intra, inter, intra95, inter5 = evaluate_reid(model, world)
        print(json.dumps({"intra_mean": round(intra, 4),
                          "inter_mean": round(inter, 4),
                          "intra_p95": round(intra95, 4),
                          "inter_p5": round(inter5, 4),
                          "world": "crowd" if args.crowd else "default"}))
        if args.eval_only:
            return
        # The appearance gate is 0.2 cosine distance (reference MAX_DIST):
        # same-identity pairs must sit inside it, others far outside; crowd
        # crops are tiny and occluded, so their bar asks for a usable margin.
        intra_bar, inter_bar = (0.2, 0.2) if args.crowd else (0.15, 0.25)
        if intra95 > intra_bar or inter5 < inter_bar:
            print(f"embedding margin below bar (intra_p95 {intra95:.3f} "
                  f"> {intra_bar} or inter_p5 {inter5:.3f} < {inter_bar}) "
                  "— NOT saving", file=sys.stderr)
            sys.exit(1)
        _save(model, reid_out)
        return

    if args.eval_only:
        model = resolve_yolo_params("n", weights_path=str(out),
                                    device=device, dtype=torch.float32)
    else:
        base = TrainConfig()
        cfg = TrainConfig(
            steps=args.steps if args.steps is not None else base.steps,
            batch=args.batch if args.batch is not None else base.batch,
            scan=args.scan if args.scan is not None else base.scan,
            lr=args.lr if args.lr is not None else base.lr)
        init = None
        if args.crowd and DEFAULT_OUT.exists():
            print(f"warm-starting from {DEFAULT_OUT.name}")
            init = resolve_yolo_params("n", weights_path=str(DEFAULT_OUT),
                                       device=device, dtype=torch.float32)
        t0 = time.time()
        model = train_detector(world=world, input_hw=input_hw, cfg=cfg,
                               model=init, device=device)
        print(f"trained {cfg.steps} steps in {time.time() - t0:.0f}s")

    prec, rec, tp, fp, fn, ap = evaluate(model, world, input_hw)
    print(json.dumps({"precision": round(prec, 4), "recall": round(rec, 4),
                      "tp": tp, "fp": fp, "fn": fn,
                      "ap50": round(ap.ap50, 4),
                      "ap75": round(ap.ap75, 4),
                      "map_5095": round(ap.map_5095, 4),
                      "ap_score_floor": 0.25}))
    if args.eval_only:
        return
    if prec < args.min_prec or rec < args.min_rec:
        print(f"below bar (min_prec={args.min_prec}, min_rec={args.min_rec})"
              " — NOT saving", file=sys.stderr)
        sys.exit(1)
    _save(model, out)


if __name__ == "__main__":
    main()
