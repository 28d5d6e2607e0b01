"""MOTChallenge dataset harness: format I/O, per-sequence runs, reports.

The port of ``aicamera_tpu/mot.py``:

- readers and writers for the MOTChallenge text format
  (``frame,id,x,y,w,h,conf,class,visibility``; x/y are 1-based top-left,
  per the MOT16/17/20 devkit);
- a sequence runner that drives :class:`~aicamera_tpu_torch.runtime.pipeline.
  TrackingPipeline` over a sequence's image directory (``img1/*.jpg`` and
  ``*.png``, decoded without OpenCV) and collects per-frame hypotheses;
- per-sequence and aggregate reports: CLEAR-MOT, HOTA and IDF1, optionally
  after GSI post-processing (aggregation pools the raw error counts across
  sequences, the devkit's "overall" row).

Usage (``--device`` defaults to ``cuda``):
    python -m aicamera_tpu_torch.mot --data MOT17/train --out results/ [--run]
"""

from __future__ import annotations

import dataclasses
import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from .eval import (HOTAResult, IdentityResult, MOTResult, evaluate_hota,
                   evaluate_identity, evaluate_mot)
from .postprocess import gsi_smooth
from .utils.jpeg import read_jpeg
from .utils.png import read_png

# MOTChallenge class ids considered ground-truth targets for pedestrian
# tracking (devkit protocol): 1 = pedestrian. Class 7 (static person) and
# others are neither targets nor distractors we model here.
GT_TARGET_CLASSES = (1,)


@dataclasses.dataclass
class MOTFrame:
    """One frame of boxes in xyxy with ids (and optional confidences)."""
    boxes: np.ndarray  # (N, 4) float32 xyxy
    ids: np.ndarray    # (N,) int
    conf: np.ndarray   # (N,) float32


def _tlwh_to_xyxy(tlwh: np.ndarray) -> np.ndarray:
    out = tlwh.astype(np.float32).copy()
    out[:, 2:] = out[:, :2] + out[:, 2:]
    return out


def load_mot_file(path: str | Path,
                  min_confidence: float | None = None,
                  target_classes: Sequence[int] | None = None,
                  ) -> Dict[int, MOTFrame]:
    """Parse a MOTChallenge txt (gt.txt / det.txt / results) into frames.

    MOT coordinates are 1-based ``(x, y, w, h)``; returned boxes are 0-based
    xyxy. For ``gt.txt`` pass ``min_confidence=1`` (the conf column is the
    "consider" flag) and ``target_classes=GT_TARGET_CLASSES``; for detection
    or result files leave both None.
    """
    per_frame: Dict[int, List[Tuple[float, ...]]] = defaultdict(list)
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.replace(" ", ",").split(",")
            frame, tid = int(float(parts[0])), int(float(parts[1]))
            x, y, w, h = (float(v) for v in parts[2:6])
            conf = float(parts[6]) if len(parts) > 6 else 1.0
            cls = int(float(parts[7])) if len(parts) > 7 else -1
            if min_confidence is not None and conf < min_confidence:
                continue
            if target_classes is not None and cls not in target_classes:
                continue
            per_frame[frame].append((tid, x - 1.0, y - 1.0, w, h, conf))

    out: Dict[int, MOTFrame] = {}
    for frame, rows in per_frame.items():
        arr = np.asarray(rows, np.float32).reshape(-1, 6)
        out[frame] = MOTFrame(boxes=_tlwh_to_xyxy(arr[:, 1:5]),
                              ids=arr[:, 0].astype(np.int64),
                              conf=arr[:, 5])
    return out


def write_mot_file(path: str | Path, frames: Dict[int, MOTFrame]) -> None:
    """Write tracker hypotheses in the MOTChallenge submission format."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for frame in sorted(frames):
            fr = frames[frame]
            for box, tid, conf in zip(fr.boxes, fr.ids, fr.conf):
                x1, y1, x2, y2 = (float(v) for v in box)
                f.write(f"{frame},{int(tid)},{x1 + 1.0:.2f},{y1 + 1.0:.2f},"
                        f"{x2 - x1:.2f},{y2 - y1:.2f},{float(conf):.3f},"
                        f"-1,-1,-1\n")


def _frames_to_eval_lists(gt: Dict[int, MOTFrame], hyp: Dict[int, MOTFrame]):
    """Align the two frame dicts onto a common 1..max frame range."""
    last = max([*gt, *hyp], default=0)
    empty = (np.zeros((0, 4), np.float32), np.zeros((0,), np.int64))
    gt_list, hyp_list = [], []
    for t in range(1, last + 1):
        g = gt.get(t)
        h = hyp.get(t)
        gt_list.append((g.boxes, g.ids) if g else empty)
        hyp_list.append((h.boxes, h.ids) if h else empty)
    return gt_list, hyp_list


def evaluate_sequence(gt_path: str | Path, result_path: str | Path,
                      iou_threshold: float = 0.5) -> MOTResult:
    """Score one sequence's results file against its gt.txt."""
    gt = load_mot_file(gt_path, min_confidence=1,
                       target_classes=GT_TARGET_CLASSES)
    hyp = load_mot_file(result_path)
    gt_list, hyp_list = _frames_to_eval_lists(gt, hyp)
    return evaluate_mot(gt_list, hyp_list, iou_threshold=iou_threshold)


def evaluate_sequence_hota(gt_path: str | Path,
                           result_path: str | Path) -> HOTAResult:
    """HOTA for one sequence's results file against its gt.txt
    (eval.py::evaluate_hota — the MOT-challenge headline metric)."""
    gt = load_mot_file(gt_path, min_confidence=1,
                       target_classes=GT_TARGET_CLASSES)
    hyp = load_mot_file(result_path)
    gt_list, hyp_list = _frames_to_eval_lists(gt, hyp)
    return evaluate_hota(gt_list, hyp_list)


def evaluate_sequence_identity(gt_path: str | Path,
                               result_path: str | Path,
                               iou_threshold: float = 0.5
                               ) -> IdentityResult:
    """IDF1/IDP/IDR for one sequence's results file against its gt.txt
    (eval.py::evaluate_identity — global trajectory-level identity)."""
    gt = load_mot_file(gt_path, min_confidence=1,
                       target_classes=GT_TARGET_CLASSES)
    hyp = load_mot_file(result_path)
    gt_list, hyp_list = _frames_to_eval_lists(gt, hyp)
    return evaluate_identity(gt_list, hyp_list, iou_threshold=iou_threshold)


def aggregate(results: Dict[str, MOTResult]) -> MOTResult:
    """Pool raw error counts across sequences (the devkit OVERALL row)."""
    fp = sum(r.false_positives for r in results.values())
    fn = sum(r.misses for r in results.values())
    idsw = sum(r.id_switches for r in results.values())
    matches = sum(r.matches for r in results.values())
    num_gt = sum(r.num_gt for r in results.values())
    iou_sum = sum(r.motp * r.matches for r in results.values())
    return MOTResult(
        mota=1.0 - (fn + fp + idsw) / max(num_gt, 1),
        motp=iou_sum / max(matches, 1),
        id_switches=idsw, false_positives=fp, misses=fn,
        matches=matches, num_gt=num_gt)


# --- sequence discovery / running -------------------------------------------

def sequence_frames(seq_dir: str | Path) -> Iterator[np.ndarray]:
    """Yield BGR frames for a MOTChallenge sequence directory: ``img1/*.jpg``
    then ``img1/*.png``, as the JAX harness orders them, decoded by
    ``utils/jpeg.py`` and ``utils/png.py`` (what ``cv2.imread`` returns)."""
    img_dir = Path(seq_dir) / "img1"
    files = sorted(img_dir.glob("*.jpg")) + sorted(img_dir.glob("*.png"))
    if not files:
        raise FileNotFoundError(f"no frames under {img_dir}")
    for p in files:
        yield read_jpeg(p) if p.suffix == ".jpg" else read_png(p)


def run_sequence(seq_dir: str | Path, pipeline=None,
                 max_frames: int | None = None) -> Dict[int, MOTFrame]:
    """Track a MOTChallenge sequence; returns per-frame hypotheses.

    A fresh tracker state per sequence (ids restart at 1, matching the
    reference's per-run reset, aicamera_tracker.py:72).
    """
    if pipeline is None:  # the GPU; raises without one
        from .runtime.pipeline import TrackingPipeline
        pipeline = TrackingPipeline()
    pipeline.reset()

    def frames():
        for i, f in enumerate(sequence_frames(seq_dir)):
            if max_frames is not None and i >= max_frames:
                return
            yield f

    out: Dict[int, MOTFrame] = {}
    for result in pipeline.process_frames(frames()):
        if not result.tracks:
            continue
        rows = np.asarray([t[:4] for t in result.tracks], np.float32)
        ids = np.asarray([t[4] for t in result.tracks], np.int64)
        conf = np.asarray([t[6] for t in result.tracks], np.float32)
        out[result.frame_index + 1] = MOTFrame(boxes=rows, ids=ids, conf=conf)
    return out


def discover_sequences(data_dir: str | Path) -> List[Path]:
    """Sequences = subdirectories containing img1/ (MOTChallenge layout)."""
    root = Path(data_dir)
    return sorted(p for p in root.iterdir()
                  if p.is_dir() and (p / "img1").is_dir())


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="MOT-Challenge evaluation harness")
    ap.add_argument("--data", required=True,
                    help="MOTChallenge split dir (contains sequence dirs)")
    ap.add_argument("--out", default="mot_results",
                    help="directory for result txt files")
    ap.add_argument("--run", action="store_true",
                    help="run the tracker (otherwise score existing results)")
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument("--iou", type=float, default=0.5)
    ap.add_argument("--tracker", default="deepsort",
                    choices=("deepsort", "strongsort", "bytetrack",
                             "botsort", "ocsort", "deepocsort"),
                    help="tracker core to run (--run mode)")
    ap.add_argument("--device", default="cuda",
                    help="device of the --run pipeline: 'cuda' (default) "
                         "or 'cpu'")
    ap.add_argument("--yolo_weights", default=None,
                    help="detector weights (.msgpack or .onnx) for --run; "
                         "default config.YOLO_PARAMS_PATH")
    ap.add_argument("--reid_weights", default=None,
                    help="ReID weights (.msgpack or .onnx) for --run; default "
                         "config.REID_PARAMS_PATH")
    ap.add_argument("--gsi", action="store_true",
                    help="also score GSI-post-processed results "
                         "(postprocess.gsi_smooth: gap interpolation + "
                         "GP smoothing) and write <seq>.gsi.txt")
    args = ap.parse_args(argv)

    seqs = discover_sequences(args.data)
    if not seqs:
        raise SystemExit(f"no sequences found under {args.data}")
    out_dir = Path(args.out)

    if args.run:
        from .runtime.pipeline import TrackingPipeline
        pipeline = TrackingPipeline(tracker=args.tracker,
                                    yolo_weights=args.yolo_weights,
                                    reid_weights=args.reid_weights,
                                    device=args.device)
        for seq in seqs:
            hyp = run_sequence(seq, pipeline, max_frames=args.max_frames)
            write_mot_file(out_dir / f"{seq.name}.txt", hyp)
            print(f"ran {seq.name}: {sum(len(f.ids) for f in hyp.values())} "
                  f"boxes over {len(hyp)} frames")

    results: Dict[str, MOTResult] = {}
    hotas = {}
    idents = {}
    gsis = {}
    for seq in seqs:
        gt_path = seq / "gt" / "gt.txt"
        res_path = out_dir / f"{seq.name}.txt"
        if not gt_path.exists() or not res_path.exists():
            print(f"skip {seq.name}: missing "
                  f"{'gt' if not gt_path.exists() else 'results'}")
            continue
        results[seq.name] = evaluate_sequence(gt_path, res_path,
                                              iou_threshold=args.iou)
        hotas[seq.name] = evaluate_sequence_hota(gt_path, res_path)
        idents[seq.name] = evaluate_sequence_identity(
            gt_path, res_path, iou_threshold=args.iou)
        if args.gsi:
            gt_f = load_mot_file(gt_path, min_confidence=1,
                                 target_classes=GT_TARGET_CLASSES)
            hyp_f = load_mot_file(res_path)
            gt_list, hyp_list = _frames_to_eval_lists(gt_f, hyp_f)
            smooth = gsi_smooth(hyp_list)
            gsi_path = out_dir / f"{seq.name}.gsi.txt"
            write_mot_file(gsi_path, {
                t + 1: MOTFrame(boxes=b, ids=i,
                                conf=np.ones(len(i), np.float32))
                for t, (b, i) in enumerate(smooth) if len(i)})
            gsis[seq.name] = (
                evaluate_mot(gt_list, smooth, iou_threshold=args.iou),
                evaluate_hota(gt_list, smooth))

    report = {}
    for name, r in results.items():
        row = r.as_dict()
        h = hotas[name]
        ident = idents[name]
        row.update(hota=round(h.hota, 4), det_a=round(h.det_a, 4),
                   ass_a=round(h.ass_a, 4),
                   idf1=round(ident.idf1, 4), idp=round(ident.idp, 4),
                   idr=round(ident.idr, 4))
        if name in gsis:
            g_mot, g_hota = gsis[name]
            row.update(gsi_mota=round(g_mot.mota, 4),
                       gsi_motp=round(g_mot.motp, 4),
                       gsi_hota=round(g_hota.hota, 4))
        report[name] = row
    if results:
        report["OVERALL"] = aggregate(results).as_dict()
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
