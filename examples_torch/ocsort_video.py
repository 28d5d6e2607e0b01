"""OC-SORT: observation-centric motion tracking (no ReID model).

A drop-in swap for DeepSORT with the same ``update`` contract. Association
is IoU plus a velocity-direction momentum bonus (OCM); lost tracks recover
by their last observation box (OCR) and the Kalman state replays the
missed trajectory on revival (ORU: on the GPU one launch of the ORU kernel
an update, ``csrc/oru.cu``). Two usage modes:

1. Facade loop (below): ``YOLODetector.detect`` then ``OCSort.update``.
   OC-SORT gates its input strictly at ``det_thresh`` (0.6 by default) —
   run the detector at or below that so the tracker sees every box it
   would accept.
2. Fused pipeline: ``TrackingPipeline(tracker="ocsort")`` or CLI
   ``--tracker ocsort`` (the ReID crop/embed stage disappears from the
   device step entirely).

    python examples_torch/ocsort_video.py [--device cpu] [--input clip.avi]
        [--frames 16]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples_torch._common import parse_args, frames  # noqa: E402


def main(argv=None):
    args = parse_args(__doc__, extra=lambda ap: (
        ap.add_argument("--input", help="MJPEG .avi or .npy of frames "
                                        "(default: synthetic)"),
        ap.add_argument("--frames", type=int, default=16),
    ), argv=argv)

    from aicamera_tpu_torch.detector import YOLODetector
    from aicamera_tpu_torch.ocsort_api import OCSort

    det = YOLODetector(conf_threshold=0.3, device=args.device)
    # det_thresh=0.6, iou_threshold=0.3, min_hits=3
    tracker = OCSort(device=args.device)

    for i, frame in enumerate(frames(args)):
        boxes, scores, class_ids, keep = det.detect(frame)
        tracks = tracker.update(boxes[keep], scores[keep], class_ids[keep],
                                frame)
        print(f"frame {i:3d}: {len(keep)} detections, "
              f"{len(tracks)} emitted tracks")
        for x1, y1, x2, y2, tid, cls, conf in tracks:
            print(f"    ID:{tid} {cls} {conf:.2f} ({x1},{y1},{x2},{y2})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
