"""ByteTrack: the alternative tracker core (motion-only, no ReID model).

A drop-in swap for DeepSORT with the same ``update`` contract. Two usage
modes:

1. Facade loop (below): ``YOLODetector.detect`` at a LOW confidence
   threshold — ByteTrack's second association stage recovers occluded
   objects from the low-score boxes other pipelines throw away — then
   ``ByteTrack.update``.
2. Fused pipeline: ``TrackingPipeline(tracker="bytetrack")`` or CLI
   ``--tracker bytetrack`` (the ReID crop/embed stage disappears from the
   device step entirely).

    python examples_torch/bytetrack_video.py [--device cpu]
        [--input clip.avi] [--frames 16]
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

    from aicamera_tpu_torch.bytetrack_api import ByteTrack
    from aicamera_tpu_torch.detector import YOLODetector

    # the detector must emit low-score boxes for BYTE's second stage:
    # conf_threshold at the tracker's low floor (0.1), not the usual 0.3
    det = YOLODetector(conf_threshold=0.1, device=args.device)
    # track_thresh=0.5, match_thresh=0.8, buffer=30
    tracker = ByteTrack(device=args.device)

    for i, frame in enumerate(frames(args)):
        boxes, scores, class_ids, keep = det.detect(frame)
        tracks = tracker.update(boxes[keep], scores[keep], class_ids[keep],
                                frame)
        print(f"frame {i:3d}: {len(keep)} detections, "
              f"{len(tracks)} active tracks")
        for x1, y1, x2, y2, tid, cls, conf in tracks:
            print(f"    ID:{tid} {cls} {conf:.2f} ({x1},{y1},{x2},{y2})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
