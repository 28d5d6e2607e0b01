"""Frame-by-frame tracking with the reference-compatible facades.

The exact loop a user of the reference writes, against the same two
classes: ``YOLODetector.detect`` then ``DeepSORT.update``. On the GPU each
``detect`` replays the captured detect step (letterbox and NMS kernels) and
each ``update`` runs the assignment kernel with no read of the device.

    python examples_torch/track_video.py [--device cpu] [--input clip.avi]
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
    from aicamera_tpu_torch.tracker_api import DeepSORT

    det = YOLODetector(conf_threshold=0.3, device=args.device)
    # reference defaults: MAX_DIST=0.2, MAX_AGE=70, ...
    tracker = DeepSORT(device=args.device)

    for i, frame in enumerate(frames(args)):
        boxes, scores, class_ids, keep = det.detect(frame)
        tracks = tracker.update(boxes[keep], scores[keep], class_ids[keep],
                                frame)
        print(f"frame {i:3d}: {len(keep)} detections, "
              f"{len(tracks)} confirmed tracks")
        for x1, y1, x2, y2, tid, cls, conf in tracks:
            print(f"    ID:{tid} {cls} {conf:.2f} ({x1},{y1},{x2},{y2})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
