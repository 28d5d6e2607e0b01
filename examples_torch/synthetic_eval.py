"""Quality evaluation without external data: synthetic world -> metrics.

The procedural world (``aicamera_tpu_torch.synthetic``) emits frames with
exact ground-truth boxes and identities. This example runs the full fused
pipeline over a moving-object sequence and scores it:

- detection quality: COCO AP50/AP75/mAP@[.5:.95] (``evaluate_detections``)
- tracking quality: CLEAR-MOT MOTA/MOTP/ID-switches (``evaluate_mot``)

The committed checkpoints (``models/detection/yolov8n_synthetic.msgpack``,
``models/reid/deepsort_reid_synthetic.msgpack``) are picked up when
present; with random weights the scores are ~0 (nothing real is detected).

    python examples_torch/synthetic_eval.py [--device cpu] [--frames 48]
        [--chunk 8]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples_torch._common import parse_args  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
DET_W = ROOT / "models" / "detection" / "yolov8n_synthetic.msgpack"
REID_W = ROOT / "models" / "reid" / "deepsort_reid_synthetic.msgpack"


def main(argv=None):
    args = parse_args(__doc__, extra=lambda ap: (
        ap.add_argument("--frames", type=int, default=48),
        ap.add_argument("--chunk", type=int, default=8),
    ), argv=argv)

    import numpy as np
    from aicamera_tpu_torch.eval import evaluate_detections, evaluate_mot
    from aicamera_tpu_torch.runtime.pipeline import TrackingPipeline
    from aicamera_tpu_torch.synthetic import TemporalWorld, WorldSpec

    world = TemporalWorld(WorldSpec(max_objects=8, presence=1.0), seed=3,
                          speed=2.0, device=args.device)
    frames, gt_frames, gt_tracks = [], [], []
    for _ in range(args.frames):
        frame, boxes, ids, cls, valid = world.step()
        frames.append(frame)
        gt_frames.append((boxes[valid], cls[valid]))
        gt_tracks.append((boxes[valid], ids[valid]))

    pipe = TrackingPipeline(
        chunk_size=args.chunk,
        yolo_weights=str(DET_W) if DET_W.exists() else None,
        reid_weights=str(REID_W) if REID_W.exists() else None,
        device=args.device)
    if not DET_W.exists():
        print("(random weights — train with "
              "aicamera_tpu_torch.train_synthetic for meaningful scores)")

    pred_frames, hyp_tracks = [], []
    for res in pipe.process_frames(iter(frames)):
        pred_frames.append((res.det_boxes, res.det_scores, res.det_labels))
        t = np.array([tr[:4] for tr in res.tracks], np.float32)
        i = np.array([tr[4] for tr in res.tracks], np.int64)
        hyp_tracks.append((t.reshape(-1, 4), i))

    ap = evaluate_detections(gt_frames, pred_frames)
    mot = evaluate_mot(gt_tracks, hyp_tracks)
    print(f"detection: AP50={ap.ap50:.3f} AP75={ap.ap75:.3f} "
          f"mAP[.5:.95]={ap.map_5095:.3f} "
          f"({ap.num_pred} preds / {ap.num_gt} gt)")
    print(f"tracking : MOTA={mot.mota:.3f} MOTP={mot.motp:.3f} "
          f"IDsw={mot.id_switches} FP={mot.false_positives} "
          f"FN={mot.misses}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
