"""YOLODetector facade on a single frame.

Mirrors the reference's detector contract: BGR uint8 frame in,
``(boxes_xyxy, scores, class_ids, filtered_indices)`` in original frame
coordinates out. On the GPU the detect step (letterbox kernel, YOLOv8, the
NMS kernel) replays as one CUDA graph.

    python examples_torch/detect_image.py [--device cpu] [--image path.jpg]
        [--weights yolov8n.msgpack|.onnx|.cudae] [--detect_dtype f32]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples_torch._common import parse_args, demo_frame  # noqa: E402


def read_image(path):
    """A JPEG or PNG file as a BGR uint8 frame, by the port's decoders."""
    from aicamera_tpu_torch.utils.jpeg import read_jpeg
    from aicamera_tpu_torch.utils.png import read_png
    return (read_png if Path(path).suffix.lower() == ".png"
            else read_jpeg)(path)


def main(argv=None):
    args = parse_args(__doc__, extra=lambda ap: (
        ap.add_argument("--image", help="JPEG or PNG file "
                                        "(default: synthetic)"),
        ap.add_argument("--weights", help="msgpack/ONNX detector weights or "
                                          "a .cudae engine"),
        ap.add_argument("--detect_dtype", choices=("bf16", "f32"),
                        help="compute dtype (default: bf16 on the GPU, f32 "
                             "on the CPU)"),
    ), argv=argv)

    from aicamera_tpu_torch.detector import YOLODetector

    frame = read_image(args.image) if args.image else demo_frame()

    det = YOLODetector(engine_path=args.weights, conf_threshold=0.3,
                       detect_dtype=args.detect_dtype, device=args.device)
    boxes, scores, class_ids, keep = det.detect(frame)
    print(f"{len(keep)} detections above threshold")
    for b, s, c in zip(boxes[keep], scores[keep], class_ids[keep]):
        print(f"  class={int(c):2d} conf={float(s):.3f} "
              f"box=({b[0]:.0f},{b[1]:.0f},{b[2]:.0f},{b[3]:.0f})")
    if not args.weights:
        print("(random weights — boxes are meaningless; pass --weights or "
              "run aicamera_tpu_torch.train_synthetic)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
