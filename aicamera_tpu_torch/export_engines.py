"""Export ``.cudae`` inference engines: the port's trtexec step.

The port of ``scripts/export_engines.py``, with the same flags plus
``--device``. It writes self-contained engine files (weights, letterbox
spec and thresholds baked in, ``runtime/engine.py``) that
``YOLODetector(engine_path=...)`` and ``ReIDModel(engine_path=...)`` load
with no weight file present.

Usage::

    python -m aicamera_tpu_torch.export_engines [--out_dir models/engines]
        [--frame_hw 540x960 ...] [--variant n] [--input_size 640]
        [--conf_thresh T] [--skip_yolo] [--skip_reid] [--device cuda|cpu]

Notes:

- The detect engine is fixed per source frame shape (the un-letterbox is
  baked in), like the reference's fixed-shape YOLO engine; pass
  ``--frame_hw`` more than once for several shapes.
- The ReID engine has a dynamic batch axis: a GPU captures one graph per
  batch size at first use.
- The compute dtype in the file is the exporting device's (bf16 on the GPU,
  f32 on the CPU): export on the device you will serve on, as a TensorRT
  engine is built on its target GPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out_dir", type=str, default="models/engines")
    ap.add_argument("--frame_hw", action="append", default=None,
                    help="source frame HxW (repeatable); default 540x960 "
                         "(the benchmark clip)")
    ap.add_argument("--variant", type=str, default="n",
                    choices=list("nsmlx"))
    ap.add_argument("--input_size", type=int, default=640,
                    help="square letterbox target (reference: 640)")
    ap.add_argument("--conf_thresh", type=float, default=None)
    ap.add_argument("--skip_yolo", action="store_true")
    ap.add_argument("--skip_reid", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    out_dir = Path(args.out_dir)
    frame_hws = []
    for s in (args.frame_hw or ["540x960"]):
        h, w = s.lower().split("x")
        frame_hws.append((int(h), int(w)))

    from . import config
    from .detector import YOLODetector
    from .tracker_api import ReIDModel

    if not args.skip_yolo:
        det = YOLODetector(
            input_shape=(args.input_size, args.input_size),
            conf_threshold=(args.conf_thresh
                            if args.conf_thresh is not None
                            else config.YOLO_CONF_THRESHOLD),
            variant=args.variant, device=args.device)
        for hw in frame_hws:
            path = out_dir / (f"yolov8{args.variant}_{args.input_size}"
                              f"_frame{hw[0]}x{hw[1]}.cudae")
            det.export_engine(hw, path)
            print(f"wrote {path} ({path.stat().st_size / 1e6:.1f} MB)")

    if not args.skip_reid:
        reid = ReIDModel(device=args.device)
        path = out_dir / "reid_dynamic.cudae"
        reid.export_engine(path)
        print(f"wrote {path} ({path.stat().st_size / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
