"""Serialized ``.cudae`` engines: export once, load anywhere (trtexec UX).

The reference builds self-contained TensorRT ``.engine`` files that its
runtime deserializes without the ONNX files present. The port's analog is
the ``.cudae`` file (``runtime/engine.py``): a JSON header (letterbox spec,
thresholds, compute dtype, I/O details) and the weights in one file; the
loader rebuilds the step and captures it as a CUDA graph, once per input
shape; the ReID engine's batch axis is dynamic like the reference engine's
dynamic-batch profile. On the CPU an engine calls its step directly.

    python examples_torch/serialized_engines.py [--device cpu]
"""

import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples_torch._common import parse_args, demo_frame  # noqa: E402


def main(argv=None):
    args = parse_args(__doc__, argv=argv)

    import numpy as np
    from aicamera_tpu_torch.detector import YOLODetector
    from aicamera_tpu_torch.tracker_api import DeepSORT, ReIDModel

    frame = demo_frame(hw=(270, 480))
    if args.device.type == "cpu":
        print("(on the CPU each engine calls its step directly; on the GPU "
              "it replays the step's CUDA graph)")
    with tempfile.TemporaryDirectory(prefix="aicam_engines_") as d:
        out_dir = Path(d)

        # --- export: bake the fused detect step + the dynamic-batch embedder
        det = YOLODetector(input_shape=(320, 320), device=args.device)
        yolo_path = det.export_engine(frame.shape[:2],
                                      out_dir / "yolov8n_320.cudae")
        reid_path = ReIDModel(device=args.device).export_engine(
            out_dir / "reid_dynamic.cudae")
        for p in (yolo_path, reid_path):
            print(f"exported {p} ({Path(p).stat().st_size / 1e6:.1f} MB)")

        # --- load: no weight files, no model resolution — artifacts only
        det2 = YOLODetector(engine_path=str(yolo_path), device=args.device)
        eng = det2.get_engine(frame.shape[:2])
        print("engine I/O:", eng.get_input_details(),
              "->", [o.shape for o in eng.get_output_details()])
        boxes, scores, cls, idx = det2.detect(frame)
        print(f"detect via serialized engine: {len(boxes)} boxes")

        ds = DeepSORT(reid_model_path=str(reid_path), n_init=2,
                      device=args.device)
        for k in range(3):
            tracks = ds.update(boxes + 2 * k, scores, cls, frame)
        print(f"tracked via serialized ReID engine: {len(tracks)} confirmed "
              f"tracks after 3 frames")

    # parity against the weight-based path
    b2, s2, c2, i2 = det.detect(frame)
    if not (np.array_equal(boxes, b2) and np.array_equal(scores, s2)):
        raise AssertionError("serialized engine output != weight-based "
                             "output")
    print("serialized engine output == weight-based output (bitwise)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
