"""Int8 (W8A8) quantized model paths + chunk-granular streaming.

Two opt-in precision notches past the reference's ``--fp16`` engines:

* ``reid_quant="int8"`` — dynamic per-crop activation scales,
  per-channel int8 weights (``models/quant.py``);
* ``yolo_quant="int8"`` — static calibration over deterministic
  synthetic scenes, activation scales folded into the kernels so
  activations stay int8 between conv fusions (``models/quant_yolo.py``).

Quality holds (AP50 within 0.01 of bf16's on the synthetic world). NOTE:
on an NVIDIA H100 80GB HBM3 at a 700 W power limit int8 measures *slower*
than bf16: 3.9-5.2x bf16's time for the ReID embed at 32 crops and for
YOLOv8n at 8 frames (``chip_smoke.py``'s ``[int8]`` phase, CUDA-graph
replays). The int8 convolutions go through ``torch._int_mm`` with im2col
copies and a dequant epilogue, so these stay opt-in until a fused int8
convolution exists.

Also shows ``process_chunks`` — chunk-granular streaming (one Python
crossing per device dispatch, the CLI's ``--native_io`` fast path).

    python examples_torch/quantized_pipeline.py [--device cpu] [--frames 8]
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples_torch._common import parse_args, demo_frame  # noqa: E402


def main(argv=None):
    args = parse_args(__doc__, extra=lambda ap: (
        ap.add_argument("--frames", type=int, default=8),
    ), argv=argv)

    from aicamera_tpu_torch.runtime.pipeline import TrackingPipeline

    # small input keeps the CPU demo quick; drop input_shape for 640x640
    pipe = TrackingPipeline(chunk_size=4, input_shape=(256, 256),
                            reid_quant="int8", yolo_quant="int8",
                            device=args.device)
    print(f"reid_quant={pipe.reid_quant}  yolo_quant={pipe.yolo_quant}  "
          f"(detector calibrated on synthetic scenes at init)")

    frames = np.stack([demo_frame(seed=i) for i in range(args.frames)])

    def chunks():  # e.g. NativeVideoReader.read_chunk(4) in production
        for i in range(0, len(frames), 4):
            yield frames[i:i + 4]

    for res in pipe.process_chunks(chunks()):
        print(f"frame {res.frame_index}: {len(res.det_boxes)} detections, "
              f"{len(res.tracks)} tracks")
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
