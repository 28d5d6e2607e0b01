"""Pipeline-parallel detector: backbone/neck/head stages across devices.

The detector's three natural stages are placed on separate devices (up to
three cards; one card holds all three) and microbatches stream through
them GPipe-style: the host enqueues microbatch after microbatch without a
sync, so stage k of microbatch i runs while stage k+1 of microbatch i-1
runs on the next card. Use it when a large variant's weights and
activations outgrow one card's memory. A microbatch's levels are bitwise
the unsplit ``YOLOv8`` forward of the same frames on the same device, and
feed the fixed-shape decode + NMS unchanged.

    python examples_torch/pipeline_parallel.py [--device cpu] [--batch 8]
        [--variant n]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples_torch._common import parse_args, demo_frame  # noqa: E402


def main(argv=None):
    args = parse_args(__doc__, extra=lambda ap: (
        ap.add_argument("--batch", type=int, default=8),
        ap.add_argument("--variant", default="n"),
    ), argv=argv)

    import numpy as np
    import torch
    from aicamera_tpu_torch.ops.letterbox import letterbox
    from aicamera_tpu_torch.ops.nms import fused_decode_nms
    from aicamera_tpu_torch.ops.preprocess import letterbox_spec
    from aicamera_tpu_torch.parallel import PipelineParallelDetector
    from aicamera_tpu_torch.runtime.params import resolve_yolo_params
    from aicamera_tpu_torch.runtime.pipeline import precision

    # the GPU: up to three cards (the class's default); else the one device
    pp = PipelineParallelDetector(
        args.variant,
        devices=None if args.device == torch.device("cuda")
        else [args.device])
    print(f"stages backbone/neck/head on {[str(d) for d in pp.devices]}")

    hw, input_hw = (288, 512), (256, 256)
    model = resolve_yolo_params(args.variant, device=pp.devices[0],
                                dtype=pp.dtype).eval()
    pp.place_params(model)

    frames = np.stack([demo_frame(hw, seed=s) for s in range(args.batch)])
    x = letterbox(torch.from_numpy(frames).to(pp.devices[0]),
                  letterbox_spec(hw, input_hw), torch.float32)

    mb = max(1, args.batch // 4)
    levels = pp.forward(x, microbatch=mb)
    num, boxes, scores, labels = fused_decode_nms(
        levels, score_threshold=0.25, iou_threshold=0.45,
        top_k=128, max_det=32)
    print(f"per-level outputs: "
          f"{[tuple(map(int, r.shape)) for r, _ in levels]}")
    print(f"detections per frame: {num.tolist()}")

    # the unsplit forward, a microbatch at a time (convolution algorithms
    # are chosen by batch size), on the first stage's device
    with torch.no_grad(), precision(pp.dtype):
        whole = [model(x[i:i + mb].to(pp.dtype))
                 for i in range(0, args.batch, mb)]
    for k, (box, cls) in enumerate(levels):
        want_box = torch.cat([w[k][0] for w in whole])
        want_cls = torch.cat([w[k][1] for w in whole])
        if not (torch.equal(box.to(want_box.device), want_box)
                and torch.equal(cls.to(want_cls.device), want_cls)):
            raise AssertionError(f"level {k}: the staged forward differs "
                                 f"from the unsplit one")
    print(f"staged forward == unsplit YOLOv8 forward on {pp.devices[0]} "
          f"(bitwise, microbatches of {mb})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
