"""High-throughput chunked pipeline with checkpoint/resume.

``TrackingPipeline`` runs preprocess -> detect -> NMS -> crops -> ReID ->
associate -> track as one device step per K frames; this is what the CLI
runs. On the GPU the step is one CUDA-graph replay a chunk whose branches
(the ReID bucket, the tracker scan's capacity) the device decides. Tracker
state is a set of tensors that can be snapshotted mid-stream and restored
later (capability beyond the reference).

    python examples_torch/fused_pipeline.py [--device cpu] [--frames 24]
        [--chunk 8]
"""

import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples_torch._common import parse_args, demo_frame  # noqa: E402


def main(argv=None):
    args = parse_args(__doc__, extra=lambda ap: (
        ap.add_argument("--frames", type=int, default=24),
        ap.add_argument("--chunk", type=int, default=8),
    ), argv=argv)

    from aicamera_tpu_torch.runtime.checkpoint import load_state, save_state
    from aicamera_tpu_torch.runtime.pipeline import TrackingPipeline

    pipe = TrackingPipeline(chunk_size=args.chunk, device=args.device)
    frames = (demo_frame(seed=i) for i in range(args.frames))
    for res in pipe.process_frames(frames):
        print(f"frame {res.frame_index:3d}: {len(res.det_boxes)} dets, "
              f"{len(res.tracks)} tracks")

    # snapshot, then resume into a fresh pipeline
    with tempfile.TemporaryDirectory() as d:
        ckpt = Path(d) / "tracker_state.msgpack"
        save_state(ckpt, pipe.state)
        pipe2 = TrackingPipeline(chunk_size=args.chunk, device=args.device)
        pipe2.state = load_state(ckpt, pipe2.tracker_params,
                                 device=pipe2.device)
        print(f"restored tracker state from {ckpt.name}; "
              f"next_id={int(pipe2.state.next_id)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
