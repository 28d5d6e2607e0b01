"""Multi-tenant tracking-as-a-service: leased stream slots, mixed rates.

``MultiTenantTrackingService`` rides one ``MultiStreamPipeline``: every
dispatch batches frames from all active tenants into a single device step,
with a per-(stream, frame) validity mask so tenants at different frame
rates never advance each other's tracker state. Slots are leased
(``open_stream``/``close_stream``); per-stream SLA windows decide when a
partial batch fires. No reference equivalent (single stream, single
process).

    python examples_torch/multitenant_serving.py [--device cpu]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples_torch._common import parse_args, demo_frame  # noqa: E402


def main(argv=None):
    args = parse_args(__doc__, argv=argv)

    from aicamera_tpu_torch.core.state import TrackerParams
    from aicamera_tpu_torch.serving import MultiTenantTrackingService

    tp = TrackerParams(max_tracks=16, max_detections=8, nn_budget=4,
                       max_age=10, feature_dim=512)
    svc = MultiTenantTrackingService(
        n_streams=2, frame_hw=(96, 128), chunk_size=2,
        max_latency_ms=50.0, input_shape=(128, 128),
        tracker_params=tp, max_reid_crops=4, device=args.device)
    try:
        cam_a = svc.open_stream()                      # default SLA
        cam_b = svc.open_stream(max_latency_ms=200.0)  # slow tenant

        # tenant A submits 4 frames, tenant B 2 — they share dispatches
        # but each keeps its own tracker state and frame counter
        futs_a = [svc.submit(cam_a, demo_frame(hw=(96, 128), seed=i))
                  for i in range(4)]
        futs_b = [svc.submit(cam_b, demo_frame(hw=(96, 128), seed=10 + i))
                  for i in range(2)]
        for name, futs in (("A", futs_a), ("B", futs_b)):
            for f in futs:
                r = f.result(timeout=600)
                print(f"tenant {name} stream={r.stream_id} "
                      f"frame={r.frame_index}: {len(r.tracks)} tracks")

        svc.close_stream(cam_a)
        svc.close_stream(cam_b)
        svc.wait_idle()          # safe point to re-lease for new tenants
        print("drained; slots free:", svc.open_stream() is not None)
    finally:
        svc.shutdown()
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
