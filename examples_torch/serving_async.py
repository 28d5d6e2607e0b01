"""Async serving: futures over fused device chunks, then multi-tenant.

``TrackingService`` batches concurrent ``submit()`` calls into one device
dispatch (bounded by a latency window). ``MultiTenantTrackingService``
leases per-stream slots on a shared ``MultiStreamPipeline`` so independent
cameras at different frame rates never advance each other's tracker state.

    python examples_torch/serving_async.py [--device cpu]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples_torch._common import parse_args, demo_frame  # noqa: E402


def main(argv=None):
    args = parse_args(__doc__, argv=argv)

    from aicamera_tpu_torch.serving import (MultiTenantTrackingService,
                                            TrackingService)

    # --- single-stream batching service ------------------------------
    svc = TrackingService(chunk_size=4, max_latency_ms=50,
                          device=args.device)
    try:
        futures = [svc.submit(demo_frame(seed=i)) for i in range(8)]
        for i, fut in enumerate(futures):
            res = fut.result(timeout=120)
            print(f"frame {i}: {len(res.det_boxes)} dets, "
                  f"{len(res.tracks)} tracks")
    finally:
        svc.shutdown()

    # --- multi-tenant: two cameras sharing one pipeline --------------
    hw = (288, 512)
    mts = MultiTenantTrackingService(n_streams=4, frame_hw=hw,
                                     max_latency_ms=30, device=args.device)
    try:
        cam_a = mts.open_stream()
        cam_b = mts.open_stream(max_latency_ms=10)  # tighter per-stream SLA
        fa = [mts.submit(cam_a, demo_frame(hw, seed=i)) for i in range(3)]
        fb = [mts.submit(cam_b, demo_frame(hw, seed=50 + i))
              for i in range(2)]  # slower camera: fewer frames
        for name, fs in (("A", fa), ("B", fb)):
            for t, f in enumerate(fs):
                r = f.result(timeout=120)
                print(f"cam {name} frame {t}: {len(r.tracks)} tracks")
        mts.close_stream(cam_a)
        mts.close_stream(cam_b)
    finally:
        mts.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
