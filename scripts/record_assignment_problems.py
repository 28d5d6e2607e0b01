#!/usr/bin/env python3
"""Record the assignment problems that the DeepSORT main path solves.

    python3 scripts/record_assignment_problems.py [--device cuda]
        [--out tests/data/assignment_main_path.npz]

Runs ``chip_smoke.py``'s main path (``TrackingPipeline`` at full width:
YOLOv8n at 640x640, T=128 track slots, N=64 detection slots, the committed
synthetic weights, ``synthetic_load=24``, chunk 8) over its 64 seeded
960x540 frames (``scenes.moving_rectangles``, 6 objects, seed 0), with the
tracker's scans run frame by frame (the captured scans solve the same
problems: ``tests/test_torch_assignment.py``), and saves the inputs of every
matching cascade and IoU solve that the tracker step makes, in call order.
The full-width detector wants a GPU host; ``--device cpu`` gives the f32
CPU path's problems.

The file holds, for problem ``q``: ``p{q:03d}_cost`` (R, C) f32,
``p{q:03d}_rows`` (R,) and ``p{q:03d}_cols`` (C,) bool, and for a cascade
``p{q:03d}_level`` (R,) int32; ``kind`` (``"cascade"`` or ``"match"``),
``max_d`` and ``depth`` by problem. ``chip_smoke.main_path_problems`` reads
it.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def record(device: str):
    import chip_smoke
    from aicamera_tpu_torch.core import tracker
    from aicamera_tpu_torch.scenes import moving_rectangles

    problems = []
    cascade, match = tracker.matching_cascade, tracker.min_cost_matching

    def host(x):
        return x.detach().cpu().numpy().copy()

    def spy_cascade(cost, level, elig, valid, max_d, depth):
        problems.append(("cascade", host(cost), host(elig), host(valid),
                         host(level).astype(np.int32), max_d, depth))
        return cascade(cost, level, elig, valid, max_d, depth)

    def spy_match(cost, rows, cols, max_d):
        problems.append(("match", host(cost), host(rows), host(cols), None,
                         max_d, 0))
        return match(cost, rows, cols, max_d)

    frames = moving_rectangles(chip_smoke.N_CHUNKS * chip_smoke.CHUNK,
                               chip_smoke.FRAME_HW, n_objects=6,
                               seed=chip_smoke.SEED)
    pipe = chip_smoke.make_pipeline(device)
    tracker.matching_cascade, tracker.min_cost_matching = (spy_cascade,
                                                           spy_match)
    try:
        with chip_smoke.eager_scans(pipe):
            results = list(pipe.process_frames(iter(frames)))
    finally:
        tracker.matching_cascade, tracker.min_cost_matching = cascade, match
    return problems, results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(
        ROOT / "tests" / "data" / "assignment_main_path.npz"))
    args = ap.parse_args()
    problems, results = record(args.device)
    arrays = {"kind": np.array([p[0] for p in problems]),
              "max_d": np.array([p[5] for p in problems], np.float32),
              "depth": np.array([p[6] for p in problems], np.int32)}
    for q, (kind, cost, rows, cols, level, _, _) in enumerate(problems):
        arrays[f"p{q:03d}_cost"] = cost
        arrays[f"p{q:03d}_rows"] = rows
        arrays[f"p{q:03d}_cols"] = cols
        if level is not None:
            arrays[f"p{q:03d}_level"] = level
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    shapes = sorted({p[1].shape for p in problems})
    print(f"{len(problems)} problems over {len(results)} frames "
          f"({sum(p[0] == 'cascade' for p in problems)} cascades; shapes "
          f"{shapes}; live rows a problem {min(int(p[2].sum()) for p in problems)}"
          f"-{max(int(p[2].sum()) for p in problems)}) -> {args.out} "
          f"({Path(args.out).stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
