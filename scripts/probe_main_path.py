#!/usr/bin/env python3
"""Main-path FPS of several checkouts of the port on one GPU, in one call.

    python3 scripts/probe_main_path.py [ROOT ...] [--ocsort ROOT]

For each ROOT in turn (name a checkout twice to run it twice, e.g. parent
change change parent) a fresh process imports ``aicamera_tpu_torch`` from
that checkout, builds its kernel, warms up and drives the main path of
``chip_smoke.py`` (YOLOv8n at 640x640, T=128, chunk 8, ``synthetic_load=24``,
64 seeded 960x540 frames) three times: FPS by the host clock, then the
tracker's ms per frame from CUDA events, then the tracker's host syncs per
frame. Host time on a shared machine moves FPS by tens of per cent between
calls, so two versions compare only inside one call.

``--ocsort ROOT`` adds, for that checkout, where the OC-SORT loop's reads
come from over 32 frames with ``det_thresh=0.4``: frames that took the round-1
shortcut or the assignment solve, and the reads inside the solves.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import sys, time
root = sys.argv[1]
sys.path.insert(0, root)
import torch
from aicamera_tpu_torch import config
from aicamera_tpu_torch.core.assignment import TRACKER_SYNCS
from aicamera_tpu_torch.runtime import pipeline as pl
from aicamera_tpu_torch.scenes import moving_rectangles

Timer = getattr(pl, "CudaStageTimer", None) or pl.StageTimer
frames = moving_rectangles(64, (540, 960), n_objects=6, seed=0)
pipe = pl.TrackingPipeline(
    yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
    reid_weights=str(config.REID_SYNTHETIC_PATH),
    chunk_size=8, synthetic_load=24, device="cuda")
pipe.warm_up((540, 960))
fps, trk = [], []
for timed in (False, True) * 3:
    pipe.reset()
    pipe.stage_timer = Timer() if timed else None
    TRACKER_SYNCS.count = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_tracks = sum(len(r.tracks) for r in pipe.process_frames(iter(frames)))
    torch.cuda.synchronize()
    if timed:
        trk.append(pipe.stage_timer.totals["tracker"] / len(frames))
    else:
        fps.append(len(frames) / (time.perf_counter() - t0))
print(f"[probe] {root}: FPS " + " / ".join(f"{x:.2f}" for x in fps)
      + "; tracker ms per frame " + " / ".join(f"{x:.3f}" for x in trk)
      + f"; tracker syncs per frame {TRACKER_SYNCS.count / len(frames):.3f}; "
      f"track outputs {n_tracks}; scan_bucket "
      f"{getattr(pipe, 'scan_bucket', 'absent')}, chunks "
      f"{getattr(pipe, 'scan_stats', 'n/a')}")
"""

OCSORT_CHILD = r"""
import sys
root = sys.argv[1]
sys.path.insert(0, root)
import torch
from aicamera_tpu_torch import config
from aicamera_tpu_torch.core import ocsort
from aicamera_tpu_torch.core.assignment import TRACKER_SYNCS
from aicamera_tpu_torch.runtime.pipeline import TrackingPipeline
from aicamera_tpu_torch.scenes import moving_rectangles

calls = {"solves": 0, "reads in solves": 0, "rows": 0}
solve = ocsort.min_cost_matching
def counted(cost, rows, cols, max_distance):
    before = TRACKER_SYNCS.count
    out = solve(cost, rows, cols, max_distance)
    calls["solves"] += 1
    calls["reads in solves"] += TRACKER_SYNCS.count - before
    calls["rows"] += int(rows.sum())
    return out
ocsort.min_cost_matching = counted
frames = moving_rectangles(32, (540, 960), n_objects=6, seed=0)
pipe = TrackingPipeline(
    yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
    reid_weights=str(config.REID_SYNTHETIC_PATH), chunk_size=8,
    synthetic_load=24, tracker="ocsort", device="cuda",
    ocsort_params=ocsort.OCSortParams(det_thresh=0.4))
pipe.warm_up((540, 960))
calls.update(dict.fromkeys(calls, 0))
TRACKER_SYNCS.count = 0
n_tracks = sum(len(r.tracks) for r in pipe.process_frames(iter(frames)))
print(f"[probe] ocsort, 32 frames: {TRACKER_SYNCS.count} tracker reads, "
      f"{calls['solves']} assignment solves (round 1 without the shortcut, "
      f"and round 2) over {calls['rows']} rows with {calls['reads in solves']}"
      f" reads inside them; track outputs {n_tracks}")
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--ocsort", type=Path, metavar="ROOT")
    args = ap.parse_args()
    ident = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(f"[probe] {ident.stdout.strip()}")
    jobs = [(CHILD, r) for r in args.roots]
    if args.ocsort:
        jobs.append((OCSORT_CHILD, args.ocsort))
    for code, root in jobs:
        out = subprocess.run([sys.executable, "-c", code, str(root.resolve())],
                             capture_output=True, text=True, timeout=600)
        sys.stdout.write(out.stdout)
        if out.returncode:
            sys.stdout.write(out.stderr[-3000:])
            return out.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
