#!/usr/bin/env python3
"""Main-path FPS of several checkouts of the port on one GPU, in one call.

    python3 scripts/probe_main_path.py [--tracker NAME] [ROOT ...]

For each ROOT in turn (name a checkout twice to run it twice, e.g. parent
change change parent) a fresh process imports ``aicamera_tpu_torch`` from
that checkout, builds its kernels, warms up and drives the main path of
``chip_smoke.py`` (YOLOv8n at 640x640, T=128, chunk 8, ``synthetic_load=24``,
64 seeded 960x540 frames) three times: FPS by the host clock, then the
tracker's ms per frame from CUDA events, then the tracker's host syncs per
frame, with a SHA-256 of every run's track tuples (equal digests: the
checkouts' outputs are bitwise the same). Host time on a shared machine
moves FPS by tens of per cent between calls, so two versions compare only
inside one call.

``--tracker``: the core the pipeline runs (default ``deepsort``, the main
path; ``bytetrack``, ``botsort``, ``ocsort`` and ``deepocsort`` run with
their thresholds at 0.4, as ``chip_smoke.py``'s ``[trackers]``, so that the
synthetic boxes of conf 0.5 start tracks); it also prints the assignment
and ORU kernels' launches a frame (``n/a`` where the checkout has no such
kernel).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import hashlib, importlib, sys, time
root, tracker = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
import torch
from aicamera_tpu_torch import config
from aicamera_tpu_torch.core import bytetrack, ocsort
from aicamera_tpu_torch.core.assignment import TRACKER_SYNCS
from aicamera_tpu_torch.runtime import pipeline as pl
from aicamera_tpu_torch.scenes import moving_rectangles


def kernel(module):
    try:
        return importlib.import_module(module).KERNEL
    except ImportError:
        return None


kernels = {"assignment": kernel("aicamera_tpu_torch.ops.assignment"),
           "oru": kernel("aicamera_tpu_torch.ops.oru")}
app = tracker in ("botsort", "deepocsort")
core = {}
if tracker in ("bytetrack", "botsort"):
    core = dict(bytetrack_params=bytetrack.ByteTrackParams(
        track_thresh=0.4, with_appearance=app,
        feature_dim=config.REID_FEATURE_DIM))
elif tracker in ("ocsort", "deepocsort"):
    core = dict(ocsort_params=ocsort.OCSortParams(
        det_thresh=0.4, with_appearance=app,
        feature_dim=config.REID_FEATURE_DIM))
Timer = getattr(pl, "CudaStageTimer", None) or pl.StageTimer
frames = moving_rectangles(64, (540, 960), n_objects=6, seed=0)
pipe = pl.TrackingPipeline(
    yolo_weights=str(config.YOLO_SYNTHETIC_PATH),
    reid_weights=str(config.REID_SYNTHETIC_PATH),
    chunk_size=8, synthetic_load=24, device="cuda", tracker=tracker, **core)
pipe.warm_up((540, 960))
fps, trk, digests = [], [], set()
for timed in (False, True) * 3:
    pipe.reset()
    pipe.stage_timer = Timer() if timed else None
    TRACKER_SYNCS.count = 0
    for k in kernels.values():
        if k is not None:
            k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tracks = [r.tracks for r in pipe.process_frames(iter(frames))]
    torch.cuda.synchronize()
    n_tracks = sum(map(len, tracks))
    digests.add(hashlib.sha256(repr(tracks).encode()).hexdigest()[:16])
    if timed:
        trk.append(pipe.stage_timer.totals["tracker"] / len(frames))
    else:
        fps.append(len(frames) / (time.perf_counter() - t0))
launches = ", ".join(
    f"{name} " + ("n/a" if k is None else f"{k.launches / len(frames):.3f}")
    for name, k in kernels.items())
print(f"[probe] {root} ({tracker}): FPS " + " / ".join(f"{x:.2f}" for x in fps)
      + "; tracker ms per frame " + " / ".join(f"{x:.3f}" for x in trk)
      + f"; tracker syncs per frame {TRACKER_SYNCS.count / len(frames):.3f}; "
      f"launches per frame: {launches}; "
      f"track outputs {n_tracks}, SHA-256 of the tuples "
      f"{', '.join(sorted(digests))}; scan_bucket "
      f"{getattr(pipe, 'scan_bucket', 'absent')}, chunks "
      f"{getattr(pipe, 'scan_stats', 'n/a')}")
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--tracker", default="deepsort",
                    choices=("deepsort", "strongsort", "bytetrack",
                             "botsort", "ocsort", "deepocsort"))
    args = ap.parse_args()
    ident = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(f"[probe] {ident.stdout.strip()}")
    for root in args.roots:
        out = subprocess.run([sys.executable, "-c", CHILD,
                              str(root.resolve()), args.tracker],
                             capture_output=True, text=True, timeout=600)
        sys.stdout.write(out.stdout)
        if out.returncode:
            sys.stdout.write(out.stderr[-3000:])
            return out.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
