#!/usr/bin/env python3
"""Main-path FPS, reads and output digests of several checkouts of the port
on one GPU, in one call.

    python3 scripts/probe_main_path.py [--tracker NAME] [ROOT ...]

For each ROOT in turn (name a checkout twice to run it twice, e.g. parent
change change parent) a fresh process imports ``aicamera_tpu_torch`` from
that checkout, builds its kernels, warms up and drives the main path of
``chip_smoke.py`` (YOLOv8n at 640x640, T=128, chunk 8, ``synthetic_load=24``,
64 seeded 960x540 frames) three times: FPS by the host clock, then the
tracker's and the NMS stage's ms per frame from CUDA events (a checkout
whose chunk step is one captured replay times that whole, ``step``, and
prints its graph's nodes and capture seconds; its stages read 0), then
every read counter per frame (NMS, ReID bucket, tracker, scan bucket). Then it
captures the NMS stage of one chunk alone (``fused_decode_nms`` at B = 8 on
seeded bf16 level outputs of YOLOv8n's shapes) into a CUDA graph: its nodes
(the stage's launches a chunk), its replay's ms and its outputs' digest.
Then it drives the other detect paths on the same frames:

- ``f32``: the main path with no synthetic load in f32, TF32 off;
- ``facade bf16`` and ``facade f32``: ``YOLODetector.detect`` ->
  ``DeepSORT.update`` on 16 frames and ``detect_tiled`` (2x2 and the full
  frame) on 4; the ``detect`` engine's replay ms (CUDA events, 30 replays)
  and graph nodes;
- ``streams``: ``MultiStreamPipeline`` at 8 streams of 1280x720, chunk 4:
  three rounds of three dispatches after one of warm-up, ms a dispatch by
  the host clock each round, then one round's NMS stage by CUDA events.

Each path prints a SHA-256 of its detections and track tuples; after the
last ROOT the digests of every run are compared: equal digests mean bitwise
equal outputs, and the script exits 1 where one differs. The other paths
need a checkout that has them (``MultiStreamPipeline``, the facades'
engines). Host time on a shared machine moves FPS and wall times by tens of
per cent between calls, so two versions compare only inside one call.

``--tracker``: the core the main path runs (default ``deepsort``;
``bytetrack``, ``botsort``, ``ocsort`` and ``deepocsort`` run with their
thresholds at 0.4, as ``chip_smoke.py``'s ``[trackers]``, so that the
synthetic boxes of conf 0.5 start tracks); it also prints the assignment,
ORU and NMS kernels' launches a frame (``n/a`` where the checkout has no
such kernel).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import contextlib, hashlib, importlib, json, sys, time
root, tracker = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
import numpy as np
import torch
from aicamera_tpu_torch import config
from aicamera_tpu_torch.core import bytetrack, ocsort
from aicamera_tpu_torch.core.assignment import TRACKER_SYNCS
from aicamera_tpu_torch.ops.nms import NMS_SYNCS
from aicamera_tpu_torch.runtime import pipeline as pl
from aicamera_tpu_torch.scenes import moving_rectangles


def kernel(module):
    try:
        return importlib.import_module(module).KERNEL
    except (ImportError, AttributeError):
        return None


def digest(obj):
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]


def detections(results):
    return digest([(r.det_boxes.tobytes(), r.det_scores.tobytes(),
                    r.det_labels.tobytes()) for r in results])


kernels = {name: kernel(f"aicamera_tpu_torch.ops.{name}")
           for name in ("assignment", "oru", "nms")}
counters = {"NMS": NMS_SYNCS, "ReID bucket": getattr(pl, "EMBED_SYNCS", None),
            "tracker": TRACKER_SYNCS,
            "scan bucket": getattr(pl, "BUCKET_SYNCS", None)}
counters = {k: c for k, c in counters.items() if c is not None}


def zero():
    for c in counters.values():
        c.count = 0
    for k in kernels.values():
        if k is not None:
            k.launches = 0
    torch.cuda.synchronize()


def reads(n):
    return ", ".join(f"{k} {c.count / n:.3f}" for k, c in counters.items())


YOLO, REID = str(config.YOLO_SYNTHETIC_PATH), str(config.REID_SYNTHETIC_PATH)
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
pipe = pl.TrackingPipeline(yolo_weights=YOLO, reid_weights=REID,
                           chunk_size=8, synthetic_load=24, device="cuda",
                           tracker=tracker, **core)
pipe.warm_up((540, 960))
fps, trk, nms, stp, tuples, dets = [], [], [], [], set(), set()
for timed in (False, True) * 3:
    pipe.reset()
    pipe.stage_timer = Timer() if timed else None
    zero()
    t0 = time.perf_counter()
    res = list(pipe.process_frames(iter(frames)))
    torch.cuda.synchronize()
    tracks = [r.tracks for r in res]
    n_tracks = sum(map(len, tracks))
    tuples.add(digest(tracks))
    dets.add(detections(res))
    if timed:
        totals = pipe.stage_timer.totals
        trk.append(totals["tracker"] / len(frames))
        nms.append(totals.get("nms", float("nan")) / len(frames))
        stp.append(totals.get("step", float("nan")) / len(frames))
    else:
        fps.append(len(frames) / (time.perf_counter() - t0))
launches = ", ".join(
    f"{name} " + ("n/a" if k is None else f"{k.launches / len(frames):.3f}")
    for name, k in kernels.items())
print(f"[probe] {root} ({tracker}): FPS " + " / ".join(f"{x:.2f}" for x in fps)
      + "; tracker ms per frame " + " / ".join(f"{x:.3f}" for x in trk)
      + "; nms stage ms per frame " + " / ".join(f"{x:.3f}" for x in nms)
      + " (a chunk of 8: " + " / ".join(f"{8 * x:.3f}" for x in nms) + ")"
      + "; captured step ms per frame " + " / ".join(f"{x:.3f}" for x in stp)
      + "".join(f"; {st.engine.name}: {st.engine.graph_nodes()} nodes, "
                f"capture {st.engine.compile_seconds:.3f} s"
                for st in getattr(pipe, "_steps", {}).values())
      + f"; reads per frame {reads(len(frames))}; "
      f"launches per frame: {launches}; "
      f"track outputs {n_tracks}, SHA-256 of the tuples "
      f"{', '.join(sorted(tuples))}, of the detections "
      f"{', '.join(sorted(dets))}; scan_bucket "
      f"{getattr(pipe, 'scan_bucket', 'absent')}, chunks "
      f"{getattr(pipe, 'scan_stats', 'n/a')}", flush=True)
out = {"main tuples": sorted(tuples), "main detections": sorted(dets)}
del pipe

# the NMS stage of one chunk alone: fused_decode_nms at the main path's
# shapes (B = 8, YOLOv8n's three levels at 640x640, bf16) on seeded random
# level outputs, captured into a CUDA graph: its nodes are the stage's
# launches a chunk; its replay's device ms and its outputs' digest
from aicamera_tpu_torch.ops.nms import fused_decode_nms
from aicamera_tpu_torch.runtime.engine import CUDAGraphEngine

gen = torch.Generator().manual_seed(0)
levels = []
for hw in (80, 40, 20):
    levels += [torch.randn((8, hw, hw, 64), generator=gen),
               torch.randn((8, hw, hw, 80), generator=gen) * 3 - 4]
levels = [t.to("cuda", torch.bfloat16) for t in levels]


def nms_stage(*t):
    return fused_decode_nms(
        [(t[i], t[i + 1]) for i in (0, 2, 4)],
        score_threshold=config.YOLO_NMS_SCORE_THRESHOLD,
        iou_threshold=config.YOLO_NMS_THRESHOLD, top_k=config.YOLO_NMS_TOPK,
        max_det=config.YOLO_MAX_DETECTIONS)


stage = CUDAGraphEngine(nms_stage, levels, name="nms_stage", warmup_iters=1,
                        device="cuda")
(cap,) = stage._graphs.values()
start = torch.cuda.Event(enable_timing=True)
end = torch.cuda.Event(enable_timing=True)
for _ in range(5):
    cap.graph.replay()
start.record()
for _ in range(100):
    cap.graph.replay()
end.record()
end.synchronize()
got = stage(*levels)
out["nms stage"] = digest([t.cpu().numpy().tobytes() for t in got])
print(f"[probe] {root} nms stage (fused_decode_nms, B=8, seeded levels, "
      f"bf16): {cap.nodes} graph nodes a chunk, replay "
      f"{start.elapsed_time(end) / 100:.4f} ms; {int(got[0].sum())} "
      f"detections; SHA-256 {out['nms stage']}", flush=True)
del stage, cap

from aicamera_tpu_torch.detector import YOLODetector
from aicamera_tpu_torch.parallel import MultiStreamPipeline
from aicamera_tpu_torch.tracker_api import DeepSORT

f32 = dict(detect_dtype="f32", reid_dtype="f32")
with pl.full_f32():
    pipe = pl.TrackingPipeline(yolo_weights=YOLO, reid_weights=REID,
                               chunk_size=8, synthetic_load=0, device="cuda",
                               **f32)
    pipe.warm_up((540, 960))
    zero()
    res = list(pipe.process_frames(iter(frames)))
    out["f32"] = [digest([r.tracks for r in res]), detections(res)]
    print(f"[probe] {root} f32: reads per frame {reads(len(frames))}; "
          f"SHA-256 of the tuples and the detections {out['f32']}",
          flush=True)
    del pipe

for name, dtype in (("facade bf16", None), ("facade f32", "f32")):
    ctx = pl.full_f32() if dtype == "f32" else contextlib.nullcontext()
    with ctx:
        det = YOLODetector(YOLO, device="cuda", detect_dtype=dtype)
        trk = DeepSORT(REID, device="cuda", reid_dtype=dtype)
        sub = frames[:16]
        det.detect(sub[0])
        zero()
        got = []
        for f in sub:
            d = det.detect(f)
            got.append((tuple(np.asarray(x).tobytes() for x in d),
                        trk.update(*d[:3], f)))
        tiled = [tuple(np.asarray(x).tobytes() for x in det.detect_tiled(f))
                 for f in sub[:4]]
        (cap,) = det.get_engine((540, 960))._graphs.values()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(5):
            cap.graph.replay()
        start.record()
        for _ in range(30):
            cap.graph.replay()
        end.record()
        end.synchronize()
        out[name] = [digest(got), digest(tiled)]
        print(f"[probe] {root} {name}: reads per frame {reads(len(sub))}; "
              f"detect replay {start.elapsed_time(end) / 30:.4f} ms, "
              f"{cap.nodes} graph nodes; SHA-256 of detect + update and of "
              f"detect_tiled {out[name]}", flush=True)

scenes = np.stack([moving_rectangles(12, (720, 1280), n_objects=6,
                                     seed=1 + s) for s in range(8)])
ms = MultiStreamPipeline(n_streams=8, frame_hw=(720, 1280), yolo_weights=YOLO,
                         reid_weights=REID, device="cuda")
ms.step_chunk(scenes[:, 0:4])  # warm-up: captures what the chunks take
walls, outs = [], set()
for timed in (False, False, False, True):
    for i in range(8):
        ms.reset_stream(i)
    ms.stage_timer = pl.CudaStageTimer() if timed else None
    zero()
    t0 = time.perf_counter()
    got = [tuple(x.cpu().numpy().tobytes()
                 for x in ms.step_chunk(scenes[:, a:a + 4])) for a in (0, 4, 8)]
    torch.cuda.synchronize()
    outs.add(digest(got))
    if not timed:
        walls.append((time.perf_counter() - t0) / 3 * 1e3)
        n_reads = reads(3)
stage = ms.stage_timer.totals["nms"] / ms.stage_timer.chunks
out["streams"] = sorted(outs)
print(f"[probe] {root} streams: ms a dispatch "
      + " / ".join(f"{x:.2f}" for x in walls)
      + f"; nms stage {stage:.3f} ms a dispatch; reads a dispatch {n_reads}; "
      f"SHA-256 of the outputs {out['streams']}", flush=True)
print("DIGESTS " + json.dumps(out))
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
    runs = []
    for root in args.roots:
        out = subprocess.run([sys.executable, "-c", CHILD,
                              str(root.resolve()), args.tracker],
                             capture_output=True, text=True, timeout=900)
        lines = out.stdout.splitlines()
        sys.stdout.write("".join(ln + "\n" for ln in lines
                                 if not ln.startswith("DIGESTS ")))
        if out.returncode:
            sys.stdout.write(out.stderr[-3000:])
            return out.returncode
        runs.append(json.loads([ln for ln in lines
                                if ln.startswith("DIGESTS ")][-1][8:]))
    same = True
    for path in (runs[0] if runs else {}):
        seen = {json.dumps(r[path]) for r in runs}
        same &= len(seen) == 1
        print(f"[probe] {path}: " + ("equal in every run" if len(seen) == 1
                                     else f"DIFFERS {sorted(seen)}"))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
