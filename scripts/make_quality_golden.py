#!/usr/bin/env python3
"""Write ``tests/data/quality_golden.json``: the JAX package's tracking
quality on BASELINE config 9's world, the reference the port's ``[quality]``
phase of ``chip_smoke.py`` is held to.

    JAX_PLATFORMS=cpu python scripts/make_quality_golden.py [--out PATH]

The world is ``TemporalWorld(WorldSpec(max_objects=10, presence=1.0),
seed=4, speed=3.0)`` at 960x540 (``benchmarks/run_configs.py::
_trained_world_frames``), 96 frames. The JAX ``TrackingPipeline`` runs on its
CPU backend in f32 (``detect_dtype="f32"``, ``reid_dtype="f32"``) with the
committed synthetic weights, DeepSORT defaults and chunk 8. Tracking is
scored from frame 5 on (``_replay_quality``: the first frames are the
tracker's n_init warm-up): CLEAR-MOT, HOTA and IDF1; detection AP over all
96 frames of the pipeline's detections. The file also holds each frame's
SHA-256 (``chip_smoke.frame_digest``: the frame, then its valid ground-truth
boxes, ids and classes) and the track tuples of every frame, so that a run
elsewhere can name the first frame where its scene or its tracks differ.
Takes about a minute on 8 CPU cores.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WORLD = dict(hw=[540, 960], max_objects=10, presence=1.0, seed=4, speed=3.0)
FRAMES = 96
SCORE_FROM = 5
CHUNK = 8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "tests" / "data"
                                         / "quality_golden.json"))
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT))
    import jax
    import numpy as np
    jax.config.update("jax_platforms", "cpu")
    from aicamera_tpu import config
    from aicamera_tpu.eval import (evaluate_detections, evaluate_hota,
                                   evaluate_identity, evaluate_mot)
    from aicamera_tpu.runtime.pipeline import TrackingPipeline
    from aicamera_tpu.synthetic import TemporalWorld, WorldSpec
    from chip_smoke import frame_digest   # the digest the card is held to

    t0 = time.perf_counter()
    world = TemporalWorld(
        WorldSpec(hw=tuple(WORLD["hw"]), max_objects=WORLD["max_objects"],
                  presence=WORLD["presence"]),
        seed=WORLD["seed"], speed=WORLD["speed"])
    frames, gt, gt_det, digests = [], [], [], []
    for _ in range(FRAMES):
        f, b, ids, cls, v = world.step()
        frames.append(f)
        gt.append((b[v], ids[v]))
        gt_det.append((b[v], cls[v]))
        digests.append(frame_digest(f, b[v], ids[v], cls[v]))
    pipe = TrackingPipeline(
        yolo_weights=str(config.PROJECT_ROOT / "models" / "detection"
                         / "yolov8n_synthetic.msgpack"),
        reid_weights=str(config.PROJECT_ROOT / "models" / "reid"
                         / "deepsort_reid_synthetic.msgpack"),
        chunk_size=CHUNK, detect_dtype="f32", reid_dtype="f32")
    hyp, preds, tracks = [], [], []
    for res in pipe.process_frames(iter(frames)):
        tracks.append([[int(v) for v in t[:5]] for t in res.tracks])
        hyp.append((np.asarray([t[:4] for t in res.tracks],
                               np.float32).reshape(-1, 4),
                    np.asarray([t[4] for t in res.tracks], np.int64)))
        preds.append((res.det_boxes, res.det_scores, res.det_labels))
    window = slice(SCORE_FROM, FRAMES)
    mot = evaluate_mot(gt[window], hyp[window])
    hota = evaluate_hota(gt[window], hyp[window])
    ident = evaluate_identity(gt[window], hyp[window])
    ap = evaluate_detections(gt_det, preds)
    golden = {
        "written_by": "scripts/make_quality_golden.py",
        "jax": jax.__version__,
        "world": WORLD, "frames": FRAMES, "score_from": SCORE_FROM,
        "chunk_size": CHUNK, "dtype": "f32",
        "mot": mot.as_dict(),
        "hota": {k: getattr(hota, k)
                 for k in ("hota", "det_a", "ass_a", "loc_a", "num_gt",
                           "num_hyp")},
        "identity": ident.as_dict(),
        "detection": {k: getattr(ap, k)
                      for k in ("ap50", "ap75", "map_5095", "num_gt",
                                "num_pred")},
        "frame_sha256": digests,
        "tracks": tracks,
    }
    Path(args.out).write_text(json.dumps(golden) + "\n")
    print(f"wrote {args.out} in {time.perf_counter() - t0:.1f} s: MOTA "
          f"{mot.mota:.4f}, IDSW {mot.id_switches}, HOTA {hota.hota:.4f}, "
          f"IDF1 {ident.idf1:.4f}, AP50 {ap.ap50:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
