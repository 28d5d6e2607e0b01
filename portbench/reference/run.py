"""The reference over what a run served: each stream's frames in order,
from a fresh tracker, through the configuration's detector family's
``Reference`` and :class:`.perception.Perception` (once per distinct
frame) and the configuration's tracker.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import time

import numpy as np

from .perception import Perception
from .trackers import track_stream

#: the last run's seconds by part, for the run's notes
TIMES = {}
_SERIAL = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


@contextlib.contextmanager
def _pool(n: int):
    """A spawn pool of ``n`` single-threaded workers, joined on exit."""
    saved = {k: os.environ.get(k) for k in _SERIAL}
    os.environ.update({k: "1" for k in _SERIAL})
    try:
        pool = multiprocessing.get_context("spawn").Pool(n)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    try:
        yield pool
        pool.close()
    finally:
        pool.terminate()
        pool.join()


def _tlwh(xyxy: np.ndarray) -> np.ndarray:
    out = xyxy.astype(np.float32).copy()
    out[:, 2:] -= out[:, :2]
    return out


def run(config: dict, family, frame_hw, clips: dict, streams: list,
        trees: dict, device, precision: str = "f32", want_dets: bool = False):
    """``family``: the detector family's module (``portbench/families``).
    ``clips``: key -> ``(n, H, W, 3)`` uint8 frames. ``streams``: per
    stream the ``(clip key, frame index)`` of each frame, in order.
    ``trees``: the detector's (``yolo``) and the ReID net's (``reid``) Flax
    trees.
    Returns per stream, per frame, the tracks ``(x1, y1, x2, y2, id,
    class, conf)``; with ``want_dets`` also per stream, per frame, the
    detections at or above the output threshold, ``(boxes, scores,
    classes)``."""
    t0 = time.perf_counter()
    detector = family.Reference(config, frame_hw, trees["yolo"], device,
                                precision)
    perc = Perception(config, detector, trees.get("reid"), device, precision)
    need = {}
    for s in streams:
        for key, i in s:
            need.setdefault(key, set()).add(int(i))
    seen = {}
    for key, idx in need.items():
        idx = sorted(idx)
        for i, d in zip(idx, perc(clips[key][idx])):
            seen[(key, i)] = d
    t1 = time.perf_counter()
    params = config["tracker"]
    thr = config["pipeline"]["conf_threshold"]
    inputs = {}
    for key, i in seen:
        d = seen[(key, i)]
        sl = d.slots
        inputs[(key, i)] = (_tlwh(d.boxes[sl]), d.scores[sl], d.classes[sl],
                            d.feats)
    jobs = [(params, [inputs[(key, int(i))] for key, i in s])
            for s in streams]
    workers = min(len(jobs), os.cpu_count() or 1, 8)
    if workers > 1:
        with _pool(workers) as pool:
            tracks = pool.map(track_stream, jobs, chunksize=1)
    else:
        tracks = [track_stream(j) for j in jobs]
    TIMES.update(perception_s=t1 - t0, trackers_s=time.perf_counter() - t1,
                 frames_perceived=len(seen))
    if not want_dets:
        return tracks
    dets = []
    for s in streams:
        dout = []
        for key, i in s:
            d = seen[(key, int(i))]
            v = d.scores >= thr
            dout.append((d.boxes[v], d.scores[v], d.classes[v]))
        dets.append(dout)
    return tracks, dets
