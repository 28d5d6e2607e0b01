"""What the drivers share: the clips the traffic plays, weight files, the
program's track tuples as class ids, and the harness's host phases."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..reference.coco import CLASS_IDS
from ..world.synthetic import TemporalWorld, WorldSpec


def traffic_rng(seed: int) -> np.random.Generator:
    """The generator of the run's choices (world order, offsets, phases),
    from ``--seed``."""
    return np.random.default_rng(
        np.random.SeedSequence(int(seed) & (2 ** 64 - 1)))


def render_clip(world: dict, frame_hw, n: int, index: int, device):
    """``n`` frames ``(n, H, W, 3)`` uint8 of world ``index`` of the
    traffic's fixed set (its seed ``world["seed"] + index``), rendered on
    the device by the frozen world and held in pageable host memory. The
    run's seed chooses which world a camera shows and where it starts, not
    the worlds: every seed gets the same scenes, so the same work."""
    spec = WorldSpec(hw=tuple(frame_hw), max_objects=world["max_objects"],
                     presence=world["presence"])
    w = TemporalWorld(spec, seed=world["seed"] + index,
                      speed=world["speed"], device=device)
    out = np.empty((n, *frame_hw, 3), np.uint8)
    for i in range(n):
        out[i] = w.step()[0]
    return out


def pingpong(n: int) -> np.ndarray:
    """Clip indices played forward then back, each end shown twice: period
    ``2 n``."""
    return np.concatenate([np.arange(n), np.arange(n)[::-1]])


def tracks_by_id(tracks: list) -> list:
    """The program's ``(x1, y1, x2, y2, id, class name, conf)`` tuples with
    the class as its COCO id."""
    return [(t[0], t[1], t[2], t[3], int(t[4]), CLASS_IDS.get(t[5], -1),
             float(t[6])) for t in tracks]


def tracks_from_arrays(tlbr, ids, cls, conf, mask) -> list:
    """One frame's raw track outputs as tuples (boxes as the program's own
    formatting rounds them)."""
    out = []
    for b, i, c, s in zip(tlbr[mask], ids[mask], cls[mask], conf[mask]):
        out.append((int(round(float(b[0]))), int(round(float(b[1]))),
                    int(round(float(b[2]))), int(round(float(b[3]))),
                    int(i), int(c), float(s)))
    return out


class Phases:
    """The harness's host phases: durations by name (``keep``), and each
    handed to the tracer, which keeps those of its traced sub-window."""

    def __init__(self, tracer):
        self.spans = {}
        self.tracer = tracer

    @contextlib.contextmanager
    def __call__(self, name: str, keep: bool = False):
        t0, n0 = time.perf_counter(), time.time_ns()
        yield
        self.tracer.phase(name, n0, time.time_ns())
        if keep:
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)


def pipeline_kwargs(cfg: dict, family) -> dict:
    """The program's constructor arguments that the configuration states:
    the detector family's (``portbench/families``) and the tracker's."""
    p, trk = cfg["pipeline"], cfg["tracker"]
    kw = dict(family.program_kwargs(cfg), tracker=trk["kind"],
              scan_bucket=trk["scan_bucket"])
    if trk["kind"] == "deepsort":
        from aicamera_tpu_torch.core.state import TrackerParams
        kw["min_detection_confidence"] = p["min_confidence"]
        kw["max_reid_crops"] = cfg["reid"]["crops"]
        kw["tracker_params"] = TrackerParams(
            feature_dim=cfg["reid"]["feature_dim"],
            **{f: trk[f] for f in ("max_cosine_distance", "nn_budget",
                                   "max_iou_distance", "max_age", "n_init",
                                   "max_tracks", "max_detections")})
    elif trk["kind"] == "bytetrack":
        from aicamera_tpu_torch.core.bytetrack import ByteTrackParams
        kw["bytetrack_params"] = ByteTrackParams(
            **{f: trk[f] for f in ("track_thresh", "match_thresh",
                                   "second_match_thresh",
                                   "unconfirmed_match_thresh", "low_thresh",
                                   "det_thresh", "max_time_lost",
                                   "fuse_score", "dup_iou_cost",
                                   "max_tracks", "max_detections")})
    return kw


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
