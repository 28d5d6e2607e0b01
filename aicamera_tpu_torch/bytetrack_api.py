"""ByteTrack facade: the DeepSORT facade's call contract, motion only.

The port of ``aicamera_tpu/bytetrack_api.py``: the ByteTrack core
(``core/bytetrack.py``) behind the ``update(bboxes, confs, class_ids, frame)
-> [(x1, y1, x2, y2, track_id, class_name, conf)]`` contract of
:class:`~aicamera_tpu_torch.tracker_api.DeepSORT`, a drop-in tracker swap:

- **No ReID model.** Association is Kalman-predicted IoU only; the frame is
  needed only with ``gmc``.
- **Feed it low-score detections.** ByteTrack's second stage recovers
  occluded objects from boxes between ``low_thresh`` and ``track_thresh``:
  run the detector with ``conf_threshold <= low_thresh`` (0.1) for the
  algorithm to see them. The facade keeps tracked classes with ``score >
  low_thresh``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from . import config
from .core import bytetrack as bt
from .core.costs import mean_to_tlwh, tlwh_to_tlbr
from .tracker_api import _TrackerFacade


class ByteTrack(_TrackerFacade):
    """High-level ByteTrack facade (official BYTETracker semantics)."""

    def __init__(self,
                 track_thresh: float = 0.5,
                 match_thresh: float = 0.8,
                 track_buffer: int = 30,
                 frame_rate: int = 30,
                 fuse_score: bool = True,
                 max_tracks: int = config.MAX_TRACKS,
                 max_detections: int = config.MAX_DETECTIONS,
                 gmc: str | bool = False,
                 device=None):
        """``track_buffer`` scales with ``frame_rate`` as in the official
        tracker: ``max_time_lost = frame_rate / 30 * track_buffer``.
        ``gmc`` (``"affine"``/``True`` or ``"translation"``): camera-motion
        compensation, BoT-SORT's compensated motion model; every
        :meth:`update` then needs the frame. ``device``: default the GPU."""
        self._setup(gmc, device)
        self.params = bt.ByteTrackParams(
            track_thresh=float(track_thresh),
            match_thresh=float(match_thresh),
            max_time_lost=int(frame_rate / 30.0 * track_buffer),
            fuse_score=bool(fuse_score),
            max_tracks=int(max_tracks),
            max_detections=int(max_detections),
        )
        self.max_reid_crops = None
        self.state = self._init_state()
        print(f"ByteTrack Tracker initialized (PyTorch on {self.device}).")
        print(f"  Params: TrackThresh={track_thresh}, "
              f"MatchThresh={match_thresh}, MaxTimeLost="
              f"{self.params.max_time_lost}")

    def _init_state(self):
        return bt.init_state(self.params, self.device)

    @torch.no_grad()
    def update(self,
               yolo_bboxes_xyxy: np.ndarray,
               yolo_confidences: np.ndarray,
               yolo_class_ids: np.ndarray,
               original_frame_bgr: np.ndarray | None = None
               ) -> List[Tuple[int, int, int, int, int, str, float]]:
        """Process one frame's detections; returns the activated tracked
        tracks. ``original_frame_bgr`` may be None unless ``gmc`` is on."""
        self.frame_count += 1
        # the low-score floor in float32, as the step's own score split
        low = np.float32(self.params.low_thresh)
        host, _ = self._pad(yolo_bboxes_xyxy, yolo_confidences,
                            yolo_class_ids, lambda c: c > low)
        d_xyxy, d_conf, d_cls, d_valid = self._to_device(host)
        camera = self._camera(original_frame_bgr)
        dets = bt.ByteDetections(
            tlwh=torch.cat([d_xyxy[:, :2], d_xyxy[:, 2:] - d_xyxy[:, :2]],
                           dim=-1),
            score=d_conf, class_id=d_cls, valid=d_valid)
        self.state = bt.step(self.state, dets, self.params, gmc=camera)
        return self._emit(bt.get_outputs(self.state))

    def get_active_tracks(self):
        """All live tracks (tracked and lost) as ``(x1, y1, x2, y2,
        track_id, class_name, conf, time_since_update)`` tuples."""
        tlbr = tlwh_to_tlbr(mean_to_tlwh(self.state.mean)).cpu().numpy()
        return self._active_tuples(tlbr, self.state.score)
