"""BoT-SORT facade: ByteTrack's two-pass association fused with ReID.

The port of ``aicamera_tpu/botsort_api.py``. BoT-SORT (Aharon et al. 2022)
is ByteTrack plus appearance: the first- and third-stage costs are
``min(iou, emb)`` with proximity and appearance masking, and each track
keeps an EMA-smoothed ReID embedding. Per frame the crops are gathered from
the frame on the device and embedded in one batch
(:meth:`~aicamera_tpu_torch.tracker_api.ReIDModel.device_apply`); add
``gmc="affine"`` for the paper's full stack. Feed it low-score detections,
as ByteTrack.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from . import config
from .bytetrack_api import ByteTrack
from .core import bytetrack as bt
from .tracker_api import ReIDModel


class BoTSORT(ByteTrack):
    """High-level BoT-SORT facade (official BoTSORT association; motion
    model: the xyah Kalman bank of the ByteTrack core)."""

    def __init__(self,
                 reid_model_path: str | None = None,
                 reid_input_shape: Tuple[int, int] = config.REID_INPUT_SHAPE,
                 track_thresh: float = 0.5,
                 match_thresh: float = 0.8,
                 track_buffer: int = 30,
                 frame_rate: int = 30,
                 fuse_score: bool = True,
                 proximity_thresh: float = 0.5,
                 appearance_thresh: float = 0.25,
                 feat_ema_alpha: float = 0.9,
                 max_tracks: int = config.MAX_TRACKS,
                 max_detections: int = config.MAX_DETECTIONS,
                 max_reid_crops: int = config.MAX_REID_CROPS,
                 gmc: str | bool = False,
                 reid_dtype: str | None = None,
                 device=None):
        """As the JAX facade, plus ``reid_dtype`` (as
        :class:`~aicamera_tpu_torch.tracker_api.ReIDModel`) and ``device``
        (default the GPU)."""
        self._setup(gmc, device)
        self.params = bt.ByteTrackParams(
            track_thresh=float(track_thresh),
            match_thresh=float(match_thresh),
            max_time_lost=int(frame_rate / 30.0 * track_buffer),
            fuse_score=bool(fuse_score),
            max_tracks=int(max_tracks),
            max_detections=int(max_detections),
            with_appearance=True,
            proximity_thresh=float(proximity_thresh),
            appearance_thresh=float(appearance_thresh),
            feat_ema_alpha=float(feat_ema_alpha),
            feature_dim=config.REID_FEATURE_DIM,
        )
        self.max_reid_crops = min(int(max_reid_crops), int(max_detections))
        self.reid_model = ReIDModel(engine_path=reid_model_path,
                                    input_shape=reid_input_shape,
                                    device=self.device,
                                    reid_dtype=reid_dtype)
        self.state = self._init_state()
        print(f"BoT-SORT Tracker initialized (PyTorch on {self.device}).")
        print(f"  Params: TrackThresh={track_thresh}, "
              f"MatchThresh={match_thresh}, "
              f"AppearanceThresh={appearance_thresh}, "
              f"MaxTimeLost={self.params.max_time_lost}")

    @torch.no_grad()
    def update(self,
               yolo_bboxes_xyxy: np.ndarray,
               yolo_confidences: np.ndarray,
               yolo_class_ids: np.ndarray,
               original_frame_bgr: np.ndarray
               ) -> List[Tuple[int, int, int, int, int, str, float]]:
        """Process one frame's detections; returns the activated tracked
        tracks. The frame feeds the crop gather (and GMC when on)."""
        self.frame_count += 1
        low = np.float32(self.params.low_thresh)
        host, _ = self._pad(yolo_bboxes_xyxy, yolo_confidences,
                            yolo_class_ids, lambda c: c > low)
        d_xyxy, d_conf, d_cls, d_valid = self._to_device(host)
        frame = self._upload_frame(original_frame_bgr)
        camera = self._camera(frame)
        d_feats, d_hasfeat = self._appearance(self.reid_model, frame,
                                              d_xyxy, d_valid)
        dets = bt.ByteDetections(
            tlwh=torch.cat([d_xyxy[:, :2], d_xyxy[:, 2:] - d_xyxy[:, :2]],
                           dim=-1),
            score=d_conf, class_id=d_cls, valid=d_valid, feature=d_feats,
            has_feature=d_hasfeat)
        self.state = bt.step(self.state, dets, self.params, gmc=camera)
        return self._emit(bt.get_outputs(self.state))
