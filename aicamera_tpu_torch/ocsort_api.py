"""OC-SORT facade: the DeepSORT facade's call contract, observation-centric
motion tracking inside.

The port of ``aicamera_tpu/ocsort_api.py``: the OC-SORT core
(``core/ocsort.py``) behind the ``update(bboxes, confs, class_ids, frame)``
contract of :class:`~aicamera_tpu_torch.tracker_api.DeepSORT`:

- **No ReID model.** Association is IoU plus velocity-direction consistency
  (OCM); lost tracks recover by their last observation (OCR) and re-update
  along the virtual trajectory (ORU). The frame is needed only with ``gmc``.
- **Observation-centric outputs.** Emitted boxes are the matched detections,
  and appear once a track has ``min_hits`` consecutive hits (except during
  the first frames).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from . import config
from .core import ocsort as oc
from .tracker_api import _TrackerFacade


def _ocsort_active_boxes(state) -> np.ndarray:
    """Each slot's last observation, or its Kalman box before the first."""
    last = state.last_obs
    return torch.where((last[:, 4] >= 0)[:, None], last[:, :4],
                       oc.x_to_xyxy(state.x)).cpu().numpy()


class OCSort(_TrackerFacade):
    """High-level OC-SORT facade (official OCSort semantics)."""

    def __init__(self,
                 det_thresh: float = 0.6,
                 max_age: int = 30,
                 min_hits: int = 3,
                 iou_threshold: float = 0.3,
                 delta_t: int = 3,
                 inertia: float = 0.2,
                 max_tracks: int = config.MAX_TRACKS,
                 max_detections: int = config.MAX_DETECTIONS,
                 gmc: str | bool = False,
                 device=None):
        """``gmc`` (``"affine"``/``True`` or ``"translation"``): warps the
        Kalman bank and OC-SORT's observation history each frame; every
        :meth:`update` then needs the frame. ``device``: default the GPU."""
        self._setup(gmc, device)
        self.params = oc.OCSortParams(
            det_thresh=float(det_thresh),
            max_age=int(max_age),
            min_hits=int(min_hits),
            iou_threshold=float(iou_threshold),
            delta_t=int(delta_t),
            inertia=float(inertia),
            max_tracks=int(max_tracks),
            max_detections=int(max_detections),
        )
        self.max_reid_crops = None
        self.state = self._init_state()
        print(f"OC-SORT Tracker initialized (PyTorch on {self.device}).")
        print(f"  Params: DetThresh={det_thresh}, IoUThresh={iou_threshold}, "
              f"MaxAge={max_age}, MinHits={min_hits}, DeltaT={delta_t}, "
              f"Inertia={inertia}")

    def _init_state(self):
        return oc.init_state(self.params, self.device)

    @torch.no_grad()
    def update(self,
               yolo_bboxes_xyxy: np.ndarray,
               yolo_confidences: np.ndarray,
               yolo_class_ids: np.ndarray,
               original_frame_bgr: np.ndarray | None = None
               ) -> List[Tuple[int, int, int, int, int, str, float]]:
        """Process one frame's detections; returns the emitted tracks.
        ``original_frame_bgr`` may be None unless ``gmc`` is on."""
        self.frame_count += 1
        # the strict det_thresh floor in float32, as the step's own gate
        thr = np.float32(self.params.det_thresh)
        host, _ = self._pad(yolo_bboxes_xyxy, yolo_confidences,
                            yolo_class_ids, lambda c: c > thr)
        d_xyxy, d_conf, d_cls, d_valid = self._to_device(host)
        camera = self._camera(original_frame_bgr)
        dets = oc.OCSortDetections(xyxy=d_xyxy, score=d_conf,
                                   class_id=d_cls, valid=d_valid)
        self.state = oc.step(self.state, dets, self.params, gmc=camera)
        return self._emit(oc.get_outputs(self.state, self.params))

    def get_active_tracks(self):
        """All live tracks as ``(x1, y1, x2, y2, track_id, class_name, conf,
        time_since_update)`` tuples (Kalman boxes for tracks not yet
        observed)."""
        return self._active_tuples(_ocsort_active_boxes(self.state),
                                   self.state.score)
