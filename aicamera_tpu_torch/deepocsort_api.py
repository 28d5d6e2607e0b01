"""Deep OC-SORT facade: OC-SORT's observation-centric motion tracking fused
with adaptively weighted ReID appearance.

The port of ``aicamera_tpu/deepocsort_api.py``. Deep OC-SORT (Maggiolino et
al., ICIP 2023) adds to OC-SORT camera-motion compensation, a per-track
EMA-smoothed ReID embedding with a confidence-modulated alpha, and an
adaptively weighted cosine term in the first association round. Per frame
the crops are gathered from the frame on the device and embedded in one
batch; add ``gmc="affine"`` for the paper's full stack.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from . import config
from .core import ocsort as oc
from .ocsort_api import OCSort
from .tracker_api import ReIDModel


class DeepOCSort(OCSort):
    """High-level Deep OC-SORT facade (official defaults: w_assoc_emb 0.75,
    aw_param 0.5, alpha_fixed_emb 0.95)."""

    def __init__(self,
                 reid_model_path: str | None = None,
                 reid_input_shape: Tuple[int, int] = config.REID_INPUT_SHAPE,
                 det_thresh: float = 0.6,
                 max_age: int = 30,
                 min_hits: int = 3,
                 iou_threshold: float = 0.3,
                 delta_t: int = 3,
                 inertia: float = 0.2,
                 w_assoc_emb: float = 0.75,
                 aw_param: float = 0.5,
                 alpha_fixed_emb: float = 0.95,
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
        self.params = oc.OCSortParams(
            det_thresh=float(det_thresh),
            max_age=int(max_age),
            min_hits=int(min_hits),
            iou_threshold=float(iou_threshold),
            delta_t=int(delta_t),
            inertia=float(inertia),
            max_tracks=int(max_tracks),
            max_detections=int(max_detections),
            with_appearance=True,
            feature_dim=config.REID_FEATURE_DIM,
            alpha_fixed_emb=float(alpha_fixed_emb),
            w_assoc_emb=float(w_assoc_emb),
            aw_param=float(aw_param),
        )
        self.max_reid_crops = min(int(max_reid_crops), int(max_detections))
        self.reid_model = ReIDModel(engine_path=reid_model_path,
                                    input_shape=reid_input_shape,
                                    device=self.device,
                                    reid_dtype=reid_dtype)
        self.state = self._init_state()
        print(f"Deep OC-SORT Tracker initialized (PyTorch on {self.device}).")
        print(f"  Params: DetThresh={det_thresh}, IoUThresh={iou_threshold}, "
              f"WAssocEmb={w_assoc_emb}, AwParam={aw_param}, "
              f"AlphaFixedEmb={alpha_fixed_emb}")

    @torch.no_grad()
    def update(self,
               yolo_bboxes_xyxy: np.ndarray,
               yolo_confidences: np.ndarray,
               yolo_class_ids: np.ndarray,
               original_frame_bgr: np.ndarray
               ) -> List[Tuple[int, int, int, int, int, str, float]]:
        """Process one frame's detections; returns the emitted tracks. The
        frame feeds the crop gather (and GMC when on)."""
        self.frame_count += 1
        thr = np.float32(self.params.det_thresh)
        host, _ = self._pad(yolo_bboxes_xyxy, yolo_confidences,
                            yolo_class_ids, lambda c: c > thr)
        d_xyxy, d_conf, d_cls, d_valid = self._to_device(host)
        frame = self._upload_frame(original_frame_bgr)
        camera = self._camera(frame)
        d_feats, d_hasfeat = self._appearance(self.reid_model, frame,
                                              d_xyxy, d_valid)
        dets = oc.OCSortDetections(
            xyxy=d_xyxy, score=d_conf, class_id=d_cls, valid=d_valid,
            feature=d_feats, has_feature=d_hasfeat)
        self.state = oc.step(self.state, dets, self.params, gmc=camera)
        return self._emit(oc.get_outputs(self.state, self.params))
