"""StrongSORT facade: DeepSORT with the StrongSORT upgrades switched on.

The port of ``aicamera_tpu/strongsort_api.py``. StrongSORT (Du et al. 2023)
keeps DeepSORT's association skeleton and upgrades its pieces: an EMA
appearance bank (``gallery_strategy="ema"``), the noise-scale-adaptive
Kalman update (``nsa=True``) and camera-motion compensation
(``gmc="affine"``, the block phase correlation of ``ops/gmc.py`` where the
paper uses ECC). GSI, its offline interpolation, works on finished tracks
and is not part of the online facade. The facade keeps the reference's
matching cascade. Every upgrade stays overridable; this class is the named
preset, with the same ``update(bboxes, confs, class_ids, frame)`` contract.
"""

from __future__ import annotations

from typing import Optional, Tuple

from . import config
from .tracker_api import DeepSORT


class StrongSORT(DeepSORT):
    """DeepSORT with the StrongSORT defaults: EMA gallery, NSA Kalman and
    camera-motion compensation."""

    def __init__(self,
                 reid_model_path: str | None = None,
                 reid_input_shape: Tuple[int, int] = config.REID_INPUT_SHAPE,
                 max_cosine_distance: float = config.DEEPSORT_MAX_DIST,
                 nn_budget: Optional[int] = config.DEEPSORT_NN_BUDGET,
                 max_iou_distance: float = config.DEEPSORT_MAX_IOU_DISTANCE,
                 max_age: int = config.DEEPSORT_MAX_AGE,
                 n_init: int = config.DEEPSORT_N_INIT,
                 min_detection_confidence: float =
                 config.DEEPSORT_MIN_CONFIDENCE,
                 max_tracks: int = config.MAX_TRACKS,
                 max_detections: int = config.MAX_DETECTIONS,
                 max_reid_crops: int = config.MAX_REID_CROPS,
                 capture_features: bool = False,
                 gallery_strategy: str = "ema",
                 ema_alpha: float = 0.9,
                 gmc: str | bool = "affine",
                 nsa: bool = True,
                 reid_dtype: str | None = None,
                 device=None):
        super().__init__(
            reid_model_path=reid_model_path,
            reid_input_shape=reid_input_shape,
            max_cosine_distance=max_cosine_distance,
            nn_budget=nn_budget,
            max_iou_distance=max_iou_distance,
            max_age=max_age,
            n_init=n_init,
            min_detection_confidence=min_detection_confidence,
            max_tracks=max_tracks,
            max_detections=max_detections,
            max_reid_crops=max_reid_crops,
            capture_features=capture_features,
            gallery_strategy=gallery_strategy,
            ema_alpha=ema_alpha,
            gmc=gmc,
            nsa=nsa,
            reid_dtype=reid_dtype,
            device=device)
