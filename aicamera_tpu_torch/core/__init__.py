"""DeepSORT tracker core over fixed-capacity padded tensors."""

from .state import (Detections, TrackerParams, TrackerState, init_state,
                    make_detections)
from .tracker import get_outputs, predict, update

__all__ = ["Detections", "TrackerParams", "TrackerState", "init_state",
           "make_detections", "predict", "update", "get_outputs"]
