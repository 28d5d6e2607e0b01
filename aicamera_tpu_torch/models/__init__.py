"""YOLOv8 detector and DeepSORT ReID embedder as PyTorch modules."""

from .reid import ReIDNet
from .yolov8 import YOLOv8

__all__ = ["ReIDNet", "YOLOv8"]
