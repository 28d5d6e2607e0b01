"""Central configuration: weight paths, thresholds, classes, capacities.

The port's own copy of ``aicamera_tpu/config.py`` (the port imports nothing
of the JAX package). Values are identical; the weight paths also name the
committed synthetic checkpoints, which are the only weights in the repo.
"""

from __future__ import annotations

import random
from pathlib import Path

PROJECT_ROOT = Path(__file__).resolve().parent.parent

# --- Model weights -----------------------------------------------------------
# Default checkpoint locations (msgpack of Flax params). These files and the
# ONNX exports below are not in the repo; resolution then falls back to a
# seeded random init with a warning, as the JAX package does.
_MODELS = PROJECT_ROOT / "models"
YOLO_PARAMS_PATH = _MODELS / "detection/yolov8n.msgpack"
REID_PARAMS_PATH = _MODELS / "reid/deepsort_reid.msgpack"
# The reference's ONNX exports (reference src/config.py:12-13), imported on
# first use and cached at the paths above.
YOLO_ONNX_PATH = _MODELS / "detection/yolov8n.onnx"
REID_ONNX_PATH = _MODELS / "reid/deepsort_reid.onnx"
# Committed checkpoints (tracked in git).
YOLO_SYNTHETIC_PATH = _MODELS / "detection/yolov8n_synthetic.msgpack"
RTDETR_SYNTHETIC_PATH = _MODELS / "detection/rtdetr_l_synthetic.msgpack"
YOLO_SYNTHETIC_CROWD_PATH = (_MODELS
                             / "detection/yolov8n_synthetic_crowd.msgpack")
YOLO_CLIP_ADAPTED_PATH = _MODELS / "detection/yolov8n_clip_adapted.msgpack"
REID_SYNTHETIC_PATH = _MODELS / "reid/deepsort_reid_synthetic.msgpack"
REID_SYNTHETIC_CROWD_PATH = (_MODELS
                             / "reid/deepsort_reid_synthetic_crowd.msgpack")
COMMITTED_CHECKPOINTS = {
    "yolo": (YOLO_SYNTHETIC_PATH, YOLO_SYNTHETIC_CROWD_PATH,
             YOLO_CLIP_ADAPTED_PATH),
    "reid": (REID_SYNTHETIC_PATH, REID_SYNTHETIC_CROWD_PATH),
}

# --- YOLOv8 ------------------------------------------------------------------
YOLO_INPUT_SHAPE = (640, 640)  # (H, W)
YOLO_CONF_THRESHOLD = 0.3
YOLO_NMS_THRESHOLD = 0.5
YOLO_NMS_SCORE_THRESHOLD = 0.25  # pre-NMS score floor
YOLO_MAX_DETECTIONS = 100        # post-NMS cap
YOLO_NMS_TOPK = 300              # pre-NMS candidate pool

# --- DeepSORT ----------------------------------------------------------------
DEEPSORT_MAX_DIST = 0.2
DEEPSORT_MIN_CONFIDENCE = 0.3
DEEPSORT_MAX_IOU_DISTANCE = 0.7
DEEPSORT_MAX_AGE = 70
DEEPSORT_N_INIT = 3
DEEPSORT_NN_BUDGET = 100

# --- ReID model --------------------------------------------------------------
REID_INPUT_SHAPE = (128, 64)  # (H, W)
REID_FEATURE_DIM = 512

# --- Static capacities -------------------------------------------------------
MAX_TRACKS = 128        # padded track-slot capacity
MAX_DETECTIONS = 64     # padded per-frame detection capacity (tracker)
MAX_REID_CROPS = 32     # padded per-frame ReID crop batch

# --- Video -------------------------------------------------------------------
DEFAULT_OUTPUT_FPS = 30  # the frame rate assumed for a source that names none

# --- Classes (COCO, YOLOv8 ordering) -----------------------------------------
CLASSES = (
    'person', 'bicycle', 'car', 'motorcycle', 'airplane', 'bus', 'train',
    'truck', 'boat', 'traffic light', 'fire hydrant', 'stop sign',
    'parking meter', 'bench', 'bird', 'cat', 'dog', 'horse', 'sheep', 'cow',
    'elephant', 'bear', 'zebra', 'giraffe', 'backpack', 'umbrella',
    'handbag', 'tie', 'suitcase', 'frisbee', 'skis', 'snowboard',
    'sports ball', 'kite', 'baseball bat', 'baseball glove', 'skateboard',
    'surfboard', 'tennis racket', 'bottle', 'wine glass', 'cup', 'fork',
    'knife', 'spoon', 'bowl', 'banana', 'apple', 'sandwich', 'orange',
    'broccoli', 'carrot', 'hot dog', 'pizza', 'donut', 'cake', 'chair',
    'couch', 'potted plant', 'bed', 'dining table', 'toilet', 'tv',
    'laptop', 'mouse', 'remote', 'keyboard', 'cell phone', 'microwave',
    'oven', 'toaster', 'sink', 'refrigerator', 'book', 'clock', 'vase',
    'scissors', 'teddy bear', 'hair drier', 'toothbrush',
)

# Classes eligible for tracking.
CLASSES_TO_TRACK = {'person', 'car', 'bus', 'truck', 'motorcycle'}
CLASS_IDS_TO_TRACK = tuple(
    i for i, name in enumerate(CLASSES) if name in CLASSES_TO_TRACK
)

# --- Visualization ----------------------------------------------------------
_color_rng = random.Random(0)
CLASS_COLORS = {
    cls_name: [_color_rng.randint(0, 255) for _ in range(3)]
    for cls_name in CLASSES
}
DEFAULT_TRACK_COLOR = (0, 255, 0)

FONT_SCALE_ID = 0.7
FONT_SCALE_INFO = 0.9
FONT_THICKNESS = 2


def get_track_color(class_name: str):
    """Color for a tracked box of the given class."""
    return CLASS_COLORS.get(class_name, DEFAULT_TRACK_COLOR)


def get_class_color(class_name: str):
    """Color for a raw detection box of the given class."""
    return CLASS_COLORS.get(class_name, (200, 200, 200))
