"""YOLODetector facade: the reference detector API on PyTorch/CUDA.

The port of ``aicamera_tpu/detector.py``: construct with a weights path,
input shape and thresholds, call ``.detect(frame_bgr)`` and get
``(bboxes_xyxy, scores, class_ids, filtered_indices)`` in original frame
coordinates. The detect path (letterbox -> YOLOv8 -> decode + NMS ->
un-letterbox) runs on the facade's device; on a GPU the letterbox is the
hand-written kernel (``ops/letterbox.py``), launched once per :meth:`detect`
call (K=1) and twice per :meth:`detect_tiled` call (the tiles, then the full
frame). Serialized ``.xlae`` engines and int8 quantization are not ported.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import config, not_ported
from .device import resolve_device
from .ops.letterbox import letterbox
from .ops.nms import fused_decode_nms
from .ops.preprocess import letterbox_spec, scale_boxes_back
from .ops.tiling import extract_tiles, merge_detections, tile_layout
from .runtime.params import resolve_yolo_params
from .runtime.pipeline import precision

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
ENGINE_FILE_SUFFIX = ".xlae"


def is_engine_file(path) -> bool:
    """True if ``path`` names a serialized engine artifact (by suffix)."""
    return path is not None and str(path).endswith(ENGINE_FILE_SUFFIX)


class YOLODetector:
    """YOLOv8 detector with the reference's ``detect`` contract."""

    def __init__(self,
                 engine_path: str | None = None,
                 input_shape: Tuple[int, int] = config.YOLO_INPUT_SHAPE,
                 conf_threshold: float = config.YOLO_CONF_THRESHOLD,
                 nms_threshold: float = config.YOLO_NMS_THRESHOLD,
                 variant: str = "n",
                 device=None,
                 quant: str | None = None,
                 detect_dtype: str | None = None):
        """``engine_path``: ``.msgpack`` weights (``None``: the default
        checkpoint, else a seeded random init with a warning).
        ``detect_dtype``: ``None`` (bf16 on the GPU, f32 on the CPU),
        ``"bf16"`` or ``"f32"`` (TF32 off: scores stable across batch
        shapes). ``device``: default the GPU (raises without one)."""
        if quant not in (None, "", "none", "int8"):
            raise ValueError(f"quant must be None or 'int8' (got {quant!r})")
        if detect_dtype not in (None, "bf16", "f32"):
            raise ValueError(
                f"detect_dtype must be None, 'bf16' or 'f32' "
                f"(got {detect_dtype!r})")
        if detect_dtype == "f32" and quant == "int8":
            raise ValueError("detect_dtype='f32' and quant='int8' conflict")
        if quant == "int8":
            raise not_ported("quant='int8' (models/quant_yolo.py)")
        if is_engine_file(engine_path):
            raise not_ported("serialized .xlae engines (runtime/engine.py)")
        self.input_shape = tuple(input_shape)
        self.conf_threshold = float(conf_threshold)
        self.nms_threshold = float(nms_threshold)
        self.variant = variant
        self.device = resolve_device(device)
        self.model = resolve_yolo_params(variant, weights_path=engine_path,
                                         device=self.device,
                                         dtype=_DTYPES.get(detect_dtype))
        self._dtype = next(self.model.parameters()).dtype
        # The NMS pre-filter follows conf_threshold below the default 0.25
        # floor, so that low-score recipes (ByteTrack's second stage) see
        # those boxes.
        self._nms_floor = min(config.YOLO_NMS_SCORE_THRESHOLD,
                              self.conf_threshold)
        self._specs = {}
        print(f"YOLODetector initialized (YOLOv8{variant}, PyTorch on "
              f"{self.device}). Input shape: {self.input_shape}")

    def _spec(self, frame_hw):
        key = tuple(frame_hw)
        if key not in self._specs:
            self._specs[key] = letterbox_spec(key, self.input_shape)
        return self._specs[key]

    def _upload(self, frame_bgr) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(frame_bgr)).to(
            self.device)

    def _forward_nms(self, x: torch.Tensor):
        with precision(self._dtype):
            levels = self.model(x)
        return fused_decode_nms(
            levels, score_threshold=self._nms_floor,
            iou_threshold=self.nms_threshold, top_k=config.YOLO_NMS_TOPK,
            max_det=config.YOLO_MAX_DETECTIONS)

    @staticmethod
    def _host(boxes, scores, labels, valid):
        boxes, scores, labels, valid = (t.cpu().numpy() for t in
                                        (boxes, scores, labels, valid))
        idx = np.flatnonzero(valid)
        return boxes[idx], scores[idx], labels[idx].astype(np.int32), idx

    @torch.no_grad()
    def detect(self, frame_bgr: np.ndarray):
        """Detect objects in one BGR frame.

        Returns ``(bboxes_xyxy (N, 4) f32, scores (N,), class_ids (N,)
        int32, filtered_indices (N,))``, the reference contract. N is the
        post-threshold count."""
        spec = self._spec(frame_bgr.shape[:2])
        frame = self._upload(frame_bgr)
        num, nboxes, nscores, nlabels = self._forward_nms(
            letterbox(frame[None], spec, self._dtype))
        boxes = scale_boxes_back(nboxes[0], spec)
        present = torch.arange(boxes.shape[0], device=self.device) < num[0]
        valid = present & (nscores[0] >= self.conf_threshold)
        return self._host(boxes, nscores[0], nlabels[0], valid)

    @torch.no_grad()
    def detect_tiled(self, frame_bgr: np.ndarray,
                     grid: Tuple[int, int] = (2, 2), overlap: float = 0.2,
                     include_full_frame: bool = True,
                     merge_criterion: str = "iou"):
        """Sliced high-resolution detection (SAHI-style), same return
        contract as :meth:`detect`.

        Slices the frame into a static ``grid`` of tiles with fractional
        ``overlap``, detects on all tiles (plus the full frame when
        ``include_full_frame``, so that large objects spanning tiles are
        still seen whole) in one batched forward, and merges everything with
        a global class-aware NMS (``ops/tiling.py``); ``merge_criterion``
        ``"ios"`` (intersection over the smaller area) collapses
        tile-boundary fragments."""
        frame_hw = tuple(frame_bgr.shape[:2])
        origins, tile_hw = tile_layout(frame_hw, tuple(grid), float(overlap))
        tile_spec = self._spec(tile_hw)
        frame = self._upload(frame_bgr)
        x = letterbox(extract_tiles(frame, origins, tile_hw), tile_spec,
                      self._dtype)
        if include_full_frame:
            full_spec = self._spec(frame_hw)
            x = torch.cat([x, letterbox(frame[None], full_spec, self._dtype)])
        num, nboxes, nscores, nlabels = self._forward_nms(x)
        t = len(origins)
        max_det = config.YOLO_MAX_DETECTIONS
        offsets = torch.tensor([[x0, y0, x0, y0] for (y0, x0) in origins],
                               dtype=torch.float32, device=self.device)
        tb = scale_boxes_back(nboxes[:t], tile_spec) + offsets[:, None]
        slot = torch.arange(max_det, device=self.device)
        parts = [(tb.reshape(-1, 4), nscores[:t].reshape(-1),
                  nlabels[:t].reshape(-1),
                  (slot[None] < num[:t, None]).reshape(-1))]
        if include_full_frame:
            parts.append((scale_boxes_back(nboxes[t], full_spec), nscores[t],
                          nlabels[t], slot < num[t]))
        allb, alls, allc, allv = (torch.cat(p) for p in zip(*parts))
        num_m, mb, ms, mc = merge_detections(
            allb, alls, allc, allv, self.nms_threshold, max_det,
            frame_hw=frame_hw, criterion=str(merge_criterion))
        valid = (slot < num_m) & (ms >= self.conf_threshold)
        return self._host(mb, ms, mc, valid)

    def warm_up(self, frame_hw, iters: int = 5):
        """Run the detect path on blank frames of ``frame_hw`` (builds the
        letterbox kernel, warms the allocator and cuDNN)."""
        dummy = np.zeros((*frame_hw, 3), np.uint8)
        for _ in range(iters):
            self.detect(dummy)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def get_engine(self, frame_hw):
        raise not_ported("YOLODetector.get_engine (runtime/engine.py)")

    def export_engine(self, frame_hw, path, name: str | None = None):
        raise not_ported("YOLODetector.export_engine (runtime/engine.py)")
