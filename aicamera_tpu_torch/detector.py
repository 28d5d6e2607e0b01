"""YOLODetector facade: the reference detector API on PyTorch/CUDA.

The port of ``aicamera_tpu/detector.py``: construct with a weights path (or
a ``.cudae`` engine file), input shape and thresholds, call
``.detect(frame_bgr)`` and get ``(bboxes_xyxy, scores, class_ids,
filtered_indices)`` in original frame coordinates. The detect path
(letterbox -> YOLOv8 -> decode + NMS -> un-letterbox) is one engine per
frame shape (``runtime.engine.CUDAGraphEngine``, the counterpart of JAX's
``XLAEngine``): on a GPU it is captured into a CUDA graph, the frame is
uploaded into the graph's static input and each call replays the graph, in
which the letterbox kernel (``ops/letterbox.py``) runs once for
:meth:`~YOLODetector.detect` (K=1) and twice for
:meth:`~YOLODetector.detect_tiled` (the tiles, then the full frame); replays
count in ``ops.letterbox.KERNEL.launches``. ``quant="int8"`` runs the
static-calibrated W8A8 twin (``models/quant_yolo.py``), calibrated at load.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
import torch

from . import config
from .device import resolve_device
from .ops.letterbox import letterbox
from .ops.nms import fused_decode_nms
from .ops.preprocess import device_constant, letterbox_spec, scale_boxes_back
from .ops.tiling import extract_tiles, merge_detections, tile_layout
from .runtime.engine import (CUDAGraphEngine, SerializedEngine, TensorInfo,
                             export_engine, is_engine_file,
                             is_xla_engine_file, xla_engine_error)
from .runtime.params import (flax_tree, load_state_strict, resolve_yolo_params,
                             tensor_tree, yolo_state_dict_from_flax)
from .runtime.pipeline import precision

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32"}
# detect engines: eager passes before each capture
_WARMUP_ITERS = 2


def detect_step(model, dtype: torch.dtype, spec, conf_threshold: float,
                nms_threshold: float, fixed_iters: bool):
    """The fused detect step of one frame shape: ``(H, W, 3)`` uint8 on the
    device -> ``(boxes (100, 4) f32 in frame coordinates, scores (100,),
    labels (100,) int32, valid (100,) bool)``, the JAX package's step.
    ``fixed_iters``: the NMS keep without reads (a captured step)."""
    # The NMS pre-filter follows conf_threshold below the default 0.25
    # floor, so that low-score recipes (ByteTrack's second stage) see
    # those boxes.
    nms_floor = min(config.YOLO_NMS_SCORE_THRESHOLD, conf_threshold)

    def step(frame_u8):
        x = letterbox(frame_u8[None], spec, dtype)
        with precision(dtype):
            levels = model(x)
        num, nboxes, nscores, nlabels = fused_decode_nms(
            levels, score_threshold=nms_floor, iou_threshold=nms_threshold,
            top_k=config.YOLO_NMS_TOPK, max_det=config.YOLO_MAX_DETECTIONS,
            fixed_iters=fixed_iters)
        boxes = scale_boxes_back(nboxes[0], spec)
        present = torch.arange(boxes.shape[0], device=boxes.device) < num[0]
        valid = present & (nscores[0] >= conf_threshold)
        return boxes, nscores[0], nlabels[0], valid

    return step


def tiled_step(model, dtype: torch.dtype, frame_hw, input_shape, grid,
               overlap: float, include_full: bool, merge_criterion: str,
               conf_threshold: float, nms_threshold: float,
               fixed_iters: bool):
    """The tiled detect step (``detect_tiled``) of one frame shape and
    layout, with :func:`detect_step`'s contract."""
    origins, tile_hw = tile_layout(frame_hw, grid, overlap)
    tile_spec = letterbox_spec(tile_hw, input_shape)
    full_spec = letterbox_spec(tuple(frame_hw), input_shape)
    nms_floor = min(config.YOLO_NMS_SCORE_THRESHOLD, conf_threshold)
    t = len(origins)
    max_det = config.YOLO_MAX_DETECTIONS
    offsets = tuple((x0, y0, x0, y0) for (y0, x0) in origins)

    def step(frame_u8):
        dev = frame_u8.device
        x = letterbox(extract_tiles(frame_u8, origins, tile_hw), tile_spec,
                      dtype)
        if include_full:
            x = torch.cat([x, letterbox(frame_u8[None], full_spec, dtype)])
        # one batched forward for all tiles (and the full frame)
        with precision(dtype):
            levels = model(x)
        num, nboxes, nscores, nlabels = fused_decode_nms(
            levels, score_threshold=nms_floor, iou_threshold=nms_threshold,
            top_k=config.YOLO_NMS_TOPK, max_det=max_det,
            fixed_iters=fixed_iters)
        tb = scale_boxes_back(nboxes[:t], tile_spec) \
            + device_constant(offsets, torch.float32, dev)[:, None]
        slot = torch.arange(max_det, device=dev)
        parts = [(tb.reshape(-1, 4), nscores[:t].reshape(-1),
                  nlabels[:t].reshape(-1),
                  (slot[None] < num[:t, None]).reshape(-1))]
        if include_full:
            parts.append((scale_boxes_back(nboxes[t], full_spec), nscores[t],
                          nlabels[t], slot < num[t]))
        allb, alls, allc, allv = (torch.cat(p) for p in zip(*parts))
        num_m, mb, ms, mc = merge_detections(
            allb, alls, allc, allv, nms_threshold, max_det,
            frame_hw=tuple(frame_hw), criterion=merge_criterion,
            fixed_iters=fixed_iters)
        valid = (slot < num_m) & (ms >= conf_threshold)
        return mb, ms, mc, valid

    return step


def serialized_step(header: dict, weights: dict, device: torch.device):
    """Rebuild a ``yolo_detect`` engine file's step (``runtime.engine``)."""
    meta, settings = header["metadata"], header["settings"]
    variant = meta.get("variant", "n")
    num_classes = settings.get("num_classes", 80)
    dtype = _DTYPES[header.get("dtype", "f32")]
    if settings.get("quant") == "int8":
        from .models.quant_yolo import QuantYOLOv8
        model = QuantYOLOv8(variant, num_classes).bind(
            tensor_tree(weights), settings["scales"], device)
        dtype = torch.float32
    else:
        from .models.yolov8 import YOLOv8
        model = YOLOv8(variant=variant, num_classes=num_classes)
        load_state_strict(model, yolo_state_dict_from_flax(weights))
        model = model.to(device=device, dtype=dtype).eval()
    spec = letterbox_spec(tuple(meta["frame_hw"]), tuple(meta["input_shape"]))
    return detect_step(model, dtype, spec, meta["conf_threshold"],
                       meta["nms_threshold"], device.type == "cuda")


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
        """``engine_path``: ``.msgpack`` or ``.onnx`` weights (``None``: the
        default checkpoint, else a seeded random init with a warning) or a
        ``.cudae`` engine file (weights, letterbox, thresholds and dtype
        baked in; constructor values that differ from the baked ones, and
        any ``detect_dtype``, are replaced with a warning). ``quant="int8"``: the static-calibrated W8A8 detector,
        calibrated at load on synthetic scenes. ``detect_dtype``: ``None``
        (bf16 on the GPU, f32 on the CPU), ``"bf16"`` or ``"f32"`` (TF32
        off: scores stable across batch shapes). ``device``: default the GPU
        (raises without one)."""
        if quant not in (None, "", "none", "int8"):
            raise ValueError(f"quant must be None or 'int8' (got {quant!r})")
        if detect_dtype not in (None, "bf16", "f32"):
            raise ValueError(
                f"detect_dtype must be None, 'bf16' or 'f32' "
                f"(got {detect_dtype!r})")
        if detect_dtype == "f32" and quant == "int8":
            raise ValueError("detect_dtype='f32' and quant='int8' conflict")
        if quant == "int8" and (is_engine_file(engine_path)
                                or is_xla_engine_file(engine_path)):
            raise ValueError("quant='int8' needs weights, not a serialized "
                             ".cudae engine (calibration happens at load)")
        if is_xla_engine_file(engine_path):
            raise xla_engine_error(engine_path)
        self.input_shape = tuple(input_shape)
        self.conf_threshold = float(conf_threshold)
        self.nms_threshold = float(nms_threshold)
        self.variant = variant
        self.device = resolve_device(device)
        self._serialized: SerializedEngine | None = None
        self._engines = {}
        self._specs = {}
        if is_engine_file(engine_path):
            self._load_engine(engine_path, detect_dtype)
            return
        self.quant = quant if quant == "int8" else None
        # int8 calibrates and quantizes from the f32 weights
        dtype = torch.float32 if self.quant else _DTYPES.get(detect_dtype)
        self.model = resolve_yolo_params(variant, weights_path=engine_path,
                                         device=self.device, dtype=dtype)
        self._dtype = next(self.model.parameters()).dtype
        if self.quant:
            from .models.quant_yolo import quantize_yolo_synthetic
            self.model, _ = quantize_yolo_synthetic(
                self.model, variant, self.model.num_classes,
                self.input_shape)
        # The NMS pre-filter follows conf_threshold below the default 0.25
        # floor, so that low-score recipes (ByteTrack's second stage) see
        # those boxes.
        self._nms_floor = min(config.YOLO_NMS_SCORE_THRESHOLD,
                              self.conf_threshold)
        print(f"YOLODetector initialized (YOLOv8{variant}"
              f"{', int8' if self.quant else ''}, PyTorch on "
              f"{self.device}). Input shape: {self.input_shape}")

    def _load_engine(self, path, detect_dtype=None):
        """A ``.cudae`` detect engine: its baked settings win (JAX
        ``detector.py:73-91``), the dtype among them: a ``detect_dtype``
        given with the file is ignored, with a warning."""
        if detect_dtype is not None:
            warnings.warn(
                f"{path}: the engine's dtype is baked in; detect_dtype="
                f"{detect_dtype!r} is ignored.", stacklevel=3)
        self._serialized = SerializedEngine.load(path, device=self.device)
        meta = self._serialized.metadata
        defaults = {"input_shape": tuple(config.YOLO_INPUT_SHAPE),
                    "conf_threshold": float(config.YOLO_CONF_THRESHOLD),
                    "nms_threshold": float(config.YOLO_NMS_THRESHOLD),
                    "variant": "n"}
        for attr, default in defaults.items():
            if attr not in meta:
                continue
            baked = meta[attr]
            if isinstance(baked, list):
                baked = tuple(baked)
            given = getattr(self, attr)
            if given != baked and given != default:
                warnings.warn(
                    f"{path}: {attr}={baked!r} is baked into the engine; "
                    f"the constructor value {given!r} is ignored.",
                    stacklevel=3)
            setattr(self, attr, baked)
        self.model = None
        self.quant = self._serialized.settings.get("quant")
        self._dtype = None
        print(f"YOLODetector initialized from serialized engine "
              f"'{self._serialized.name}' (PyTorch on {self.device}). Input "
              f"shape: {self.input_shape}")

    def _spec(self, frame_hw):
        key = tuple(frame_hw)
        if key not in self._specs:
            self._specs[key] = letterbox_spec(key, self.input_shape)
        return self._specs[key]

    @staticmethod
    def _frame(frame_bgr) -> torch.Tensor:
        """The host frame as a tensor; an engine uploads it into its static
        input."""
        return torch.from_numpy(np.ascontiguousarray(frame_bgr))

    def _engine(self, key, name, make_step) -> CUDAGraphEngine:
        """The engine cached under ``key`` (its frame shape first), built
        from ``make_step()`` on first use."""
        eng = self._engines.get(key)
        if eng is None:
            frame_hw = key if isinstance(key[0], int) else key[0]
            eng = CUDAGraphEngine(
                make_step(), [TensorInfo("frame", (*frame_hw, 3),
                                         torch.uint8)],
                name=name, warmup_iters=_WARMUP_ITERS, device=self.device)
            self._engines[key] = eng
        return eng

    def get_engine(self, frame_hw):
        """The engine of :meth:`detect` for ``frame_hw`` (I/O details,
        ``cost_analysis``, ``replays``); a loaded engine file checks the
        shape it was exported for."""
        key = tuple(frame_hw)
        if self._serialized is not None:
            baked_hw = tuple(self._serialized.get_input_details()[0].shape
                             )[:2]
            if key != baked_hw:
                raise ValueError(
                    f"serialized engine '{self._serialized.name}' is built "
                    f"for frame shape {baked_hw}, got {key}. Export an "
                    "engine per frame shape (YOLODetector.export_engine), "
                    "like the reference's fixed-shape TRT engines.")
            return self._serialized
        return self._engine(
            key, f"yolov8{self.variant}_detect_{key[0]}x{key[1]}",
            lambda: detect_step(self.model, self._dtype, self._spec(key),
                                self.conf_threshold, self.nms_threshold,
                                self.device.type == "cuda"))

    def _tiled_engine(self, frame_hw, grid, overlap, include_full,
                      merge_criterion):
        if self._serialized is not None:
            raise ValueError(
                "detect_tiled needs the model + params; this detector was "
                "loaded from a serialized single-pass engine. Construct "
                "from weights instead.")
        key = (tuple(frame_hw), grid, overlap, include_full, merge_criterion)
        return self._engine(
            key, (f"yolov8{self.variant}_detect_tiled_{frame_hw[0]}x"
                  f"{frame_hw[1]}_{grid[0]}x{grid[1]}_{merge_criterion}"),
            lambda: tiled_step(self.model, self._dtype, frame_hw,
                               self.input_shape, grid, overlap, include_full,
                               merge_criterion, self.conf_threshold,
                               self.nms_threshold,
                               self.device.type == "cuda"))

    @staticmethod
    def _host(boxes, scores, labels, valid):
        boxes, scores, labels, valid = (t.cpu().numpy() for t in
                                        (boxes, scores, labels, valid))
        idx = np.flatnonzero(valid)
        return boxes[idx], scores[idx], labels[idx].astype(np.int32), idx

    def detect(self, frame_bgr: np.ndarray):
        """Detect objects in one BGR frame.

        Returns ``(bboxes_xyxy (N, 4) f32, scores (N,), class_ids (N,)
        int32, filtered_indices (N,))``, the reference contract. N is the
        post-threshold count."""
        eng = self.get_engine(frame_bgr.shape[:2])
        return self._host(*eng(self._frame(frame_bgr)))

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
        tile-boundary fragments. One engine per frame shape and layout."""
        eng = self._tiled_engine(frame_bgr.shape[:2], tuple(grid),
                                 float(overlap), bool(include_full_frame),
                                 str(merge_criterion))
        return self._host(*eng(self._frame(frame_bgr)))

    def warm_up(self, frame_hw, iters: int = 5):
        """Run the detect path on blank frames of ``frame_hw`` (builds and
        captures its engine, then replays it)."""
        dummy = np.zeros((*frame_hw, 3), np.uint8)
        for _ in range(iters):
            self.detect(dummy)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def export_engine(self, frame_hw, path, name: str | None = None):
        """Write the detect step of ``frame_hw`` to a self-contained
        ``.cudae`` engine file (weights or int8 tree, letterbox spec and
        thresholds baked in, compute dtype this detector's): a
        ``YOLODetector(engine_path=<file>)`` runs it with no weight file."""
        if self._serialized is not None:
            raise ValueError("this detector was itself loaded from a "
                             "serialized engine; nothing new to export")
        key = tuple(frame_hw)
        eng = self.get_engine(key)
        settings = {"num_classes": self.model.num_classes}
        if self.quant:
            weights = {k: {f: v.numpy() for f, v in q.items()}
                       for k, q in self.model.qparams.items()}
            settings.update(quant="int8", scales=self.model.scales)
        else:
            weights = flax_tree(self.model)
        return export_engine(
            path, "yolo_detect", weights, eng.get_input_details(),
            eng.get_output_details(),
            name=name or f"yolov8{self.variant}_detect_{key[0]}x{key[1]}",
            metadata={"frame_hw": list(key),
                      "input_shape": list(self.input_shape),
                      "conf_threshold": self.conf_threshold,
                      "nms_threshold": self.nms_threshold,
                      "variant": self.variant},
            dtype=_DTYPE_NAMES[self._dtype], settings=settings)
