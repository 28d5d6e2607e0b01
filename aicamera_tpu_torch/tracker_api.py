"""DeepSORT and ReIDModel facades: the reference tracker API on PyTorch/CUDA.

The port of ``aicamera_tpu/tracker_api.py``. ``DeepSORT.update(bboxes,
confs, class_ids, frame)`` keeps the reference's call and return contract (a
list of ``(x1, y1, x2, y2, track_id, class_name, conf)`` for confirmed,
just-updated tracks); inside, the detections are padded to the tracker's
fixed capacities and the crop gather, ReID embedding, camera-motion warp,
association and lifecycle run on the facade's device.

``ReIDModel`` mirrors the reference's ``reid_model.py``: batched feature
extraction from host crop lists, padded to power-of-two batch buckets. Its
host resize is :func:`resize_linear_u8`, this package's copy of OpenCV's
``INTER_LINEAR`` for uint8 images (the port does not use OpenCV). It runs
the float net, the W8A8 twin (``quant="int8"``, ``models/quant.py``) or a
``.cudae`` engine file, captured per batch size on a GPU
(``runtime/engine.py``).

:class:`_TrackerFacade` holds the host side every tracker facade shares:
the class and score prefilter, the capacity truncation with its one-time
warning, the upload, the camera-motion step and the output tuples.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import config
from .core import state as core_state
from .core import tracker as core_tracker
from .core.costs import mean_to_tlwh, tlwh_to_tlbr
from .core.state import Detections, TrackerParams
from .device import resolve_device
from .ops import gmc as gmc_ops
from .ops.crops import extract_reid_crops
from .runtime.engine import (SerializedEngine, TensorInfo, export_engine,
                             is_engine_file, is_xla_engine_file,
                             xla_engine_error)
from .runtime.params import (flax_tree, load_state_strict,
                             reid_state_dict_from_flax, resolve_reid_params,
                             tensor_tree)
from .runtime.pipeline import _format_tracks, precision

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# OpenCV's fixed-point bilinear resize of uint8 images: 11-bit weights
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _linear_weights(dst: int, src: int, clamp: bool):
    """Source indices and fixed-point weights of one axis, as OpenCV's
    ``resize`` computes them: the coordinate in f32 from a double, its
    floor, the fraction in f32, each weight rounded half to even from
    ``w * 2048``. ``clamp`` (the horizontal axis): a coordinate left of the
    first pixel or at/after the last takes that pixel alone."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:
        low, high = s < 0, s >= src - 1
        f = np.where(low | high, np.float32(0.0), f)
        s = np.where(low, 0, np.where(high, src - 1, s))
    w0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE))
    w1 = np.rint(f * np.float32(_COEF_SCALE))
    i0 = np.clip(s, 0, src - 1)
    i1 = np.clip(s + 1, 0, src - 1)
    return i0, i1, w0.astype(np.int64), w1.astype(np.int64)


def resize_linear_u8(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """``(H, W, C)`` uint8 -> ``(out_h, out_w, C)`` uint8 bilinear resize
    with OpenCV's ``INTER_LINEAR`` arithmetic for 8-bit images: half-pixel
    centres, 11-bit integer weights, the horizontal pass in exact integers,
    then the vertical pass as OpenCV's vector path rounds it (each row's
    value shifted right by 4, times its weight, the high 16 bits, summed,
    then ``(v + 2) >> 2`` saturated)."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    x0, x1, a0, a1 = _linear_weights(ow, w, clamp=True)
    y0, y1, b0, b1 = _linear_weights(oh, h, clamp=False)
    src = img.astype(np.int64)
    horiz = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
    v = (((horiz[y0] >> 4) * b0[:, None, None]) >> 16) \
        + (((horiz[y1] >> 4) * b1[:, None, None]) >> 16)
    return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)


def serialized_step(header: dict, weights: dict, device: torch.device):
    """Rebuild a ``reid_embed`` engine file's step (``runtime.engine``):
    normalized f32 NHWC crops -> f32 features."""
    if header["settings"].get("quant") == "int8":
        from .models.quant import QuantReIDNet
        model = QuantReIDNet(tensor_tree(weights),
                             header["metadata"]["feature_dim"]).to(device)
        dtype = torch.float32
    else:
        from .models.reid import ReIDNet
        dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[
            header.get("dtype", "f32")]
        model = ReIDNet(feature_dim=header["metadata"]["feature_dim"])
        load_state_strict(model, reid_state_dict_from_flax(weights))
        model = model.to(device=device, dtype=dtype).eval()

    def embed(crops_f32):
        with precision(dtype):
            return model(crops_f32).float()

    return embed


class ReIDModel:
    """Appearance feature extractor with the reference's host-crop API."""

    _BUCKETS = (1, 2, 4, 8, 16, 32, 64)

    def __init__(self,
                 engine_path: str | None = None,
                 input_shape: Tuple[int, int] = config.REID_INPUT_SHAPE,
                 device=None,
                 quant: str | None = None,
                 reid_dtype: str | None = None):
        """``engine_path``: ``.msgpack``/``.onnx`` weights or a ``.cudae``
        engine file (its batch axis dynamic or fixed, as exported; its dtype
        baked in: a ``reid_dtype`` given with it is ignored, with a
        warning).
        ``quant="int8"``: the W8A8 twin, quantized at load. ``reid_dtype``:
        ``None`` (bf16 on the GPU, f32 on the CPU), ``"bf16"`` or ``"f32"``
        (TF32 off: features stable across batch shapes). ``device``: default the GPU."""
        if quant not in (None, "", "none", "int8"):
            raise ValueError(f"quant must be None or 'int8' (got {quant!r})")
        if reid_dtype not in (None, "bf16", "f32"):
            raise ValueError(f"reid_dtype must be None, 'bf16' or 'f32' "
                             f"(got {reid_dtype!r})")
        if reid_dtype == "f32" and quant == "int8":
            raise ValueError("reid_dtype='f32' and quant='int8' conflict")
        if quant == "int8" and (is_engine_file(engine_path)
                                or is_xla_engine_file(engine_path)):
            raise ValueError("quant='int8' needs weights, not a serialized "
                             ".cudae engine (quantization happens at load)")
        if is_xla_engine_file(engine_path):
            raise xla_engine_error(engine_path)
        self.input_shape = tuple(input_shape)
        self.device = resolve_device(device)
        self._serialized: SerializedEngine | None = None
        self.quant = quant if quant == "int8" else None
        if is_engine_file(engine_path):
            # weights and dtype baked in; a dynamic batch axis captures once
            # per size
            if reid_dtype is not None:
                warnings.warn(
                    f"{engine_path}: the engine's dtype is baked in; "
                    f"reid_dtype={reid_dtype!r} is ignored.", stacklevel=2)
            self._serialized = SerializedEngine.load(engine_path,
                                                     device=self.device)
            out = self._serialized.get_output_details()[0]
            self.feature_dim = int(out.shape[-1])
            in_shape = self._serialized.get_input_details()[0].shape
            self.input_shape = (int(in_shape[1]), int(in_shape[2]))
            self.model = None
            self.quant = self._serialized.settings.get("quant")
            self.dtype = torch.float32   # the engine's input contract
            return
        dtype = torch.float32 if self.quant else _DTYPES.get(reid_dtype)
        self.model = resolve_reid_params(engine_path, device=self.device,
                                         dtype=dtype)
        if self.quant:
            from .models.quant import QuantReIDNet, quantize_reid_params
            self.model = QuantReIDNet(
                quantize_reid_params(self.model),
                feature_dim=config.REID_FEATURE_DIM).to(self.device)
            self.dtype = self.model.dtype
        else:
            self.dtype = next(self.model.parameters()).dtype
        self.feature_dim = config.REID_FEATURE_DIM

    def _preprocess(self, crop_bgr: np.ndarray) -> np.ndarray:
        """Host-side resize + normalize for the list API: HWC f32 RGB."""
        resized = resize_linear_u8(crop_bgr, self.input_shape)
        rgb = resized[..., ::-1].astype(np.float32) / 255.0
        return (rgb - _IMAGENET_MEAN) / _IMAGENET_STD

    @torch.no_grad()
    def device_apply(self, crops: torch.Tensor) -> torch.Tensor:
        """``(B, H, W, 3)`` normalized crops on the device -> ``(B,
        feature_dim)`` f32 L2-normalized features, on the device (through
        the engine when one is loaded)."""
        if self._serialized is not None:
            return self._serialized(crops.float())
        with precision(self.dtype):
            return self.model(crops)

    def export_engine(self, path, name: str = "reid_embed",
                      dynamic_batch: bool = True, batch: int = 8):
        """Write the embedder (weights or int8 tree baked in) to a ``.cudae``
        engine file. ``dynamic_batch=True`` leaves the batch axis free (the
        reference engine's dynamic batch 1..8 without its ceiling; a GPU
        captures once per size), else it is ``batch``. The input is
        normalized f32 NHWC crops (ImageNet mean/std, RGB), what both
        :meth:`extract_features_batched` and :meth:`device_apply` take."""
        if self._serialized is not None:
            raise ValueError("this ReIDModel was itself loaded from a "
                             "serialized engine; nothing new to export")
        b = None if dynamic_batch else int(batch)
        if self.quant:
            weights, settings = self.model.qparams(), {"quant": "int8"}
        else:
            weights, settings = flax_tree(self.model), {}
        return export_engine(
            path, "reid_embed", weights,
            [TensorInfo("input_0", (b, *self.input_shape, 3),
                        torch.float32)],
            [TensorInfo("output_0", (b, self.feature_dim), torch.float32)],
            name=name,
            metadata={"input_shape": list(self.input_shape),
                      "feature_dim": self.feature_dim,
                      "dynamic_batch": bool(dynamic_batch)},
            dtype="bf16" if self.dtype == torch.bfloat16 else "f32",
            settings=settings)

    def extract_features_batched(self, crops_bgr: List[np.ndarray]
                                 ) -> np.ndarray:
        """``(N crops)`` -> ``(N, feature_dim)`` f32, L2-normalized. Empty
        crops give zero rows, as the reference skips them."""
        if not crops_bgr:
            return np.zeros((0, self.feature_dim), np.float32)
        valid_idx = [i for i, c in enumerate(crops_bgr)
                     if c is not None and c.size > 0
                     and c.shape[0] > 0 and c.shape[1] > 0]
        out = np.zeros((len(crops_bgr), self.feature_dim), np.float32)
        if not valid_idx:
            return out
        batch = np.stack([self._preprocess(crops_bgr[i]) for i in valid_idx])
        n = len(valid_idx)
        bucket = next(b for b in self._BUCKETS if b >= n) if n <= 64 else n
        padded = np.zeros((bucket, *batch.shape[1:]), np.float32)
        padded[:n] = batch
        feats = self.device_apply(torch.from_numpy(padded).to(self.device))
        out[valid_idx] = feats[:n].cpu().numpy()
        return out


def _class_names(class_ids) -> list:
    return [config.CLASSES[int(c)] if 0 <= int(c) < len(config.CLASSES)
            else "Unknown" for c in class_ids]


class _TrackerFacade:
    """The host side shared by the tracker facades. A subclass sets
    ``params`` (with ``max_detections``), ``device``, ``state``,
    ``max_reid_crops`` (``None`` without appearance) and ``_gmc``, and
    defines ``_init_state``."""

    def _setup(self, gmc, device):
        self.device = resolve_device(device)
        method = gmc_ops.gmc_method(gmc)
        self._gmc = (None if method is None
                     else gmc_ops.GMCEstimator(method, device=self.device))
        self.frame_count = 0
        self._dropped_host = 0
        self._warned_capacity = False

    def reset(self):
        self.state = self._init_state()
        self.frame_count = 0
        self._dropped_host = 0
        if self._gmc is not None:
            self._gmc.reset()

    @property
    def dropped_detections(self) -> int:
        """Detections dropped to the fixed capacities (host truncation plus
        the device's own counter). The reference has no capacity; a nonzero
        value flags crowded-scene divergence."""
        return self._dropped_host + int(self.state.dropped)

    def _pad(self, bboxes, confs, class_ids, score_ok):
        """Class filter + ``score_ok(confs)``, truncation to
        ``max_detections`` (warned once), padding: ``(d_xyxy, d_conf,
        d_cls, d_valid)`` as host arrays and the kept count."""
        n_det = self.params.max_detections
        boxes = np.asarray(bboxes, np.float32).reshape(-1, 4)
        confs = np.asarray(confs, np.float32).reshape(-1)
        clss = np.asarray(class_ids).reshape(-1).astype(np.int32)
        names = _class_names(clss)
        keep = [i for i in range(len(boxes))
                if score_ok(confs[i]) and names[i] in config.CLASSES_TO_TRACK]
        if len(keep) > n_det:
            self._dropped_host += len(keep) - n_det
            if not self._warned_capacity:
                crops = ("" if self.max_reid_crops is None else
                         f" (and only the first {self.max_reid_crops} get "
                         f"appearance features)")
                raise_ = ("max_detections" if self.max_reid_crops is None
                          else "max_detections/max_reid_crops")
                warnings.warn(
                    f"frame {self.frame_count}: {len(keep)} filtered "
                    f"detections exceed max_detections={n_det}; dropping "
                    f"the extras{crops}. Raise {raise_} for crowded scenes; "
                    "see .dropped_detections. (warned once)", stacklevel=3)
                self._warned_capacity = True
        keep = keep[:n_det]
        d_xyxy = np.zeros((n_det, 4), np.float32)
        d_conf = np.zeros((n_det,), np.float32)
        d_cls = np.zeros((n_det,), np.int32)
        d_valid = np.zeros((n_det,), bool)
        k = len(keep)
        if k:
            d_xyxy[:k] = boxes[keep]
            d_conf[:k] = confs[keep]
            d_cls[:k] = clss[keep]
            d_valid[:k] = True
        return (d_xyxy, d_conf, d_cls, d_valid), k

    def _to_device(self, arrays):
        return tuple(torch.from_numpy(a).to(self.device) for a in arrays)

    def _upload_frame(self, frame_bgr) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(frame_bgr)).to(
            self.device)

    def _camera(self, frame):
        """This frame's camera ``(A, t)`` on the device, or ``None``.
        ``frame``: a host array or a tensor (uploaded only with GMC on)."""
        if self._gmc is None:
            return None
        if frame is None:
            raise ValueError("gmc is enabled: update() needs the frame")
        return self._gmc.step(frame)

    def _appearance(self, reid_model, frame, d_xyxy, d_valid):
        """Crop gather + ReID on the device: ``(features (N, D) f32,
        has_feature (N,) bool)`` over the first ``max_reid_crops`` slots."""
        n_det = self.params.max_detections
        n_c = min(self.max_reid_crops, n_det)
        crops, crop_valid = extract_reid_crops(
            frame[None], d_xyxy[None, :n_c], out_hw=reid_model.input_shape,
            compute_dtype=reid_model.dtype)
        feats = reid_model.device_apply(crops[0])
        d_feats = torch.zeros((n_det, feats.shape[-1]), dtype=torch.float32,
                              device=self.device)
        d_feats[:n_c] = feats.float()
        d_hasfeat = torch.zeros((n_det,), dtype=torch.bool,
                                device=self.device)
        d_hasfeat[:n_c] = crop_valid[0] & d_valid[:n_c]
        return d_feats, d_hasfeat

    @staticmethod
    def _emit(outs) -> list:
        return _format_tracks(*(t.cpu().numpy() for t in outs))

    def _active_tuples(self, boxes: np.ndarray, conf) -> list:
        """``(x1, y1, x2, y2, track_id, class_name, conf, tsu)`` of every
        live slot, from host ``boxes (T, 4)``."""
        st = self.state
        active, ids, cls, conf, tsu = (t.cpu().numpy() for t in (
            st.active, st.track_id, st.class_id, conf, st.tsu))
        out = []
        for i in np.flatnonzero(active):
            b = boxes[i]
            out.append((int(round(float(b[0]))), int(round(float(b[1]))),
                        int(round(float(b[2]))), int(round(float(b[3]))),
                        int(ids[i]), _class_names([cls[i]])[0],
                        float(conf[i]), int(tsu[i])))
        return out


class DeepSORT(_TrackerFacade):
    """High-level tracker facade (reference ``deepsort_tracker.py``)."""

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
                 gallery_strategy: str = "fifo",
                 ema_alpha: float = 0.9,
                 gmc: str | bool = False,
                 nsa: bool = False,
                 reid_quant: str | None = None,
                 reid_dtype: str | None = None,
                 device=None):
        """As the JAX facade, plus ``device`` (default the GPU).

        ``nn_budget=None`` (an unlimited gallery in the reference) maps to a
        100-entry ring with a warning: the device state has a fixed size.
        ``capture_features=True`` stashes host copies of each step's
        post-filter inputs and appearance features (``last_tlwh``,
        ``last_conf``, ``last_class_id``, ``last_features``,
        ``last_has_feature``). ``gallery_strategy``: ``"fifo"`` (the
        reference's ring of ``nn_budget`` features per track) or ``"ema"``
        (one exponential-moving-average embedding, blend ``ema_alpha``).
        ``gmc`` (``"affine"``/``True`` or ``"translation"``): the camera
        affine warps the Kalman bank between predict and association.
        ``nsa``: StrongSORT's noise-scale-adaptive Kalman update."""
        if gallery_strategy not in ("fifo", "ema"):
            raise ValueError(
                f"gallery_strategy must be 'fifo' or 'ema' "
                f"(got {gallery_strategy!r})")
        use_ema = gallery_strategy == "ema"
        if use_ema and not (0.0 < ema_alpha < 1.0):
            raise ValueError(
                f"ema_alpha must be in (0, 1) for the EMA gallery "
                f"(got {ema_alpha})")
        if nn_budget is None:
            warnings.warn(
                "nn_budget=None (unlimited gallery in the reference) is "
                "not representable in fixed device shapes; using a "
                "100-entry feature ring instead. Pass nn_budget explicitly "
                "to choose the ring size.", stacklevel=2)
        self._setup(gmc, device)
        self.params = TrackerParams(
            max_cosine_distance=max_cosine_distance,
            # the EMA bank only ever occupies gallery slot 0
            nn_budget=1 if use_ema else (nn_budget or 100),
            max_iou_distance=max_iou_distance,
            max_age=max_age,
            n_init=n_init,
            max_tracks=max_tracks,
            max_detections=max_detections,
            feature_dim=config.REID_FEATURE_DIM,
            ema_alpha=float(ema_alpha) if use_ema else 0.0,
            nsa=bool(nsa),
        )
        self.min_detection_confidence = float(min_detection_confidence)
        self.max_reid_crops = int(max_reid_crops)
        self._capture = bool(capture_features)
        self.reid_model = ReIDModel(engine_path=reid_model_path,
                                    input_shape=reid_input_shape,
                                    device=self.device, quant=reid_quant,
                                    reid_dtype=reid_dtype)
        self.state = self._init_state()
        print(f"DeepSORT Tracker initialized (PyTorch on {self.device}).")
        print(f"  TrackerCore Params: CosDist={max_cosine_distance}, "
              f"IoUDist={max_iou_distance}, MaxAge={max_age}, NInit={n_init}, "
              f"NNBudget={nn_budget}, Gallery={gallery_strategy}"
              + (f"(alpha={ema_alpha})" if use_ema else ""))

    def _init_state(self):
        return core_state.init_state(self.params, self.device)

    def get_active_tracks(self):
        """All live tracks (confirmed and tentative, matched or not) as
        ``(x1, y1, x2, y2, track_id, class_name, conf, time_since_update)``
        tuples."""
        tlbr = tlwh_to_tlbr(mean_to_tlwh(self.state.mean)).cpu().numpy()
        return self._active_tuples(tlbr, self.state.conf)

    @torch.no_grad()
    def update(self,
               yolo_bboxes_xyxy: np.ndarray,
               yolo_confidences: np.ndarray,
               yolo_class_ids: np.ndarray,
               original_frame_bgr: np.ndarray
               ) -> List[Tuple[int, int, int, int, int, str, float]]:
        """Process one frame's detections; returns the confirmed tracks
        updated this frame (the reference's contract)."""
        self.frame_count += 1
        p = self.params
        min_conf = self.min_detection_confidence
        host, k = self._pad(yolo_bboxes_xyxy, yolo_confidences,
                            yolo_class_ids, lambda c: c >= min_conf)
        d_xyxy, d_conf, d_cls, d_valid = self._to_device(host)
        frame = self._upload_frame(original_frame_bgr)
        camera = self._camera(frame)
        d_feats, d_hasfeat = self._appearance(self.reid_model, frame,
                                              d_xyxy, d_valid)
        tlwh = torch.cat([d_xyxy[:, :2], d_xyxy[:, 2:] - d_xyxy[:, :2]],
                         dim=-1)
        dets = Detections(tlwh=tlwh, conf=d_conf, class_id=d_cls,
                          feature=d_feats, has_feature=d_hasfeat,
                          valid=d_valid)
        state = core_tracker.predict(self.state, p)
        if camera is not None:
            mean, cov = gmc_ops.warp_xyah_bank(state.mean, state.cov,
                                               camera[0], camera[1],
                                               state.active)
            state = state.replace(mean=mean, cov=cov)
        self.state = core_tracker.update(state, dets, p)
        if self._capture:
            h_xyxy, h_conf, h_cls, _ = host
            self.last_tlwh = np.concatenate(
                [h_xyxy[:k, :2], h_xyxy[:k, 2:] - h_xyxy[:k, :2]], axis=-1)
            self.last_conf = h_conf[:k].copy()
            self.last_class_id = h_cls[:k].copy()
            self.last_features = d_feats[:k].cpu().numpy()
            self.last_has_feature = d_hasfeat[:k].cpu().numpy()
        return self._emit(core_tracker.get_outputs(self.state))
