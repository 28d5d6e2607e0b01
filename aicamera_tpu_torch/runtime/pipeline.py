"""The fused chunk pipeline: letterbox -> YOLOv8 -> decode+NMS -> crops ->
ReID -> tracker, K frames per dispatch.

The port of ``aicamera_tpu/runtime/pipeline.py`` with its three tracker
cores (DeepSORT and its StrongSORT preset, ByteTrack and BoT-SORT, OC-SORT
and Deep OC-SORT), camera-motion compensation and the capacity-bucketed
tracker scan. All batchable work (camera-motion estimate, letterbox kernel,
detector forward, decode+NMS, crop gather, ReID embedding) runs batched
over the chunk on the device; the sequential tracker then runs frame by frame
over the chunk, its state staying on the same device. The DeepSORT core
(and its StrongSORT preset) reads nothing back, so a chunk's tracker frames
replay as one captured CUDA graph, as the JAX package jits its scan; the
ByteTrack and OC-SORT steps still branch on the host. Outputs
follow the JAX package's contracts: per frame, the detections in frame
coordinates and the emitted tracks as ``(x1, y1, x2, y2, id, class_name,
conf)`` tuples.

On a CUDA device the letterbox and the assignment solves always run the
hand-written kernels (``ops/letterbox.py``, ``ops/assignment.py``); on the
CPU they run the kernels' plain versions.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Iterator, Tuple

import numpy as np
import torch

from .. import config
from ..core import bytetrack as bt_core
from ..core import ocsort as oc_core
from ..core import state as core_state
from ..core import tracker as core_tracker
from ..core.state import Detections, TrackerParams
from ..device import resolve_device
from ..ops import gmc as gmc_ops
from ..ops.crops import extract_reid_crops
from ..ops.letterbox import letterbox
from ..ops.nms import fused_decode_nms
from ..ops.preprocess import letterbox_spec, scale_boxes_back
from ..syncs import SyncCounter
from .engine import CUDAGraphEngine
from .params import resolve_reid_params, resolve_yolo_params

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}

EMBED_SYNCS = SyncCounter()  # the ReID bucket choice: one read per chunk
BUCKET_SYNCS = SyncCounter()  # the bucketed scan: one or two reads per chunk


@dataclasses.dataclass
class FrameResult:
    """Host-side per-frame outputs."""
    frame_index: int
    det_boxes: np.ndarray     # (n, 4) xyxy in frame coords
    det_scores: np.ndarray    # (n,)
    det_labels: np.ndarray    # (n,) int32
    tracks: list              # [(x1, y1, x2, y2, id, class_name, conf), ...]


@dataclasses.dataclass(frozen=True)
class TrackerInputs:
    """The tracker's inputs for a batch of frames, each ``(B, N, ...)`` over
    the N detection slots: boxes (xyxy and tlwh), scores, classes, the slot
    mask, the ReID features and where they exist; and the camera motion per
    frame, ``(B, 2, 2)`` and ``(B, 2)`` (``None`` without GMC)."""
    xyxy: torch.Tensor
    tlwh: torch.Tensor
    conf: torch.Tensor
    cls: torch.Tensor
    valid: torch.Tensor
    feats: torch.Tensor
    hasfeat: torch.Tensor
    gmc_a: torch.Tensor | None = None
    gmc_t: torch.Tensor | None = None

    def frames(self, lo: int, hi: int) -> "TrackerInputs":
        """Frames ``lo:hi`` of the batch (views)."""
        return TrackerInputs(**{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name)[lo:hi]
            for f in dataclasses.fields(self)})


@contextlib.contextmanager
def full_f32():
    """Full-precision f32 convolutions and matmuls (TF32 off) inside."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def precision(dtype: torch.dtype):
    """The context a forward in ``dtype`` runs in: :func:`full_f32` for
    f32, nothing for bf16."""
    return full_f32() if dtype == torch.float32 else contextlib.nullcontext()


class CudaStageTimer:
    """Per-stage time of each chunk on the GPU stream, from CUDA events.
    Attach one to ``TrackingPipeline.stage_timer``: each chunk then records
    an event at every stage boundary, and :meth:`finish` adds the stage
    intervals to ``totals`` (ms over ``chunks`` chunks)."""

    STAGES = ("gmc", "letterbox", "yolo", "nms", "crops_reid", "tracker")

    def __init__(self, stages=STAGES):
        self._events = []
        self.totals = dict.fromkeys(stages, 0.0)
        self.chunks = 0

    def start(self):
        self._events = [("start", self._record())]

    def mark(self, stage: str):
        self._events.append((stage, self._record()))

    @staticmethod
    def _record():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def finish(self):
        """Sync, add this chunk's stage times to the totals."""
        self._events[-1][1].synchronize()
        for (_, a), (stage, b) in zip(self._events, self._events[1:]):
            self.totals[stage] += a.elapsed_time(b)
        self.chunks += 1


def _format_tracks(tlbr, ids, cls, conf, mask):
    out = []
    for b, i, c, s in zip(tlbr[mask], ids[mask], cls[mask], conf[mask]):
        name = config.CLASSES[int(c)] if 0 <= int(c) < len(config.CLASSES) \
            else "Unknown"
        out.append((int(round(float(b[0]))), int(round(float(b[1]))),
                    int(round(float(b[2]))), int(round(float(b[3]))),
                    int(i), name, float(s)))
    return out


def _bucketed_time_scan(state, scan, params, t_small: int, stats: dict):
    """The per-frame tracker scan of one chunk at a reduced track capacity
    when all activity fits, with exact fallbacks.

    Generic over the three cores: any state whose non-scalar fields lead with
    the track axis, that places new tracks at the lowest free slots, counts
    overflow in ``dropped`` and emits zeros on masked output lanes
    (``core/state.py::slice_any_tracks``). ``scan(state, params)`` runs the
    chunk's frames at the capacity ``params.max_tracks`` and returns ``(state,
    outs)``, ``outs`` five tensors shaped ``(K, T, ...)``.

    The tracker's work per frame grows with the padded capacity, so a chunk
    whose live tracks fit in ``t_small`` slots runs on a sliced state. Two
    reads a chunk (``BUCKET_SYNCS``): whether it fits (no active slot at or
    above ``t_small``, and a quarter of the small table free, since a load at
    the boundary would overflow and pay the rerun every chunk), and after the
    small pass whether ``dropped`` grew: the small table then ran out of
    slots where the full one would not have, and the whole chunk reruns from
    the untouched ``state`` at full capacity. ``stats`` counts the chunks
    that took each way (``small``, ``skipped``, ``rerun``)."""
    t_full = params.max_tracks
    if not (t_small and t_small < t_full):
        return scan(state, params)
    headroom = max(4, t_small // 4)
    fits = ~torch.any(state.active[t_small:]) \
        & (torch.sum(state.active) <= t_small - headroom)
    if BUCKET_SYNCS.flag(fits):
        s_small, outs = scan(
            core_state.slice_any_tracks(state, t_small),
            dataclasses.replace(params, max_tracks=t_small))
        if not BUCKET_SYNCS.flag(s_small.dropped > state.dropped):
            stats["small"] += 1
            padded = tuple(torch.cat([a, a.new_zeros(
                (a.shape[0], t_full - t_small, *a.shape[2:]))], dim=1)
                for a in outs)
            return core_state.splice_any_tracks(state, s_small), padded
        stats["rerun"] += 1
    else:
        stats["skipped"] += 1
    return scan(state, params)


_TRACKERS = ("deepsort", "bytetrack", "botsort", "ocsort", "deepocsort")


class TrackingPipeline:
    """End-to-end detector + tracker with chunked device steps."""

    #: The DeepSORT scan of a chunk replays one capture; False runs it frame
    #: by frame, skipping invalid frames on the host (the eager path that
    #: the capture is checked and timed against). Read when stages are made.
    _capture_scans = True

    def __init__(self,
                 variant: str = "n",
                 input_shape: Tuple[int, int] = config.YOLO_INPUT_SHAPE,
                 conf_threshold: float = config.YOLO_CONF_THRESHOLD,
                 nms_threshold: float = config.YOLO_NMS_THRESHOLD,
                 min_detection_confidence: float =
                 config.DEEPSORT_MIN_CONFIDENCE,
                 yolo_weights: str | None = None,
                 reid_weights: str | None = None,
                 tracker_params: TrackerParams | None = None,
                 max_reid_crops: int = config.MAX_REID_CROPS,
                 chunk_size: int = 8,
                 preprocess_impl: str = "auto",
                 with_reid: bool = True,
                 synthetic_load: int = 0,
                 scan_bucket: int | None = 32,
                 letterbox_auto: bool = False,
                 tracker: str = "deepsort",
                 bytetrack_params: bt_core.ByteTrackParams | None = None,
                 ocsort_params: oc_core.OCSortParams | None = None,
                 gmc: str | bool = False,
                 nsa: bool = False,
                 reid_quant: str | None = None,
                 yolo_quant: str | None = None,
                 detect_dtype: str | None = None,
                 reid_dtype: str | None = None,
                 device=None):
        """Arguments as in the JAX ``TrackingPipeline``, plus ``device``.

        ``tracker``: ``"deepsort"`` (default), ``"strongsort"`` (the DeepSORT
        core with the StrongSORT preset: EMA appearance bank, NSA Kalman,
        and ``gmc="affine"`` unless ``gmc`` says otherwise),
        ``"bytetrack"``, ``"botsort"`` (ByteTrack with BoT-SORT's appearance
        fusion), ``"ocsort"`` or ``"deepocsort"`` (OC-SORT with Deep
        OC-SORT's appearance fusion). ByteTrack and OC-SORT skip the
        ReID stage. ByteTrack and BoT-SORT feed the tracker every
        class-eligible detection above ``low_thresh`` whatever
        ``conf_threshold`` says (which still governs the detection output
        lists), and the NMS score floor drops to ``low_thresh``; OC-SORT
        takes the detections above its strict ``det_thresh``.
        ``bytetrack_params`` / ``ocsort_params`` replace the defaults of
        their cores.

        ``scan_bucket``: capacity-bucketed tracker scan
        (:func:`_bucketed_time_scan`): while every active track lives in the
        first ``scan_bucket`` slots with room to spare, the chunk's tracker
        frames run on a state sliced to that many slots; exact by its two
        fallbacks. ``None`` or 0 disables. ``scan_stats`` counts the chunks
        that took each way since the last :meth:`reset`.

        ``synthetic_load=n`` fills the first n empty detection slots of every
        frame with a fixed grid of boxes (class person, conf 0.5) after NMS,
        so the crop gather, ReID, association and lifecycle run every frame.
        At default thresholds only the DeepSORT core takes those boxes: 0.5
        is in neither of ByteTrack's score splits and below OC-SORT's
        ``det_thresh``.
        ``letterbox_auto`` runs the detector on the stride-32 minimum
        rectangle. ``preprocess_impl`` is accepted for signature parity and
        has no effect: on a CUDA device the letterbox kernel always runs, on
        the CPU its plain version. ``detect_dtype`` / ``reid_dtype``:
        ``"f32"`` or ``"bf16"``; the default is bf16 on the GPU and f32 on
        the CPU. In f32 the forwards run with TF32 off. ``reid_dtype`` also
        sets the crop gather's dtype. ``nsa``: noise-scale-adaptive Kalman
        update, DeepSORT core only. ``gmc``: camera-motion compensation
        (``ops/gmc.py``), ``"affine"`` (or ``True``), ``"translation"`` or
        off: each chunk estimates the camera motion of its frames on the
        device (stage ``gmc``), the frame before the chunk carried over from
        the previous chunk, and every tracker frame warps its state by it
        after the prediction. ``reid_quant="int8"``: the ReID stage runs
        the W8A8 twin (``models/quant.py``: per-channel int8 weights,
        per-crop dynamic activation scales, int32 accumulation), the crops
        in f32. ``yolo_quant="int8"``: the detector runs the
        static-calibrated W8A8 twin (``models/quant_yolo.py``), calibrated
        once here on synthetic scenes, on an f32 letterbox; its detections
        differ a little from bf16's. Either conflicts with the f32 dtype of
        its stage. ``device``: default ``"cuda"`` (raises without a GPU);
        tests pass ``"cpu"``.
        """
        self.tracker_kind = str(tracker)
        if self.tracker_kind == "strongsort":
            self.tracker_kind = "deepsort"
            if gmc in (False, None):      # unset: the preset's default
                gmc = "affine"
            if tracker_params is None:
                tracker_params = TrackerParams(
                    max_cosine_distance=config.DEEPSORT_MAX_DIST,
                    nn_budget=1,          # the EMA bank occupies slot 0 only
                    max_iou_distance=config.DEEPSORT_MAX_IOU_DISTANCE,
                    max_age=config.DEEPSORT_MAX_AGE,
                    n_init=config.DEEPSORT_N_INIT,
                    max_tracks=config.MAX_TRACKS,
                    max_detections=config.MAX_DETECTIONS,
                    feature_dim=config.REID_FEATURE_DIM,
                    ema_alpha=0.9,
                    nsa=True,
                )
                nsa = False   # folded into tracker_params above
        if self.tracker_kind not in _TRACKERS:
            raise ValueError(f"tracker must be 'deepsort', 'strongsort', "
                             f"'bytetrack', 'botsort', 'ocsort' or "
                             f"'deepocsort' (got {tracker})")
        if nsa and self.tracker_kind != "deepsort":
            raise ValueError("nsa=True requires tracker='deepsort' (the "
                             "other cores take fixed-noise updates)")
        if nsa and tracker_params is not None:
            raise ValueError("pass nsa via tracker_params.nsa when "
                             "supplying explicit tracker_params")
        bytetrack = self.tracker_kind in ("bytetrack", "botsort")
        ocsort = self.tracker_kind in ("ocsort", "deepocsort")
        appearance = self.tracker_kind in ("botsort", "deepocsort")
        if bytetrack_params is not None and not bytetrack:
            raise ValueError("bytetrack_params requires tracker='bytetrack' "
                             "or 'botsort'")
        if ocsort_params is not None and not ocsort:
            raise ValueError("ocsort_params requires tracker='ocsort' "
                             "or 'deepocsort'")
        self.bytetrack_params = self.ocsort_params = None
        core_defaults = dict(max_tracks=config.MAX_TRACKS,
                             max_detections=config.MAX_DETECTIONS)
        if appearance:
            core_defaults.update(with_appearance=True,
                                 feature_dim=config.REID_FEATURE_DIM)
        if bytetrack:
            self.bytetrack_params = bytetrack_params or \
                bt_core.ByteTrackParams(**core_defaults)
            core_params = self.bytetrack_params
        elif ocsort:
            self.ocsort_params = ocsort_params or \
                oc_core.OCSortParams(**core_defaults)
            core_params = self.ocsort_params
        if bytetrack or ocsort:
            name = "bytetrack_params" if bytetrack else "ocsort_params"
            plain = "ByteTrack" if bytetrack else "OC-SORT"
            if core_params.with_appearance and not appearance:
                raise ValueError(
                    f"with_appearance=True {name} require "
                    f"tracker={'botsort' if bytetrack else 'deepocsort'!r}")
            if appearance and not core_params.with_appearance:
                raise ValueError(
                    f"tracker={self.tracker_kind!r} requires "
                    f"{name}.with_appearance=True (else it is plain "
                    f"{plain})")
            with_reid = appearance
        self.gmc_method = gmc_ops.gmc_method(gmc)
        for name, quant in (("reid_quant", reid_quant),
                            ("yolo_quant", yolo_quant)):
            if quant not in (None, "", "none", "int8"):
                raise ValueError(f"{name} must be None or 'int8' "
                                 f"(got {quant!r})")
        for name, dt in (("detect_dtype", detect_dtype),
                         ("reid_dtype", reid_dtype)):
            if dt not in (None, "bf16", "f32"):
                raise ValueError(f"{name} must be None, 'bf16' or 'f32' "
                                 f"(got {dt!r})")
        if detect_dtype == "f32" and yolo_quant == "int8":
            raise ValueError("detect_dtype='f32' and yolo_quant='int8' "
                             "conflict")
        if reid_dtype == "f32" and reid_quant == "int8":
            raise ValueError("reid_dtype='f32' and reid_quant='int8' "
                             "conflict")
        self.reid_quant = reid_quant if reid_quant == "int8" else None
        self.yolo_quant = yolo_quant if yolo_quant == "int8" else None
        self.scan_bucket = int(scan_bucket or 0)
        if self.scan_bucket < 0:
            raise ValueError(f"scan_bucket must be >= 0 (got {scan_bucket})")
        self.device = resolve_device(device)
        default_dt = torch.bfloat16 if self.device.type == "cuda" \
            else torch.float32
        # int8 stages quantize from the f32 weights and take f32 inputs
        self.detect_dtype = torch.float32 if self.yolo_quant \
            else _DTYPES.get(detect_dtype, default_dt)
        self.reid_dtype = torch.float32 if self.reid_quant \
            else _DTYPES.get(reid_dtype, default_dt)
        self.synthetic_load = int(synthetic_load)
        self.input_shape = tuple(input_shape)
        self.letterbox_auto = bool(letterbox_auto)
        self.conf_threshold = float(conf_threshold)
        self.nms_threshold = float(nms_threshold)
        self.min_detection_confidence = float(min_detection_confidence)
        self.chunk_size = int(chunk_size)
        self.with_reid = with_reid
        self.yolo = resolve_yolo_params(variant, weights_path=yolo_weights,
                                        device=self.device,
                                        dtype=self.detect_dtype)
        self.reid = resolve_reid_params(weights_path=reid_weights,
                                        device=self.device,
                                        dtype=self.reid_dtype)
        if self.reid_quant:
            from ..models.quant import QuantReIDNet, quantize_reid_params
            self.reid = QuantReIDNet(
                quantize_reid_params(self.reid),
                feature_dim=config.REID_FEATURE_DIM).to(self.device)
        if self.yolo_quant:
            from ..models.quant_yolo import quantize_yolo_synthetic
            self.yolo, _ = quantize_yolo_synthetic(
                self.yolo, variant, self.yolo.num_classes, self.input_shape,
                letterbox_auto=self.letterbox_auto)
        self.tracker_params = tracker_params or TrackerParams(
            max_cosine_distance=config.DEEPSORT_MAX_DIST,
            nn_budget=config.DEEPSORT_NN_BUDGET,
            max_iou_distance=config.DEEPSORT_MAX_IOU_DISTANCE,
            max_age=config.DEEPSORT_MAX_AGE,
            n_init=config.DEEPSORT_N_INIT,
            max_tracks=config.MAX_TRACKS,
            max_detections=config.MAX_DETECTIONS,
            feature_dim=config.REID_FEATURE_DIM,
            nsa=bool(nsa),
        )
        #: the parameters of the core that runs (what a checkpoint of
        #: ``state`` is loaded with)
        self.core_params = core_params if bytetrack or ocsort \
            else self.tracker_params
        # crops come from the detection slots: more crop capacity than
        # detection slots is unreachable
        self.max_reid_crops = min(int(max_reid_crops),
                                  self.core_params.max_detections)
        self._track_class_ids = torch.tensor(
            config.CLASS_IDS_TO_TRACK, dtype=torch.int32, device=self.device)
        # the boxes a core's own gate lets in must get past the NMS floor
        self._nms_score_floor = config.YOLO_NMS_SCORE_THRESHOLD
        if bytetrack:
            self._nms_score_floor = min(self._nms_score_floor,
                                        core_params.low_thresh)
        elif ocsort:
            self._nms_score_floor = min(self._nms_score_floor,
                                        core_params.det_thresh)
        self.stage_timer: CudaStageTimer | None = None
        self._stages = {}
        self.reset()

    def _init_tracker_state(self):
        if self.tracker_kind in ("bytetrack", "botsort"):
            return bt_core.init_state(self.bytetrack_params, self.device)
        if self.tracker_kind in ("ocsort", "deepocsort"):
            return oc_core.init_state(self.ocsort_params, self.device)
        return core_state.init_state(self.tracker_params, self.device)

    # --- the chunk step's stages ---------------------------------------------

    def _make_stages(self, frame_hw: Tuple[int, int]):
        """The two halves of a chunk step for frames of ``frame_hw``, shared
        with ``parallel.MultiStreamPipeline``:

        ``detect(frames)``: a batch of ``(B, H, W, 3)`` uint8 frames on the
        device -> ``(TrackerInputs, det_outs)``: letterbox kernel, YOLOv8,
        decode+NMS, compaction into the detection slots, the synthetic load
        and the load-bucketed crop gather + ReID, all batched over B (one
        ReID bucket for the whole batch).

        ``track(state, inputs, valid)``: one stream's frames through the
        tracker core, frame by frame, with the capacity-bucketed scan;
        ``valid[i]`` False leaves the state as it is at frame i (its output
        lane repeats the unchanged state's outputs). Returns ``(state, outs)``,
        ``outs`` five tensors shaped ``(len(valid), T, ...)``."""
        spec = letterbox_spec(frame_hw, self.input_shape,
                              auto=self.letterbox_auto)
        kind = self.tracker_kind
        bytetrack = kind in ("bytetrack", "botsort")
        ocsort = kind in ("ocsort", "deepocsort")
        appearance = kind in ("botsort", "deepocsort")
        n_det = self.core_params.max_detections
        feature_dim = self.core_params.feature_dim
        n_crops = self.max_reid_crops
        dev = self.device
        n_syn = min(self.synthetic_load, n_det)
        if n_syn:
            # static 8x8 grid of boxes spanning the frame (worst-case mode)
            fh, fw = frame_hw
            gi = np.arange(n_det)
            gx = (gi % 8) * (fw / 8.0)
            gy = ((gi // 8) % 8) * (fh / 8.0)
            syn_boxes = torch.from_numpy(np.stack(
                [gx + 2, gy + 2, gx + fw / 8.0 - 2, gy + fh / 8.0 - 2],
                axis=-1).astype(np.float32)).to(dev)
        buckets = [0] + [b for b in (4, 8, 12, 16, 24) if b < n_crops] \
            + [n_crops]
        mark = self._mark

        def compact_dets(num, boxes, scores, labels):
            """Per frame: compact tracker-eligible dets into padded slots."""
            k = boxes.shape[0]
            present = torch.arange(boxes.shape[1], device=dev)[None] \
                < num[:, None]
            det_valid = present & (scores >= self.conf_threshold)
            trackable = torch.any(
                labels[..., None] == self._track_class_ids, dim=-1)
            if bytetrack:
                # every box above the low-score floor (strictly: at or below
                # it no BYTE stage sees a box), whatever conf_threshold
                # says, which only gates the detection output lists
                elig = present & trackable & \
                    (scores > self.bytetrack_params.low_thresh)
            elif ocsort:
                # the step applies the same strict gate itself; filtering
                # here frees detection slots
                elig = present & trackable & \
                    (scores > self.ocsort_params.det_thresh)
            else:
                elig = det_valid & trackable & \
                    (scores >= self.min_detection_confidence)
            rank = torch.cumsum(elig, dim=1) - 1
            slot = torch.where(elig & (rank < n_det), rank,
                               torch.full_like(rank, n_det))
            fidx = torch.arange(k, device=dev)[:, None]

            def compact(vals):
                arr = torch.zeros((k, n_det + 1) + tuple(vals.shape[2:]),
                                  dtype=vals.dtype, device=dev)
                arr[fidx, slot] = vals
                return arr[:, :n_det]

            return (compact(boxes), compact(scores),
                    compact(labels.to(torch.int32)), compact(elig),
                    det_valid)

        def embed(frames, d_xyxy, d_valid):
            """Load-bucketed crop gather + ReID: embed only as many crop
            slots as the busiest frame of the batch needs (the bucket choice
            reads one value back per batch)."""
            k = frames.shape[0]
            d_feats = torch.zeros((k, n_det, feature_dim),
                                  dtype=torch.float32, device=dev)
            d_hasfeat = torch.zeros((k, n_det), dtype=torch.bool,
                                    device=dev)
            if not self.with_reid:
                return d_feats, d_hasfeat
            n_needed = EMBED_SYNCS.tolist(
                torch.amax(torch.sum(d_valid[:, :n_crops], 1)))
            b = buckets[sum(int(n_needed > bk) for bk in buckets[:-1])]
            if b == 0:
                return d_feats, d_hasfeat
            crops, crop_valid = extract_reid_crops(
                frames, d_xyxy[:, :b], out_hw=config.REID_INPUT_SHAPE,
                compute_dtype=self.reid_dtype)
            with precision(self.reid_dtype):
                feats = self.reid(crops.reshape(k * b, *crops.shape[2:]))
            d_feats[:, :b] = feats.reshape(k, b, -1).float()
            d_hasfeat[:, :b] = crop_valid & d_valid[:, :b]
            return d_feats, d_hasfeat

        def detect(frames):
            x = letterbox(frames, spec, self.detect_dtype)
            mark("letterbox")
            with precision(self.detect_dtype):
                levels = self.yolo(x)
            mark("yolo")
            num, nboxes, scores, labels = fused_decode_nms(
                levels,
                score_threshold=self._nms_score_floor,
                iou_threshold=self.nms_threshold,
                top_k=config.YOLO_NMS_TOPK,
                max_det=config.YOLO_MAX_DETECTIONS)
            boxes_f = scale_boxes_back(nboxes, spec)
            d_xyxy, d_conf, d_cls, d_valid, det_valid = compact_dets(
                num, boxes_f, scores, labels)
            if n_syn:
                # fill empty slots (real dets are compacted to the front)
                fill = (torch.arange(n_det, device=dev) < n_syn)[None] \
                    & ~d_valid
                d_xyxy = torch.where(fill[..., None], syn_boxes[None], d_xyxy)
                d_conf = torch.where(fill, torch.full_like(d_conf, 0.5),
                                     d_conf)
                d_cls = torch.where(fill, torch.zeros_like(d_cls), d_cls)
                d_valid = d_valid | fill
            mark("nms")
            d_feats, d_hasfeat = embed(frames, d_xyxy, d_valid)
            mark("crops_reid")
            tlwh = torch.cat([d_xyxy[..., :2],
                              d_xyxy[..., 2:] - d_xyxy[..., :2]], dim=-1)
            inputs = TrackerInputs(xyxy=d_xyxy, tlwh=tlwh, conf=d_conf,
                                   cls=d_cls, valid=d_valid, feats=d_feats,
                                   hasfeat=d_hasfeat)
            return inputs, (num, boxes_f, scores, labels, det_valid)

        def frame_step(st, inp, i, pp):
            """One frame through the core that runs."""
            common = dict(score=inp.conf[i], class_id=inp.cls[i],
                          valid=inp.valid[i])
            if appearance:
                common.update(feature=inp.feats[i], has_feature=inp.hasfeat[i])
            f_gmc = None if inp.gmc_a is None else (inp.gmc_a[i],
                                                    inp.gmc_t[i])
            if bytetrack:
                return bt_core.step(st, bt_core.ByteDetections(
                    tlwh=inp.tlwh[i], **common), pp, gmc=f_gmc)
            if ocsort:
                return oc_core.step(st, oc_core.OCSortDetections(
                    xyxy=inp.xyxy[i], **common), pp, gmc=f_gmc)
            dets = Detections(tlwh=inp.tlwh[i], conf=inp.conf[i],
                              class_id=inp.cls[i], feature=inp.feats[i],
                              has_feature=inp.hasfeat[i], valid=inp.valid[i])
            st = core_tracker.predict(st, pp)
            if f_gmc is not None:
                # BoT-SORT ordering: predict, warp by the camera affine,
                # then associate
                mean, cov = gmc_ops.warp_xyah_bank(
                    st.mean, st.cov, f_gmc[0], f_gmc[1], st.active)
                st = st.replace(mean=mean, cov=cov)
            return core_tracker.update(st, dets, pp)

        def outputs(st, pp):
            return (bt_core.get_outputs(st) if bytetrack
                    else oc_core.get_outputs(st, pp) if ocsort
                    else core_tracker.get_outputs(st))

        def eager_scan(st, inp, valid, pp):
            """The frames at the capacity of ``pp``, ``valid`` host bools."""
            outs = []
            for i, v in enumerate(valid):
                if v:  # an invalid frame leaves the state as it is
                    st = frame_step(st, inp, i, pp)
                outs.append(outputs(st, pp))
            return st, tuple(torch.stack(x) for x in zip(*outs))

        def masked_scan(st, inp, valid, pp):
            """:func:`eager_scan` with ``valid`` a ``(K,)`` bool tensor:
            every frame steps, and ``torch.where`` keeps the state as it was
            where a frame is invalid (exact), so the launches do not depend
            on the validity pattern."""
            outs = []
            for i in range(valid.shape[0]):
                nxt = frame_step(st, inp, i, pp)
                st = st.replace(**{
                    f.name: torch.where(valid[i], getattr(nxt, f.name),
                                        getattr(st, f.name))
                    for f in dataclasses.fields(st)})
                outs.append(outputs(st, pp))
            return st, tuple(torch.stack(x) for x in zip(*outs))

        scan_engines, valid_masks = {}, {}

        def captured_scan(st, inp, valid, pp):
            """:func:`masked_scan` of the DeepSORT core, which reads nothing
            back, as one CUDA-graph replay: a capture for each capacity and
            chunk length (``runtime/engine.py``; on the CPU a direct call).
            The state, the inputs and the validity mask enter through the
            graph's static buffers and leave as copies of its outputs."""
            mask = valid_masks.get(tuple(valid))
            if mask is None:  # built on the device: no host copy
                mask = torch.zeros(len(valid), dtype=torch.bool, device=dev)
                for i in np.flatnonzero(valid):
                    mask[i].fill_(True)
                valid_masks[tuple(valid)] = mask
            fields = [f.name for f in dataclasses.fields(st)]
            names = [f.name for f in dataclasses.fields(inp)
                     if getattr(inp, f.name) is not None]
            flat = [getattr(st, f) for f in fields] \
                + [getattr(inp, f) for f in names] + [mask]
            key = (pp, tuple(names))
            eng = scan_engines.get(key)
            if eng is None:
                def fn(*xs):
                    s, outs = masked_scan(
                        core_state.TrackerState(**dict(zip(fields, xs))),
                        TrackerInputs(**dict(zip(names, xs[len(fields):]))),
                        xs[-1], pp)
                    return tuple(getattr(s, f) for f in fields), outs

                eng = scan_engines[key] = CUDAGraphEngine(
                    fn, flat, name=f"deepsort scan T={pp.max_tracks}",
                    warmup_iters=1, device=dev)
            new, outs = eng(*flat)
            return core_state.TrackerState(**dict(zip(fields, new))), outs

        scan_fn = (captured_scan if self._capture_scans
                   and not (bytetrack or ocsort) else eager_scan)

        def track(state, inp, valid):
            def scan(st, pp):
                return scan_fn(st, inp, valid, pp)

            if not any(valid):
                return scan(state, self.core_params)
            return _bucketed_time_scan(state, scan, self.core_params,
                                       self.scan_bucket, self.scan_stats)

        return detect, track

    def _get_stages(self, frame_hw: Tuple[int, int]):
        key = tuple(frame_hw)
        if key not in self._stages:
            self._stages[key] = self._make_stages(key)
        return self._stages[key]

    def _mark(self, stage: str):
        if self.stage_timer is not None:
            self.stage_timer.mark(stage)

    # --- host API -----------------------------------------------------------

    def reset(self):
        """Fresh tracker state (ids restart at 1), scan counts, and no
        frame carried for the camera-motion estimate."""
        self.state = self._init_tracker_state()
        self.scan_stats = dict(small=0, skipped=0, rerun=0)
        self._gmc_prev_frame = None

    def _dispatch_chunk(self, frames_np: np.ndarray,
                        n_valid: int | None = None):
        """Upload one (K, H, W, 3) uint8 chunk and run the chunk step: its
        first ``n_valid`` frames advance the tracker, the rest are padding.
        Returns ``(det_outs, track_outs)`` on the device."""
        k = frames_np.shape[0]
        n_valid = k if n_valid is None else n_valid
        detect, track = self._get_stages(frames_np.shape[1:3])
        frames = torch.from_numpy(np.ascontiguousarray(frames_np)).to(
            self.device)
        if self.stage_timer is not None:
            self.stage_timer.start()
        with torch.no_grad():
            g_a = g_t = None
            if self.gmc_method is not None:
                # camera motion per frame, from the frame before the chunk;
                # the first chunk of a stream uses its own first frame
                # (identity motion for frame 0)
                prev = self._gmc_prev_frame
                g_a, g_t = gmc_ops.estimate_chunk(
                    frames[0] if prev is None else prev, frames,
                    gmc_ops.gmc_spec(frames_np.shape[1:3]), self.gmc_method)
                self._gmc_prev_frame = frames[n_valid - 1].clone()
                self._mark("gmc")
            inputs, det_outs = detect(frames)
            inputs = dataclasses.replace(inputs, gmc_a=g_a, gmc_t=g_t)
            self.state, track_outs = track(self.state, inputs,
                                           [i < n_valid for i in range(k)])
            self._mark("tracker")
        if self.stage_timer is not None:
            self.stage_timer.finish()
        return det_outs, track_outs

    @staticmethod
    def _emit(det_outs, track_outs, base_index: int, count: int):
        num, boxes, scores, labels, det_valid = (
            t.cpu().numpy() for t in det_outs)
        tlbr, ids, cls, conf, mask = (t.cpu().numpy() for t in track_outs)
        results = []
        for i in range(count):
            v = det_valid[i]
            results.append(FrameResult(
                frame_index=base_index + i,
                det_boxes=boxes[i][v],
                det_scores=scores[i][v],
                det_labels=labels[i][v].astype(np.int32),
                tracks=_format_tracks(tlbr[i], ids[i], cls[i], conf[i],
                                      mask[i]),
            ))
        return results

    def process_frames(self, frames: Iterator[np.ndarray],
                       chunk_size: int | None = None
                       ) -> Iterator[FrameResult]:
        """Stream frames through the tracker; yields a FrameResult per frame.
        Frames are grouped into chunks of K and run by
        :meth:`process_chunks`."""
        k = chunk_size or self.chunk_size

        def chunks():
            buf = []
            for frame in frames:
                buf.append(frame)
                if len(buf) == k:
                    yield np.stack(buf)
                    buf = []
            if buf:
                yield np.stack(buf)

        yield from self.process_chunks(chunks(), k)

    def process_chunks(self, chunks: Iterator[np.ndarray],
                       chunk_size: int | None = None
                       ) -> Iterator[FrameResult]:
        """Stream chunks through the tracker: each item is an ``(n, H, W,
        3)`` uint8 array with ``n <= K``. Yields a FrameResult per frame, one
        chunk behind the dispatch. A partial chunk is padded to K with its
        last frame; padding frames leave the tracker state untouched and
        their results are dropped."""
        k = chunk_size or self.chunk_size
        pending = None
        base = 0
        for chunk in chunks:
            n = chunk.shape[0]
            if n == 0:
                continue
            if n > k:
                raise ValueError(f"chunk of {n} frames exceeds the "
                                 f"pipeline chunk_size {k}")
            if n < k:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], k - n, axis=0)], axis=0)
            outs = self._dispatch_chunk(chunk, n_valid=n)
            prev, pending = pending, (*outs, base, n)
            base += n
            if prev is not None:
                yield from self._emit(*prev)
        if pending is not None:
            yield from self._emit(*pending)

    def process_frame(self, frame_bgr: np.ndarray) -> FrameResult:
        """Single-frame convenience API (a chunk of 1)."""
        det_outs, track_outs = self._dispatch_chunk(frame_bgr[None])
        return self._emit(det_outs, track_outs, 0, 1)[0]

    def warm_up(self, frame_hw: Tuple[int, int],
                chunk_size: int | None = None, iters: int = 2) -> float:
        """Run the chunk step on blank frames (builds the kernels, warms the
        allocator and cuDNN, captures the DeepSORT scan: the last pass at
        the full track capacity, so that a bucketed scan finds both of its
        captures), then reset; returns seconds."""
        t0 = time.perf_counter()
        k = chunk_size or self.chunk_size
        dummy = np.zeros((k, *frame_hw, 3), np.uint8)
        bucket = self.scan_bucket
        try:
            for i in range(iters):
                self.scan_bucket = bucket if i < iters - 1 else 0
                self._dispatch_chunk(dummy)
        finally:
            self.scan_bucket = bucket
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.reset()
        return time.perf_counter() - t0
