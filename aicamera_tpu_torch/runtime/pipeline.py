"""The fused chunk pipeline: letterbox -> YOLOv8 -> decode+NMS (or RT-DETR-L
-> its NMS-free post-process) -> crops -> ReID -> tracker, K frames per
dispatch.

The port of ``aicamera_tpu/runtime/pipeline.py`` with its three tracker
cores (DeepSORT and its StrongSORT preset, ByteTrack and BoT-SORT, OC-SORT
and Deep OC-SORT), camera-motion compensation and the capacity-bucketed
tracker scan. All batchable work (camera-motion estimate, letterbox kernel,
detector forward, decode+NMS, crop gather, ReID embedding) runs batched
over the chunk on the device; the sequential tracker then runs frame by frame
over the chunk, its state staying on the same device. The whole chunk step
is one function of tensors (:meth:`TrackingPipeline._make_step`) captured
into one CUDA graph, as the JAX package jits its step: its ReID bucket and
its bucketed scan branch on the device (``runtime/branches.py``), so a
chunk is one upload, one replay and one packed readback, and the host
reads nothing else. The same step runs a stack of streams' states at once
(``parallel.MultiStreamPipeline``: the JAX package's ``jax.vmap`` over
streams), a dispatch of all streams one replay. The eager step, whose host
reads the branches, stays beside it (``_capture_step``). Outputs
follow the JAX package's contracts: per frame, the detections in frame
coordinates and the emitted tracks as ``(x1, y1, x2, y2, id, class_name,
conf)`` tuples.

On a CUDA device the letterbox, the assignment solves and OC-SORT's ORU
replay always run the hand-written kernels (``ops/letterbox.py``,
``ops/assignment.py``, ``ops/oru.py``); on the CPU they run the kernels'
plain versions.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
from typing import Callable, Iterator, NamedTuple, Tuple

import numpy as np
import torch

from .. import config
from ..core import bytetrack as bt_core
from ..core import ocsort as oc_core
from ..core import state as core_state
from ..core import tracker as core_tracker
from ..core.state import Detections, TrackerParams
from ..device import resolve_device
from ..models import rtdetr as rtdetr_model
from ..ops import gmc as gmc_ops
from ..ops.crops import extract_reid_crops
from ..ops.letterbox import letterbox
from ..ops.nms import fused_decode_nms
from ..ops.preprocess import letterbox_spec, scale_boxes_back
from ..syncs import SyncCounter
from . import branches
from .engine import CUDAGraphEngine
from .params import (resolve_reid_params, resolve_rtdetr_params,
                     resolve_yolo_params)
from .profiler import CudaStageTimer

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}

# the reads of the eager step and of a step on the CPU (the captured step
# on the card decides on the device and reads neither)
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

    def by_frame(self, s: int, k: int) -> "TrackerInputs":
        """A batch of ``s`` streams' ``k`` frames each, stream-major
        (``(s * k, ...)``), as ``(k, s, ...)``: frame i of every stream at
        index i, the layout the stacked tracker step takes (copies)."""
        return TrackerInputs(**{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name).reshape(
                s, k, *getattr(self, f.name).shape[1:]).transpose(
                    0, 1).contiguous()
            for f in dataclasses.fields(self)})


_MASK_BITS = 62  # bits a fill word carries (an int64 below its sign bit)


def valid_mask(valid: np.ndarray, device) -> torch.Tensor:
    """Host bools ``valid`` (any shape) as a bool tensor on ``device``,
    without a copy from the host (which waits for the stream and which a
    CUDA graph cannot capture): the bits go into int64 words by one fill
    each (the value travels as a kernel argument) and are unpacked on the
    device. A few launches, whatever the pattern, and nothing cached by
    it."""
    flat = np.asarray(valid, bool).reshape(-1)
    n = flat.size
    words = torch.empty((max(1, -(-n // _MASK_BITS)), 1), dtype=torch.int64,
                        device=device)
    for w in range(words.shape[0]):
        chunk = flat[w * _MASK_BITS:(w + 1) * _MASK_BITS]
        words[w].fill_(sum(1 << i for i, b in enumerate(chunk) if b))
    shifts = torch.arange(_MASK_BITS, device=device)
    bits = torch.bitwise_and(torch.bitwise_right_shift(words, shifts), 1)
    return bits.reshape(-1)[:n].bool().reshape(np.shape(valid))


def select_state(keep: torch.Tensor, new, old):
    """``new`` where ``keep``, ``old`` elsewhere, field by field (exact):
    ``keep`` is a 0-d bool for one stream's state, or one bool a stream
    (``(S,)``) for a stack."""
    def pick(a, b):
        return torch.where(keep.reshape(keep.shape
                                        + (1,) * (a.ndim - keep.ndim)), a, b)
    return dataclasses.replace(old, **{
        f.name: pick(getattr(new, f.name), getattr(old, f.name))
        for f in dataclasses.fields(old) if getattr(old, f.name) is not None})


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


def _format_tracks(tlbr, ids, cls, conf, mask):
    out = []
    for b, i, c, s in zip(tlbr[mask], ids[mask], cls[mask], conf[mask]):
        name = config.CLASSES[int(c)] if 0 <= int(c) < len(config.CLASSES) \
            else "Unknown"
        out.append((int(round(float(b[0]))), int(round(float(b[1]))),
                    int(round(float(b[2]))), int(round(float(b[3]))),
                    int(i), name, float(s)))
    return out


def bucket_fits(active: torch.Tensor, t_small: int) -> torch.Tensor:
    """Whether a chunk's scan may run at ``t_small`` slots (0-d bool, on
    the device): no active slot at or above ``t_small``, and a quarter of
    the small table (at least 4 slots) free in the busiest stream, since a
    load at the boundary would overflow and pay the rerun every chunk
    (``aicamera_tpu/runtime/pipeline.py:106-108``; one decision for a stack
    ``(S, T)``, ``aicamera_tpu/parallel/multistream.py:620-623``)."""
    headroom = max(4, t_small // 4)
    return ~torch.any(active[..., t_small:]) \
        & (torch.amax(torch.sum(active, -1)) <= t_small - headroom)


def bucket_rerun(cand_dropped: torch.Tensor,
                 dropped: torch.Tensor) -> torch.Tensor:
    """Whether the chunk reruns at full capacity (0-d bool): the small
    pass's ``dropped`` (or the skip's ``dropped + 1``) grew, summed over a
    stack's streams (``aicamera_tpu/runtime/pipeline.py:113``,
    ``aicamera_tpu/parallel/multistream.py:626``)."""
    return torch.sum(cand_dropped) > torch.sum(dropped)


def reid_bucket_index(d_valid: torch.Tensor, buckets, n_crops: int):
    """The ReID bucket the busiest frame of a batch needs, as an index into
    ``buckets`` (0-d int32, on the device): ``aicamera_tpu/runtime/
    pipeline.py:607, 628``."""
    n_needed = torch.amax(torch.sum(d_valid[:, :n_crops], 1))
    idx = torch.zeros((), dtype=torch.int32, device=d_valid.device)
    for bk in buckets[:-1]:
        idx = idx + (n_needed > bk).to(torch.int32)
    return idx


def _bucketed_time_scan(state, scan, params, t_small: int, stats: dict):
    """The per-frame tracker scan of one chunk at a reduced track capacity
    when all activity fits, with exact fallbacks.

    Generic over the three cores: any state whose non-scalar fields lead with
    the track axis, that places new tracks at the lowest free slots, counts
    overflow in ``dropped`` and emits zeros on masked output lanes
    (``core/state.py::slice_any_tracks``). ``scan(state, params)`` runs the
    chunk's frames at the capacity ``params.max_tracks`` and returns ``(state,
    outs)``, ``outs`` five tensors shaped ``(K, T, ...)``. A stack of
    streams' states (``(S, T, ...)``, outs ``(K, S, T, ...)``) takes one
    decision for all, as the JAX ``MultiStreamPipeline`` does
    (``aicamera_tpu/parallel/multistream.py:580-626``): it fits when no
    stream has an active slot at or above ``t_small`` and the busiest one has
    the headroom, and the whole stack reruns at full capacity if the summed
    ``dropped`` grew; still two reads a chunk, not two a stream.

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
    act = state.active
    if BUCKET_SYNCS.flag(bucket_fits(act, t_small)):
        s_small, outs = scan(
            core_state.slice_any_tracks(state, t_small),
            dataclasses.replace(params, max_tracks=t_small))
        if not BUCKET_SYNCS.flag(bucket_rerun(s_small.dropped,
                                              state.dropped)):
            stats["small"] += 1
            ax = act.ndim   # the outputs' track axis, after K and streams
            padded = tuple(torch.cat([a, a.new_zeros(
                (*a.shape[:ax], t_full - t_small, *a.shape[ax + 1:]))],
                dim=ax) for a in outs)
            return core_state.splice_any_tracks(state, s_small), padded
        stats["rerun"] += 1
    else:
        stats["skipped"] += 1
    return scan(state, params)


class _Parts(NamedTuple):
    """A frame size's chunk-step pieces (``TrackingPipeline._stage_parts``)."""
    spec: object
    buckets: list
    detections: Callable
    bucket_index: Callable
    embed_into: Callable
    empty_feats: Callable
    tracker_inputs: Callable
    frame_step: Callable
    outputs: Callable
    masked_scan: Callable


class _Layout:
    """Where a step's outputs sit in its one packed int32 tensor, learnt
    from the first :meth:`pack` (each later one must match): floats and
    32-bit integers travel by their bits, 64-bit integers as two words,
    bools as one word each."""

    def __init__(self):
        self.meta = None   # [(shape, dtype, offset, words)]
        self.words = 0

    @staticmethod
    def _words(t: torch.Tensor) -> torch.Tensor:
        if t.dtype == torch.bool:
            return t.reshape(-1).to(torch.int32)
        return t.contiguous().reshape(-1).view(torch.int32)

    def pack(self, tensors) -> torch.Tensor:
        meta = [(tuple(t.shape), t.dtype) for t in tensors]
        if self.meta is None:
            off, self.meta = 0, []
            for shape, dt in meta:
                n = int(np.prod(shape)) * (
                    1 if dt == torch.bool else dt.itemsize // 4)
                self.meta.append((shape, dt, off, n))
                off += n
            self.words = off
        elif meta != [m[:2] for m in self.meta]:
            raise ValueError(f"packed outputs changed: {meta}")
        return torch.cat([self._words(t) for t in tensors])

    def unpack_numpy(self, words: np.ndarray) -> list:
        out = []
        for shape, dt, off, n in self.meta:
            w = words[off:off + n]
            out.append(w.astype(bool).reshape(shape) if dt == torch.bool
                       else w.view(torch.empty(0, dtype=dt).numpy().dtype)
                       .reshape(shape))
        return out

    def unpack_torch(self, words: torch.Tensor) -> list:
        out = []
        for shape, dt, off, n in self.meta:
            w = words[off:off + n]
            out.append(w.bool().reshape(shape) if dt == torch.bool
                       else w.view(dt).reshape(shape))
        return out


class _Step(NamedTuple):
    """A captured chunk step (``TrackingPipeline._make_step``)."""
    engine: CUDAGraphEngine
    layout: _Layout
    fields: list          # the state's fields, the engine's first inputs
    frame_bytes: int
    upload_bytes: int
    gmc: bool             # the frame before is carried
    bucketed: bool
    buckets: tuple        # the ReID buckets, by index
    batch: int            # frames a dispatch (K, or S * K)
    stamps: list | None   # a stamped step's boundaries, in slot order


class _Stamps:
    """One call's stage stamps (a timed captured step): an int64 buffer of
    a slot a boundary, written by the device's clock (``branches.stamp``;
    on the CPU the host's), and the boundaries' names in slot order."""

    SLOTS = 10

    def __init__(self, device):
        self.buf = torch.empty(self.SLOTS, dtype=torch.int64, device=device)
        self.names = []

    def stamp(self, name: str):
        with branches.aside():
            branches.stamp(self.buf, len(self.names))
        self.names.append(name)


class _Readback:
    """A captured chunk's packed outputs on their way to the host: on the
    GPU a copy into a pinned buffer queued behind the replay, and an event
    after it. Reading (:meth:`arrays`) waits on that event only, and counts
    the chunk's decisions once (``TrackingPipeline._count_decisions``).
    ``keep``: every output comes to the host and stays until
    :meth:`release` (``_emit`` uses them); otherwise only the decisions'
    words (a timed step's stamps and crop count among them) are copied, and
    their buffer is freed once they are counted. ``timer`` and
    ``dispatch``: the pipeline's timer at the dispatch and the dispatch's
    id, which the wait's and the formatting's spans carry."""

    def __init__(self, pipe, step: _Step, packed: torch.Tensor,
                 any_valid: bool, keep: bool = True):
        self._pipe, self._step = pipe, step
        self._any_valid, self._keep = any_valid, keep
        self.timer = pipe.stage_timer
        self.dispatch = pipe._dispatch if self.timer is not None else None
        self._arrays = None
        self._lock = threading.Lock()
        if not keep:
            _, _, off, n = step.layout.meta[-1]
            packed = packed[off:off + n]
        if packed.device.type == "cuda":
            self._host = pipe._pinned(packed.numel())
            self._host.copy_(packed, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = packed, None
        with pipe._pending_lock:
            pipe._pending.append(self)

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def settle(self):
        """Wait for the copy; count the decisions (once)."""
        with self._lock:
            if self._arrays is not None:
                return
            timer = self.timer
            if timer is not None:
                timer.open("readback.wait", self.dispatch)
            if self._event is not None:
                self._event.synchronize()
            if timer is not None:
                timer.close("readback.wait")
                timer.open("readback.count", self.dispatch)
            host = self._host.numpy()
            arrays = self._step.layout.unpack_numpy(host) if self._keep \
                else [host]
            self._pipe._count_decisions(self._step, arrays[-1],
                                        self._any_valid, timer,
                                        self.dispatch)
            if timer is not None:
                timer.close("readback.count")
            with self._pipe._pending_lock:
                if self in self._pipe._pending:
                    self._pipe._pending.remove(self)
            self._arrays = arrays
        if not self._keep:
            self.release()

    def arrays(self) -> list:
        """The detections (one stream) and the track outputs, as numpy
        arrays in the step's layout (views of the pinned buffer)."""
        self.settle()
        return self._arrays[:-1]

    def release(self):
        """Return the pinned buffer; the arrays are gone with it."""
        host, self._host = self._host, None
        if self._event is not None and host is not None:
            self._pipe._free_pinned.append(host)


class _EagerOutputs(NamedTuple):
    """The eager step's outputs, on the device."""
    det_outs: tuple
    track_outs: tuple
    timer = None        # the eager step's stages are timed by events
    dispatch = None

    def arrays(self) -> list:
        return [t.cpu().numpy() for t in (*self.det_outs, *self.track_outs)]

    def release(self):
        pass


_TRACKERS = ("deepsort", "bytetrack", "botsort", "ocsort", "deepocsort")
#: the detectors a pipeline runs
DETECTORS = ("yolov8", "rtdetr-l")


class TrackingPipeline:
    """End-to-end detector + tracker with chunked device steps."""

    #: The chunk step replays one capture (:meth:`_make_step`), its
    #: branches decided on the device; False runs the eager step
    #: (:meth:`_make_stages`: the host reads the ReID bucket and the scan's
    #: ways), which the captured step is checked and timed against.
    _capture_step = True
    #: In the eager step, the tracker scan of a chunk replays one capture;
    #: False runs it frame by frame, skipping invalid frames on the host.
    #: Read when stages are made.
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
                 detector: str = "yolov8",
                 num_queries: int | None = None,
                 device=None):
        """Arguments as in the JAX ``TrackingPipeline``, plus ``device``,
        ``detector`` and ``num_queries``.

        ``detector``: ``"yolov8"`` (default; ``variant`` names the scale)
        or ``"rtdetr-l"`` (RT-DETR-L, ``models/rtdetr.py``, its weights
        from ``yolo_weights``, default the committed
        ``config.RTDETR_SYNTHETIC_PATH``): the same letterbox kernel, then
        the backbone, encoder and decoder, then the NMS-free post-process
        (``models.rtdetr.postprocess``: each query's best class score and
        class, its top ``max_det`` queries at or above the score floor),
        boxes back to frame pixels and the same compaction, all inside the
        same captured step. ``conf_threshold`` and the score floor mean
        what they mean for YOLOv8; ``nms_threshold`` is unused. RT-DETR has
        no int8 twin (``yolo_quant`` raises). ``num_queries``: RT-DETR's
        decoder queries (default 300, the published model's).

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
        if detector not in DETECTORS:
            raise ValueError(f"detector must be one of {DETECTORS} (got "
                             f"{detector!r})")
        self.detector = detector
        if detector == "rtdetr-l" and yolo_quant not in (None, "", "none"):
            raise ValueError("yolo_quant='int8' has no RT-DETR path: the "
                             "int8 twin is YOLOv8's (models/quant_yolo.py)")
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
        #: the YOLOv8 detector, or None where RT-DETR runs (``rtdetr``)
        self.yolo = self.rtdetr = None
        if detector == "rtdetr-l":
            self.rtdetr = resolve_rtdetr_params(
                yolo_weights, device=self.device, dtype=self.detect_dtype,
                num_queries=num_queries)
        else:
            self.yolo = resolve_yolo_params(
                variant, weights_path=yolo_weights, device=self.device,
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
        self._parts = {}
        # (frame_hw, K, streams, bucket[, "stamped"]) -> _Step
        self._steps = {}
        self._scan_engines = []   # every stage's captured scans, ever made
        self._stepping = False    # inside a captured step: marks are stamps
        self._stamps = None       # the stamps of the step running, if timed
        self._dispatch = None     # the timed dispatch's id
        self._staging = {}        # pinned upload buffers by size
        self._free_pinned = []    # pinned readback buffers
        self._pending_lock = threading.Lock()
        self.reset()

    def _pinned(self, words: int) -> torch.Tensor:
        """A pinned int32 buffer of ``words`` for a readback."""
        for i, buf in enumerate(self._free_pinned):
            if buf.numel() == words:
                return self._free_pinned.pop(i)
        return torch.empty(words, dtype=torch.int32, pin_memory=True)

    def _init_tracker_state(self, n_streams: int | None = None):
        """A fresh state of the core that runs; ``n_streams``: a stack of
        that many."""
        if self.tracker_kind in ("bytetrack", "botsort"):
            return bt_core.init_state(self.bytetrack_params, self.device,
                                      n_streams)
        if self.tracker_kind in ("ocsort", "deepocsort"):
            return oc_core.init_state(self.ocsort_params, self.device,
                                      n_streams)
        return core_state.init_state(self.tracker_params, self.device,
                                     n_streams)

    # --- the chunk step's stages ---------------------------------------------

    def _stage_parts(self, frame_hw: Tuple[int, int]) -> "_Parts":
        """The pieces of a chunk step for frames of ``frame_hw``, shared by
        the eager stages (:meth:`_make_stages`) and the one-function step
        (:meth:`_make_step`); made once a frame size."""
        key = tuple(frame_hw)
        if key in self._parts:
            return self._parts[key]
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

        def detect_yolo(x):
            with precision(self.detect_dtype):
                levels = self.yolo(x)
            mark("yolo")
            return fused_decode_nms(
                levels,
                score_threshold=self._nms_score_floor,
                iou_threshold=self.nms_threshold,
                top_k=config.YOLO_NMS_TOPK,
                max_det=config.YOLO_MAX_DETECTIONS)

        def detect_rtdetr(x):
            model = self.rtdetr
            with precision(self.detect_dtype):
                maps = model.features(x)
                mark("backbone")
                feats, shapes = model.encode(maps)
                mark("encoder")
                boxes, logits = model.decode(feats, shapes)
                mark("decoder")
            return rtdetr_model.postprocess(
                boxes, logits, x.shape[-2:], self._nms_score_floor,
                config.YOLO_MAX_DETECTIONS)

        detect_model = detect_rtdetr if self.rtdetr is not None \
            else detect_yolo

        def detections(frames):
            """Letterbox kernel, the detector (YOLOv8 then decode+NMS, or
            RT-DETR then its NMS-free post-process), compaction and the
            synthetic load over a batch of frames: ``(d_xyxy, d_conf,
            d_cls, d_valid, det_outs)``."""
            x = letterbox(frames, spec, self.detect_dtype)
            mark("letterbox")
            num, nboxes, scores, labels = detect_model(x)
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
            mark("post" if self.rtdetr is not None else "nms")
            return (d_xyxy, d_conf, d_cls, d_valid,
                    (num, boxes_f, scores, labels, det_valid))

        def bucket_index(d_valid):
            return reid_bucket_index(d_valid, buckets, n_crops)

        def embed_into(frames, d_xyxy, d_valid, d_feats, d_hasfeat, b):
            """The crop gather and ReID of the first ``b`` slots of every
            frame, written into ``d_feats`` and ``d_hasfeat`` (all of them:
            zeros past ``b``)."""
            d_feats.zero_()
            d_hasfeat.zero_()
            if b == 0:
                return
            k = frames.shape[0]
            crops, crop_valid = extract_reid_crops(
                frames, d_xyxy[:, :b], out_hw=config.REID_INPUT_SHAPE,
                compute_dtype=self.reid_dtype)
            with precision(self.reid_dtype):
                feats = self.reid(crops.reshape(k * b, *crops.shape[2:]))
            d_feats[:, :b] = feats.reshape(k, b, -1).float()
            d_hasfeat[:, :b] = crop_valid & d_valid[:, :b]

        def empty_feats(k):
            return (torch.zeros((k, n_det, feature_dim), dtype=torch.float32,
                                device=dev),
                    torch.zeros((k, n_det), dtype=torch.bool, device=dev))

        def tracker_inputs(d_xyxy, d_conf, d_cls, d_valid, d_feats,
                           d_hasfeat):
            tlwh = torch.cat([d_xyxy[..., :2],
                              d_xyxy[..., 2:] - d_xyxy[..., :2]], dim=-1)
            return TrackerInputs(xyxy=d_xyxy, tlwh=tlwh, conf=d_conf,
                                 cls=d_cls, valid=d_valid, feats=d_feats,
                                 hasfeat=d_hasfeat)

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

        def masked_scan(st, inp, valid, pp):
            """The frames at the capacity of ``pp``, ``valid`` a ``(K,)``
            (``(K, S)``) bool tensor: every frame steps, and ``torch.where``
            keeps the state as it was where a frame is invalid (exact), so
            the launches do not depend on the validity pattern."""
            outs = []
            for i in range(valid.shape[0]):
                st = select_state(valid[i], frame_step(st, inp, i, pp), st)
                outs.append(outputs(st, pp))
            return st, tuple(torch.stack(x) for x in zip(*outs))

        parts = self._parts[key] = _Parts(
            spec=spec, buckets=buckets, detections=detections,
            bucket_index=bucket_index, embed_into=embed_into,
            empty_feats=empty_feats, tracker_inputs=tracker_inputs,
            frame_step=frame_step, outputs=outputs, masked_scan=masked_scan)
        return parts

    def _make_stages(self, frame_hw: Tuple[int, int]):
        """The two halves of the eager chunk step for frames of
        ``frame_hw`` (the step before it became one captured program; kept
        for the tests and for ``chip_smoke.py`` to hold the captured step
        against, and for the model-split mesh, whose collectives a capture
        cannot hold), shared with ``parallel.MultiStreamPipeline``:

        ``detect(frames)``: a batch of ``(B, H, W, 3)`` uint8 frames on the
        device -> ``(TrackerInputs, det_outs)``: letterbox kernel, YOLOv8,
        decode+NMS, compaction into the detection slots, the synthetic load
        and the load-bucketed crop gather + ReID, all batched over B (one
        ReID bucket for the whole batch, read back: ``EMBED_SYNCS``).

        ``track(state, inputs, valid)``: one stream's frames through the
        tracker core, frame by frame, with the capacity-bucketed scan
        decided on the host (``BUCKET_SYNCS``); ``valid[i]`` (host bools,
        ``(K,)``) False leaves the state as it is at frame i (its output
        lane repeats the unchanged state's outputs). Returns ``(state,
        outs)``, ``outs`` five tensors shaped ``(K, T, ...)``. Every core
        also takes a stack of S streams' states, inputs ``(K, S, N, ...)``
        (:meth:`TrackerInputs.by_frame`) and ``valid (K, S)``: every frame
        steps all streams at once (one assignment launch a stage for all of
        them), one bucket decision for the stack, one captured replay a
        chunk; ``outs`` ``(K, S, T, ...)``."""
        parts = self._stage_parts(frame_hw)
        kind = self.tracker_kind
        dev = self.device
        buckets = parts.buckets
        frame_step, outputs = parts.frame_step, parts.outputs
        masked_scan = parts.masked_scan

        def detect(frames):
            d_xyxy, d_conf, d_cls, d_valid, det_outs = parts.detections(
                frames)
            d_feats, d_hasfeat = parts.empty_feats(frames.shape[0])
            if self.with_reid:
                # embed only as many crop slots as the busiest frame of the
                # batch needs (the bucket choice reads one value back)
                b = buckets[EMBED_SYNCS.tolist(parts.bucket_index(d_valid))]
                self.reid_buckets[b] = self.reid_buckets.get(b, 0) + 1
                if b:
                    parts.embed_into(frames, d_xyxy, d_valid, d_feats,
                                     d_hasfeat, b)
            self._mark("crops_reid")
            return parts.tracker_inputs(d_xyxy, d_conf, d_cls, d_valid,
                                        d_feats, d_hasfeat), det_outs

        def eager_scan(st, inp, valid, pp):
            """The frames at the capacity of ``pp``, ``valid`` host bools
            (``(K,)``, or ``(K, S)`` for a stack): a frame no stream takes
            is skipped on the host, one that only some streams take steps
            the stack and keeps the others' states."""
            outs = []
            for i in range(len(valid)):
                v = valid[i]
                if v.all():
                    st = frame_step(st, inp, i, pp)
                elif v.any():
                    st = select_state(valid_mask(v, dev),
                                      frame_step(st, inp, i, pp), st)
                # else: an invalid frame leaves the state as it is
                outs.append(outputs(st, pp))
            return st, tuple(torch.stack(x) for x in zip(*outs))

        scan_engines = {}
        self._scan_engines.append(scan_engines)
        last_mask = {}   # the last pattern's mask: most chunks repeat it

        def captured_scan(st, inp, valid, pp):
            """:func:`masked_scan` of the core, which reads nothing back, as
            one CUDA-graph replay: a capture for each capacity, chunk
            length, stream count and set of inputs (``runtime/engine.py``;
            on the CPU a direct call). The state, the inputs and the
            validity mask (:func:`valid_mask`, built on the device when the
            pattern differs from the chunk before's) enter through the
            graph's static buffers and leave as copies of its outputs."""
            key = (valid.shape, valid.tobytes())
            if last_mask.get("key") != key:
                last_mask.update(key=key, mask=valid_mask(valid, dev))
            mask = last_mask["mask"]
            # the appearance bank of a motion-only core is None: no input
            fields = [f.name for f in dataclasses.fields(st)
                      if getattr(st, f.name) is not None]
            names = [f.name for f in dataclasses.fields(inp)
                     if getattr(inp, f.name) is not None]
            flat = [getattr(st, f) for f in fields] \
                + [getattr(inp, f) for f in names] + [mask]
            streams = st.active.ndim > 1
            key = (pp, tuple(names), streams)
            eng = scan_engines.get(key)
            if eng is None:
                template = st

                def fn(*xs):
                    s, outs = masked_scan(
                        dataclasses.replace(template,
                                            **dict(zip(fields, xs))),
                        TrackerInputs(**dict(zip(names, xs[len(fields):]))),
                        xs[-1], pp)
                    return tuple(getattr(s, f) for f in fields), outs

                eng = scan_engines[key] = CUDAGraphEngine(
                    fn, flat, name=f"{kind} scan T={pp.max_tracks}"
                    + (" over streams" if streams else ""),
                    warmup_iters=1, device=dev)
            new, outs = eng(*flat)
            return dataclasses.replace(st, **dict(zip(fields, new))), outs

        scan_fn = captured_scan if self._capture_scans else eager_scan

        def track(state, inp, valid):
            def scan(st, pp):
                return scan_fn(st, inp, valid, pp)

            if not valid.any():
                return scan(state, self.core_params)
            return _bucketed_time_scan(state, scan, self.core_params,
                                       self.scan_bucket, self._scan_stats)

        return detect, track

    def _make_step(self, frame_hw: Tuple[int, int], k: int,
                   n_streams: int | None = None,
                   stamped: bool = False) -> "_Step":
        """The chunk step as one function of tensors, as the JAX package
        jits it (``aicamera_tpu/runtime/pipeline.py:563-753``; over streams
        ``aicamera_tpu/parallel/multistream.py:654-656``), captured whole by
        a :class:`CUDAGraphEngine` (on the CPU, called directly).

        Inputs: the tracker state's fields (carried: the graph keeps them
        from one replay to the next), the frame before the chunk when GMC
        is on (carried), and one uint8 upload holding the chunk's frames
        (``(K, H, W, 3)``, or ``(S, K, H, W, 3)`` for ``n_streams`` streams),
        their validity (``(K,)`` or ``(S, K)``) and a byte that says the
        carried frame before is absent (a stream's first chunk). Inside, in
        the JAX order: GMC's estimate when on, letterbox, YOLOv8,
        ``fused_decode_nms``, ``scale_boxes_back``, the compaction, the
        synthetic load, the ReID bucket as a :func:`branches.switch` over
        its bodies (``lax.switch``, ``:628-630``), and the bucketed scan as
        two :func:`branches.cond` (``lax.cond``, ``:109``, ``:121``).
        Outputs: the new state, the new frame before, and one int32 tensor
        packing the detections (one stream only), the track outputs and
        the decisions taken (ReID bucket index, ``fits``, ``use_full``; -1
        where the step has no such branch), laid out by the step's
        :class:`_Layout`.

        ``stamped`` (a timed step, ``CudaStageTimer``): the stage
        boundaries (entry, ``gmc``, ``letterbox``, ``yolo``, ``nms``,
        ``crops_reid``, ``tracker``; RT-DETR's ``backbone``, ``encoder``,
        ``decoder`` and ``post`` in place of ``yolo`` and ``nms``) stamp the
        device's clock into a buffer (:meth:`_mark`), and the decisions'
        words go on with the chunk's real crop count (its valid slots below
        ``max_reid_crops``, summed on the device), its detections that reach
        the tracker (its valid slots, summed on the device) and the stamps'
        words. Those nodes are counted apart
        (``branches.aside``); the rest of the capture is the unstamped
        one."""
        parts = self._stage_parts(frame_hw)
        dev = self.device
        s = n_streams
        h, w = frame_hw
        b = k if s is None else s * k
        frame_bytes = b * h * w * 3
        valid_shape = (k,) if s is None else (s, k)
        n_valid = int(np.prod(valid_shape))
        pp = self.core_params
        t_full, t_small = pp.max_tracks, self.scan_bucket
        bucketed = bool(t_small and t_small < t_full)
        p_small = dataclasses.replace(pp, max_tracks=t_small) \
            if bucketed else None
        template = self._init_tracker_state(s)
        fields = [f.name for f in dataclasses.fields(template)
                  if getattr(template, f.name) is not None]
        gmc = self.gmc_method
        gspec = gmc_ops.gmc_spec(frame_hw) if gmc is not None else None
        # the track outputs' shapes: (K, [S,] T, ...)
        with torch.no_grad():
            out_meta = [((k,) + tuple(o.shape), o.dtype)
                        for o in parts.outputs(template, pp)]
        ax = template.active.ndim   # the outputs' track axis

        def last_valid(prev, fr, valid):
            """Each stream's last valid frame, or ``prev`` where none."""
            pos = torch.arange(valid.shape[-1], device=dev)
            idx = torch.amax(torch.where(valid, pos, torch.zeros_like(pos)),
                             dim=-1)
            has = torch.any(valid, dim=-1)
            if s is None:
                pick = fr.index_select(0, idx.reshape(1))[0]
            else:
                pick = fr[torch.arange(s, device=dev), idx]
                has = has.reshape(s, 1, 1, 1)
            return torch.where(has, pick, prev)

        def scan(st, inp, valid):
            """The bucketed scan as JAX's two conds: ``(state, outs,
            fits, use_full)``."""
            if not bucketed:
                st, outs = parts.masked_scan(st, inp, valid, pp)
                minus = torch.full((), -1, dtype=torch.int32, device=dev)
                return st, outs, minus, minus
            fits = bucket_fits(st.active, t_small)
            cand = [torch.empty_like(getattr(st, f)) for f in fields]
            cand_outs = [torch.empty(shape, dtype=dt, device=dev)
                         for shape, dt in out_meta]
            cand_dropped = torch.empty_like(st.dropped)

            def small_pass():
                s_small, outs = parts.masked_scan(
                    core_state.slice_any_tracks(st, t_small), inp, valid,
                    p_small)
                spliced = core_state.splice_any_tracks(st, s_small)
                for buf, f in zip(cand, fields):
                    buf.copy_(getattr(spliced, f))
                for buf, o in zip(cand_outs, outs):
                    buf.zero_()
                    buf.narrow(ax, 0, t_small).copy_(o)
                cand_dropped.copy_(s_small.dropped)

            def skip_small():
                # a high slot is active: force the full pass below
                cand_dropped.copy_(st.dropped + 1)

            taken = branches.cond(fits, small_pass, skip_small,
                                  counter=BUCKET_SYNCS, site="fits")
            # any dropped increment means the small table ran out of slots
            # mid-chunk (the full table would have placed those tracks)
            use_full = bucket_rerun(cand_dropped, st.dropped)
            new = [torch.empty_like(getattr(st, f)) for f in fields]
            new_outs = [torch.empty(shape, dtype=dt, device=dev)
                        for shape, dt in out_meta]

            def full_pass():
                full, outs = parts.masked_scan(st, inp, valid, pp)
                for buf, f in zip(new, fields):
                    buf.copy_(getattr(full, f))
                for buf, o in zip(new_outs, outs):
                    buf.copy_(o)

            def accept():
                for buf, c in zip(new + new_outs, cand + cand_outs):
                    buf.copy_(c)

            # the skip implies the full pass: the host that read ``fits``
            # needs no second read
            branches.cond(use_full, full_pass, accept,
                          counter=None if taken == 0 else BUCKET_SYNCS,
                          site="use_full")
            return (dataclasses.replace(st, **dict(zip(fields, new))),
                    tuple(new_outs), fits.to(torch.int32),
                    use_full.to(torch.int32))

        def step(*xs):
            marks = _Stamps(dev) if stamped else None
            self._stamps = marks
            try:
                return run_step(marks, *xs)
            finally:
                self._stamps = None

        def run_step(marks, *xs):
            self._mark("entry")
            st = dataclasses.replace(template,
                                     **dict(zip(fields, xs[:len(fields)])))
            upload = xs[-1]
            frames = upload[:frame_bytes].view(b, h, w, 3)
            valid = upload[frame_bytes:frame_bytes + n_valid].view(
                valid_shape).bool()
            carried = []
            g_a = g_t = None
            if gmc is not None:
                fr = frames if s is None else frames.view(s, k, h, w, 3)
                head = fr[0] if s is None else fr[:, 0]
                # a stream's first chunk: its own first frame
                prev = torch.where(upload[-1].bool(), head,
                                   xs[len(fields)])
                g_a, g_t = gmc_ops.estimate_chunk(prev, fr, gspec, gmc)
                carried.append(last_valid(prev, fr, valid))
                if s is not None:
                    g_a = g_a.reshape(b, *g_a.shape[2:])
                    g_t = g_t.reshape(b, *g_t.shape[2:])
                self._mark("gmc")
            d_xyxy, d_conf, d_cls, d_valid, det_outs = parts.detections(
                frames)
            d_feats, d_hasfeat = parts.empty_feats(b)
            reid_idx = torch.full((), -1, dtype=torch.int32, device=dev)
            if self.with_reid:
                reid_idx = parts.bucket_index(d_valid)
                branches.switch(reid_idx, [
                    functools.partial(parts.embed_into, frames, d_xyxy,
                                      d_valid, d_feats, d_hasfeat, bk)
                    for bk in parts.buckets],
                    counter=EMBED_SYNCS, site="reid")
            self._mark("crops_reid")
            inputs = dataclasses.replace(
                parts.tracker_inputs(d_xyxy, d_conf, d_cls, d_valid, d_feats,
                                     d_hasfeat), gmc_a=g_a, gmc_t=g_t)
            if s is None:
                new, outs, fits, use_full = scan(st, inputs, valid)
            else:
                new, outs, fits, use_full = scan(st, inputs.by_frame(s, k),
                                                 valid.T)
                outs = tuple(o.transpose(0, 1) for o in outs)
            self._mark("tracker")
            decisions = torch.stack([reid_idx, fits, use_full])
            if marks is not None:
                stamp_names[:] = marks.names
                with branches.aside():
                    crops = torch.sum(d_valid[:, :self.max_reid_crops],
                                      dtype=torch.int32)
                    dets = torch.sum(d_valid, dtype=torch.int32)
                    decisions = torch.cat([decisions, crops.reshape(1),
                                           dets.reshape(1),
                                           marks.buf.view(torch.int32)])
            packed = layout.pack((det_outs if s is None else ())
                                 + tuple(outs) + (decisions,))
            return (tuple(getattr(new, f) for f in fields)
                    + tuple(carried)), packed

        layout = _Layout()
        stamp_names = [] if stamped else None
        upload_bytes = frame_bytes + n_valid + 1
        prev0 = [torch.zeros((h, w, 3) if s is None else (s, h, w, 3),
                             dtype=torch.uint8, device=dev)] \
            if gmc is not None else []
        example = [getattr(template, f) for f in fields] + prev0 + [
            torch.zeros(upload_bytes, dtype=torch.uint8, device=dev)]
        name = (f"{self.tracker_kind} chunk step {h}x{w} K={k}"
                + ("" if s is None else f" over {s} streams")
                + (", stamped" if stamped else ""))
        engine = CUDAGraphEngine(step, example, name=name, warmup_iters=1,
                                 device=dev, carry=len(example) - 1,
                                 copy_outputs=False)
        return _Step(engine=engine, layout=layout, fields=fields,
                     frame_bytes=frame_bytes, upload_bytes=upload_bytes,
                     gmc=gmc is not None, bucketed=bucketed,
                     buckets=tuple(parts.buckets), batch=b,
                     stamps=stamp_names)

    def _get_stages(self, frame_hw: Tuple[int, int]):
        key = tuple(frame_hw)
        if key not in self._stages:
            self._stages[key] = self._make_stages(key)
        return self._stages[key]

    def _get_step(self, frame_hw: Tuple[int, int], k: int,
                  n_streams: int | None = None) -> "_Step":
        """The captured step of this frame size, chunk length and stream
        count, stamped while a timer is attached (made and captured at the
        first call: one graph each; a stamped one puts the device's clock on
        the host's, :meth:`CudaStageTimer.calibrate`)."""
        timer = self.stage_timer
        key = (tuple(frame_hw), int(k), n_streams, self.scan_bucket)
        if timer is not None:
            key += ("stamped",)
        if key not in self._steps:
            self._stepping = True
            try:
                self._steps[key] = self._make_step(
                    key[0], key[1], n_streams, stamped=timer is not None)
            finally:
                self._stepping = False
            if timer is not None:
                timer.calibrate(self.device)
        return self._steps[key]

    def scan_replays(self) -> int:
        """Replays of the eager step's captured tracker scans so far (0 on
        the CPU, where a capture is a direct call): one a chunk, or a
        dispatch of a stream stack, plus one a bucketed chunk that reruns at
        full capacity. The captured step replays no scan of its own
        (:meth:`step_replays`)."""
        return sum(e.replays for engines in self._scan_engines
                   for e in engines.values())

    def step_replays(self) -> int:
        """Replays of the captured chunk steps so far: one a chunk or
        dispatch (0 on the CPU)."""
        return sum(st.engine.replays for st in self._steps.values())

    def _mark(self, stage: str):
        """A stage boundary: with a timer attached, a stamp inside a timed
        captured step (made or run), else the eager step's event."""
        if self.stage_timer is None:
            return
        if self._stamps is not None:
            self._stamps.stamp(stage)
        elif not self._stepping:
            self.stage_timer.mark(stage)

    # --- host API -----------------------------------------------------------

    @property
    def scan_stats(self) -> dict:
        """Chunks (dispatches) by way of the bucketed scan since the last
        :meth:`reset`: ``small``, ``skipped``, ``rerun``. The captured
        step's are counted from its own decisions, read back with its
        outputs (:meth:`settle` waits for the ones still on their way)."""
        self.settle()
        return self._scan_stats

    def settle(self):
        """Wait for every dispatched chunk's decisions (the ReID bucket and
        the scan's ways) and count them: ``scan_stats`` and the launches of
        the hand-written kernels in the bodies the chunks took. A chunk's
        decisions come back with its outputs, so this waits only for
        chunks whose outputs were not read yet. With a timer attached to a
        stamped step, the device's clock is put on the host's once more."""
        while True:
            with self._pending_lock:
                if not self._pending:
                    break
                readback = self._pending[0]
            readback.settle()   # takes itself off the list
        if self.stage_timer is not None and any(
                st.stamps is not None for st in self._steps.values()):
            self.stage_timer.calibrate(self.device)

    def _count_decisions(self, step: "_Step", decisions, any_valid: bool,
                         timer=None, dispatch=None):
        """Count one chunk's decisions ``(reid index, fits, use_full)``; a
        stamped step's crop count and stamps, which follow them, go to
        ``timer`` under the chunk's ``dispatch`` id."""
        idx, fits, use_full = (int(v) for v in decisions[:3])
        taken = {}
        if idx >= 0:
            taken["reid"] = idx
            self.reid_buckets[step.buckets[idx]] = \
                self.reid_buckets.get(step.buckets[idx], 0) + 1
        if fits >= 0:
            taken.update(fits=fits, use_full=use_full)
            if any_valid:
                way = "skipped" if not fits else (
                    "rerun" if use_full else "small")
                self._scan_stats[way] += 1
        step.engine.count_taken(taken)
        if timer is not None and step.stamps is not None:
            n = len(step.stamps)
            stamps = np.ascontiguousarray(decisions[5:5 + 2 * n]).view(
                np.int64)
            reid = idx >= 0
            timer.arrive(dispatch, step.stamps, stamps,
                         crops=int(decisions[3]) if reid else 0,
                         slots=step.buckets[idx] * step.batch if reid else 0,
                         dets=int(decisions[4]), frames=step.batch)

    def reset(self):
        """Fresh tracker state (ids restart at 1), scan counts, no frame
        carried for the camera-motion estimate, and the timer's counts
        cleared (``CudaStageTimer.clear``)."""
        if self.stage_timer is not None:
            self.stage_timer.clear()
        self.state = self._init_tracker_state()
        self._pending = []
        self._scan_stats = dict(small=0, skipped=0, rerun=0)
        #: chunks by ReID bucket (the captured step's from its decisions,
        #: the eager step's from its reads)
        self.reid_buckets = {}
        self._gmc_prev_frame = None

    def _upload(self, step: "_Step", frames_np: np.ndarray,
                valid: np.ndarray, first: bool) -> torch.Tensor:
        """The chunk's frames, validity and first-chunk byte as one uint8
        tensor: on the GPU a pinned staging buffer (from a ring of three,
        each reused only after its last copy to the device ran), copied in
        without a wait; on the CPU a host tensor."""
        n = step.upload_bytes
        timer = self.stage_timer
        if self.device.type != "cuda":
            if timer is not None:
                timer.open("upload.copy")
            upload = torch.from_numpy(np.concatenate([
                np.ascontiguousarray(frames_np).reshape(-1),
                valid.reshape(-1).astype(np.uint8),
                np.array([first], np.uint8)]))
            if timer is not None:
                timer.close("upload.copy")
            return upload
        ring = self._staging.setdefault(n, [])
        if len(ring) < 3:
            buf = torch.empty(n, dtype=torch.uint8, pin_memory=True)
            ring.append([buf, None])
        slot = ring.pop(0)
        ring.append(slot)
        buf, event = slot
        if timer is not None:
            timer.open("upload.ring_wait")
        if event is not None:
            event.synchronize()
        if timer is not None:
            timer.close("upload.ring_wait")
            timer.open("upload.copy")
        host = buf.numpy()
        host[:step.frame_bytes] = np.asarray(frames_np).reshape(-1)
        host[step.frame_bytes:n - 1] = valid.reshape(-1)
        host[n - 1] = first
        if timer is not None:
            timer.close("upload.copy")
        return buf

    def _uploaded(self, upload: torch.Tensor):
        """Mark the staging buffer free once the work queued so far (its
        copy to the device among it) has run."""
        if self.device.type != "cuda":
            return
        for slot in self._staging[upload.numel()]:
            if slot[0] is upload:
                slot[1] = torch.cuda.Event()
                slot[1].record()

    def _replay_chunk(self, frames_np: np.ndarray, valid: np.ndarray,
                      state, prev, n_streams: int | None = None):
        """One chunk (``(K, H, W, 3)``), or one dispatch of a stack of
        ``n_streams`` streams (``(S, K, H, W, 3)``), through the captured
        step: counts the decisions of earlier chunks that have come back,
        uploads the frames with their validity ``valid`` (``([S,] K)``),
        replays on ``state`` and the carried frame before ``prev`` (``None``:
        the stream's first chunk). Returns ``(step, new state, new frame
        before, packed outputs)``; the frame before is ``None`` without GMC,
        and the packed outputs are the graph's own buffer on the GPU (valid
        until the next replay). With a timer attached this is the
        ``dispatch`` span (its id in ``_dispatch``), the engine call the
        ``replay`` span, and nothing waits."""
        timer = self.stage_timer
        if timer is not None:
            self._dispatch = timer.open("dispatch")
        with self._pending_lock:
            back = [r for r in self._pending if r.ready()]
        for readback in back:
            readback.settle()
        step = self._get_step(frames_np.shape[-3:-1], valid.shape[-1],
                              n_streams)
        upload = self._upload(step, frames_np, valid, prev is None)
        xs = [getattr(state, f) for f in step.fields]
        if step.gmc:
            xs.append(torch.zeros(frames_np.shape[:-4] + frames_np.shape[-3:],
                                  dtype=torch.uint8, device=self.device)
                      if prev is None else prev)
        if timer is not None:
            timer.open("replay")
        self._stepping = True
        try:
            with torch.no_grad():
                new, packed = step.engine(*xs, upload)
        finally:
            self._stepping = False
        self._uploaded(upload)
        if timer is not None:
            timer.close("replay")
            timer.close("dispatch")
        nf = len(step.fields)
        state = dataclasses.replace(state, **dict(zip(step.fields, new[:nf])))
        return step, state, (new[nf] if step.gmc else None), packed

    def _dispatch_chunk(self, frames_np: np.ndarray,
                        n_valid: int | None = None):
        """Upload one (K, H, W, 3) uint8 chunk and run the chunk step: its
        first ``n_valid`` frames advance the tracker, the rest are padding.
        Returns the chunk's outputs on their way to the host (``_emit``
        reads them): the captured step is one upload, one replay and one
        copy of its packed outputs into pinned memory behind an event, and
        waits for nothing."""
        k = frames_np.shape[0]
        n_valid = k if n_valid is None else n_valid
        if not self._capture_step:
            return self._eager_dispatch(frames_np, n_valid)
        step, self.state, self._gmc_prev_frame, packed = self._replay_chunk(
            frames_np, np.arange(k) < n_valid, self.state,
            self._gmc_prev_frame)
        return _Readback(self, step, packed, any_valid=n_valid > 0)

    def _eager_dispatch(self, frames_np: np.ndarray, n_valid: int):
        """The eager chunk step (:meth:`_make_stages`): the host reads the
        ReID bucket and the scan's ways."""
        k = frames_np.shape[0]
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
                                           np.arange(k) < n_valid)
            self._mark("tracker")
        if self.stage_timer is not None:
            self.stage_timer.finish()
        return _EagerOutputs(det_outs, track_outs)

    @staticmethod
    def _emit(outs, base_index: int, count: int):
        (num, boxes, scores, labels, det_valid,
         tlbr, ids, cls, conf, mask) = outs.arrays()
        timer = outs.timer
        if timer is not None:
            timer.open("emit", outs.dispatch)
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
        outs.release()
        if timer is not None:
            timer.close("emit")
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
            prev, pending = pending, (outs, base, n)
            base += n
            if prev is not None:
                yield from self._emit(*prev)
        if pending is not None:
            yield from self._emit(*pending)

    def process_frame(self, frame_bgr: np.ndarray) -> FrameResult:
        """Single-frame convenience API (a chunk of 1)."""
        return self._emit(self._dispatch_chunk(frame_bgr[None]), 0, 1)[0]

    def warm_up(self, frame_hw: Tuple[int, int],
                chunk_size: int | None = None, iters: int = 2) -> float:
        """Run the chunk step on blank frames (builds the kernels, warms the
        allocator and cuDNN, captures the step: its warm-up pass runs every
        branch body, so every ReID bucket and both scan capacities; the
        eager step's last pass runs at the full track capacity, so that its
        bucketed scan finds both of its captures), then reset; returns
        seconds."""
        t0 = time.perf_counter()
        k = chunk_size or self.chunk_size
        dummy = np.zeros((k, *frame_hw, 3), np.uint8)
        bucket = self.scan_bucket
        try:
            for i in range(iters):
                if not self._capture_step:
                    self.scan_bucket = bucket if i < iters - 1 else 0
                self._emit(self._dispatch_chunk(dummy), 0, 0)
        finally:
            self.scan_bucket = bucket
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.reset()
        return time.perf_counter() - t0
