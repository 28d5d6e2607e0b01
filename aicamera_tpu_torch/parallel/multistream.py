"""Batched multi-stream tracking on one GPU.

The port of ``aicamera_tpu/parallel/multistream.py`` (BASELINE.json config
4: "8x 720p streams with batched ReID crops"). Every stream keeps its own
tracker state. A dispatch takes K frames of each of S streams:

- the detection work of all S*K frames is one batch: one letterbox kernel
  launch, one YOLOv8 forward, one decode+NMS, one crop gather and ReID over
  the load bucket the busiest frame needs;
- camera-motion compensation, when on, estimates every stream's K frames in
  one batched call, each from that stream's frame before the dispatch;
- each stream's tracker then runs over its K frames on its own state, with
  the single-stream pipeline's stages (``TrackingPipeline._make_stages``).

The JAX package vmaps the tracker step over the stream axis. The port's
cores cannot be vmapped (their loops and branches are Python control flow
that reads the GPU), so the streams' trackers run one after another and
their time grows linearly with S. The states stay a list of single-stream
states on the device; :attr:`MultiStreamPipeline.states` stacks them into
the JAX layout on demand (checkpoints, inspection).

A per-(stream, frame) validity mask lets streams at different frame rates
share a dispatch: a masked frame leaves its stream's state as it was. The
mask is host data and is never uploaded.

Not ported: ``mesh=`` (sharding streams over several devices),
``make_mesh`` and ``make_stream_mesh``; they raise the not-ported error.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import config, not_ported
from ..core import bytetrack as bt_core
from ..core import ocsort as oc_core
from ..core.state import TrackerParams
from ..ops import gmc as gmc_ops
from ..runtime.checkpoint import state_like
from ..runtime.pipeline import TrackingPipeline


def make_stream_mesh(n_devices: int | None = None):
    raise not_ported("make_stream_mesh (streams sharded over devices)")


def make_mesh(n_stream: int, n_model: int = 1):
    raise not_ported("make_mesh (streams and channels sharded over devices)")


class MultiStreamPipeline:
    """Detect and track S independent streams per dispatch on one device."""

    def __init__(self,
                 n_streams: int,
                 frame_hw: Tuple[int, int],
                 mesh=None,
                 variant: str = "n",
                 input_shape: Tuple[int, int] = config.YOLO_INPUT_SHAPE,
                 conf_threshold: float = config.YOLO_CONF_THRESHOLD,
                 nms_threshold: float = config.YOLO_NMS_THRESHOLD,
                 min_detection_confidence: float =
                 config.DEEPSORT_MIN_CONFIDENCE,
                 tracker_params: TrackerParams | None = None,
                 max_reid_crops: int = config.MAX_REID_CROPS,
                 preprocess_impl: str = "auto",
                 yolo_weights: str | None = None,
                 reid_weights: str | None = None,
                 scan_bucket: int | None = 32,
                 letterbox_auto: bool = False,
                 tracker: str = "deepsort",
                 bytetrack_params: bt_core.ByteTrackParams | None = None,
                 ocsort_params: oc_core.OCSortParams | None = None,
                 gmc: str | bool = False,
                 reid_quant: str | None = None,
                 detect_dtype: str | None = None,
                 reid_dtype: str | None = None,
                 device=None):
        """Arguments as in the JAX ``MultiStreamPipeline``, plus
        ``detect_dtype``/``reid_dtype`` and ``device`` as in
        :class:`TrackingPipeline` (default the GPU; raises without one).
        The tracker names, their parameters and presets, ``gmc``,
        ``scan_bucket`` (decided per stream), ``letterbox_auto`` and
        ``reid_quant="int8"`` (the W8A8 embed stage over every stream's
        crops) mean what they mean there. ``mesh`` is not ported."""
        if mesh is not None:
            raise not_ported("mesh= (streams sharded over devices)")
        self.n_streams = int(n_streams)
        if self.n_streams < 1:
            raise ValueError(f"n_streams must be >= 1 (got {n_streams})")
        self.frame_hw = tuple(frame_hw)
        # the single-stream pipeline whose stages every dispatch runs; its
        # own one-stream state is not used
        self._engine = TrackingPipeline(
            variant=variant, input_shape=input_shape,
            conf_threshold=conf_threshold, nms_threshold=nms_threshold,
            min_detection_confidence=min_detection_confidence,
            yolo_weights=yolo_weights, reid_weights=reid_weights,
            tracker_params=tracker_params, max_reid_crops=max_reid_crops,
            preprocess_impl=preprocess_impl, scan_bucket=scan_bucket,
            letterbox_auto=letterbox_auto, tracker=tracker,
            bytetrack_params=bytetrack_params, ocsort_params=ocsort_params,
            gmc=gmc, reid_quant=reid_quant, detect_dtype=detect_dtype,
            reid_dtype=reid_dtype, device=device)
        eng = self._engine
        eng.state = None
        self.device = eng.device
        self.tracker_kind = eng.tracker_kind
        self.reid_quant = eng.reid_quant
        self.tracker_params = eng.tracker_params
        self.bytetrack_params = eng.bytetrack_params
        self.ocsort_params = eng.ocsort_params
        self.core_params = eng.core_params
        self.gmc_method = eng.gmc_method
        self.scan_bucket = eng.scan_bucket
        #: chunks by way of the bucketed scan, summed over the streams
        self.scan_stats = eng.scan_stats
        self._gmc_spec = (gmc_ops.gmc_spec(self.frame_hw)
                          if self.gmc_method is not None else None)
        self._gmc_prev = None   # (S, H, W, 3): each stream's last valid frame
        self._states = [eng._init_tracker_state()
                        for _ in range(self.n_streams)]

    @property
    def stage_timer(self):
        """A ``CudaStageTimer`` that times every dispatch (stages ``gmc``,
        ``letterbox``, ``yolo``, ``nms``, ``crops_reid`` and ``tracker``, the
        last over all streams), or None."""
        return self._engine.stage_timer

    @stage_timer.setter
    def stage_timer(self, timer):
        self._engine.stage_timer = timer

    # --- the stacked view of the states --------------------------------------

    @property
    def states(self):
        """Every stream's tracker state, stacked on a leading stream axis
        (the JAX package's layout; a copy on the device). Assigning a
        stacked state of the same family and capacities (from
        ``runtime.checkpoint.load_state(..., n_streams=S)``, say) replaces
        all of them."""
        first = self._states[0]
        return dataclasses.replace(first, **{
            f.name: None if getattr(first, f.name) is None
            else torch.stack([getattr(s, f.name) for s in self._states])
            for f in dataclasses.fields(first)})

    @states.setter
    def states(self, stacked):
        template = self._engine._init_tracker_state()
        if type(stacked) is not type(template):
            raise TypeError(f"states must be a stacked "
                            f"{type(template).__name__}, got "
                            f"{type(stacked).__name__}")
        stacked = state_like(
            template, {f.name: getattr(stacked, f.name)
                       for f in dataclasses.fields(stacked)},
            (self.n_streams,), self.device, where="states")
        self._states = [dataclasses.replace(stacked, **{
            f.name: getattr(stacked, f.name)[si]
            for f in dataclasses.fields(stacked)
            if getattr(stacked, f.name) is not None})
            for si in range(self.n_streams)]

    # --- dispatch ------------------------------------------------------------

    def step(self, frames: np.ndarray):
        """Advance all streams by one frame each.

        Args:
            frames: ``(S, H, W, 3)`` uint8 BGR, one frame per stream.

        Returns:
            per-stream track outputs ``(tlbr, ids, cls, conf, mask)``, each
            with a leading stream axis, on the device.
        """
        outs = self.step_chunk(np.asarray(frames)[:, None])
        return tuple(o[:, 0] for o in outs)

    def step_chunk(self, frames: np.ndarray,
                   frame_valid: np.ndarray | None = None):
        """Advance all streams by K frames each (throughput mode).

        Args:
            frames: ``(S, K, H, W, 3)`` uint8 BGR.
            frame_valid: optional ``(S, K)`` bool (host data). A False frame
                does not advance its stream's tracker state; its output lane
                repeats the unchanged state's outputs, which the caller
                ignores. Used by the multi-tenant service when streams
                produce frames at different rates.

        Returns:
            per-stream track outputs ``(tlbr, ids, cls, conf, mask)``, each
            shaped ``(S, K, T, ...)``, on the device.
        """
        frames_np = np.asarray(frames)
        s = self.n_streams
        if (frames_np.ndim != 5 or frames_np.shape[0] != s
                or frames_np.shape[2:] != (*self.frame_hw, 3)
                or frames_np.dtype != np.uint8):
            raise ValueError(
                f"frames must be uint8 (S, K, H, W, 3) with S={s} and "
                f"(H, W)={self.frame_hw} (got {frames_np.dtype}"
                f"{frames_np.shape})")
        k = frames_np.shape[1]
        valid = (np.ones((s, k), bool) if frame_valid is None
                 else np.asarray(frame_valid, bool))
        if valid.shape != (s, k):
            raise ValueError(f"frame_valid must be ({s}, {k}) (got "
                             f"{valid.shape})")
        detect, track = self._engine._get_stages(self.frame_hw)
        mark = self._engine._mark
        frames_t = torch.from_numpy(np.ascontiguousarray(frames_np)).to(
            self.device)
        timer = self.stage_timer
        if timer is not None:
            timer.start()
        with torch.no_grad():
            g_a = g_t = None
            if self.gmc_method is not None:
                # every stream's frames from its frame before the dispatch
                # (on a stream's first dispatch its own first frame)
                prev = (frames_t[:, 0] if self._gmc_prev is None
                        else self._gmc_prev)
                g_a, g_t = gmc_ops.estimate_chunk(prev, frames_t,
                                                  self._gmc_spec,
                                                  self.gmc_method)
                self._gmc_prev = self._last_valid_frames(prev, frames_t,
                                                         valid)
                mark("gmc")
            inputs, _ = detect(frames_t.reshape(s * k, *frames_t.shape[2:]))
            outs = []
            for si in range(s):
                inp = inputs.frames(si * k, (si + 1) * k)
                if g_a is not None:
                    inp = dataclasses.replace(inp, gmc_a=g_a[si],
                                              gmc_t=g_t[si])
                self._states[si], o = track(self._states[si], inp,
                                            valid[si].tolist())
                outs.append(o)
            mark("tracker")
        if timer is not None:
            timer.finish()
        return tuple(torch.stack(x) for x in zip(*outs))

    @staticmethod
    def _last_valid_frames(prev, frames_t, valid):
        """Each stream's last valid frame of this dispatch, or its ``prev``
        where none was valid: the next dispatch's frame before."""
        if valid.all():
            return frames_t[:, -1].clone()
        nxt = prev.clone()
        for si in range(valid.shape[0]):
            idx = np.flatnonzero(valid[si])
            if len(idx):
                nxt[si] = frames_t[si, idx[-1]]
        return nxt

    def reset_stream(self, i: int):
        """Reset one stream's tracker state (ids restart at 1). Call it
        only between dispatches (the serving worker does, when a stream
        slot is leased to a new tenant)."""
        self._states[i] = self._engine._init_tracker_state()
