"""Batched multi-stream tracking, on one device or sharded over a mesh.

The port of ``aicamera_tpu/parallel/multistream.py`` (BASELINE.json config
4: "8x 720p streams with batched ReID crops"). Every stream keeps its own
tracker state. A dispatch takes K frames of each of S streams:

- the detection work of all S*K frames is one batch: one letterbox kernel
  launch, one YOLOv8 forward, one decode+NMS, one crop gather and ReID over
  the load bucket the busiest frame needs;
- camera-motion compensation, when on, estimates every stream's K frames in
  one batched call, each from that stream's frame before the dispatch;
- the trackers then run over the K frames with the single-stream
  pipeline's stages (``TrackingPipeline._make_stages``).

The JAX package stacks the streams' states on a leading stream axis and
vmaps the tracker step over it. The port does the same for every core
(DeepSORT and its StrongSORT preset, ByteTrack and BoT-SORT, OC-SORT and
Deep OC-SORT, each with one GMC affine a stream), whose steps read nothing
back: the states live stacked, ``(S, T, ...)`` with the counters ``(S,)``,
each frame steps all streams at once (one assignment launch a stage for all
S problems, a thread block each; one ORU launch for every slot of every
stream), and the capacity bucket is decided once for the stack. A
dispatch is one captured chunk step (``TrackingPipeline._make_step`` over
the stack, as the JAX package jits its step: ``aicamera_tpu/parallel/
multistream.py:654-656``): detection, the ReID bucket's switch, the scan's
two conds and every stream's K frames in one CUDA-graph replay, whose
branches the device decides; the host uploads the frames and reads
nothing. ``scan_stats`` counts dispatches, from the replays' own
decisions.

A per-(stream, frame) validity mask lets streams at different frame rates
share a dispatch: a masked frame leaves its stream's state as it was. The
stacked step takes it as a device mask made by fills
(``runtime.pipeline.valid_mask``), never a copy from the host, so any
pattern replays the same capture.

On a mesh (``mesh=make_stream_mesh()`` or ``make_mesh(S, M)``, one process
per rank over ``torch.distributed``; see :mod:`.distributed`) every rank is
given the whole dispatch, as the JAX caller passes the global array, and
takes its contiguous block of S / n_stream streams: their frames are its
detection batch (one letterbox launch), their trackers and states are its
own. Tracking state never crosses streams, so detection and tracking issue
no collective; the one collective of a dispatch gathers the ranks' packed
outputs over the stream group, so that ``step_chunk`` returns all S
streams on every rank. With a ``model`` axis larger than 1 the detector's
convolutions are split by output channel over it
(:func:`.tensor_parallel.shard_detector_params`: one all-gather a sharded
conv); the ReID net stays whole on every rank. Such a model-split mesh
runs the eager step (its collectives sit inside the detector's forward,
where a capture cannot hold them): the host decides its branches, as the
port did before the step was captured.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import config
from ..core import bytetrack as bt_core
from ..core import ocsort as oc_core
from ..core.state import TrackerParams
from ..ops import gmc as gmc_ops
from ..runtime.checkpoint import state_like
from ..runtime.pipeline import TrackingPipeline, _Readback
from .distributed import COLLECTIVES, rank_device, require_world


def _mesh(device_type: str, ranks: torch.Tensor, names):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type, ranks, mesh_dim_names=names)


def make_stream_mesh(n_devices: int | None = None):
    """1-D ``DeviceMesh`` named ``("stream",)`` over the first
    ``n_devices`` ranks of the initialized world (default: all of them).
    Every rank of the world must call it (it creates the mesh's group)."""
    have = require_world("make_stream_mesh")
    n = have if n_devices is None else int(n_devices)
    if not 1 <= n <= have:
        raise ValueError(f"mesh {n} needs {n} devices, have {have}")
    return _mesh(rank_device().type, torch.arange(n), ("stream",))


def make_mesh(n_stream: int, n_model: int = 1):
    """2-D ``("stream", "model")`` ``DeviceMesh``: data parallelism over
    streams x tensor parallelism over conv output channels. ``model`` is
    the minor axis (rank = s * n_model + m), so a model group is
    neighbouring ranks, as in the JAX package's layout."""
    need = n_stream * n_model
    have = require_world("make_mesh")
    if have < need:
        raise ValueError(f"mesh {n_stream}x{n_model} needs {need} devices, "
                         f"have {have}")
    return _mesh(rank_device().type,
                 torch.arange(need).reshape(n_stream, n_model),
                 ("stream", "model"))


class MultiStreamPipeline:
    """Detect and track S independent streams per dispatch, on one device
    or sharded over a mesh's ``stream`` axis."""

    #: every core steps this rank's streams as one stack (the JAX layout)
    stacked = True

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
        ``scan_bucket``, ``letterbox_auto`` and ``reid_quant="int8"`` (the
        W8A8 embed stage over every stream's crops) mean what they mean
        there, but ``scan_bucket`` is decided once a dispatch for all
        streams of the stack (the JAX multi-stream rule). On the GPU the
        stack's assignment batches need ``max_detections`` divisible by 4
        (``ops/assignment.py``). ``mesh``: a ``DeviceMesh`` with a
        ``stream`` axis (and optionally ``model``) from
        :func:`make_stream_mesh` or :func:`make_mesh`; ``n_streams`` must
        divide by its ``stream`` size, the pipeline runs on this rank's
        device (``device`` may name only that one) and ``scan_bucket`` is
        0, as in the JAX package; each rank stacks its own streams."""
        self.n_streams = int(n_streams)
        if self.n_streams < 1:
            raise ValueError(f"n_streams must be >= 1 (got {n_streams})")
        self.frame_hw = tuple(frame_hw)
        self.mesh = mesh
        self._lo, self._n_local = 0, self.n_streams
        self._stream_group = None
        if mesh is not None:
            names = mesh.mesh_dim_names or ()
            if "stream" not in names:
                raise ValueError(f"the mesh must have a 'stream' axis (axes "
                                 f"{names})")
            if mesh.get_coordinate() is None:
                raise ValueError("this rank is not in the mesh")
            n_s = mesh.size(names.index("stream"))
            if self.n_streams % n_s:
                raise ValueError(f"n_streams={self.n_streams} not divisible "
                                 f"by the mesh's 'stream' axis size {n_s}")
            own = rank_device()
            asked = None if device is None else torch.device(device)
            if asked is not None and (asked.type != own.type or asked.index
                                      not in (None, own.index)):
                raise ValueError(f"on a mesh the pipeline runs on this "
                                 f"rank's device {own} (got device="
                                 f"{device!r})")
            device = own
            # off on a mesh, as in the JAX package (there its fits
            # predicate would reduce over the sharded states)
            scan_bucket = 0
            self._n_local = self.n_streams // n_s
            self._lo = mesh.get_local_rank("stream") * self._n_local
            self._stream_group = mesh.get_group("stream")
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
        n_det = self.core_params.max_detections
        if self.device.type == "cuda" and n_det % 4:
            raise ValueError(
                f"on the GPU a stack of streams needs max_detections "
                f"divisible by 4 (got {n_det}): the batched assignment "
                f"kernel reads every problem's rows 16 bytes at a time")
        self._gmc_spec = (gmc_ops.gmc_spec(self.frame_hw)
                          if self.gmc_method is not None else None)
        #: every dispatch is one replay of the captured step; a model-split
        #: mesh runs the eager step (chosen here, by the configuration)
        self._captured = eng._capture_step
        if mesh is not None and "model" in mesh.mesh_dim_names \
                and mesh.size(mesh.mesh_dim_names.index("model")) > 1:
            from .tensor_parallel import shard_detector_params
            eng.yolo = shard_detector_params(eng.yolo, mesh)
            self._captured = False
        # this rank's streams (all of them off a mesh): each one's last
        # valid frame (S_local, H, W, 3) and their tracker states, a stack
        # (S_local, T, ...)
        self._gmc_prev = None
        self._states = eng._init_tracker_state(n_streams=self._n_local)

    @property
    def scan_stats(self) -> dict:
        """Dispatches by way of the bucketed scan
        (``TrackingPipeline.scan_stats``)."""
        return self._engine.scan_stats

    def settle(self):
        """Wait for the dispatches' decisions and count them
        (``TrackingPipeline.settle``)."""
        self._engine.settle()

    def scan_replays(self) -> int:
        """Replays of the eager step's captured tracker scans so far
        (``TrackingPipeline.scan_replays``): one a dispatch (two when its
        bucketed pass reruns)."""
        return self._engine.scan_replays()

    def step_replays(self) -> int:
        """Replays of the captured chunk step: one a dispatch."""
        return self._engine.step_replays()

    @property
    def stage_timer(self):
        """A ``CudaStageTimer`` that times every dispatch (stages ``gmc``,
        ``letterbox``, ``yolo``, ``nms``, ``crops_reid`` and ``tracker``, the
        last over all streams; the captured step's from its own stamps, and
        the host's spans), or None. Attach it before the first dispatch of
        a shape: the timed step is a capture of its own."""
        return self._engine.stage_timer

    @stage_timer.setter
    def stage_timer(self, timer):
        self._engine.stage_timer = timer

    # --- the stacked view of the states --------------------------------------

    @property
    def states(self):
        """Every stream's tracker state, stacked on a leading stream axis
        (the JAX package's layout; a copy on the device). On a mesh the
        ranks' states are gathered over the stream group (one collective a
        field), so every rank gets all S. Assigning a stacked state of the
        same family and capacities (from ``runtime.checkpoint.load_state(...,
        n_streams=S)``, say) replaces all of them; on a mesh each rank
        keeps its own streams' part."""
        st = self._states
        return dataclasses.replace(st, **{
            f.name: self._gather(getattr(st, f.name).clone())
            for f in dataclasses.fields(st)
            if getattr(st, f.name) is not None})

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
        # this rank's streams, its own copy
        self._states = dataclasses.replace(stacked, **{
            f.name: getattr(stacked, f.name)[
                self._lo:self._lo + self._n_local].clone()
            for f in dataclasses.fields(stacked)
            if getattr(stacked, f.name) is not None})

    def _gather(self, local: torch.Tensor) -> torch.Tensor:
        """``(S_local, ...)`` on every rank -> ``(S, ...)``, in stream
        order (the identity off a mesh)."""
        if self.mesh is None:
            return local
        local = local.contiguous()
        out = torch.empty((self.n_streams, *local.shape[1:]),
                          dtype=local.dtype, device=local.device)
        return COLLECTIVES.all_gather_into_tensor(out, local,
                                                  group=self._stream_group)

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
            frames: ``(S, K, H, W, 3)`` uint8 BGR (on a mesh every rank
                passes all S streams; it uploads only its own).
            frame_valid: optional ``(S, K)`` bool (host data). A False frame
                does not advance its stream's tracker state; its output lane
                repeats the unchanged state's outputs, which the caller
                ignores. Used by the multi-tenant service when streams
                produce frames at different rates.

        Returns:
            per-stream track outputs ``(tlbr, ids, cls, conf, mask)``, each
            shaped ``(S, K, T, ...)``, on the device (on a mesh, all S
            streams on every rank).
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
        own = slice(self._lo, self._lo + self._n_local)
        outs = self._local_chunk(frames_np[own], valid[own])
        if self.mesh is None:
            return outs
        return self._unpack(self._gather(self._pack(outs)), outs)

    def _local_chunk(self, frames_np: np.ndarray, valid: np.ndarray):
        """This rank's streams ``(S_local, K, H, W, 3)`` through detection
        and their trackers: outputs ``(S_local, K, T, ...)``. One upload and
        one replay of the captured step (``TrackingPipeline._replay_chunk``);
        the outputs are a copy on the device, and only the decisions' words
        go to the host, counted later without a wait."""
        if not self._captured:
            return self._eager_chunk(frames_np, valid)
        eng = self._engine
        step, self._states, self._gmc_prev, packed = eng._replay_chunk(
            frames_np, valid, self._states, self._gmc_prev,
            n_streams=frames_np.shape[0])
        if packed.device.type == "cuda":
            packed = packed.clone()   # the next replay overwrites the graph's
        _Readback(eng, step, packed, any_valid=bool(valid.any()),
                  keep=False)
        return tuple(step.layout.unpack_torch(packed)[:-1])

    def _eager_chunk(self, frames_np: np.ndarray, valid: np.ndarray):
        """:meth:`_local_chunk` through the eager step (the host decides its
        branches)."""
        s, k = frames_np.shape[:2]
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
            if g_a is not None:
                inputs = dataclasses.replace(
                    inputs, gmc_a=g_a.reshape(s * k, *g_a.shape[2:]),
                    gmc_t=g_t.reshape(s * k, *g_t.shape[2:]))
            # all streams' frame i at index i: (K, S, ...)
            self._states, outs = track(self._states, inputs.by_frame(s, k),
                                       valid.T)
            outs = tuple(o.transpose(0, 1).contiguous() for o in outs)
            mark("tracker")
        if timer is not None:
            timer.finish()
        return outs

    @staticmethod
    def _pack(outs) -> torch.Tensor:
        """The five outputs as one ``(S, K, T, 8)`` int32 tensor, floats by
        their bits (lossless): tlbr (4), ids, classes, conf, mask."""
        tlbr, ids, cls, conf, mask = outs
        return torch.cat([tlbr.float().contiguous().view(torch.int32),
                          ids.to(torch.int32)[..., None],
                          cls.to(torch.int32)[..., None],
                          conf.float()[..., None].contiguous().view(
                              torch.int32),
                          mask.to(torch.int32)[..., None]], dim=-1)

    @staticmethod
    def _unpack(packed: torch.Tensor, like):
        """:meth:`_pack`'s inverse, in the dtypes of ``like``."""
        floats = packed.view(torch.float32)
        parts = (floats[..., :4], packed[..., 4], packed[..., 5],
                 floats[..., 6], packed[..., 7])
        return tuple(p.to(t.dtype).contiguous() for p, t in zip(parts, like))

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
        slot is leased to a new tenant). On a mesh only the rank that owns
        stream ``i`` has anything to reset; every rank may call it."""
        if not 0 <= i < self.n_streams:
            raise IndexError(f"stream {i} out of range for "
                             f"{self.n_streams} streams")
        if not self._lo <= i < self._lo + self._n_local:
            return
        j = i - self._lo
        fresh = self._engine._init_tracker_state()
        for f in dataclasses.fields(fresh):   # the stack is this pipeline's
            if getattr(fresh, f.name) is not None:
                getattr(self._states, f.name)[j].copy_(getattr(fresh, f.name))
