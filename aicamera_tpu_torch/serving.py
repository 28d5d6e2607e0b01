"""Asynchronous request/response serving over the port's pipelines.

The port of ``aicamera_tpu/serving.py``. Callers submit BGR frames and get
``concurrent.futures.Future`` objects back. One worker thread owns the
device and batches submissions into chunk dispatches; a resolver thread
reads the results back and resolves the futures, with at most
``max_inflight`` dispatched chunks unresolved as backpressure.

- :class:`TrackingService`: one stream over a :class:`TrackingPipeline`.
- :class:`MultiTenantTrackingService`: many tenant streams in leased slots
  over one :class:`~aicamera_tpu_torch.parallel.MultiStreamPipeline`, with
  per-request deadlines and a per-(stream, frame) validity mask.

Both threads run under ``torch.no_grad()`` (it is thread-local). A device
error in a dispatch or a readback reaches the futures it concerns through
``set_exception``; nothing retries on the CPU. The port's dispatch reads
the GPU several times a frame (the tracker's branches), so on this port the
worker thread itself waits inside ``step_chunk``; the scheduler's logic is
the JAX package's all the same.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Tuple

import numpy as np
import torch

from .runtime.pipeline import TrackingPipeline, _format_tracks


class TrackingService:
    """Threaded tracking server around one :class:`TrackingPipeline`.

    A worker gathers up to ``chunk_size`` frames, waiting at most
    ``max_latency_ms`` after the first for batch-mates, and dispatches them
    as one chunk (padded to ``chunk_size``; padding frames leave the state
    as it is). Frames are one stream, numbered in order of submission."""

    def __init__(self, pipeline: Optional[TrackingPipeline] = None,
                 chunk_size: int = 8, max_latency_ms: float = 30.0,
                 max_inflight: int = 8, **pipeline_kwargs):
        self.pipeline = pipeline or TrackingPipeline(
            chunk_size=chunk_size, **pipeline_kwargs)
        self.chunk_size = int(chunk_size)
        self.max_latency = max_latency_ms / 1e3
        self._q: queue.Queue = queue.Queue()
        self._frame_index = 0
        self._running = True
        # guards _running + sentinel enqueue so no submit can slip a frame
        # in behind the shutdown sentinel (whose Future would never resolve)
        self._state_lock = threading.Lock()
        self._resolve_q: queue.Queue = queue.Queue(
            maxsize=max(1, int(max_inflight)))
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self._resolver = threading.Thread(target=self._run_resolver,
                                          daemon=True)
        self._resolver.start()

    # --- client API ----------------------------------------------------------

    def submit(self, frame_bgr: np.ndarray) -> Future:
        """Enqueue one frame; returns a Future of ``FrameResult``."""
        fut: Future = Future()
        with self._state_lock:
            if not self._running:
                raise RuntimeError("service is shut down")
            self._q.put((fut, np.asarray(frame_bgr)))
        return fut

    def reset(self) -> Future:
        """Fresh tracker state (ids restart at 1) once every frame submitted
        before it has been dispatched. The worker resets the pipeline
        between two dispatches; returns a Future that resolves once the
        results of those frames have resolved too."""
        fut: Future = Future()
        with self._state_lock:
            if not self._running:
                raise RuntimeError("service is shut down")
            self._q.put(_Reset(fut))
        return fut

    def shutdown(self, timeout: float = 30.0):
        """Drain outstanding work and stop the workers. Idempotent."""
        with self._state_lock:
            if self._running:
                self._running = False
                self._q.put(None)
        t0 = time.perf_counter()
        self._worker.join(timeout=timeout)
        self._resolver.join(
            timeout=max(0.1, timeout - (time.perf_counter() - t0)))

    # --- worker --------------------------------------------------------------

    def _gather(self):
        """Collect up to chunk_size frames, waiting at most max_latency
        after the first arrival. Returns ``(futures, frames, stop, reset)``:
        ``reset`` is a :class:`_Reset` met after the frames (it ends the
        gather), or None."""
        futures: List[Future] = []
        frames: List[np.ndarray] = []
        deadline = None
        while len(frames) < self.chunk_size:
            if deadline is None:
                timeout = 0.05
            else:
                timeout = deadline - time.perf_counter()
                if timeout <= 0:
                    break
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if item is None:
                return futures, frames, True, None
            if isinstance(item, _Reset):
                return futures, frames, False, item
            futures.append(item[0])
            frames.append(item[1])
            if deadline is None:
                deadline = time.perf_counter() + self.max_latency
        return futures, frames, False, None

    def _resolve(self, pending):
        futures, det_outs, track_outs, base, count = pending
        try:
            results = self.pipeline._emit(det_outs, track_outs, base, count)
            for fut, res in zip(futures, results):
                fut.set_result(res)
        except Exception as e:  # a device failure reaches the callers
            for fut in futures:
                if not fut.done():
                    fut.set_exception(e)

    def _run(self):
        with torch.no_grad():
            self._serve()

    def _serve(self):
        stop = False
        while not stop:
            futures, frames, stop, reset = self._gather()
            if frames:
                self._dispatch(futures, frames)
            if reset is not None:
                # between dispatches: no step is running over the state
                try:
                    self.pipeline.reset()
                except Exception as e:
                    reset.future.set_exception(e)
                else:
                    # the resolver, FIFO, resolves it after earlier chunks
                    self._resolve_q.put(reset)
        # reject anything left in the queue
        try:
            while True:
                item = self._q.get_nowait()
                if isinstance(item, _Reset):
                    item.future.set_exception(
                        RuntimeError("service shut down"))
                elif item is not None:
                    item[0].set_exception(RuntimeError("service shut down"))
        except queue.Empty:
            pass
        self._resolve_q.put(None)  # resolver drains FIFO, then stops

    def _dispatch(self, futures, frames):
        k = self.chunk_size
        count = len(frames)
        if count < k:
            frames = frames + [frames[-1]] * (k - count)
        base = self._frame_index
        self._frame_index += count
        try:
            det_outs, track_outs = self.pipeline._dispatch_chunk(
                np.stack(frames), n_valid=count)
        except Exception as e:  # a device failure reaches the callers
            for fut in futures:
                fut.set_exception(e)
            return
        # blocks only at max_inflight unresolved chunks
        self._resolve_q.put((futures, det_outs, track_outs, base, count))

    def _run_resolver(self):
        with torch.no_grad():
            while True:
                item = self._resolve_q.get()
                if item is None:
                    break
                if isinstance(item, _Reset):
                    item.future.set_result(None)
                else:
                    self._resolve(item)


@dataclasses.dataclass
class _Reset:
    """A reset request in the worker's queue."""
    future: Future


# --- multi-tenant serving ------------------------------------------------


@dataclasses.dataclass
class StreamFrameResult:
    """Per-frame result for one tenant stream.

    The three timestamps (``time.perf_counter`` seconds) decompose the
    request's latency: ``dispatch_ts - arrival_ts`` is the queue wait (the
    scheduler's share), ``resolve_ts - dispatch_ts`` the dispatch and the
    readback."""
    stream_id: int
    frame_index: int   # per-stream frame counter
    tracks: list       # [(x1, y1, x2, y2, track_id, class_name, conf), ...]
    arrival_ts: float = 0.0
    dispatch_ts: float = 0.0
    resolve_ts: float = 0.0


_FREE, _ACTIVE, _DRAINING = 0, 1, 2


class _StreamSlot:
    __slots__ = ("state", "pending", "sla", "next_index", "needs_reset")

    def __init__(self):
        self.state = _FREE
        # (Future, frame, arrival_ts, deadline_ts)
        self.pending = collections.deque()
        self.sla = 0.0
        self.next_index = 0
        self.needs_reset = False


class MultiTenantTrackingService:
    """Tracking as a service for many independent tenant video streams.

    S fixed stream slots ride one ``MultiStreamPipeline``: every dispatch
    batches up to ``chunk_size`` frames from each active stream into one
    device step (one detector batch over all tenants, each stream's tracker
    on its own state), with a per-(stream, frame) validity mask so tenants
    at different frame rates never advance each other's tracker state.

    Deadline-aware windowing (the JAX package's scheduler, unchanged): every
    request carries a deadline (arrival + the stream's ``max_latency_ms``,
    or an explicit ``deadline_ms`` at :meth:`submit`). The worker keeps EWMA
    estimates of the readback time and of the arrival rate and fires a
    dispatch when a slot holds a full chunk, when the earliest deadline
    comes within the readback estimate plus ``sla_margin_ms``, or at once
    when the device is idle and no batch-mate is expected in time
    (:meth:`_dispatch_ready`).

    The readback is one transfer per dispatch: the five output tensors are
    packed into one ``(S, K, T, 9)`` f32 tensor on the device, copied
    without blocking into pinned host memory, and a CUDA event recorded
    after the copy; the resolver thread waits on that event before it reads
    the buffer. On the CPU the packed tensor is the host buffer.

    Slots are leased: :meth:`close_stream` drains the tenant's queued
    frames and frees the slot; the next :meth:`open_stream` re-leases it
    with a fresh tracker state (ids restart at 1).
    """

    def __init__(self, n_streams: int = 4,
                 frame_hw: Tuple[int, int] = (720, 1280),
                 chunk_size: int = 4,
                 max_latency_ms: float = 30.0,
                 sla_margin_ms: float = 5.0,
                 max_inflight: int = 8,
                 pipeline=None, **pipeline_kwargs):
        if pipeline is None:
            from .parallel import MultiStreamPipeline
            pipeline = MultiStreamPipeline(
                n_streams=n_streams, frame_hw=frame_hw, **pipeline_kwargs)
        self.pipeline = pipeline
        self.n_streams = int(pipeline.n_streams)
        self.frame_hw = tuple(pipeline.frame_hw)
        self.chunk_size = int(chunk_size)
        self.default_sla = max_latency_ms / 1e3
        self.sla_margin = sla_margin_ms / 1e3
        self._slots = [_StreamSlot() for _ in range(self.n_streams)]
        self._outstanding = 0  # submitted frames not yet resolved
        self._resolve_q: queue.Queue = queue.Queue(
            maxsize=max(1, int(max_inflight)))
        self._inflight = 0  # dispatched, not yet resolved (under _cond)
        # Scheduler estimators (EWMA, alpha 0.3). The deadline lead is
        # est_resolve, the resolver's blocking readback time: the marginal
        # per-chunk cost at which the FIFO resolver drains. est_cycle
        # (dispatch -> results) is kept for stats only: under backlog it
        # includes the resolver queue's wait, and as the lead it would feed
        # back (a longer lead, more deadline fires, more tiny dispatches, a
        # deeper backlog). arrival_rate = 1/EWMA(inter-arrival) over all
        # tenants decides whether waiting for batch-mates can pay off.
        self._est_cycle = 0.0
        self._est_resolve = 0.0
        self._mean_interarrival = 0.0
        self._last_arrival = 0.0
        self.stats = {"dispatches": 0, "frames": 0, "deadline_fires": 0,
                      "full_fires": 0, "eager_fires": 0}
        self._cond = threading.Condition()
        self._running = True
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self._resolver = threading.Thread(target=self._run_resolver,
                                          daemon=True)
        self._resolver.start()

    # --- client API ----------------------------------------------------------

    def open_stream(self, max_latency_ms: float | None = None) -> int:
        """Lease a free stream slot; returns its stream id.

        The slot's tracker state is reset (by the worker, before the
        stream's first frame is processed). Raises RuntimeError when all
        slots are leased."""
        with self._cond:
            if not self._running:
                raise RuntimeError("service is shut down")
            for sid, slot in enumerate(self._slots):
                if slot.state == _FREE:
                    slot.state = _ACTIVE
                    slot.sla = (self.default_sla if max_latency_ms is None
                                else max_latency_ms / 1e3)
                    slot.next_index = 0
                    slot.needs_reset = True
                    return sid
        raise RuntimeError(
            f"all {self.n_streams} stream slots are leased")

    def submit(self, stream_id: int, frame_bgr: np.ndarray,
               deadline_ms: float | None = None) -> Future:
        """Enqueue one frame for a leased stream; Future of
        StreamFrameResult. ``deadline_ms`` overrides the stream's SLA
        window for this request (latency budget from now)."""
        frame = np.asarray(frame_bgr)
        if frame.shape != (*self.frame_hw, 3):
            raise ValueError(
                f"frame shape {frame.shape} != service shape "
                f"{(*self.frame_hw, 3)} (all tenants share one compiled "
                f"step; resize host-side)")
        fut: Future = Future()
        with self._cond:
            if not self._running:
                raise RuntimeError("service is shut down")
            slot = self._slots[stream_id]
            if slot.state != _ACTIVE:
                raise RuntimeError(f"stream {stream_id} is not open")
            now = time.perf_counter()
            budget = slot.sla if deadline_ms is None else deadline_ms / 1e3
            slot.pending.append((fut, frame, now, now + budget))
            self._outstanding += 1
            # arrival-rate EWMA (all tenants): long idle gaps decay the
            # rate so a sporadic frame dispatches eagerly
            if self._last_arrival:
                dt = now - self._last_arrival
                self._mean_interarrival = (
                    dt if self._mean_interarrival == 0.0
                    else 0.7 * self._mean_interarrival + 0.3 * dt)
            self._last_arrival = now
            self._cond.notify()
        return fut

    def wait_idle(self, timeout: float = 300.0) -> None:
        """Block until every slot is FREE and every submitted frame has
        resolved, e.g. between a drain (:meth:`close_stream`) and re-leasing
        slots for a new tenant generation."""
        deadline = time.perf_counter() + timeout
        with self._cond:
            while (self._outstanding or
                   any(s.state != _FREE or s.pending
                       for s in self._slots)):
                if time.perf_counter() >= deadline:
                    raise TimeoutError(
                        f"service did not drain within {timeout}s "
                        f"({self._outstanding} outstanding)")
                self._cond.wait(timeout=0.1)

    def _finished(self, n: int) -> None:
        with self._cond:
            self._outstanding -= n
            self._inflight -= 1
            self._cond.notify_all()

    def close_stream(self, stream_id: int):
        """Stop accepting frames for the stream; queued frames still
        resolve, then the slot is freed for re-lease. Idempotent."""
        with self._cond:
            slot = self._slots[stream_id]
            if slot.state == _ACTIVE:
                slot.state = _DRAINING if slot.pending else _FREE
                self._cond.notify()

    def shutdown(self, timeout: float = 60.0):
        """Drain all queued work and stop the workers. Idempotent."""
        with self._cond:
            if self._running:
                self._running = False
                self._cond.notify()
        t0 = time.perf_counter()
        self._worker.join(timeout=timeout)
        self._resolver.join(
            timeout=max(0.1, timeout - (time.perf_counter() - t0)))

    # --- worker --------------------------------------------------------------

    def _earliest_deadline(self) -> Optional[float]:
        dl = None
        for slot in self._slots:
            if slot.pending:
                d = slot.pending[0][3]
                dl = d if dl is None else min(dl, d)
        return dl

    def _dispatch_ready(self, now: float, device_idle: bool) -> bool:
        """True when some queued frame must (or profitably may) ride a
        dispatch now. Lock held. Three triggers:

        - FULL: a slot has a full chunk queued: fire at once, and every
          other tenant's queued frames ride the same dispatch.
        - DEADLINE: the earliest queued deadline is within the readback
          lead time (+ margin): fires before the deadline, as long as the
          estimate tracks the truth.
        - EAGER: the device is idle and either the arrival rate says fewer
          than one batch-mate is expected within the remaining deadline
          budget, or the oldest queued frame has already waited one
          readback time (or the margin) for batch-mates.
        """
        pending = False
        oldest = None
        for slot in self._slots:
            if not slot.pending:
                continue
            pending = True
            a = slot.pending[0][2]
            oldest = a if oldest is None else min(oldest, a)
            if len(slot.pending) >= self.chunk_size:
                self.stats["full_fires"] += 1
                return True
        if not pending:
            return False
        dl = self._earliest_deadline()
        lead = self._est_resolve + self.sla_margin
        if now + lead >= dl:
            self.stats["deadline_fires"] += 1
            return True
        if device_idle:
            budget = dl - lead - now
            rate = (1.0 / self._mean_interarrival
                    if self._mean_interarrival > 0 else 0.0)
            if (rate * budget < 1.0 or
                    now - oldest >= max(self._est_resolve,
                                        self.sla_margin)):
                self.stats["eager_fires"] += 1
                return True
        return False

    def _next_wake(self, now: float) -> float:
        """Seconds until the next scheduling event: the earliest queued
        deadline minus the dispatch lead (0 floor, 0.05 idle cap; the cap
        also bounds the eager wait-for-batch-mates granularity)."""
        wake = 0.05
        dl = self._earliest_deadline()
        if dl is not None:
            wake = min(wake, dl - self._est_resolve - self.sla_margin
                       - now)
        return max(wake, 0.0)

    def _gather(self):
        """Build one (S, K, H, W, 3) batch from queued frames. Lock held.
        Returns (frames, valid, jobs, earliest_deadline_of_jobs)."""
        k = self.chunk_size
        frames = np.zeros((self.n_streams, k, *self.frame_hw, 3), np.uint8)
        valid = np.zeros((self.n_streams, k), bool)
        jobs = []  # (stream_id, t, future, frame_index, arrival_ts)
        deadline = None
        for sid, slot in enumerate(self._slots):
            if slot.needs_reset:
                # safe here: the worker thread owns the device between
                # dispatches, so no step is running over these states
                self.pipeline.reset_stream(sid)
                slot.needs_reset = False
            for t in range(min(k, len(slot.pending))):
                fut, frame, arrival, dl = slot.pending.popleft()
                frames[sid, t] = frame
                valid[sid, t] = True
                jobs.append((sid, t, fut, slot.next_index, arrival))
                deadline = dl if deadline is None else min(deadline, dl)
                slot.next_index += 1
            if slot.state == _DRAINING and not slot.pending:
                slot.state = _FREE
        return frames, valid, jobs, deadline

    def _resolve(self, inflight):
        packed, ready, jobs, dispatch_ts = inflight
        t0 = time.perf_counter()
        try:
            if ready is not None:
                ready.synchronize()  # the copy into the pinned buffer
            arr = packed.numpy()
            tlbr = arr[..., :4]
            ids = (arr[..., 4].astype(np.int64)
                   | (arr[..., 5].astype(np.int64) << 16))
            cls = arr[..., 6].astype(np.int32)
            conf = arr[..., 7]
            mask = arr[..., 8] != 0.0
            resolve_ts = time.perf_counter()
            for sid, t, fut, fidx, arrival in jobs:
                fut.set_result(StreamFrameResult(
                    stream_id=sid, frame_index=fidx,
                    tracks=_format_tracks(tlbr[sid, t], ids[sid, t],
                                          cls[sid, t], conf[sid, t],
                                          mask[sid, t]),
                    arrival_ts=arrival, dispatch_ts=dispatch_ts,
                    resolve_ts=resolve_ts))
        except Exception as e:  # a device failure reaches the callers
            resolve_ts = time.perf_counter()
            for _, _, fut, _, _ in jobs:
                if not fut.done():
                    fut.set_exception(e)
        finally:
            # EWMA the scheduler's lead-time estimates from what actually
            # happened: the whole dispatch -> results latency and the
            # blocking readback
            cycle = resolve_ts - dispatch_ts
            blk = resolve_ts - t0
            a = 0.3
            self._est_cycle = (cycle if self._est_cycle == 0.0
                               else (1 - a) * self._est_cycle + a * cycle)
            self._est_resolve = (blk if self._est_resolve == 0.0
                                 else (1 - a) * self._est_resolve + a * blk)
            self._finished(len(jobs))

    def _run(self):
        with torch.no_grad():
            self._serve()

    def _serve(self):
        """Dispatch loop: gathers and dispatches; the readbacks are the
        resolver's. Bounded unresolved chunks (the _resolve_q maxsize)
        provide backpressure."""
        while True:
            do_dispatch = False
            with self._cond:
                now = time.perf_counter()
                while self._running:
                    if self._dispatch_ready(now, self._inflight == 0):
                        do_dispatch = True
                        break
                    self._cond.wait(timeout=self._next_wake(now))
                    now = time.perf_counter()
                if not self._running:
                    if any(s.pending for s in self._slots):
                        do_dispatch = True  # drain
                    else:
                        break
                if do_dispatch:
                    frames, valid, jobs, _ = self._gather()
                    do_dispatch = bool(jobs)
                    if do_dispatch:
                        self._inflight += 1
            if do_dispatch:
                dispatch_ts = time.perf_counter()
                try:
                    outs = self.pipeline.step_chunk(frames,
                                                    frame_valid=valid)
                    packed, ready = self._readback(self._pack_outputs(outs))
                except Exception as e:  # a device failure reaches callers
                    for _, _, fut, _, _ in jobs:
                        fut.set_exception(e)
                    self._finished(len(jobs))
                    continue
                self.stats["dispatches"] += 1
                self.stats["frames"] += len(jobs)
                # blocks only when max_inflight chunks are unresolved
                self._resolve_q.put((packed, ready, jobs, dispatch_ts))
        # reject anything that slipped in after the drain loop exited
        with self._cond:
            for slot in self._slots:
                while slot.pending:
                    fut, _, _, _ = slot.pending.popleft()
                    fut.set_exception(RuntimeError("service shut down"))
                    self._outstanding -= 1
            self._cond.notify_all()
        self._resolve_q.put(None)  # resolver drains FIFO, then stops

    @staticmethod
    def _pack_outputs(outs):
        """Fuse the 5 output tensors into one ``(S, K, T, 9)`` f32 tensor
        (one readback). Track ids ride as two 16-bit lanes (lo, hi): one f32
        lane is exact only below 2^24, and a long-lived service's ids grow
        without end; two lanes are exact for the whole 32-bit range. The bit
        operations run in int64."""
        tlbr, ids, cls, conf, mask = outs
        ids64 = ids.to(torch.int64) & 0xFFFFFFFF
        return torch.cat(
            [tlbr.to(torch.float32),
             (ids64 & 0xFFFF).to(torch.float32)[..., None],
             (ids64 >> 16).to(torch.float32)[..., None],
             cls.to(torch.float32)[..., None],
             conf.to(torch.float32)[..., None],
             mask.to(torch.float32)[..., None]], dim=-1)

    @staticmethod
    def _readback(packed):
        """Start the packed tensor's copy to the host: ``(host tensor,
        event)``. On a GPU the copy goes without blocking into pinned memory
        and the event completes with it; on the CPU the tensor is already
        there and the event is None."""
        if packed.device.type != "cuda":
            return packed, None
        host = torch.empty(packed.shape, dtype=packed.dtype,
                           pin_memory=True)
        host.copy_(packed, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return host, ready

    def _run_resolver(self):
        """Readback loop: FIFO, off the dispatch path."""
        with torch.no_grad():
            while True:
                item = self._resolve_q.get()
                if item is None:
                    break
                self._resolve(item)
