"""Per-stage timing, device traces and cost estimates.

The port of ``aicamera_tpu/runtime/profiler.py``:

- :class:`StageTimer`: named wall-time samples with mean and percentile
  summaries for host-visible stages (the result loop, checkpoint writes),
  which ``cli.py --profile`` prints.
- :class:`CudaStageTimer`: where a pipeline's chunk goes: the device time of
  each stage of the captured chunk step, from timestamps the graph writes
  itself, and the host's spans around each dispatch (also exported by
  ``runtime.pipeline``).
- :func:`trace`: ``torch.profiler`` around a block, written as a
  Chrome-trace JSON that Perfetto opens (JAX: ``jax.profiler``).
- :func:`device_cost`: the FLOPs and bytes of an engine's function, the
  keys XLA's cost analysis returns, counted op by op under a
  ``TorchDispatchMode`` (:class:`CostMode`). It is what a bound on an
  engine's time reads.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry


class StageTimer:
    """Accumulates wall-time samples per named stage."""

    def __init__(self):
        self._samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float):
        self._samples[name].append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self._samples.items():
            xs_sorted = sorted(xs)
            n = len(xs_sorted)
            out[name] = {
                "count": n,
                "mean_ms": 1e3 * sum(xs) / n,
                "p50_ms": 1e3 * xs_sorted[n // 2],
                "p95_ms": 1e3 * xs_sorted[min(n - 1, int(n * 0.95))],
                "total_s": sum(xs),
            }
        return out

    def report(self) -> str:
        lines = [f"{'stage':<24} {'count':>6} {'mean':>9} {'p50':>9} "
                 f"{'p95':>9}"]
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name:<24} {s['count']:>6d} {s['mean_ms']:>8.2f}m "
                f"{s['p50_ms']:>8.2f}m {s['p95_ms']:>8.2f}m")
        return "\n".join(lines)


class CudaStageTimer:
    """Where a pipeline's chunks go: the device time of each stage, and the
    host's spans around each dispatch. Attach one to
    ``TrackingPipeline.stage_timer`` (or a ``MultiStreamPipeline``'s) before
    the chunk step is first dispatched; without one the pipeline checks
    ``None`` once a boundary and does nothing else.

    - The captured step (one CUDA-graph replay) stamps its stage boundaries
      with the device's own clock (``runtime.branches.stamp``, a node of the
      graph): its entry, then ``gmc`` (when on), ``letterbox``, ``yolo``,
      ``nms`` (decode, NMS, compaction, synthetic load), ``crops_reid``
      (after the ReID bucket's switch) and ``tracker`` (after the scan's
      conds, before the pack); an RT-DETR step stamps ``backbone``,
      ``encoder``, ``decoder`` (the query selection and the six layers) and
      ``post`` (the NMS-free post-process, compaction, synthetic load) in
      place of ``yolo`` and ``nms``. A stage's time runs from the boundary
      before it. The stamps, the chunk's real crop count and its
      detections that reach the tracker come home with the chunk's
      decisions, so they add no read and no wait:
      :meth:`arrive` takes them when the chunk is read back. A stamped step
      is a capture of its own; without a timer the capture holds no stamp.
    - The eager step records a CUDA event at each boundary (:meth:`start`,
      :meth:`mark`); :meth:`finish` waits for the last one (a sync a chunk)
      and adds the intervals. The training step marks its own stages.
    - Host spans (:meth:`open`, :meth:`close`) on ``time.time_ns()``:
      ``dispatch`` (the parent, in ``_replay_chunk``), ``upload.ring_wait``
      and ``upload.copy``, ``replay`` (the copy to the device queued and the
      graph launched), ``readback.wait`` (the wait for a chunk's outputs),
      ``readback.count`` (their unpacking and the counting of its
      decisions, its stamps among them) and ``emit`` (their formatting),
      each kept as ``(name, t0_ns, t1_ns, dispatch id, parent)``; a
      readback's spans carry the id of the chunk read. ``on_span(name,
      t0_ns, t1_ns)`` receives each as it closes.

    Kept in constant memory: ``totals`` (device ms by stage over
    ``chunks``), ``span_totals`` (host ms and count by span),
    ``gap_totals`` (ms of the device's gap from a replay's last stamp to the
    next one's first, by the innermost host span open at its middle, or
    ``caller`` where none was: the rule of ``portbench/yardstick/
    trace.py``), ``crops`` (real crops, crop slots computed), ``dets``
    (detections that reached the tracker, frames),
    ``calibrations``, the last ``KEEP`` dispatches' records
    (:meth:`records`) and the last 1,024 spans (:meth:`spans`).
    :meth:`calibrate` puts the device's clock on the host's."""

    STAGES = ("gmc", "letterbox", "yolo", "nms", "crops_reid", "tracker",
              "backbone", "encoder", "decoder", "post")
    KEEP = 4096

    def __init__(self, stages=STAGES, on_span=None):
        self.totals = dict.fromkeys(stages, 0.0)
        self.chunks = 0
        self.on_span = on_span
        self.span_totals = {}     # name -> [ms, count]
        self.gap_totals = {}      # host span -> ms
        self.gaps = 0
        self.crops = [0, 0]       # real crops, crop slots computed
        self.dets = [0, 0]        # detections to the tracker, frames
        #: ``(host ns, offset ns, error ns)``: device clock + offset = host
        #: clock, within the error (the first and the last 15 kept)
        self.calibrations = []
        self._records = collections.OrderedDict()
        self._recent = collections.deque(maxlen=1024)
        self._stacks = {}         # thread -> open spans
        self._next = 0
        self._last = None         # (dispatch id, last stamp) of the latest
        self._events = []
        self._probe = None
        self._lock = threading.Lock()

    # --- the eager step: CUDA events -----------------------------------------

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

    # --- host spans ----------------------------------------------------------

    def open(self, name: str, dispatch: int | None = None) -> int | None:
        """Open span ``name`` on this thread, inside the span open there.
        ``dispatch``: the id it carries (default: the enclosing span's);
        ``"dispatch"`` takes a new id, starts that dispatch's record and
        returns the id."""
        stack = self._stacks.setdefault(threading.get_ident(), [])
        if name == "dispatch":
            stack.clear()   # the outermost span: drop any left open
        parent = stack[-1] if stack else None
        if name == "dispatch":
            with self._lock:
                dispatch = self._next
                self._next += 1
                self._records[dispatch] = dict(
                    id=dispatch, t0=None, t1=None, spans={}, stages=None,
                    first=None, last=None, gap=None, gap_at=None, crops=0,
                    slots=0, dets=0, frames=0)
                while len(self._records) > self.KEEP:
                    self._records.popitem(last=False)
        elif dispatch is None and parent is not None:
            dispatch = parent[2]
        stack.append((name, time.time_ns(), dispatch,
                      None if parent is None else parent[0]))
        return dispatch

    def close(self, name: str):
        """Close this thread's span ``name`` (and any left open inside it,
        unrecorded: an exception passed through them)."""
        t1 = time.time_ns()
        stack = self._stacks.get(threading.get_ident(), [])
        while stack:
            span = stack.pop()
            if span[0] == name:
                break
        else:
            return
        _, t0, dispatch, parent = span
        ms = (t1 - t0) * 1e-6
        with self._lock:
            total = self.span_totals.setdefault(name, [0.0, 0])
            total[0] += ms
            total[1] += 1
            rec = self._records.get(dispatch)
            if rec is not None:
                if name == "dispatch":
                    rec["t0"], rec["t1"] = t0, t1
                rec["spans"][name] = rec["spans"].get(name, 0.0) + ms
            self._recent.append((name, t0, t1, dispatch, parent))
        if self.on_span is not None:
            self.on_span(name, t0, t1)

    def spans(self) -> list:
        """The last closed spans, ``(name, t0_ns, t1_ns, dispatch id,
        parent)``, oldest first."""
        with self._lock:
            return list(self._recent)

    # --- the captured step: stamps -------------------------------------------

    def arrive(self, dispatch: int | None, names, stamps, crops: int = 0,
               slots: int = 0, dets: int = 0, frames: int = 0):
        """A captured chunk's stamps, read back with its decisions:
        ``stamps[i]`` (ns, the device's clock) at boundary ``names[i]``,
        ``names[0]`` the step's entry; ``crops``, its real crops, and
        ``slots``, the crop slots its ReID bucket computed (0 without
        ReID); ``dets``, its detections that reached the tracker, over
        ``frames`` frames."""
        stamps = [int(t) for t in stamps[:len(names)]]
        stages = {name: (b - a) * 1e-6 for name, a, b
                  in zip(names[1:], stamps, stamps[1:])}
        with self._lock:
            off = self.calibrations[-1][1] if self.calibrations else 0
            for name, ms in stages.items():
                self.totals[name] = self.totals.get(name, 0.0) + ms
            self.chunks += 1
            self.crops[0] += crops
            self.crops[1] += slots
            self.dets[0] += dets
            self.dets[1] += frames
            gap = where = None
            if dispatch is not None and self._last is not None \
                    and self._last[0] == dispatch - 1:
                gap = (stamps[0] - self._last[1]) * 1e-6
                where = self._label(off + (stamps[0] + self._last[1]) // 2)
                self.gap_totals[where] = self.gap_totals.get(where, 0.0) + gap
                self.gaps += 1
            self._last = (dispatch, stamps[-1])
            rec = self._records.get(dispatch)
            if rec is not None:
                rec.update(stages=stages, first=stamps[0] + off,
                           last=stamps[-1] + off, gap=gap, gap_at=where,
                           crops=crops, slots=slots, dets=dets,
                           frames=frames)

    def _label(self, t: int) -> str:
        """The innermost (shortest) span open at host time ``t``, closed or
        still open, else ``caller``. Spans are kept in the order they
        closed, so the search stops at the first that closed before ``t``
        (a few spans back, not the whole ring)."""
        now = time.time_ns()
        spans = []
        for name, t0, t1, _, _ in reversed(self._recent):
            if t1 < t:
                break
            if t0 <= t:
                spans.append((t1 - t0, name))
        for stack in list(self._stacks.values()):
            spans += [(now - t0, name) for name, t0, _, _ in list(stack)
                      if t0 <= t]
        return min(spans)[1] if spans else "caller"

    def calibrate(self, device):
        """Put the device's clock on the host's: launch a stamp,
        synchronize, and take the midpoint of the host clock read before the
        launch and after the synchronize (the shortest of five round trips).
        Keeps ``(host ns, offset, error)``, the error half that round trip.
        On the CPU the stamps are the host's clock: offset and error 0."""
        device = torch.device(device)
        if device.type != "cuda":
            cal = (time.time_ns(), 0, 0)
        else:
            from . import branches
            if self._probe is None:
                self._probe = torch.zeros(1, dtype=torch.int64, device=device)
            best = None
            for _ in range(5):
                torch.cuda.synchronize(device)
                t0 = time.time_ns()
                branches.stamp(self._probe, 0)
                torch.cuda.synchronize(device)
                rt = time.time_ns() - t0
                if best is None or rt < best[0]:
                    best = (rt, t0, int(self._probe[0]))
            rt, t0, g = best
            cal = (t0 + rt // 2, t0 + rt // 2 - g, rt // 2)
        with self._lock:
            self.calibrations.append(cal)
            if len(self.calibrations) > 16:
                del self.calibrations[1]

    def clear(self):
        """Forget what was timed (a warm-up's chunks, say); the
        calibrations stay."""
        with self._lock:
            self.totals = dict.fromkeys(self.totals, 0.0)
            self.chunks = self.gaps = 0
            self.span_totals, self.gap_totals = {}, {}
            self.crops = [0, 0]
            self.dets = [0, 0]
            self._records.clear()
            self._recent.clear()
            self._last = None

    # --- reading -------------------------------------------------------------

    def records(self) -> list:
        """The last dispatches' records, oldest first: ``id``, the
        ``dispatch`` span's ``t0`` and ``t1`` (host ns), ``spans`` (host ms
        by span), ``stages`` (device ms by stage), ``first`` and ``last``
        stamp (host ns, through the latest calibration), ``gap`` (device ms
        from the dispatch before's last stamp, where that one came back
        just before) and ``gap_at`` (the host span open at its middle),
        ``crops`` and ``slots``, ``dets`` and ``frames``. A dispatch not
        read back yet has ``stages`` None."""
        with self._lock:
            return [dict(r, spans=dict(r["spans"])) for r in
                    self._records.values()]

    def summary(self) -> dict:
        """Means a chunk over everything timed: device ms by stage, host ms
        by span (over the dispatches), gap ms by the host span open at its
        middle, the share of computed crop slots holding a real crop, and
        the detections a frame that reached the tracker, and the clock's
        calibration (offset, error, drift between the first and the
        last)."""
        with self._lock:
            n, gaps = self.chunks, self.gaps
            d = self.span_totals.get("dispatch", [0.0, 0])[1]
            out = {"chunks": n, "dispatches": d, "gaps": gaps,
                   "stage_ms": {k: v / n for k, v in self.totals.items()}
                   if n else {},
                   "span_ms": {k: ms / d for k, (ms, _)
                               in self.span_totals.items()} if d else {},
                   "gap_ms": {k: v / gaps for k, v in
                              sorted(self.gap_totals.items(),
                                     key=lambda kv: -kv[1])} if gaps else {},
                   "crop_use": self.crops[0] / self.crops[1]
                   if self.crops[1] else None,
                   "dets_per_frame": self.dets[0] / self.dets[1]
                   if self.dets[1] else None}
            cal = list(self.calibrations)
        if cal:
            out["clock"] = {"offset_ns": cal[-1][1], "error_ns": cal[-1][2],
                            "drift_ns": cal[-1][1] - cal[0][1],
                            "over_s": (cal[-1][0] - cal[0][0]) * 1e-9}
        return out

    def report(self) -> str:
        """:meth:`summary` as lines of text (``cli.py --profile``)."""
        s = self.summary()
        lines = []
        if s["stage_ms"]:
            ms = {k: v for k, v in s["stage_ms"].items() if v}
            lines.append(f"stage ms a chunk (the step's stamps, "
                         f"{s['chunks']} chunks): "
                         + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
                         + f"; in all {sum(ms.values()):.3f}")
        if s["span_ms"]:
            lines.append(f"host span ms a chunk ({s['dispatches']} "
                         f"dispatches): "
                         + ", ".join(f"{k} {v:.3f}"
                                     for k, v in s["span_ms"].items()))
        if s["gap_ms"]:
            lines.append(
                f"step gap ms a chunk (a replay's last stamp to the next "
                f"one's first, {s['gaps']} gaps), by the host span open at "
                f"its middle: "
                + ", ".join(f"{k} {v:.3f}" for k, v in s["gap_ms"].items())
                + f"; in all {sum(s['gap_ms'].values()):.3f}")
        if s["crop_use"] is not None:
            lines.append(f"ReID crop slots holding a real crop: "
                         f"{100 * s['crop_use']:.1f}% ({self.crops[0]} of "
                         f"{self.crops[1]})")
        if s["dets_per_frame"] is not None:
            lines.append(f"detections a frame to the tracker: "
                         f"{s['dets_per_frame']:.3f}")
        if "clock" in s:
            c = s["clock"]
            lines.append(f"stamp clock: host - stamp {c['offset_ns']} ns "
                         f"+- {c['error_ns'] * 1e-3:.1f} us, drift "
                         f"{c['drift_ns'] * 1e-3:.1f} us over "
                         f"{c['over_s']:.1f} s")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str = "aicamera_trace"):
    """Profile the block with ``torch.profiler``: CPU activity, plus CUDA
    activity when a GPU is present. Writes ``trace_<pid>_<ns>.json``, a
    Chrome trace that Perfetto opens, into ``log_dir`` when the block ends,
    and yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(
            str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))


# Ops that move no bytes: views of their input, and allocations.
_NO_TRAFFIC = ("empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "lift_fresh", "detach", "alias")


def _tensor_bytes(tree) -> int:
    return sum(t.nbytes for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class CostMode(TorchDispatchMode):
    """Counts the FLOPs and bytes of every op dispatched inside it.

    FLOPs use ``torch.utils.flop_counter``'s formulas (convolutions and
    matrix products: 2 per multiply-add), plus ``_int_mm`` (2 per int8
    multiply-add; other ops count no FLOPs). Bytes are each op's input and
    output tensor bytes; views and allocations count none. A kernel that
    the dispatcher cannot see (a ``ctypes`` launch) reports its own bytes
    through :meth:`opaque`, which also hides the ops it runs inside."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.opaque_bytes: Dict[str, int] = defaultdict(int)
        self._hidden = 0

    @contextlib.contextmanager
    def opaque(self, name: str, nbytes: int):
        self.bytes += nbytes
        self.opaque_bytes[name] += nbytes
        self._hidden += 1
        try:
            yield
        finally:
            self._hidden -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._hidden:
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        elif packet is torch.ops.aten._int_mm:
            (m, k), n = args[0].shape, args[1].shape[1]
            self.flops += 2 * m * k * n
        if not (func.is_view or packet.__name__ in _NO_TRAFFIC):
            self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


def device_cost(engine) -> dict:
    """``{"flops", "bytes accessed"}`` of one call of ``engine``'s function
    on its example inputs (``runtime.engine.CUDAGraphEngine``; JAX: XLA's
    cost analysis of the compiled function). Counted by running the function
    once, eagerly, under :class:`CostMode`: the count is the work of these
    inputs, a loop that ends early included."""
    mode = CostMode()
    with torch.no_grad(), mode:
        engine.run_eager()
    return {"flops": float(mode.flops), "bytes accessed": float(mode.bytes)}
