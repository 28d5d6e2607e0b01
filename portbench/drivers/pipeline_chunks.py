"""One camera, closed loop, through ``TrackingPipeline.process_chunks``.

The camera's clip is rendered in set-up and played forward and back; each
chunk the program is handed is a contiguous, pageable ``(K, H, W, 3)``
uint8 view of it, as a decoder hands frames. The program dispatches a chunk
and yields the results of the one before, so one chunk is always in
flight. The window counts the frames whose results reached the host before
it closed; the chunk still in flight at the close is compared with the
rest.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import common


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic
        self.results = []
        self.arrivals = []

    def setup(self):
        ctx, t = self.ctx, self.t
        from aicamera_tpu_torch import TrackingPipeline
        cfg = ctx.config
        hw = tuple(t["frame_hw"])
        self.k = int(t["chunk"])
        quant = {"yolo_quant": "int8", "reid_quant": "int8"} \
            if ctx.control == "program_int8" else {}
        self.pipe = TrackingPipeline(
            yolo_weights=ctx.weight_path("yolo"),
            reid_weights=ctx.weight_path("reid"), chunk_size=self.k,
            device=ctx.device, **common.pipeline_kwargs(cfg, ctx.family),
            **quant)
        n = int(t["clip_frames"])
        clip = common.render_clip(t["world"], hw, n, 0, ctx.device)
        self.clips = {0: clip}
        order = common.pingpong(n)
        if len(order) % self.k:
            raise ValueError("the played clip must hold whole chunks")
        # the seed's starting chunk; every chunk a contiguous view of one
        # buffer in played order
        start = int(common.traffic_rng(ctx.seed).integers(
            len(order) // self.k)) * self.k
        self.order = np.roll(order, -start)
        self.played = np.ascontiguousarray(clip[self.order])
        self.pipe.warm_up(hw, self.k)

    def window(self):
        ctx, k = self.ctx, self.k
        phases, tracer = ctx.phases, ctx.tracer
        period = len(self.order) // k
        skip, n_trace = (int(v) for v in self.t["trace_chunks"])
        events = []
        t_end = [None]
        state = {"i": 0}
        cuda = torch.device(ctx.device).type == "cuda"

        def chunks():
            i = 0
            while time.perf_counter() < t_end[0]:
                if ctx.trace and i == skip:
                    tracer.start()
                if cuda:
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    events.append([ev, None])
                lo = (i % period) * k
                t0, n0 = time.perf_counter(), time.time_ns()
                yield self.played[lo:lo + k]
                phases.spans.setdefault("dispatch", []).append(
                    time.perf_counter() - t0)
                tracer.phase("dispatch", n0, time.time_ns())
                if events and events[-1][1] is None:
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    events[-1][1] = ev
                i += 1
                state["i"] = i
                if ctx.trace and i == skip + n_trace and tracer.active:
                    tracer.stop(dispatches=n_trace, frames=n_trace * k)

        t0 = time.perf_counter()
        t_end[0] = t0 + ctx.seconds
        it = self.pipe.process_chunks(chunks(), k)
        while True:
            with phases("program"):
                r = next(it, None)
            if r is None:
                break
            self.results.append(r)
            self.arrivals.append(time.perf_counter())
        if tracer.active:
            tracer.stop(dispatches=state["i"] - skip,
                        frames=(state["i"] - skip) * k)
        ctx.window_s = t_end[0] - t0
        ctx.window = (t0, t_end[0])
        ctx.arrivals = [(a, 1) for a in self.arrivals]
        ctx.frames_done = sum(a < t_end[0] for a in self.arrivals)
        ctx.frames_compared = len(self.results)
        ctx.attempted = len(self.results)
        ctx.failed = 0
        ctx.dispatches = state["i"]
        ctx.events = [e for e in events if e[1] is not None]

    def drain(self):
        common.sync(self.ctx.device)   # results are all in already

    def counters(self) -> dict:
        self.pipe.settle()
        steps = list(self.pipe._steps.values())
        return {"graph_nodes": sum((s.engine.graph_nodes() or 0)
                                   for s in steps) or None,
                "reid_buckets": dict(self.pipe.reid_buckets),
                "chunk": self.k, "streams": 1}

    def outputs(self) -> dict:
        tracks = [[common.tracks_by_id(r.tracks) for r in self.results]]
        dets = [[(r.det_boxes, r.det_scores, r.det_labels)
                 for r in self.results]]
        n = len(self.order)
        streams = [[(0, int(self.order[r.frame_index % n]))
                    for r in self.results]]
        return {"tracks": tracks, "dets": dets, "streams": streams,
                "clips": self.clips}

    def release(self):
        self.pipe = None
        self.played = None
