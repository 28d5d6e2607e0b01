"""S cameras, closed loop, through ``MultiStreamPipeline.step_chunk``.

Each camera's clip is rendered in set-up and played forward and back from
an offset of its own; every dispatch's frames are one contiguous, pageable
``(S, K, H, W, 3)`` uint8 array, built in set-up. One dispatch is in
flight: after each call the harness starts the copy of its track outputs
to pinned host memory, then reads the dispatch before (one behind). The
window counts the stream-frames whose tracks reached the host before it
closed.
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
        self.outs = []
        self.arrivals = []

    def setup(self):
        ctx, t = self.ctx, self.t
        from aicamera_tpu_torch.parallel import MultiStreamPipeline
        cfg = ctx.config
        hw = tuple(t["frame_hw"])
        s, k = int(t["streams"]), int(t["chunk"])
        self.s, self.k = s, k
        self.pipe = MultiStreamPipeline(
            n_streams=s, frame_hw=hw, yolo_weights=ctx.weight_path("yolo"),
            reid_weights=ctx.weight_path("reid"), device=ctx.device,
            **common.pipeline_kwargs(cfg, ctx.family))
        n = int(t["clip_frames"])
        order = common.pingpong(n)
        period = len(order)
        if period % k:
            raise ValueError("the played clip must hold whole chunks")
        # the seed deals the fixed worlds to the cameras and picks each
        # camera's starting chunk
        rng = common.traffic_rng(ctx.seed)
        worlds = rng.permutation(s)
        self.clips = {c: common.render_clip(t["world"], hw, n,
                                            int(worlds[c]), ctx.device)
                      for c in range(s)}
        self.offsets = [int(o) * k for o in rng.integers(period // k,
                                                         size=s)]
        self.period = period // k
        self.order = order
        self.batches = []
        for d in range(self.period):
            arr = np.empty((s, k, *hw, 3), np.uint8)
            for c in range(s):
                idx = order[(d * k + self.offsets[c] + np.arange(k))
                            % period]
                arr[c] = self.clips[c][idx]
            self.batches.append(arr)
        # capture the cell's one step, then start every stream afresh
        self.pipe.step_chunk(np.zeros((s, k, *hw, 3), np.uint8))
        common.sync(ctx.device)
        for c in range(s):
            self.pipe.reset_stream(c)
        cuda = torch.device(ctx.device).type == "cuda"
        self._pinned = cuda

    def _start_readback(self, outs):
        if not self._pinned:
            return [o.clone() for o in outs], None
        host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                for o in outs]
        for h, o in zip(host, outs):
            h.copy_(o, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def _finish(self, pending):
        host, ev = pending
        if ev is not None:
            ev.synchronize()
        self.outs.append([h.numpy().copy() for h in host])
        self.arrivals.append(time.perf_counter())

    def window(self):
        ctx = self.ctx
        phases, tracer = ctx.phases, ctx.tracer
        skip, n_trace = (int(v) for v in self.t["trace_chunks"])
        cuda = torch.device(ctx.device).type == "cuda"
        events = []
        pending = None
        d = 0
        t0 = time.perf_counter()
        t_end = t0 + ctx.seconds
        while time.perf_counter() < t_end:
            if ctx.trace and d == skip:
                tracer.start()
            if cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e0.record()
            with phases("dispatch", keep=True):
                outs = self.pipe.step_chunk(self.batches[d % self.period])
            if cuda:
                e1 = torch.cuda.Event(enable_timing=True)
                e1.record()
                events.append([e0, e1])
            with phases("readback"):
                nxt = self._start_readback(outs)
                if pending is not None:
                    self._finish(pending)
            pending = nxt
            d += 1
            if ctx.trace and d == skip + n_trace and tracer.active:
                tracer.stop(dispatches=n_trace,
                            frames=n_trace * self.s * self.k)
        if pending is not None:
            self._finish(pending)
        if tracer.active:
            tracer.stop(dispatches=d - skip,
                        frames=(d - skip) * self.s * self.k)
        ctx.window_s = t_end - t0
        ctx.window = (t0, t_end)
        ctx.arrivals = [(a, self.s * self.k) for a in self.arrivals]
        per = self.s * self.k
        ctx.frames_done = per * sum(a < t_end for a in self.arrivals)
        ctx.frames_compared = per * len(self.outs)
        ctx.attempted = ctx.frames_compared
        ctx.failed = 0
        ctx.dispatches = d
        ctx.events = events

    def drain(self):
        common.sync(self.ctx.device)

    def counters(self) -> dict:
        eng = self.pipe._engine
        self.pipe.settle()
        steps = list(eng._steps.values())
        return {"graph_nodes": sum((s.engine.graph_nodes() or 0)
                                   for s in steps) or None,
                "reid_buckets": dict(eng.reid_buckets),
                "chunk": self.k, "streams": self.s}

    def outputs(self) -> dict:
        tracks = [[] for _ in range(self.s)]
        streams = [[] for _ in range(self.s)]
        for d, (tlbr, ids, cls, conf, mask) in enumerate(self.outs):
            for c in range(self.s):
                for j in range(self.k):
                    tracks[c].append(common.tracks_from_arrays(
                        tlbr[c, j], ids[c, j], cls[c, j], conf[c, j],
                        mask[c, j].astype(bool)))
                    pos = (d * self.k + self.offsets[c] + j) \
                        % len(self.order)
                    streams[c].append((c, int(self.order[pos])))
        return {"tracks": tracks, "dets": None, "streams": streams,
                "clips": self.clips}

    def release(self):
        self.pipe = None
        self.batches = None

