"""``multistream_chunks``' traffic with the program's stage timer: in a
``--trace 1`` run a ``CudaStageTimer`` goes on the pipeline once set-up has
captured the plain step; the stamped step is captured and warmed in
set-up too (one more dispatch of blank frames, then every stream afresh),
so the window compiles nothing. The stage totals a dispatch and the
detections a frame that reached the tracker join the counters, and the
graph's nodes are the stamped step's alone (the step the window replays;
its stamps are counted apart by the program)."""

from __future__ import annotations

import numpy as np

from . import common, multistream_chunks


class Driver(multistream_chunks.Driver):
    def setup(self):
        super().setup()
        self.timer = None
        if not self.ctx.trace:
            return
        from aicamera_tpu_torch.runtime.profiler import CudaStageTimer
        self.timer = CudaStageTimer()
        self.pipe.stage_timer = self.timer
        hw = tuple(self.t["frame_hw"])
        self.pipe.step_chunk(np.zeros((self.s, self.k, *hw, 3), np.uint8))
        self.pipe.settle()
        common.sync(self.ctx.device)
        for c in range(self.s):
            self.pipe.reset_stream(c)
        self.timer.clear()

    def counters(self) -> dict:
        out = super().counters()
        if self.timer is not None:
            steps = [st for key, st in self.pipe._engine._steps.items()
                     if key[-1] == "stamped"]
            out["graph_nodes"] = sum((st.engine.graph_nodes() or 0)
                                     for st in steps) or None
            s = self.timer.summary()
            out["stage_ms"] = dict(s["stage_ms"])
            out["dets_per_frame"] = s["dets_per_frame"]
        return out
