"""Per-stage timing on the host.

The port of the ``StageTimer`` of ``aicamera_tpu/runtime/profiler.py``: named
wall-time samples with mean and percentile summaries for host-visible stages
(the result loop, checkpoint writes), which ``cli.py --profile`` prints.
The stages on the GPU stream are timed by CUDA events instead
(``runtime.pipeline.CudaStageTimer``).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List


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
