"""Per-stage timing, device traces and cost estimates.

The port of ``aicamera_tpu/runtime/profiler.py``:

- :class:`StageTimer`: named wall-time samples with mean and percentile
  summaries for host-visible stages (the result loop, checkpoint writes),
  which ``cli.py --profile`` prints. The stages on the GPU stream are timed
  by CUDA events instead (``runtime.pipeline.CudaStageTimer``).
- :func:`trace`: ``torch.profiler`` around a block, written as a
  Chrome-trace JSON that Perfetto opens (JAX: ``jax.profiler``).
- :func:`device_cost`: the FLOPs and bytes of an engine's function, the
  keys XLA's cost analysis returns, counted op by op under a
  ``TorchDispatchMode`` (:class:`CostMode`). It is what a bound on an
  engine's time reads.
"""

from __future__ import annotations

import contextlib
import os
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
