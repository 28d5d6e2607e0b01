"""A traced sub-window: ``torch.profiler`` over a few dispatches, reduced to
device busy time, time by device operation, kernel launches by name, and
the longest idle gaps with what the host was doing in them.

The profiler records device activity only (with the CUDA runtime calls
that come with it), not the host's operators, whose recording slowed the
step; the harness's host phases are kept on the host clock instead
(:meth:`Tracer.phase`). An idle gap is labelled by the innermost phase
open at its middle, else by the longest runtime call open there. Tracing
a captured graph's kernels still widens the gaps between them, more the
more nodes it has: the run's notes give the sub-window's time a dispatch
beside the whole window's.
"""

from __future__ import annotations

import time

import torch


class Tracer:
    """Start with :meth:`start` and end with :meth:`stop` (the driver calls
    both at dispatch boundaries); :attr:`summary` holds the reduction."""

    def __init__(self):
        self.prof = None
        self.summary = None
        self.t0 = self.t1 = None
        self.phases = []

    @property
    def active(self) -> bool:
        return self.prof is not None

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CUDA]
                       if torch.cuda.is_available()
                       else [ProfilerActivity.CPU])

    def warm(self):
        """Start and stop the profiler once, in set-up: its first start
        (CUPTI's initialisation) takes seconds that would otherwise fall
        into the window."""
        prof = self._profile()
        prof.start()
        torch.zeros(1, device="cuda" if torch.cuda.is_available()
                    else "cpu").add_(1)
        prof.stop()

    def start(self):
        self.p0 = time.perf_counter()
        self.prof = self._profile()
        self.prof.start()
        if torch.cuda.is_available():
            # the work queued before the sub-window runs out here, so the
            # window holds only its own dispatches' device time
            torch.cuda.synchronize()
        self.phases = []
        self.t0 = time.time_ns()

    def phase(self, name: str, t0_ns: int, t1_ns: int):
        """Keep a host phase of the harness that ran while tracing."""
        if self.prof is not None:
            self.phases.append((t0_ns, t1_ns, f"portbench.{name}"))

    def stop(self, **counts):
        """End the traced sub-window; ``counts`` (dispatches, frames) are
        kept with the summary. ``p0``..``p1`` (host clock) spans all that
        tracing costs the run: the profiler's start, the sub-window and the
        reduction."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.stop()
        self.summary = summarize(self.prof, self.t0, self.t1, self.phases)
        self.summary.update(counts)
        self.prof = None
        self.p1 = time.perf_counter()


def _events(prof):
    """``(name, is_device, start_ns, end_ns)`` of every traced event."""
    try:
        raw = prof.profiler.kineto_results.events()
        return [(e.name(), e.device_type() != torch.autograd.DeviceType.CPU,
                 e.start_ns(), e.start_ns() + e.duration_ns()) for e in raw]
    except AttributeError:   # an older profiler: microseconds from its start
        base = prof.profiler.kineto_results.trace_start_ns()
        return [(e.name, e.device_type != torch.autograd.DeviceType.CPU,
                 base + int(e.time_range.start * 1e3),
                 base + int(e.time_range.end * 1e3))
                for e in prof.events()]


def summarize(prof, t0: int, t1: int, phases=()) -> dict:
    """The reduction of a traced sub-window ``[t0, t1]`` (ns). The window
    opens at its first device operation: the device is idle from the
    drain at :meth:`Tracer.start` until then, which is not the program's
    idle time."""
    events = _events(prof)
    dev = sorted((s, e, n) for n, d, s, e in events if d and e > s)
    if dev:
        t0 = max(t0, min(dev[0][0], t1))
    host = [(s, e, n) for n, d, s, e in events if not d and e > s]
    host += list(phases)
    by_name, launches = {}, {}
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, e, n in dev:
        s_c, e_c = max(s, t0), min(e, t1)
        if e_c > s_c:
            by_name[n] = by_name.get(n, 0) + (e_c - s_c)
        launches[n] = launches.get(n, 0) + 1
        if cur_e is None:
            if s > t0:
                gaps.append((t0, s))
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += max(0, min(cur_e, t1) - max(cur_s, t0))
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += max(0, min(cur_e, t1) - max(cur_s, t0))
        if cur_e < t1:
            gaps.append((cur_e, t1))
    else:
        gaps.append((t0, t1))
    gaps = sorted(((b - a, a, b) for a, b in gaps if b > a), reverse=True)
    labelled = []
    for dur, a, b in gaps[:10]:
        labelled.append([_host_label(host, (a + b) // 2), dur * 1e-9])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"window_s": (t1 - t0) * 1e-9, "busy_s": busy * 1e-9,
            "device_ops": [[n, v * 1e-9] for n, v in ops[:10]],
            "time_by_name_s": {n: v * 1e-9 for n, v in by_name.items()},
            "launches_by_name": launches, "idle_gaps": labelled}


def _host_label(host, t: int) -> str:
    ours = [(e - s, n) for s, e, n in host
            if s <= t <= e and n.startswith("portbench.")]
    if ours:
        return min(ours)[1]
    other = [(e - s, n) for s, e, n in host if s <= t <= e]
    return max(other)[1] if other else "no host operation traced"
