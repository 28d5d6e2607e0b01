"""Device milliseconds a stream-frame of the program's hand kernels
(letterbox, NMS, assignment, ORU, branch) in the traced sub-window."""

from portbench.yardstick import kernels


def read(ctx):
    tr = ctx.trace_summary
    if tr is None or not tr.get("frames"):
        return None
    t = sum(v for n, v in tr["time_by_name_s"].items()
            if kernels.kernel_of(n) is not None)
    return 1e3 * t / tr["frames"] if t else None
