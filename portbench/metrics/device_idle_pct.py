"""The share of the traced sub-window with no operation on the device
(``torch.profiler``'s device activity)."""


def read(ctx):
    tr = ctx.trace_summary
    if tr is None or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
