"""The letterbox kernel's share of its roofline in the traced sub-window:
the bytes its launches must move (each needed source row read once, the
bf16 output written once) over the HBM peak, against its device time."""

from portbench.yardstick import kernels


def read(ctx):
    tr = ctx.trace_summary
    if tr is None:
        return None
    t = sum(v for n, v in tr["time_by_name_s"].items()
            if kernels.kernel_of(n) == "letterbox")
    launches = sum(v for n, v in tr["launches_by_name"].items()
                   if kernels.kernel_of(n) == "letterbox")
    if not t or not launches:
        return None
    per = ctx.counters["chunk"] * ctx.counters["streams"]
    nbytes = launches * kernels.letterbox_bytes(
        ctx.traffic["frame_hw"], ctx.config["pipeline"]["input_hw"], per)
    return 100.0 * nbytes / kernels.PEAK_HBM_BYTES / t
