"""The model FLOPs of the tracked frames over the seconds they took, as a
share of the card's bf16 peak: the detector for every frame (its family's
count, ``portbench/families``), and the ReID net for every crop slot of the
bucket each chunk ran (FLOPs from layer shapes, ``yardstick/arch.py``).
Taken over the window less all that tracing took (the profiler's start, its
sub-window, where it slows the program, and its reduction)."""

from portbench.yardstick import arch, kernels


def read(ctx):
    if not ctx.arrivals:
        return None
    t0, t1 = ctx.window
    seconds = t1 - t0
    lo = hi = None
    if ctx.tracer.t0 is not None:
        lo, hi = ctx.tracer.p0, ctx.tracer.p1
        seconds -= max(0.0, min(hi, t1) - lo)
    frames = sum(n for a, n in ctx.arrivals
                 if a < t1 and (lo is None or not lo <= a <= hi))
    if seconds <= 0 or not frames:
        return None
    cfg = ctx.config
    flops = frames * ctx.family.flops(cfg)
    buckets = ctx.counters.get("reid_buckets") or {}
    chunks = sum(buckets.values())
    if chunks:
        crops = sum(b * n for b, n in buckets.items()) / chunks
        flops += frames * crops * arch.reid_flops(
            cfg["reid"]["feature_dim"], cfg["reid"]["input_hw"])
    return 100.0 * flops / (seconds * kernels.PEAK_BF16_FLOPS)
