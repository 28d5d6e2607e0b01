"""One run of a benchmark cell with the pipeline's ``CudaStageTimer``
attached, and where its chunks went: the stage stamps of the captured step,
the host spans of each dispatch and the device's gap between replays.

    python3 scripts/probe_stage_stamps.py --workload n540-deepsort-1x8 \
        --seed 7 [--timer 1] [--trace 0] [--judge 0] [--seconds 10] \
        [--out stamps.jsonl]

From the root of a checkout, on a machine with a CUDA card. The cell runs
as ``portbench/run.py`` runs it (``portbench.harness.run_cell``), but every
``TrackingPipeline`` made in the process gets a timer before its warm-up
and capture, whose spans also go to the harness's tracer (so that a
``--trace 1`` run's idle gaps are labelled by them). ``--timer 0`` runs the
cell untouched, the base for the timer's cost. Prints one JSON line (and
appends it to ``--out``): the result line's end-to-end metrics and
``correct`` (with ``--judge 1``), and from the window's dispatches (those
whose dispatch span and device span lie inside the window and clear of the
profiler's sub-window) the mean device ms of the detect stages (entry to
``nms``), of ReID (``nms`` to ``crops_reid``) and of the scan
(``crops_reid`` to ``tracker``), the step gap and its ms by the host span
open at its middle, the host spans' ms, the share of ReID crop slots
holding a real crop, the device period a chunk (first stamp to first
stamp) against the host's, the clock's calibration, the step's graph
nodes with and without the stamps' ones, and one stamp node's device
time.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

DETECT = ("gmc", "letterbox", "yolo", "nms")


def window_records(records, lo_ns, hi_ns, skip=None) -> list:
    """The records of dispatches read back whose host dispatch span and
    device span (its gap included) lie inside ``[lo_ns, hi_ns]`` and clear
    of ``skip`` (an ``(a, b)`` host span, the profiler's)."""
    out = []
    for r in records:
        if r["stages"] is None or r["t0"] is None:
            continue
        a = min(r["t0"], r["first"] - int(1e6 * (r["gap"] or 0)))
        b = max(r["t1"], r["last"])
        if a < lo_ns or b > hi_ns:
            continue
        if skip is not None and a <= skip[1] and b >= skip[0]:
            continue
        out.append(r)
    return out


def reduce(recs) -> dict:
    """Means a dispatch over ``recs`` (see the module's docstring)."""
    n = len(recs)
    if not n:
        return {"dispatches": 0}

    def mean(f):
        return sum(f(r) for r in recs) / n

    gaps = [r for r in recs if r["gap"] is not None]
    by_span = {}
    for r in gaps:
        by_span[r["gap_at"]] = by_span.get(r["gap_at"], 0.0) + r["gap"]
    names = sorted({k for r in recs for k in r["spans"]})
    # first stamp to first stamp of consecutive dispatches
    steps = [(b["first"] - a["first"]) * 1e-6
             for a, b in zip(recs, recs[1:]) if b["id"] == a["id"] + 1]
    slots = sum(r["slots"] for r in recs)
    return {
        "dispatches": n,
        "detect_device_ms": mean(lambda r: sum(
            v for k, v in r["stages"].items() if k in DETECT)),
        "reid_device_ms": mean(lambda r: r["stages"].get("crops_reid", 0.0)),
        "scan_device_ms": mean(lambda r: r["stages"].get("tracker", 0.0)),
        "stages_ms": {k: mean(lambda r, k=k: r["stages"].get(k, 0.0))
                      for k in recs[0]["stages"]},
        "step_gap_ms": (sum(r["gap"] for r in gaps) / len(gaps)
                        if gaps else None),
        "gap_ms_by_span": {k: v / len(gaps) for k, v in sorted(
            by_span.items(), key=lambda kv: -kv[1])} if gaps else {},
        "upload_host_ms": mean(lambda r: r["spans"].get("upload.ring_wait",
                                                        0.0)
                               + r["spans"].get("upload.copy", 0.0)),
        "readback_wait_ms": mean(lambda r: r["spans"].get("readback.wait",
                                                          0.0)),
        "spans_ms": {k: mean(lambda r, k=k: r["spans"].get(k, 0.0))
                     for k in names},
        "reid_crop_use": 100.0 * sum(r["crops"] for r in recs) / slots
        if slots else None,
        "device_period_ms": sum(steps) / len(steps) if steps else None,
    }


def stamp_node_us(n: int = 64, replays: int = 50) -> float:
    """Device microseconds of one stamp node: a graph of ``n`` stamps into
    one buffer, replayed ``replays`` times between CUDA events."""
    import torch
    from aicamera_tpu_torch.runtime import branches
    buf = torch.zeros(8, dtype=torch.int64, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        branches.stamp(buf, 0)      # builds and loads the library
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            branches.stamp(buf, i % 8)
    graph.replay()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    b.synchronize()
    return 1e3 * a.elapsed_time(b) / (replays * n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--timer", type=int, choices=(0, 1), default=1)
    ap.add_argument("--judge", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from portbench import run as bench_run
    bench_run._environment()
    import torch
    from aicamera_tpu_torch.runtime import pipeline as pl
    from aicamera_tpu_torch.runtime.profiler import CudaStageTimer
    from portbench import harness
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.find_cell(bench, args.workload)
    config, traffic, limits = harness.cell_files(bench, cell)
    made, ctxs = [], []
    if args.timer:
        ctx_init = harness.Context.__init__
        pipe_init = pl.TrackingPipeline.__init__

        def context(self, *a, **k):
            ctx_init(self, *a, **k)
            ctxs.append(self)

        def pipeline(self, *a, **k):
            pipe_init(self, *a, **k)
            self.stage_timer = CudaStageTimer(
                on_span=lambda n, t0, t1: ctxs[-1].tracer.phase(n, t0, t1))
            made.append(self)

        harness.Context.__init__ = context
        pl.TrackingPipeline.__init__ = pipeline
    keep = {}
    line = harness.run_cell(bench, cell, config, traffic, limits, args.seed,
                            args.seconds, bool(args.trace), device="cuda",
                            t_start=T_START, keep=keep,
                            judge=bool(args.judge))
    off = time.time_ns() - time.perf_counter_ns()
    ctx = keep["ctx"]
    out = {"workload": args.workload, "seed": args.seed,
           "timer": args.timer, "trace": args.trace,
           "card": torch.cuda.get_device_name(0),
           "correct": line["correct"],
           "metrics": {k: v["value"] for k, v in line["metrics"].items()},
           "dispatches": ctx.dispatches, "window_s": ctx.window_s,
           "host_period_ms": 1e3 * ctx.window_s / ctx.dispatches}
    if made:
        pipe = made[0]
        timer = pipe.stage_timer
        lo, hi = (int(t * 1e9) + off for t in ctx.window)
        skip = None
        if ctx.tracer.t0 is not None:
            skip = (int(ctx.tracer.p0 * 1e9) + off,
                    int(ctx.tracer.p1 * 1e9) + off)
        recs = window_records(timer.records(), lo, hi, skip)
        out.update(reduce(recs))
        if skip is not None:
            # the profiler's sub-window's own dispatches, for comparison
            out["traced"] = reduce(window_records(timer.records(), *skip))
        out["stamp_node_us"] = stamp_node_us()
        cal = timer.calibrations
        out["clock"] = {"offset_ns": [c[1] for c in cal],
                        "error_ns": [c[2] for c in cal],
                        "drift_ns": cal[-1][1] - cal[0][1] if cal else None,
                        "over_s": (cal[-1][0] - cal[0][0]) * 1e-9
                        if cal else None}
        out["graph_nodes"] = [(s.engine.graph_nodes(),
                               s.engine.aside_nodes())
                              for s in pipe._steps.values()]
    if args.trace and "breakdown" in line:
        out["idle_gaps"] = line["breakdown"]["idle_gaps"]
    text = json.dumps(out, default=float)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
