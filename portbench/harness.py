"""One run of one cell: set-up, the measured window, the late answers, the
metrics, the reference comparison and the result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``;
its configuration in the file that names, whose ``model.family`` names its
detector's module in ``portbench/families``; its traffic in
``portbench/traffic/<traffic>.json``, whose ``driver`` names a module of
``portbench/drivers``; its limits in ``portbench/workloads/<cell>.json``;
each metric's reader in ``portbench/metrics/<metric>.py`` (or, for
``<metric>.<suffix>``, the reader of ``<metric>``).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .drivers.common import Phases
from .reference import msgpack_io
from .reference import run as reference
from .yardstick import compare
from .yardstick.trace import Tracer

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "aicamera_tpu")


class Context:
    """What a driver and the metric readers share in one run."""

    def __init__(self, cell, config, traffic, limits, seed, seconds, trace,
                 device, root=ROOT, control=None):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.limits = limits
        self.seed, self.seconds, self.trace = int(seed), seconds, bool(trace)
        self.device = device
        self.root = Path(root)
        self.control = control
        self.family = family_module(config, self.root)
        self.tracer = Tracer()
        self.phases = Phases(self.tracer)
        self.events = []
        self.notes = []
        self.window = self.arrivals = None
        self.counters = {}
        self.window_s = self.setup_s = None
        self.frames_done = self.frames_compared = self.dispatches = 0
        self.attempted = self.failed = 0
        self._trees = {}
        self._paths = {}

    def weight_path(self, what: str) -> str | None:
        """The weight file the program loads for ``what`` (``yolo``, the
        detector, or ``reid``): a string spec is a file path; a dict spec is
        made first by the detector family's ``make_weights``."""
        spec = self.config["weights"].get(what)
        if spec is None:
            return None
        if isinstance(spec, str):
            return str(self.root / spec)
        if what not in self._paths:
            tree = self.family.make_weights(spec, self.config, self.seed,
                                            self.device)
            work = self.root / "portbench" / ".work"
            work.mkdir(parents=True, exist_ok=True)
            fd, path = tempfile.mkstemp(suffix=".msgpack", dir=work)
            with os.fdopen(fd, "wb") as f:
                f.write(msgpack_io.write_flax_msgpack(tree))
            self._trees[what] = tree
            self._paths[what] = path
        return self._paths[what]

    def remove_made_weights(self):
        """Delete the weight files this run made (the program has loaded
        them; the reference keeps the trees)."""
        for path in self._paths.values():
            os.unlink(path)
        self._paths = {}

    def tree(self, what: str):
        """The Flax tree of the weights the program was given."""
        if what not in self._trees:
            path = self.weight_path(what)
            self._trees[what] = (None if path is None else
                                 msgpack_io.load_flax_msgpack(path))
        return self._trees[what]


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def cell_files(bench: dict, cell: dict, root: Path = ROOT):
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(root / cfg["file"])
    traffic = load_json(root / "portbench" / "traffic"
                        / f"{cell['traffic']}.json")
    limits = load_json(root / "portbench" / "workloads"
                       / f"{cell['name']}.json")
    return config, traffic, limits


def metric_reader(name: str, root: Path = ROOT):
    """The ``read`` of ``portbench/metrics/<name>.py``; a name with a
    suffix (``stream_fps.8x4``: the same quantity under a name of its own,
    for a bound or an end-to-end metric of its own) falls back to the
    reader of the name before its first dot."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    if not path.exists():
        path = path.with_name(f"{name.split('.')[0]}.py")
    return _module_at(path,
                      f"portbench_metric_{name.replace('.', '_')}").read


def family_module(config: dict, root: Path = ROOT):
    """The detector family that ``config["model"]["family"]`` names: the
    module of ``portbench/families/<family>.py`` under ``root``."""
    family = config["model"]["family"]
    return _module_at(root / "portbench" / "families" / f"{family}.py",
                      f"portbench_family_{family}")


def _module_at(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: dict, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell["name"] in m["workloads"]]


def forbidden_modules(names=None) -> list:
    """The forbidden top-level packages among ``names`` (default: the
    modules this process holds), each compared as a whole name."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def run_cell(bench: dict, cell: dict, config: dict, traffic: dict,
             limits: dict, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None, root=ROOT,
             control=None, keep=None, judge=True) -> dict:
    """One run; returns the result line's object. ``keep``, a dict, also
    receives the program's outputs, the clips, the weights and the
    reference's outputs, for tools that read them; ``judge=False`` skips
    the reference (``correct`` is then None)."""
    t_start = time.perf_counter() if t_start is None else t_start
    ctx = Context(cell, config, traffic, limits, seed, seconds, trace,
                  device, root, control)
    driver = importlib.import_module(
        f"portbench.drivers.{traffic['driver']}").Driver(ctx)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    try:
        driver.setup()
    finally:
        ctx.remove_made_weights()
    if trace:
        ctx.tracer.warm()
    ctx.setup_s = time.perf_counter() - t_start
    with _HostWatch() as watch:
        driver.window()
    ctx.notes.append(watch.note())
    driver.drain()
    ctx.counters = driver.counters()
    ctx.spans = ctx.phases.spans
    if ctx.events and cuda:
        torch.cuda.synchronize(device)
        ev = [a.elapsed_time(b) for a, b in ctx.events]
        sp = ctx.spans.get("dispatch") or [0.0]
        ctx.notes.append(
            f"{len(ev)} dispatches: device ms a dispatch mean "
            f"{np.mean(ev):.3f} (p50 {np.median(ev):.3f}), host ms in the "
            f"dispatch call mean {1e3 * np.mean(sp):.3f}")
    ctx.trace_summary = tr = ctx.tracer.summary
    if tr is not None and tr.get("dispatches") \
            and ctx.dispatches > tr["dispatches"]:
        rest = ctx.window_s - (ctx.tracer.p1 - ctx.tracer.p0)
        ctx.notes.append(
            f"traced sub-window: {tr['dispatches']} dispatches, "
            f"{1e3 * tr['window_s'] / tr['dispatches']:.3f} ms a dispatch, "
            f"{1e3 * tr['busy_s'] / tr['dispatches']:.3f} ms of it busy; "
            f"untraced: {1e3 * rest / (ctx.dispatches - tr['dispatches']):.3f}"
            f" ms a dispatch")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))
           if cuda else 0}
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        value = metric_reader(m["name"], root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace and ctx.trace_summary is not None:
        dev["busy_s"] = ctx.trace_summary["busy_s"]
        dev["window_s"] = ctx.trace_summary["window_s"]
    out = driver.outputs()
    trees = {"yolo": ctx.tree("yolo"), "reid": ctx.tree("reid")
             if config["tracker"]["kind"] == "deepsort" else None}
    driver.release()
    del driver
    gc.collect()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    clips = out.pop("clips")
    if keep is not None:
        keep.update(program=out, clips=clips, trees=trees, ctx=ctx)
    if not judge:
        return {"correct": None, "attempted": int(ctx.attempted),
                "failed": int(ctx.failed), "metrics": metrics,
                "device": dev, "notes": ctx.notes, "checks": {}}
    t_ref = time.perf_counter()
    numbers, ref = judge_outputs(config, ctx.family, traffic, out, trees,
                                 device, clips)
    ctx.notes.append(f"reference and comparison: "
                     f"{time.perf_counter() - t_ref:.1f} s over "
                     f"{ctx.frames_compared} frames "
                     f"({reference.TIMES})")
    correct, checks = compare.judge(numbers, limits["limits"])
    if numbers["tracks_reference"] == 0:
        correct = False
        checks["tracks_reference"] = {"value": 0, "limit": 1}
    if keep is not None:
        keep.update(reference=ref, numbers=numbers)
    line = {"correct": bool(correct), "attempted": int(ctx.attempted),
            "failed": int(ctx.failed), "metrics": metrics, "device": dev}
    if trace and ctx.trace_summary is not None:
        line["breakdown"] = {
            "device_ops": ctx.trace_summary["device_ops"],
            "idle_gaps": ctx.trace_summary["idle_gaps"]}
    line["notes"] = ctx.notes + ["numbers compared: " + ", ".join(
        f"{k} {v}" for k, v in numbers.items())]
    line["checks"] = checks
    return line


def judge_outputs(config, family, traffic, out, trees, device, clips,
                  precision="f32"):
    """The reference over the served frames, through the detector
    ``family``'s module, and the numbers compared."""
    hw = tuple(traffic["frame_hw"])
    want_dets = out.get("dets") is not None
    with _f32():
        got = reference.run(config, family, hw, clips, out["streams"],
                            trees, device, precision=precision,
                            want_dets=want_dets)
    ref_tracks, ref_dets = got if want_dets else (got, None)
    numbers = compare.compare_tracks(out["tracks"], ref_tracks)
    numbers["tracks_reference"] = sum(len(t) for s in ref_tracks for t in s)
    if want_dets:
        numbers.update(compare.compare_dets(
            [d for s in out["dets"] for d in s],
            [d for s in ref_dets for d in s]))
    return numbers, {"tracks": ref_tracks, "dets": ref_dets}


class _HostWatch:
    """The window's host CPU seconds and the cyclic collector's passes."""

    def __enter__(self):
        self.gc_s, self.gc_n, self._t = 0.0, 0, None
        gc.callbacks.append(self._cb)
        self.cpu0, self.wall0 = time.process_time(), time.perf_counter()
        return self

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self.gc_n += 1

    def __exit__(self, *exc):
        self.cpu = time.process_time() - self.cpu0
        self.wall = time.perf_counter() - self.wall0
        gc.callbacks.remove(self._cb)

    def note(self) -> str:
        return (f"window host: {self.cpu:.3f} CPU s in {self.wall:.3f} s; "
                f"{self.gc_n} collections, {self.gc_s:.3f} s")


class _f32:
    """TF32 off for the reference's products."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def print_result(line: dict) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    for note in line.get("notes", []):
        print(note, file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line, allow_nan=False, default=float))
    sys.stdout.flush()
