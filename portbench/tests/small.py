"""Cells of the benchmark cut to a size a CPU test can run: the real files,
with the detector input, frames, clips and stream counts made small."""

from __future__ import annotations

import copy

from portbench import harness

CELLS = ("n540-deepsort-1x8", "m720-bytetrack-8x4")


def cell(name: str):
    """``(bench, cell, config, traffic, limits)`` of ``name``, small."""
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    c = harness.find_cell(bench, name)
    config, traffic, limits = (copy.deepcopy(x) for x in
                               harness.cell_files(bench, c))
    config["pipeline"]["input_hw"] = [160, 160]
    traffic["clip_frames"] = 16
    traffic["frame_hw"] = [120, 200]
    if "streams" in traffic:
        traffic["streams"] = 2
    return bench, c, config, traffic, limits


def run(name: str, seconds: float = 2.0, seed: int = 3, keep=None,
        **kw) -> dict:
    bench, c, config, traffic, limits = cell(name)
    return harness.run_cell(bench, c, config, traffic, limits, seed,
                            seconds, False, device="cpu", keep=keep, **kw)
