"""A later change adds a cell and a metric by adding files alone: a new
traffic mix, a new cell's limits and a new metric's reader, found by the
names in the manifest, with no file of the harness edited."""

import json
import shutil

from portbench import harness
from portbench.tests import small


def test_a_cell_and_a_metric_from_new_files(tmp_path):
    bench, cell, config, traffic, limits = small.cell("n540-deepsort-1x8")
    root = tmp_path
    for sub in ("configs", "traffic", "workloads", "metrics"):
        (root / "portbench" / sub).mkdir(parents=True)
    # a configuration file of its own
    config["weights"] = {k: str(harness.ROOT / v)
                         for k, v in config["weights"].items()}
    (root / "portbench/configs/tiny.json").write_text(json.dumps(config))
    # a new traffic mix: data only, read by an existing driver
    traffic = dict(traffic, chunk=4, world=dict(traffic["world"], seed=77))
    (root / "portbench/traffic/tiny-chunk4.json").write_text(
        json.dumps(traffic))
    (root / "portbench/workloads/tiny-cell.json").write_text(
        json.dumps(limits))
    # a new metric: a reader of its own
    (root / "portbench/metrics/frames_compared.py").write_text(
        "def read(ctx):\n    return float(ctx.frames_compared)\n")
    shutil.copy(harness.ROOT / "portbench/metrics/setup_s.py",
                root / "portbench/metrics/setup_s.py")
    new_cell = {"name": "tiny-cell", "config": "tiny",
                "traffic": "tiny-chunk4", "chips": 1, "why": "a test"}
    bench = {"configs": [{"name": "tiny", "source": "x",
                          "file": "portbench/configs/tiny.json",
                          "reduced": [], "why": "a test"}],
             "workloads": [new_cell],
             "end_to_end": [{"name": "frames_compared", "unit": "frames",
                             "better": "higher", "bound": 0.1,
                             "source": "host_clock"},
                            {"name": "setup_s", "unit": "s",
                             "better": "lower", "bound": 0.25,
                             "source": "host_clock"}],
             "per_layer": []}
    cfg, trf, lim = harness.cell_files(bench, new_cell, root)
    line = harness.run_cell(bench, new_cell, cfg, trf, lim, 11, 1.5, False,
                            device="cpu", root=root)
    assert set(line["checks"]) >= set(lim["limits"])
    assert line["metrics"]["frames_compared"]["value"] > 0
    assert set(line["metrics"]) == {"frames_compared", "setup_s"}
