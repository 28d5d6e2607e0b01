"""``BENCHMARK.json`` against the rules it is checked by: names, units,
keys, files found by name, the budget of a full check."""

import json
import math
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT = ("why", "layer", "source")


def _text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int) \
        and 1 <= BENCH["run_seconds"] <= 51


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(_text_ok(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for w in cmd:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in paths)


def test_names_units_and_entry_keys():
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in seen
        seen.add(c["name"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    cells = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k])
        assert w["name"] not in cells and w["chips"] in (1, 4)
        cells.add(w["name"])
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    metrics = set()
    for group, keys in (("end_to_end", {"name", "unit", "better", "bound",
                                        "source"}),
                        ("per_layer", {"name", "unit", "better", "source",
                                       "layer", "moves"})):
        for m in BENCH[group]:
            assert set(m) - {"workloads"} == keys
            assert NAME.match(m["name"]) and m["name"] not in metrics
            metrics.add(m["name"])
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                               "higher")
            for k in TEXT:
                if k in m:
                    assert _text_ok(m[k])
    for entry in BENCH["configs"] + BENCH["workloads"]:
        for k in TEXT:
            if k in entry:
                assert _text_ok(entry[k])


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        mine = [m for m in BENCH["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        layer = [m for m in BENCH["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])]
        assert layer
        for m in layer:
            moved = e2e[m["moves"]]
            assert w["name"] in moved.get("workloads", [w["name"]])


def test_files_are_found_by_name():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        traffic = json.loads((ROOT / "portbench/traffic"
                              / f"{w['traffic']}.json").read_text())
        assert (ROOT / "portbench/drivers"
                / f"{traffic['driver']}.py").is_file()
        assert (ROOT / "portbench/workloads" / f"{w['name']}.json").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        own = ROOT / "portbench/metrics" / f"{m['name']}.py"
        base = own.with_name(f"{m['name'].split('.')[0]}.py")
        assert own.is_file() or base.is_file()


def test_a_full_check_fits_with_24_cells():
    r = BENCH["run_seconds"]
    total = (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, math.floor(0.25 * len(BENCH["workloads"])))
