"""``correct`` comes out false where it must: the control (the reference
computed in float8 in the program's place) and the faults a cell can have,
each planted in the program underneath a run that skips only the look for
a card. At sizes a CPU test holds; ``portbench/control.py`` reads the
control on the chip at the cells' own sizes."""

import pytest

from portbench import faults, harness
from portbench.drivers import common
from portbench.reference import run as reference
from portbench.tests import small
from portbench.yardstick import compare


@pytest.mark.parametrize("name", small.CELLS)
def test_the_control_is_not_correct(name):
    """The reference in float8 against the reference in f32 over the same
    frames (every camera's whole clip, twice), judged by the cell's
    limits."""
    bench, cell, config, traffic, limits = small.cell(name)
    keep = {}
    line = harness.run_cell(bench, cell, config, traffic, limits, 5, 1.0,
                            False, device="cpu", keep=keep)
    assert line["correct"] is True
    order = list(common.pingpong(traffic["clip_frames"])) * 2
    streams = [[(key, int(i)) for i in order] for key in keep["clips"]]
    want_dets = keep["program"]["dets"] is not None
    family = keep["ctx"].family
    with harness._f32():
        got = reference.run(config, family, traffic["frame_hw"],
                            keep["clips"], streams, keep["trees"], "cpu",
                            want_dets=want_dets)
    tracks, dets = got if want_dets else (got, None)
    numbers, _ = harness.judge_outputs(
        config, family, traffic, {"streams": streams, "tracks": tracks,
                                  "dets": dets},
        keep["trees"], "cpu", keep["clips"], precision="fp8")
    assert numbers["tracks_paired"] > 20
    correct, checks = compare.judge(numbers, limits["limits"])
    assert not correct, checks


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", small.CELLS)
def test_a_fault_is_not_correct(name, fault):
    with faults.FAULTS[fault]():
        line = small.run(name, seconds=2.0)
    assert line["correct"] is False, line["checks"]
