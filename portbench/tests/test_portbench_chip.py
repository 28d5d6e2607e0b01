"""A cell's run on the card, as the driver makes it (skips without one).

    python -m pytest portbench/tests/test_portbench_chip.py -m cuda
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["n540-deepsort-1x8", "m720-bytetrack-8x4"])
def test_a_cell_runs_correct_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483711", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"


def test_no_result_without_a_card(tmp_path):
    """Without CUDA the run exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "n540-deepsort-1x8", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
