"""Readings that set the limits of ``correct``: the program's numbers and
its control's, on the chip, at the cell's own size, seed after seed.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 20 [--control reference_fp8|program_int8|none]

For each seed one run of the cell as the benchmark makes it (its window,
its comparison with the f32 reference), then the control on the same
frames: ``reference_fp8`` puts the reference computed in float8 e4m3 (the
precision below the configuration's bf16) in the program's place and
compares it with the f32 reference; ``program_int8`` runs the program's
own int8 path (``yolo_quant`` and ``reid_quant``) as a second run and
compares that; ``fault_<name>`` runs the program with a fault of
``portbench/faults.py`` planted instead. Prints one JSON line a seed: the
numbers of each.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    sys.path.insert(0, str(ROOT))
    from portbench.run import _environment
    _environment()
    from portbench import faults, harness
    ap.add_argument("--control", default="reference_fp8",
                    choices=("reference_fp8", "program_int8", "none")
                    + tuple(f"fault_{f}" for f in faults.FAULTS))
    args = ap.parse_args(argv)
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.find_cell(bench, args.workload)
    config, traffic, limits = harness.cell_files(bench, cell)
    for seed in (int(s) for s in args.seeds.split(",")):
        row = {"workload": args.workload, "seed": seed}
        keep = {}
        t0 = time.perf_counter()
        if not args.control.startswith("fault_"):
            line = harness.run_cell(bench, cell, config, traffic, limits,
                                    seed, args.seconds, False, keep=keep)
            row["program"] = keep["numbers"]
            row["program_correct"] = line["correct"]
            row["metrics"] = {k: v["value"]
                              for k, v in line["metrics"].items()}
        if args.control == "reference_fp8":
            numbers, _ = harness.judge_outputs(
                config, keep["ctx"].family, traffic,
                {"streams": keep["program"]["streams"],
                 "tracks": keep["reference"]["tracks"],
                 "dets": keep["reference"]["dets"]},
                keep["trees"], "cuda", keep["clips"], precision="fp8")
            row["control"] = numbers
        elif args.control.startswith("fault_"):
            kc = {}
            with faults.FAULTS[args.control[len("fault_"):]]():
                fl = harness.run_cell(bench, cell, config, traffic, limits,
                                      seed, args.seconds, False, keep=kc)
            row["control"] = kc["numbers"]
            row["control_correct"] = fl["correct"]
        elif args.control == "program_int8":
            kc = {}
            harness.run_cell(bench, cell, config, traffic, limits, seed,
                             args.seconds, False, control="program_int8",
                             keep=kc)
            row["control"] = kc["numbers"]
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
