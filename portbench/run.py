"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

From the root of a checkout, on a machine with the cell's cards. The cell,
its configuration, traffic, limits and metrics are found by name from
``BENCHMARK.json`` (``portbench/harness.py``). The last line of standard
output is the result (a JSON object); the numbers compared for ``correct``
are the last lines of standard error. Exits non-zero, printing no result,
without enough CUDA devices, without the program, or when the process
holds JAX or the JAX package once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment():
    """Build and kernel caches at fixed paths inside the checkout, and no
    JAX behind any library."""
    os.environ.setdefault("AICAMERA_COMPILE_CACHE",
                          str(ROOT / "aicamera_tpu_torch" / "_build"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "portbench" / ".cache" / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "portbench" / ".cache" / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import harness
    bench_file = ROOT / "BENCHMARK.json"
    if not bench_file.exists():
        print("BENCHMARK.json is missing", file=sys.stderr)
        return 2
    bench = harness.load_json(bench_file)
    cell = harness.find_cell(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        import aicamera_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 4
    config, traffic, limits = harness.cell_files(bench, cell)
    line = harness.run_cell(bench, cell, config, traffic, limits, args.seed,
                            args.seconds, bool(args.trace), device="cuda",
                            t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"the process holds {found} after the window", file=sys.stderr)
        return 5
    harness.print_result(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
