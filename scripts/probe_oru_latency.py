#!/usr/bin/env python3
"""What a virtual step of the ORU kernel is made of, on the GPU.

    python3 scripts/probe_oru_latency.py

Needs one CUDA GPU and ``nvcc``. Two readings:

- the latency, in cycles on one warp, of each operation on the dependent
  chain of ``aicamera_tpu_torch/csrc/oru.cu``'s virtual step
  (``scripts/probe_oru_latency.cu``, built with ``--fmad=false`` as the
  kernel is): the checked IEEE division, the same division of a zero
  dividend, four independent divisions a step, the square root, an add, a
  multiply, a width-8 shuffle under the whole warp's mask and under an
  8-lane group's mask, a select, and the zero test with its direct answer
  that ``quotient<true>`` puts in place of a zero division;
- the SASS of both designs of the committed ``csrc/oru.cu`` (``cuobjdump``
  from the CUDA toolkit): each kernel's instructions by opcode (shuffles,
  the warp syncs and divergence checks a shuffle needs, the calls to the
  division's and square root's slow subroutines, the branches).

Prints the card's name and power limit first.
"""

from __future__ import annotations

import collections
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CHAINS = ("division", "division, zero dividend", "4 independent divisions",
          "square root + add", "add", "multiply", "shuffle, warp mask",
          "shuffle, group mask", "select", "zero test + direct answer")
OPCODES = ("SHFL", "WARPSYNC", "MATCH", "VOTEU", "REDUX", "CALL", "MUFU",
           "FCHK", "BSSY", "BRA", "FADD", "FMUL", "FFMA", "FSEL", "LDG",
           "STG")


def sass_counts(lib: Path) -> dict:
    """``{kernel: Counter(opcode)}`` of a built library's SASS."""
    from torch.utils.cpp_extension import CUDA_HOME
    tool = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    kernels = {}
    for body in re.split(r"\n\s*Function : ", out)[1:]:
        name = body.split("\n", 1)[0].strip()
        design = "rows" if "rows" in name else "v1" if "v1" in name else name
        kernels[design] = collections.Counter(
            op.split(".")[0] for op in re.findall(
                r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                body))
    return kernels


def main() -> int:
    import torch
    from aicamera_tpu_torch.ops import cuda_build
    from aicamera_tpu_torch.ops.oru import OruKernel
    if not torch.cuda.is_available():
        print("probe_oru_latency: needs a CUDA GPU", file=sys.stderr)
        return 2
    ident = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[probe] {ident.strip()}")
    lib_path, _ = cuda_build.build(ROOT / "scripts" / "probe_oru_latency.cu",
                                   flags=OruKernel.flags)
    lib = ctypes.CDLL(str(lib_path))
    lib.aicam_oru_latency.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_longlong * len(CHAINS))()
    err = lib.aicam_oru_latency(buf)
    if err:
        print(f"probe_oru_latency: CUDA error {err}", file=sys.stderr)
        return 1
    steps = lib.aicam_oru_latency_steps()
    for name, cycles in zip(CHAINS, buf):
        print(f"[probe] {name}: {cycles / steps:.1f} cycles a step "
              f"(one warp, {steps} dependent steps)")
    kernel_lib, _ = cuda_build.build(OruKernel.source, flags=OruKernel.flags)
    for design, ops in sorted(sass_counts(kernel_lib).items()):
        print(f"[probe] SASS {design}: {sum(ops.values())} instructions; "
              + ", ".join(f"{op} {ops.get(op, 0)}" for op in OPCODES))
    return 0


if __name__ == "__main__":
    sys.exit(main())
