"""Port: the ORU replay kernel's designs, on the CPU.

- ``core.ocsort.oru_replay``'s ``variant``: an unknown design raises; on
  CPU tensors every design is ``oru_replay_plain``, bitwise, and nothing is
  launched;
- ``chip_smoke.oru_compare``, the check the card's comparisons use: NaN
  where NaN, an infinity where the same infinity, anything else fails;
- ``csrc/oru.cu`` itself, built for the host under a CPU emulation of the
  CUDA built-ins it uses (``tests/data/cuda_emulation.h``: a block's threads
  as host threads, ``__shfl_sync`` and ``__syncthreads`` as barriers, f32
  without contraction, as ``--fmad=false`` builds it): the rows design
  bitwise the v1 design on every lane, through its 16-byte copy and its
  scalar copy, on a ragged last block and degenerate boxes, both within
  ``chip_smoke.ORU_TOL`` of the plain version, slots without a replay
  unchanged; the probe build's counts. What the card's compiler makes of
  the source shows only on the card (``tests/test_torch_cuda.py``).
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from aicamera_tpu_torch.core import ocsort as oc
from aicamera_tpu_torch.ops import oru as koru

DATA = Path(__file__).resolve().parent / "data"
MAX_GAP = chip_smoke.ORU_MAX_AGE + 1


def _small_cases():
    return [("B=1 T=16 mixed", chip_smoke.oru_inputs(1, seed=2, t=16)),
            ("B=3 T=13 mixed", chip_smoke.oru_inputs(3, seed=6, t=13)),
            ("B=1 T=8 gap 8", chip_smoke.oru_inputs(1, gap=8, seed=4, t=8)),
            ("B=1 T=8 gap 31", chip_smoke.oru_inputs(1, gap=31, seed=5,
                                                     t=8)),
            ("B=2 T=8 no replay", chip_smoke.oru_inputs(2, gap=0, seed=3,
                                                        t=8)),
            ("B=2 T=16 degenerate", chip_smoke.oru_degenerate())]


# --- the wrapper's design on the CPU -------------------------------------------

def test_an_unknown_variant_raises():
    args = chip_smoke.oru_inputs(1, seed=1, t=8)
    for bad in ("lanes", "", "V1"):
        with pytest.raises(ValueError, match="variant"):
            oc.oru_replay(*args, MAX_GAP, variant=bad)
        with pytest.raises(ValueError, match="variant"):
            koru.KERNEL(*args, MAX_GAP, variant=bad)


@pytest.mark.parametrize("variant", koru.VARIANTS)
def test_every_variant_is_the_plain_version_on_the_cpu(variant):
    before = koru.KERNEL.launches
    for _, args in _small_cases():
        got = oc.oru_replay(*args, MAX_GAP, variant=variant)
        want = oc.oru_replay_plain(*args, MAX_GAP)
        assert chip_smoke.oru_lanes_same(got, want)[0] == args[4].numel()
    assert koru.KERNEL.launches == before


def test_oru_compare_holds_nan_where_nan():
    x = torch.tensor([[1.0, 2.0, float("nan")]])
    p = torch.ones(1, 3, 3)
    rel, same, n = chip_smoke.oru_compare((x, p), (x.clone(), p.clone()))
    assert (rel, same, n) == (0.0, 1, 1)
    off = x.clone()
    off[0, 1] = 2.0 + 1e-3
    rel, same, _ = chip_smoke.oru_compare((off, p), (x, p))
    assert rel == pytest.approx(1e-3 / 2.0, rel=1e-3) and same == 0
    finite = torch.nan_to_num(x)
    for got, want in (((finite, p), (x, p)), ((x, p), (finite, p))):
        assert chip_smoke.oru_compare(got, want)[0] == float("inf")
    inf = p.clone()
    inf[0, 0, 0] = float("inf")
    assert chip_smoke.oru_compare((x, inf), (x, inf))[0] == 0.0
    assert chip_smoke.oru_compare((x, -inf), (x, inf))[0] == float("inf")


# --- csrc/oru.cu under the CPU emulation ----------------------------------------

def _emulated_source() -> str:
    src = koru.OruKernel.source.read_text()
    src = src.replace("#include <cuda_runtime.h>",
                      '#include "cuda_emulation.h"')
    src, n = re.subn(r"(\w+::oru_kernel)<<<([^,]+), ([^,]+), 0, "
                     r"\(cudaStream_t\)stream>>>\(",
                     r"emu_launch(\2, \3, \1, ", src)
    assert n == 2, "both launches of csrc/oru.cu found"
    return src


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``{"plain": lib, "probe": lib}``: csrc/oru.cu for the host."""
    cxx = shutil.which("c++") or shutil.which("g++")
    assert cxx, "a C++ compiler on PATH"
    out = tmp_path_factory.mktemp("oru_emulation")
    src = out / "oru_emulated.cpp"
    src.write_text(_emulated_source())
    libs = {}
    for name, defines in (("plain", []), ("probe", ["-DAICAM_ORU_PROBE"])):
        lib = out / f"liboru_{name}.so"
        proc = subprocess.run(
            [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
             "-shared", "-pthread", *defines, f"-I{DATA}", str(src), "-o",
             str(lib)], capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-4000:]
        libs[name] = ctypes.CDLL(str(lib))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (libs[name].aicam_oru_replay,
                   libs[name].aicam_oru_replay_v1):
            fn.argtypes = [i32] + [ptr] * 8 + [i32] + [ptr] * 3
            fn.restype = i32
    libs["probe"].aicam_oru_probe.argtypes = [ctypes.c_void_p,
                                              ctypes.c_int]
    return libs


def _run(lib, variant, args, offset=0):
    """One emulated launch of ``variant`` on ``args``; ``offset`` floats
    shift x, p and the outputs off the 16-byte grid."""
    fn = (lib.aicam_oru_replay if variant == "rows"
          else lib.aicam_oru_replay_v1)
    x, p, fx, fp, replay, gap, z1, z2 = args
    keep = []

    def buf(t, out=False):
        a = np.zeros(t.numel() + offset + 4, np.float32)
        if not out:
            a[offset:offset + t.numel()] = t.numpy().ravel()
        keep.append(a)
        return a.ctypes.data + 4 * offset

    xo, po = buf(x, out=True), buf(p, out=True)
    ins = [buf(x), buf(p)]
    rest = [np.ascontiguousarray(t.numpy()) for t in (fx, fp)]
    rest += [np.ascontiguousarray(replay.numpy().astype(np.uint8)),
             np.ascontiguousarray(gap.numpy().astype(np.int32))]
    rest += [np.ascontiguousarray(t.numpy()) for t in (z1, z2)]
    err = fn(replay.numel(), *ins, *(a.ctypes.data for a in rest), MAX_GAP,
             xo, po, None)
    assert err == 0
    n = replay.numel()
    out_x, out_p = keep[0][offset:offset + 7 * n], keep[1][offset:offset
                                                          + 49 * n]
    return (torch.from_numpy(out_x.copy()).view(x.shape),
            torch.from_numpy(out_p.copy()).view(p.shape))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("case", range(len(_small_cases())))
def test_emulated_rows_design_is_bitwise_v1(emulated, case, offset):
    name, args = _small_cases()[case]
    rows = _run(emulated["plain"], "rows", args, offset)
    v1 = _run(emulated["plain"], "v1", args, offset)
    n = args[4].numel()
    assert chip_smoke.oru_lanes_same(rows, v1) == (n, n), name
    want = oc.oru_replay_plain(*args, MAX_GAP)
    for out in (rows, v1):
        rel, _, _ = chip_smoke.oru_compare(out, want)
        assert rel <= chip_smoke.ORU_TOL, (name, rel)
    idle = ~args[4]
    assert torch.equal(rows[0][idle], args[0][idle])
    assert torch.equal(rows[1][idle], args[1][idle])


def test_emulated_probe_counts_slots_steps_and_blocks(emulated):
    lib = emulated["probe"]
    slots = ("slots", "replaying", "steps", "load", "gain", "joseph",
             "predict", "store", "blocks", "total", "sink")
    assert slots == koru.PROBE_SLOTS
    _, args = _small_cases()[1]          # 39 slots: a last block of 7
    replay, gap = args[4], args[5]
    steps = int(gap.clamp(max=MAX_GAP)[replay].clamp(min=0).sum())
    for variant, per_block in (("rows", 8), ("v1", 128)):
        buf = (ctypes.c_ulonglong * len(slots))()
        assert lib.aicam_oru_probe(buf, 1) == len(slots)   # reset
        out = _run(lib, variant, args)
        assert lib.aicam_oru_probe(buf, 1) == len(slots)
        got = dict(zip(slots, buf))
        assert got["slots"] == 39 and got["blocks"] == -(-39 // per_block)
        assert got["replaying"] == int(replay.sum())
        assert got["steps"] == steps and got["sink"] == 0
        assert chip_smoke.oru_lanes_same(out, _run(
            emulated["plain"], "v1", args)) == (39, 39)
