"""Port: the NMS kernel (``csrc/nms.cu``) and its wrapper, on the CPU.

- ``csrc/nms.cu`` itself, built for the host under a CPU emulation of the
  CUDA built-ins it uses (``tests/data/cuda_emulation.h``: a block's threads
  as host threads, ``__ballot_sync``, ``__shfl_sync`` and ``__syncthreads``
  as barriers, shared memory as function statics, f32 without contraction,
  as ``--fmad=false`` builds it): on ``chip_smoke.nms_cases`` (the detect
  paths' shapes at B = 1 and 8, K = 1, 33, 300, 500 and 1100, the chain of
  length K, none and all valid, NaN, infinite and degenerate boxes,
  overlaps exactly at the threshold, IoU and IoS) its kept set is bitwise
  the port's plain version, in both forms, and the JAX package's
  ``_greedy_keep`` over ``_pairwise_iou_xyxy`` / ``_pairwise_ios_xyxy``;
  the scratch mask starts as garbage, so every word the scan reads is one
  the mask launch wrote;
- the wrapper: CPU tensors take the plain version through
  ``_suppress_and_emit`` and launch nothing; the kernel's argument checks
  raise on what it does not take.

What the card's compiler makes of the source shows only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``'s ``[nms]`` phase).
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from aicamera_tpu.ops import nms as jnms  # noqa: E402
from aicamera_tpu_torch.ops import nms as tnms  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"
CASES = chip_smoke.nms_cases()
GARBAGE = 0xA5A5A5A5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _emulated_source() -> str:
    src = tnms.NmsKernel.source.read_text()
    src = src.replace("#include <cuda_runtime.h>",
                      '#include "cuda_emulation.h"')
    src, n = re.subn(r"(\w+)<<<([^,]+), ([^,]+), 0, "
                     r"\(cudaStream_t\)stream>>>\(",
                     r"emu_launch(\2, \3, \1, ", src)
    assert n == 2, "both launches of csrc/nms.cu found"
    return src


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """csrc/nms.cu for the host."""
    cxx = shutil.which("c++") or shutil.which("g++")
    assert cxx, "a C++ compiler on PATH"
    out = tmp_path_factory.mktemp("nms_emulation")
    src = out / "nms_emulated.cpp"
    src.write_text(_emulated_source())
    lib = out / "libnms_emulated.so"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-pthread", f"-I{DATA}", str(src), "-o", str(lib)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    dll.aicam_nms_keep.argtypes = [i32, i32, ptr, ptr, ctypes.c_float, i32,
                                   ptr, ptr, ptr]
    dll.aicam_nms_keep.restype = i32
    dll.aicam_nms_max_k.restype = i32
    return dll


def _aligned_words(n):
    """``n`` uint32 on a 16-byte boundary, filled with garbage."""
    raw = np.full(n + 4, GARBAGE, np.uint32)
    skip = (-raw.ctypes.data % 16) // 4
    return raw[skip:skip + n]


def _run(lib, shifted, valid, threshold, criterion):
    """One emulated call: the kept set ``(B, K)`` bool."""
    b, k = valid.shape
    words = -(-k // 32)
    boxes = np.ascontiguousarray(shifted.numpy(), np.float32)
    flags = np.ascontiguousarray(valid.numpy().astype(np.uint8))
    mask = _aligned_words(b * words * 32 * words)
    kept = np.full((b, k), 7, np.uint8)
    err = lib.aicam_nms_keep(b, k, boxes.ctypes.data, flags.ctypes.data,
                             float(np.float32(threshold)),
                             0 if criterion == "iou" else 1,
                             mask.ctypes.data, kept.ctypes.data, None)
    assert err == 0
    assert set(np.unique(kept)) <= {0, 1}
    return torch.from_numpy(kept.astype(bool))


def _jax_keep(shifted, valid, threshold, criterion):
    """The JAX package's composition, frame by frame, op by op."""
    pairwise = {"iou": jnms._pairwise_iou_xyxy,
                "ios": jnms._pairwise_ios_xyxy}[criterion]
    return np.stack([
        np.asarray(jnms._greedy_keep(
            pairwise(jnp.asarray(shifted[f].numpy())) > threshold,
            jnp.asarray(valid[f].numpy())))
        for f in range(valid.shape[0])])


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_emulated_kernel_is_bitwise_the_plain_version_and_jax(emulated, case):
    name, shifted, valid, threshold, criterion = CASES[case]
    got = _run(emulated, shifted, valid, threshold, criterion)
    eager = tnms.greedy_keep_plain(shifted, valid, threshold, criterion)
    assert torch.equal(got, eager), name
    assert not (got & ~valid).any(), name
    if valid.shape[-1] <= chip_smoke.NMS_TILED_K:
        fixed = tnms.greedy_keep_plain(shifted, valid, threshold, criterion,
                                       fixed_iters=True)
        assert torch.equal(got, fixed), name
    np.testing.assert_array_equal(
        got.numpy(), _jax_keep(shifted, valid, threshold, criterion),
        err_msg=name)


def test_emulated_kernel_compares_in_f32_at_the_threshold(emulated):
    """IoU exactly 3/10 rounds to f32(0.3), which is above 0.3: the pair
    does not suppress at threshold 0.3 (a comparison in double would)."""
    shifted = torch.tensor([[[0.0, 0.0, 10.0, 1.0], [0.0, 0.0, 3.0, 1.0],
                             [7.0, 0.0, 17.0, 1.0]]])
    valid = torch.ones((1, 3), dtype=torch.bool)
    for criterion, thr, want in (("iou", 0.3, [1, 1, 1]),
                                 ("iou", 0.29, [1, 0, 1]),
                                 ("ios", 0.3, [1, 0, 1]),
                                 ("ios", 0.299, [1, 0, 0])):
        got = _run(emulated, shifted, valid, thr, criterion)
        assert got[0].tolist() == [bool(v) for v in want], (criterion, thr)
        assert torch.equal(got, tnms.greedy_keep_plain(shifted, valid, thr,
                                                       criterion))


def test_emulated_kernel_refuses_what_it_does_not_take(emulated):
    boxes = np.zeros((1, 4, 4), np.float32)
    flags = np.ones((1, 4), np.uint8)
    kept = np.zeros((1, 4), np.uint8)
    mask = _aligned_words(32 + 4)
    assert emulated.aicam_nms_max_k() == tnms.MAX_K
    for b, k, m in ((0, 4, mask), (1, 0, mask), (1, tnms.MAX_K + 1, mask),
                    (1, 4, mask[1:])):  # a mask off the 16-byte grid
        assert emulated.aicam_nms_keep(
            b, k, boxes.ctypes.data, flags.ctypes.data, 0.5, 0,
            m.ctypes.data, kept.ctypes.data, None) != 0


# --- the wrapper on the CPU ------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    before = tnms.KERNEL.launches
    name, shifted, valid, thr, criterion = CASES[0]
    b, k = valid.shape
    rng = np.random.RandomState(0)
    score = torch.from_numpy(-np.sort(-rng.rand(b, k)).astype(np.float32))
    cls = torch.zeros((b, k), dtype=torch.int32)
    for fixed in (False, True):
        num, boxes, scores, labels = tnms._suppress_and_emit(
            shifted, score, cls, valid, thr, k, 100, criterion=criterion,
            fixed_iters=fixed)
        kept = tnms.greedy_keep_plain(shifted, valid, thr, criterion)
        assert torch.equal(num, kept.sum(-1).clamp(max=100).to(torch.int32))
    assert tnms.KERNEL.launches == before


def _good_args():
    (_, shifted, valid, thr, criterion), = [c for c in CASES
                                            if c[0] == "B=8 K=33"]
    return shifted, valid, thr, criterion


@pytest.mark.parametrize("bad,error,match", [
    (lambda s, v: (s.double(), v), TypeError, "float32"),
    (lambda s, v: (s.half(), v), TypeError, "float32"),
    (lambda s, v: (s, v.to(torch.uint8)), TypeError, "bool"),
    (lambda s, v: (s[..., :3].contiguous(), v), ValueError,
     r"\(\.\.\., K, 4\)"),
    (lambda s, v: (s[0, 0], v[0, 0]), ValueError, r"\(\.\.\., K, 4\)"),
    (lambda s, v: (s, v[:, :-1].contiguous()), ValueError, "valid must be"),
    (lambda s, v: (s[:, :0].contiguous(), v[:, :0].contiguous()), ValueError,
     "1 <= K"),
    (lambda s, v: (s.transpose(0, 1).contiguous().transpose(0, 1), v),
     ValueError, "contiguous"),
    (lambda s, v: (s, v.t().contiguous().t()), ValueError, "contiguous"),
])
def test_the_kernel_raises_on_what_it_does_not_take(bad, error, match):
    shifted, valid, thr, criterion = _good_args()
    s, v = bad(shifted, valid)
    before = tnms.KERNEL.launches
    with pytest.raises(error, match=match):
        tnms.KERNEL(s, v, thr, criterion)
    assert tnms.KERNEL.launches == before


def test_the_kernel_raises_on_k_past_its_limit_and_odd_arguments():
    shifted, valid, thr, criterion = _good_args()
    before = tnms.KERNEL.launches
    big = torch.zeros((1, tnms.MAX_K + 1, 4))
    with pytest.raises(ValueError, match="1 <= K"):
        tnms.KERNEL(big, torch.ones((1, tnms.MAX_K + 1), dtype=torch.bool),
                    thr)
    with pytest.raises(ValueError, match="criterion"):
        tnms.KERNEL(shifted, valid, thr, "giou")
    with pytest.raises(TypeError, match="threshold"):
        tnms.KERNEL(shifted, valid, torch.tensor(thr), criterion)
    # the right arguments on the CPU: the kernel takes CUDA tensors only
    with pytest.raises(ValueError, match="CUDA"):
        tnms.KERNEL(shifted, valid, thr, criterion)
    assert tnms.KERNEL.launches == before


def _sequential_scan(overlap, valid):
    """The greedy scan in index order, one candidate at a time."""
    keep = np.zeros_like(valid)
    for i in range(len(valid)):
        keep[i] = valid[i] and not np.any(keep[:i] & overlap[:i, i])
    return keep


@pytest.mark.parametrize("criterion", ["iou", "ios"])
def test_greedy_keep_plain_is_the_sequential_scan(criterion):
    """The plain version (the kernel's oracle) against the scan written as
    a loop, on the cases' frames of up to 500 candidates, NaN and infinite
    boxes among them."""
    for name, shifted, valid, thr, _ in CASES:
        if valid.shape[-1] > chip_smoke.NMS_TILED_K:
            continue
        overlap = (tnms._PAIRWISE[criterion](shifted) > thr).numpy()
        got = tnms.greedy_keep_plain(shifted, valid, thr, criterion).numpy()
        for f in range(valid.shape[0]):
            np.testing.assert_array_equal(
                got[f], _sequential_scan(overlap[f], valid[f].numpy()),
                err_msg=name)
