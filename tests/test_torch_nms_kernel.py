"""Port: the NMS kernel (``csrc/nms.cu``) and its wrapper, on the CPU.

- ``csrc/nms.cu`` itself, built for the host under a CPU emulation of the
  CUDA built-ins it uses (``tests/data/cuda_emulation.h``: a block's threads
  as host threads, ``__ballot_sync``, ``__shfl_sync``, ``__shfl_up_sync``
  and ``__syncthreads`` as barriers, shared memory as function statics and
  one garbage-filled buffer a launch, the bulk copy as a plain copy and the
  wait on its mbarrier as a block barrier, f32 without contraction, as
  ``--fmad=false`` builds it), twice: as the card builds it and with a
  tile of 64 candidates, so that frames of a few hundred candidates take
  the path of several tiles that K > 2048 takes on the card;
- the one-launch tail (``aicam_nms_emit``): on ``chip_smoke.
  nms_tail_cases`` (every keep case of ``chip_smoke.nms_cases``, the
  detect paths' shapes at B = 1 and 8, K = 1, 33, 300, 500 and 1100, the
  chain of length K, none and all valid, NaN, infinite and degenerate
  boxes, overlaps exactly at the threshold, IoU and IoS; and the emit's
  own cases: max_det below the kept count and past K, classes shifted by
  8192 and by the tiled merge's frame-scaled offset, scores with ties and
  a tail at or below 0) its ``num``, ``boxes``, ``scores``, ``labels`` and
  ``kept`` are bitwise the port's plain ``suppress_and_emit_plain`` (both
  forms) and the JAX package's ``_suppress_and_emit`` (frame by frame, the
  kept set from its ``_greedy_keep``); score rows a stride apart and
  inputs off the 16-byte grid stage the same;
- the first design (``aicam_nms_keep``, ``v1``): its kept set bitwise the
  plain keep and the JAX package's ``_greedy_keep`` on ``nms_cases``, the
  scratch mask starting as garbage, so every word the scan reads is one
  the mask launch wrote;
- the wrapper: CPU tensors take the plain version through
  ``_suppress_and_emit`` and launch nothing; both designs' argument checks
  raise on what they do not take.

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
TAIL_CASES = chip_smoke.nms_tail_cases()
GARBAGE = 0xA5A5A5A5
TILES = (None, 64)   # the card's build (2048), and a tile of 64 candidates


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
    src, n = re.subn(r"(\w+)<<<([^,]+), ([^,]+), ([^,]+), "
                     r"\(cudaStream_t\)stream>>>\(",
                     r"emu_launch_smem(\2, \3, \4, \1, ", src)
    assert n == 3, "the three launches of csrc/nms.cu found"
    return src


def _build(out, tile):
    cxx = shutil.which("c++") or shutil.which("g++")
    assert cxx, "a C++ compiler on PATH"
    src = out / "nms_emulated.cpp"
    src.write_text(_emulated_source())
    lib = out / f"libnms_emulated_{tile}.so"
    defines = [] if tile is None else [f"-DAICAM_NMS_TILE={tile}"]
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-pthread", *defines, f"-I{DATA}", str(src), "-o", str(lib)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.aicam_nms_keep.argtypes = [i32, i32, ptr, ptr, f32, i32, ptr, ptr,
                                   ptr]
    dll.aicam_nms_keep.restype = i32
    dll.aicam_nms_emit.argtypes = ([i32, i32, ptr, ptr, ctypes.c_longlong,
                                    ptr, ptr, f32, f32, i32, i32]
                                   + [ptr] * 6)
    dll.aicam_nms_emit.restype = i32
    dll.aicam_nms_max_k.restype = i32
    return dll


@pytest.fixture(scope="module")
def emulated_builds(tmp_path_factory):
    """csrc/nms.cu for the host, by tile (``TILES``)."""
    out = tmp_path_factory.mktemp("nms_emulation")
    return {tile: _build(out, tile) for tile in TILES}


@pytest.fixture(scope="module")
def emulated(emulated_builds):
    """csrc/nms.cu for the host, as the card builds it."""
    return emulated_builds[None]


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
    """The first design (v1, ``aicam_nms_keep``): its kept set."""
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
    does not suppress at threshold 0.3 (a comparison in double would).
    Both designs."""
    shifted = torch.tensor([[[0.0, 0.0, 10.0, 1.0], [0.0, 0.0, 3.0, 1.0],
                             [7.0, 0.0, 17.0, 1.0]]])
    valid = torch.ones((1, 3), dtype=torch.bool)
    score = torch.tensor([[0.9, 0.8, 0.7]])
    cls = torch.zeros((1, 3), dtype=torch.int32)
    for criterion, thr, want in (("iou", 0.3, [1, 1, 1]),
                                 ("iou", 0.29, [1, 0, 1]),
                                 ("ios", 0.3, [1, 0, 1]),
                                 ("ios", 0.299, [1, 0, 0])):
        got = _run(emulated, shifted, valid, thr, criterion)
        assert got[0].tolist() == [bool(v) for v in want], (criterion, thr)
        assert torch.equal(got, tnms.greedy_keep_plain(shifted, valid, thr,
                                                       criterion))
        tail = _run_tail(emulated, shifted, score, cls, valid, thr,
                         criterion, 4, 8192.0)
        assert tail[4][0].tolist() == [bool(v) for v in want]
        assert tail[0].tolist() == [sum(want)]


def test_emulated_kernel_refuses_what_it_does_not_take(emulated):
    """v1's C entry point."""
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


# --- the one-launch tail under the emulation ---------------------------------

def _run_tail(lib, boxes, score, cls, valid, threshold, criterion, max_det,
              class_offset, score_stride=None):
    """One emulated call of the tail on CPU tensors, outputs prefilled with
    garbage: ``(num, boxes, scores, labels, kept)`` as torch tensors."""
    b, k = valid.shape
    bx = np.ascontiguousarray(boxes.numpy(), np.float32)
    sc = score.numpy()
    cl = np.ascontiguousarray(cls.numpy(), np.int32)
    va = np.ascontiguousarray(valid.numpy().astype(np.uint8))
    num = np.full(b, -7, np.int32)
    out_boxes = np.full((b, max_det, 4), np.nan, np.float32)
    out_scores = np.full((b, max_det), 7.0, np.float32)
    out_labels = np.full((b, max_det), -7, np.int32)
    kept = np.full((b, k), 7, np.uint8)
    stride = sc.strides[0] // 4 if score_stride is None else score_stride
    err = lib.aicam_nms_emit(
        b, k, bx.ctypes.data, sc.ctypes.data, stride, cl.ctypes.data,
        va.ctypes.data, float(np.float32(class_offset)),
        float(np.float32(threshold)), 0 if criterion == "iou" else 1,
        max_det, num.ctypes.data, out_boxes.ctypes.data,
        out_scores.ctypes.data, out_labels.ctypes.data, kept.ctypes.data,
        None)
    assert err == 0
    assert set(np.unique(kept)) <= {0, 1}
    return (torch.from_numpy(num), torch.from_numpy(out_boxes),
            torch.from_numpy(out_scores), torch.from_numpy(out_labels),
            torch.from_numpy(kept.astype(bool)))


def _same_bits(a, b) -> bool:
    """Equal shapes, dtypes and bytes (NaN where NaN, -0.0 apart from 0)."""
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(np.ascontiguousarray(a).view(np.uint8),
                               np.ascontiguousarray(b).view(np.uint8)))


_JAX_TAILS = {}


def _jax_tail(case):
    """The JAX package's ``_suppress_and_emit`` frame by frame, op by op,
    and the kept set of its ``_greedy_keep`` on the same shifted boxes:
    ``(num, boxes, scores, labels, kept)`` as numpy arrays."""
    if case not in _JAX_TAILS:
        name, boxes, score, cls, valid, thr, crit, max_det, offset = \
            TAIL_CASES[case]
        b, k = valid.shape
        outs = []
        for f in range(b):
            args = [jnp.asarray(t[f].numpy()) for t in (boxes, score, cls,
                                                        valid)]
            tail = jnms._suppress_and_emit(*args, thr, k, max_det,
                                           class_offset=offset,
                                           criterion=crit)
            shifted = args[0] + (args[2].astype(jnp.float32)
                                 * offset)[:, None]
            pairwise = {"iou": jnms._pairwise_iou_xyxy,
                        "ios": jnms._pairwise_ios_xyxy}[crit]
            kept = jnms._greedy_keep(pairwise(shifted) > thr, args[3])
            outs.append([np.asarray(x) for x in (*tail, kept)])
        _JAX_TAILS[case] = [np.stack(x) for x in zip(*outs)]
    return _JAX_TAILS[case]


@pytest.mark.parametrize("case", range(len(TAIL_CASES)),
                         ids=[c[0] for c in TAIL_CASES])
@pytest.mark.parametrize("tile", TILES, ids=["tile 2048", "tile 64"])
def test_emulated_tail_is_bitwise_the_plain_version_and_jax(emulated_builds,
                                                            tile, case):
    """The one-launch kernel's five outputs against the port's plain tail
    (eager, and fixed-K up to K = 500) and the JAX package's; bitwise."""
    name, boxes, score, cls, valid, thr, crit, max_det, offset = \
        TAIL_CASES[case]
    k = valid.shape[-1]
    got = _run_tail(emulated_builds[tile], boxes, score, cls, valid, thr,
                    crit, max_det, offset)
    forms = [False] + ([True] if k <= chip_smoke.NMS_TILED_K else [])
    for fixed in forms:
        want = tnms.suppress_and_emit_plain(boxes, score, cls, valid, thr, k,
                                            max_det, offset, crit, fixed)
        for part, a, w in zip(("num", "boxes", "scores", "labels", "kept"),
                              got, want):
            assert _same_bits(a.numpy(), w.numpy()), (name, part, fixed)
    jax_out = _jax_tail(case)
    for part, a, w in zip(("num", "boxes", "scores", "labels", "kept"), got,
                          jax_out):
        assert _same_bits(a.numpy(), w), (name, part, "JAX")
    assert int(got[0].max()) <= max_det and got[4].sum() >= got[0].sum()


@pytest.mark.parametrize("tile", TILES, ids=["tile 2048", "tile 64"])
def test_emulated_tail_stages_strided_and_unaligned_inputs(emulated_builds,
                                                           tile):
    """Score rows a stride apart (the top-k's slice of a wider sort) and
    every input off the 16-byte grid: the staged copy's ragged ends go by
    plain loads, and the outputs are those of contiguous aligned inputs."""
    lib = emulated_builds[tile]
    name, boxes, score, cls, valid, thr, crit, max_det, offset = \
        TAIL_CASES[-1]
    b, k = valid.shape
    want = _run_tail(lib, boxes, score, cls, valid, thr, crit, max_det,
                     offset)
    wide = np.zeros((b, 3 * k + 7), np.float32)
    wide[:, 5:5 + k] = score.numpy()

    def shifted(x, lead):
        """x's bytes ``lead`` elements past a 16-byte boundary."""
        flat = np.ascontiguousarray(x.numpy()).reshape(-1)
        raw = np.zeros(flat.size + 8, flat.dtype)
        skip = (-raw.ctypes.data % 16) // raw.itemsize + lead
        raw[skip:skip + flat.size] = flat
        return torch.from_numpy(raw[skip:skip + flat.size].reshape(x.shape))

    got = _run_tail(lib, shifted(boxes, 1), torch.from_numpy(wide[:, 5:]),
                    shifted(cls, 3), shifted(valid, 5), thr, crit, max_det,
                    offset, score_stride=wide.shape[1])
    for a, w in zip(got, want):
        assert _same_bits(a.numpy(), w.numpy())


@pytest.mark.parametrize("threshold", [
    0.0, -0.0, 1e-45, 1e-38, 0.3, 0.5, 0.99999994, 1.0, -0.5,
    float(np.finfo(np.float32).max), float("inf"), float("-inf"),
    float("nan")])
def test_emulated_tail_thresholds_at_the_edges(emulated, threshold):
    """The one launch decides ``overlap > thr`` without dividing (against
    the midpoint of thr and the next f32, in double): its kept set and
    outputs are the plain tail's at thresholds at the edges of f32, on a
    crowded frame and on tiny boxes whose intersections and quotients are
    denormal."""
    name, boxes, score, cls, valid, thr, crit, max_det, offset = \
        TAIL_CASES[0]
    rng = np.random.RandomState(3)
    tiny = (rng.rand(1, 64, 4) * 1e-19).astype(np.float32)
    tiny[..., 2:] += tiny[..., :2]
    cases = [(boxes[:2], score[:2], cls[:2], valid[:2]),
             (torch.from_numpy(tiny), score[:1, :64], cls[:1, :64],
              torch.ones((1, 64), dtype=torch.bool))]
    for crit in ("iou", "ios"):
        for b, sc, c, v in cases:
            got = _run_tail(emulated, b, sc, c, v, threshold, crit, 100,
                            offset)
            want = tnms.suppress_and_emit_plain(b, sc, c, v, threshold,
                                                v.shape[-1], 100, offset,
                                                crit)
            for part, a, w in zip(("num", "boxes", "scores", "labels",
                                   "kept"), got, want):
                assert _same_bits(a.numpy(), w.numpy()), (crit, part)


def test_emulated_tail_refuses_what_it_does_not_take(emulated):
    """The one-launch entry point: no frame, K of 0 or past ``MAX_K``,
    max_det below 0, a negative score stride, boxes off the 4-byte grid."""
    boxes = np.zeros((1, 4, 4), np.float32)
    flags = np.ones((1, 4), np.uint8)
    score = np.ones((1, 4), np.float32)
    cls = np.zeros((1, 4), np.int32)
    outs = [np.zeros(64, np.float32) for _ in range(5)]
    for b, k, max_det, stride, off in ((0, 4, 8, 4, 0), (1, 0, 8, 4, 0),
                                       (1, tnms.MAX_K + 1, 8, 4, 0),
                                       (1, 4, -1, 4, 0), (1, 4, 8, -1, 0),
                                       (1, 4, 8, 4, 1)):
        assert emulated.aicam_nms_emit(
            b, k, boxes.ctypes.data + off, score.ctypes.data, stride,
            cls.ctypes.data, flags.ctypes.data, 8192.0, 0.5, 0, max_det,
            *(o.ctypes.data for o in outs), None) != 0


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
        want = tnms.suppress_and_emit_plain(shifted, score, cls, valid, thr,
                                            k, 100, criterion=criterion)
        for a, w in zip((num, boxes, scores, labels), want):
            assert torch.equal(a, w)
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
        tnms.KERNEL.keep_v1(s, v, thr, criterion)
    assert tnms.KERNEL.launches == before


def test_the_kernel_raises_on_k_past_its_limit_and_odd_arguments():
    shifted, valid, thr, criterion = _good_args()
    before = tnms.KERNEL.launches
    big = torch.zeros((1, tnms.MAX_K + 1, 4))
    with pytest.raises(ValueError, match="1 <= K"):
        tnms.KERNEL.keep_v1(big, torch.ones((1, tnms.MAX_K + 1),
                                            dtype=torch.bool), thr)
    with pytest.raises(ValueError, match="criterion"):
        tnms.KERNEL.keep_v1(shifted, valid, thr, "giou")
    with pytest.raises(TypeError, match="threshold"):
        tnms.KERNEL.keep_v1(shifted, valid, torch.tensor(thr), criterion)
    # the right arguments on the CPU: the kernel takes CUDA tensors only
    with pytest.raises(ValueError, match="CUDA"):
        tnms.KERNEL.keep_v1(shifted, valid, thr, criterion)
    assert tnms.KERNEL.launches == before


def _tail_args():
    name, boxes, score, cls, valid, thr, crit, max_det, offset = \
        TAIL_CASES[-1]
    return boxes, score, cls, valid, thr, crit, max_det, offset


@pytest.mark.parametrize("bad,error,match", [
    (lambda a: dict(a, boxes=a["boxes"].double()), TypeError, "float32"),
    (lambda a: dict(a, score=a["score"].half()), TypeError, "score"),
    (lambda a: dict(a, cls=a["cls"].long()), TypeError, "int32"),
    (lambda a: dict(a, valid=a["valid"].to(torch.uint8)), TypeError,
     "bool"),
    (lambda a: dict(a, boxes=a["boxes"][None]), ValueError,
     r"\(B, K, 4\)"),
    (lambda a: dict(a, cls=a["cls"][:, :-1]), ValueError, "cls must be"),
    (lambda a: dict(a, score=a["score"][:1]), ValueError, "score must be"),
    (lambda a: dict(a, boxes=a["boxes"][:, :0], score=a["score"][:, :0],
                    cls=a["cls"][:, :0], valid=a["valid"][:, :0]),
     ValueError, "1 <= K"),
    (lambda a: dict(a, boxes=a["boxes"].transpose(0, 1).contiguous()
                    .transpose(0, 1)), ValueError, "contiguous"),
    (lambda a: dict(a, score=a["score"].t().contiguous().t()), ValueError,
     "contiguous"),
    (lambda a: dict(a, thr=torch.tensor(0.5)), TypeError, "threshold"),
    (lambda a: dict(a, offset=torch.tensor(8192.0)), TypeError,
     "class_offset"),
    (lambda a: dict(a, max_det=-1), ValueError, "max_det"),
    (lambda a: dict(a, max_det=2.5), ValueError, "max_det"),
    (lambda a: dict(a, crit="giou"), ValueError, "criterion"),
    (lambda a: a, ValueError, "CUDA"),  # right, but on the CPU
])
def test_the_tail_kernel_raises_on_what_it_does_not_take(bad, error, match):
    boxes, score, cls, valid, thr, crit, max_det, offset = _tail_args()
    a = bad(dict(boxes=boxes, score=score, cls=cls, valid=valid, thr=thr,
                 crit=crit, max_det=max_det, offset=offset))
    before = tnms.KERNEL.launches
    with pytest.raises(error, match=match):
        tnms.KERNEL(a["boxes"], a["score"], a["cls"], a["valid"], a["thr"],
                    a["max_det"], a["offset"], a["crit"])
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
