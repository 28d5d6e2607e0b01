"""Fused DFL decode + top-k + class-aware greedy NMS in PyTorch.

The port of ``aicamera_tpu/ops/nms.py`` (``fused_decode_nms`` and its
helpers), with the reference engine's ``(num, boxes, scores, labels)`` output
contract. Tie order follows ``lax.top_k``: on equal scores the lower index
comes first, which a stable descending sort gives (``torch.topk`` on CUDA
promises no order). Labels come from the argmax over logits (first maximum).

The tail over a chunk's score-ordered candidates (:func:`_suppress_and_emit`:
class shift, greedy keep, emit) runs where its tensors lie. On the card it is
the NMS kernel (``csrc/nms.cu``, ``KERNEL``): one launch for every frame of
the batch, the shift, the overlaps, the scan and the emit in it, nothing
read back and no scratch, so a CUDA graph can capture it; each call adds one
to ``KERNEL.launches``. On the CPU it is the plain version
(:func:`suppress_and_emit_plain`): the JAX package's fixpoint iteration run
batched over the chunk (:func:`_greedy_keep` over
:func:`_pairwise_iou_xyxy` or :func:`_pairwise_ios_xyxy`; a frame that has
converged stays fixed under further iterations, so iterating until every
frame has converged gives each frame's own fixpoint), then a stable top-k
emit. Each iteration costs one read (``NMS_SYNCS`` counts them); with
``fixed_iters=True`` it runs K iterations and reads nothing, the same
result. The two give the same outputs bit for bit: the kernel's shift and
overlap are the same sequences of rounded operations, and its emit in index
order is the stable top-k because the kept candidates' scores do not
increase along K. There is no fallback from one to the other: a CUDA tensor
launches the kernel or raises. ``KERNEL.keep_v1`` is the kernel's first
design (the keep alone of shifted boxes, two launches), kept for
measurements and tests on no path.

Replaces the JAX package's device loop (XLA, not Pallas) and the jitted
program around it: ``aicamera_tpu/ops/nms.py``'s ``_greedy_keep`` and its
``lax.while_loop``, over the overlap that ``_suppress_and_emit`` builds,
with its class shift and emit.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from ..syncs import SyncCounter
from . import cuda_build
from .letterbox import _current_stream

# Class-aware NMS trick: shift boxes per class so different classes never
# overlap. Larger than any letterboxed coordinate.
_CLASS_OFFSET = 8192.0

NMS_SYNCS = SyncCounter()


def _topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last axis, lower index first on ties (``lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _pairwise_iou_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(..., K, 4) xyxy -> (..., K, K) IoU."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-7)


def _pairwise_ios_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(..., K, 4) xyxy -> (..., K, K) intersection over the smaller area.

    A small fragment fully inside a larger box scores about 1 whatever the
    size ratio: the merge of tiled detections uses it to collapse
    tile-boundary fragments against the full-frame detection."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    smaller = torch.minimum(area[..., :, None], area[..., None, :])
    return inter / torch.clamp(smaller, min=1e-7)


_PAIRWISE = {"iou": _pairwise_iou_xyxy, "ios": _pairwise_ios_xyxy}


def _greedy_keep(overlap: torch.Tensor, valid: torch.Tensor,
                 fixed_iters: bool = False) -> torch.Tensor:
    """Exact greedy-NMS keep set by fixpoint iteration, batched: the plain
    version (the CPU path, and the kernel's oracle on the card).

    ``overlap`` (B, K, K) bool, ``valid`` (B, K) bool over score-ordered
    candidates. The greedy scan is the unique fixpoint of
    ``kept[i] = valid[i] and not any_{j<i}(kept[j] and overlap[j, i])``;
    Jacobi iteration from ``kept = valid`` reaches it in at most K steps
    (``kept[i]`` is final once every ``kept[j<i]`` is, so after ``i + 1``
    steps). The eager form stops at the fixpoint, one read a step;
    ``fixed_iters`` runs all K steps with no read: the steps after the
    fixpoint change nothing. :func:`_suppress_and_emit` takes this only for
    CPU tensors; on the card it launches the kernel, whatever
    ``fixed_iters`` says.
    """
    k = overlap.shape[-1]
    lower = torch.tril(torch.ones((k, k), dtype=torch.bool,
                                  device=overlap.device), diagonal=-1)
    ov_lower = (overlap & lower.T).float()  # ov_lower[j, i]: j < i
    if fixed_iters:
        valid_f = valid.float()
        kept_f = valid_f
        for _ in range(k):
            hits = torch.matmul(kept_f[..., None, :], ov_lower)[..., 0, :]
            kept_f = valid_f * (hits == 0)  # hits count kept j < i
        return kept_f > 0
    kept, prev = valid, ~valid
    it = 0
    while it < k and NMS_SYNCS.flag(torch.any(kept != prev)):
        sup = torch.matmul(kept.float()[..., None, :], ov_lower)[..., 0, :] > 0
        kept, prev = valid & ~sup, kept
        it += 1
    return kept


def greedy_keep_plain(shifted: torch.Tensor, valid: torch.Tensor,
                      threshold: float, criterion: str = "iou",
                      fixed_iters: bool = False) -> torch.Tensor:
    """What the NMS kernel computes, in plain PyTorch: the keep set of
    class-shifted boxes ``shifted (..., K, 4)`` under ``valid (..., K)``,
    ``_greedy_keep(pairwise(shifted) > threshold, valid)``."""
    return _greedy_keep(_pairwise(criterion)(shifted) > threshold, valid,
                        fixed_iters)


def _pairwise(criterion: str):
    pairwise = _PAIRWISE.get(criterion)
    if pairwise is None:
        raise ValueError(f"criterion must be 'iou' or 'ios', got "
                         f"{criterion!r}")
    return pairwise


MAX_K = 16384  # the most candidates a frame the kernel takes


def check_args(shifted: torch.Tensor, valid: torch.Tensor, threshold,
               criterion: str) -> None:
    """The argument checks the first design (:meth:`NmsKernel.keep_v1`)
    relies on (device-independent):
    ``shifted`` f32 ``(..., K, 4)`` with ``1 <= K <= MAX_K`` and at most
    65535 frames, ``valid`` bool ``(..., K)`` of the same frames, both
    contiguous and on one device; ``threshold`` a Python or numpy number;
    ``criterion`` ``"iou"`` or ``"ios"``."""
    _pairwise(criterion)
    if shifted.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"the NMS kernel takes float32 boxes and bool valid "
                        f"(got {shifted.dtype}, {valid.dtype})")
    if shifted.ndim < 2 or shifted.shape[-1] != 4:
        raise ValueError(f"boxes must be (..., K, 4) (got "
                         f"{tuple(shifted.shape)})")
    if tuple(valid.shape) != tuple(shifted.shape[:-1]):
        raise ValueError(f"valid must be {tuple(shifted.shape[:-1])} (got "
                         f"{tuple(valid.shape)})")
    k = shifted.shape[-2]
    frames = valid.numel() // max(k, 1)
    if not 1 <= k <= MAX_K or not 1 <= frames <= 65535:
        raise ValueError(f"the NMS kernel takes 1 <= K <= {MAX_K} candidates "
                         f"and 1 to 65535 frames (got "
                         f"{tuple(shifted.shape)})")
    if not (shifted.is_contiguous() and valid.is_contiguous()):
        raise ValueError("the NMS kernel takes contiguous boxes and valid")
    if valid.device != shifted.device:
        raise ValueError(f"valid is on {valid.device}, boxes on "
                         f"{shifted.device}")
    if not np.isscalar(threshold):
        raise TypeError(f"threshold must be a number (got "
                        f"{type(threshold).__name__}): a tensor would be "
                        f"read back")


def check_emit_args(k_boxes: torch.Tensor, k_score: torch.Tensor,
                    k_cls: torch.Tensor, k_valid: torch.Tensor, threshold,
                    max_det: int, class_offset, criterion: str) -> None:
    """The argument checks the one-launch kernel relies on
    (device-independent): ``k_boxes`` f32 ``(B, K, 4)``, ``k_cls`` int32 and
    ``k_valid`` bool ``(B, K)``, all three contiguous, ``k_score`` f32
    ``(B, K)`` with contiguous rows (any row stride: the top-k's slice),
    ``1 <= K <= MAX_K`` and ``1 <= B <= 65535``, all on one device;
    ``threshold`` and ``class_offset`` Python or numpy numbers;
    ``max_det`` an int >= 0; ``criterion`` ``"iou"`` or ``"ios"``."""
    _pairwise(criterion)
    if k_boxes.ndim != 3 or k_boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, K, 4) (got "
                         f"{tuple(k_boxes.shape)})")
    b, k = k_boxes.shape[:2]
    want = {"boxes": (k_boxes, torch.float32), "score": (k_score,
                                                         torch.float32),
            "cls": (k_cls, torch.int32), "valid": (k_valid, torch.bool)}
    for name, (t, dtype) in want.items():
        if t.dtype != dtype:
            raise TypeError(f"the NMS kernel takes {dtype} {name} (got "
                            f"{t.dtype})")
        if name != "boxes" and tuple(t.shape) != (b, k):
            raise ValueError(f"{name} must be {(b, k)} (got "
                             f"{tuple(t.shape)})")
        if t.device != k_boxes.device:
            raise ValueError(f"{name} is on {t.device}, boxes on "
                             f"{k_boxes.device}")
    if not 1 <= k <= MAX_K or not 1 <= b <= 65535:
        raise ValueError(f"the NMS kernel takes 1 <= K <= {MAX_K} candidates "
                         f"and 1 to 65535 frames (got "
                         f"{tuple(k_boxes.shape)})")
    if not (k_boxes.is_contiguous() and k_cls.is_contiguous()
            and k_valid.is_contiguous() and (k == 1 or k_score.stride(1)
                                             == 1)):
        raise ValueError("the NMS kernel takes contiguous boxes, classes, "
                         "valid and score rows")
    for name, v in (("threshold", threshold), ("class_offset",
                                                 class_offset)):
        if not np.isscalar(v):
            raise TypeError(f"{name} must be a number (got "
                            f"{type(v).__name__}): a tensor would be read "
                            f"back")
    if not isinstance(max_det, (int, np.integer)) or max_det < 0:
        raise ValueError(f"max_det must be an int >= 0 (got {max_det!r})")


# the one-launch design's phase probe, in the order of csrc/nms.cu's
# ProbeSlot: blocks, thread 0's cycles by phase (the rest of the staging
# copy's wait, n (the copy in flight), the shift, the diagonal words, the
# scan's barrier waits, its resolves and its items, the emit, later tiles,
# the tail), each block's cycles from entry to exit, and counts of scan
# steps, diagonal items and OR items
PROBE_SLOTS = ("blocks", "stage", "count", "shift", "diag", "wait",
               "resolve", "items", "emit", "stream", "tail", "total",
               "steps", "diag_items", "or_items")


class NmsKernel:
    """Builds, loads and launches ``csrc/nms.cu``; counts calls. A call of
    the kernel is one launch that does the whole tail for every frame of
    the batch; a call of ``keep_v1`` is the first design's two launches
    (the overlap mask, then the scan). Each adds one to ``launches``.
    ``probe=True``: the build with the one-launch design's phase probe
    (``-DAICAM_NMS_PROBE``; measurements only), read by
    :meth:`read_probe`."""

    name = "nms"
    source = cuda_build.CSRC_DIR / "nms.cu"
    replaces = ("aicamera_tpu/ops/nms.py:36 _greedy_keep (its "
                "lax.while_loop at :66) over _suppress_and_emit's overlap "
                "(:109), with the class shift (:108) and the emit (:112-125) "
                "around it (XLA, not Pallas)")
    #: no fused multiply-adds: each operation rounds as the plain version's
    #: separate PyTorch kernels round it
    flags = ("--fmad=false",)

    def __init__(self, probe: bool = False):
        self.launches = 0
        self.probe = probe
        self.defines = ("AICAM_NMS_PROBE",) if probe else ()
        self._lib = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = cuda_build.load_library(self.source, self.defines,
                                              self.flags)
                ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
                lib.aicam_nms_emit.argtypes = (
                    [i32, i32, ptr, ptr, ctypes.c_longlong, ptr, ptr, f32,
                     f32, i32, i32] + [ptr] * 6)
                lib.aicam_nms_emit.restype = i32
                lib.aicam_nms_keep.argtypes = [i32, i32, ptr, ptr, f32, i32,
                                               ptr, ptr, ptr]
                lib.aicam_nms_keep.restype = i32
                lib.aicam_nms_max_k.restype = i32
                if lib.aicam_nms_max_k() != MAX_K:
                    raise RuntimeError("csrc/nms.cu's kMaxK is not MAX_K")
                if self.probe:
                    lib.aicam_nms_probe.argtypes = [ctypes.c_void_p, i32]
                    lib.aicam_nms_probe.restype = i32
                self._lib = lib
            return self._lib

    def read_probe(self, reset: bool = True) -> dict:
        """The probe's sums since the last reset (``PROBE_SLOTS``);
        synchronous. ``reset`` zeroes them."""
        if not self.probe:
            raise RuntimeError("read_probe needs NmsKernel(probe=True)")
        lib = self.load()
        buf = (ctypes.c_ulonglong * len(PROBE_SLOTS))()
        got = lib.aicam_nms_probe(buf, int(reset))
        if got != len(PROBE_SLOTS):
            raise RuntimeError(f"NMS probe read failed ({got})")
        return dict(zip(PROBE_SLOTS, buf))

    def _launch(self, fn, dev, args, what):
        if dev.index == torch.cuda.current_device():
            err = fn(*args, _current_stream(dev))
        else:
            with torch.cuda.device(dev):
                err = fn(*args, _current_stream(dev))
        if err != 0:
            raise RuntimeError(f"NMS kernel launch failed: CUDA error {err} "
                               f"({what})")
        self.launches += 1

    def __call__(self, k_boxes: torch.Tensor, k_score: torch.Tensor,
                 k_cls: torch.Tensor, k_valid: torch.Tensor, threshold,
                 max_det: int, class_offset=_CLASS_OFFSET,
                 criterion: str = "iou"):
        """The whole tail of (B, K) score-ordered candidates (scores not
        increasing along K) in one launch: ``(num (B,) int32, boxes
        (B, max_det, 4) f32, scores (B, max_det) f32, labels (B, max_det)
        int32, kept (B, K) bool)``, bit for bit
        :func:`suppress_and_emit_plain`'s, ``threshold`` and
        ``class_offset`` taken as the f32 they round to. Takes CUDA
        tensors only (:func:`check_emit_args`); raises on anything else."""
        check_emit_args(k_boxes, k_score, k_cls, k_valid, threshold,
                        max_det, class_offset, criterion)
        if k_boxes.device.type != "cuda":
            raise ValueError(f"the NMS kernel needs CUDA tensors (got "
                             f"{k_boxes.device})")
        lib = self._lib or self.load()
        b, k = k_valid.shape
        dev = k_boxes.device
        num = torch.empty((b,), dtype=torch.int32, device=dev)
        out_boxes = torch.empty((b, max_det, 4), dtype=torch.float32,
                                device=dev)
        out_score = torch.empty((b, max_det), dtype=torch.float32,
                                device=dev)
        out_cls = torch.empty((b, max_det), dtype=torch.int32, device=dev)
        kept = torch.empty((b, k), dtype=torch.bool, device=dev)
        args = (b, k, k_boxes.data_ptr(), k_score.data_ptr(),
                k_score.stride(0), k_cls.data_ptr(), k_valid.data_ptr(),
                float(np.float32(class_offset)),
                float(np.float32(threshold)), 0 if criterion == "iou" else 1,
                int(max_det), num.data_ptr(), out_boxes.data_ptr(),
                out_score.data_ptr(), out_cls.data_ptr(), kept.data_ptr())
        self._launch(lib.aicam_nms_emit, dev, args,
                     f"boxes {tuple(k_boxes.shape)}, {criterion}")
        return num, out_boxes, out_score, out_cls, kept

    def keep_v1(self, shifted: torch.Tensor, valid: torch.Tensor,
                threshold: float, criterion: str = "iou") -> torch.Tensor:
        """The first design: the keep set ``(..., K)`` bool of class-shifted,
        score-ordered boxes ``shifted (..., K, 4)`` f32 under ``valid
        (..., K)`` bool, ``_greedy_keep(pairwise(shifted) > threshold,
        valid)`` bit for bit, ``threshold`` compared as the f32 it rounds
        to; two launches and a scratch mask. Takes CUDA tensors only, 1 <=
        K <= ``MAX_K`` (16384) and at most 65535 frames; raises on anything
        else. On no path: for measurements and tests."""
        check_args(shifted, valid, threshold, criterion)
        if shifted.device.type != "cuda":
            raise ValueError(f"the NMS kernel needs CUDA tensors (got "
                             f"{shifted.device})")
        lib = self._lib or self.load()
        k = shifted.shape[-2]
        frames = valid.numel() // k
        words = -(-k // 32)
        dev = shifted.device
        # the overlap mask, (frames, W, 32 W) words; torch.empty is 16-byte
        # aligned (the scan reads it in 16-byte loads)
        mask = torch.empty((frames, words, 32 * words), dtype=torch.int32,
                           device=dev)
        kept = torch.empty(valid.shape, dtype=torch.bool, device=dev)
        args = (frames, k, shifted.data_ptr(), valid.data_ptr(),
                float(np.float32(threshold)), 0 if criterion == "iou" else 1,
                mask.data_ptr(), kept.data_ptr())
        self._launch(lib.aicam_nms_keep, dev, args,
                     f"v1, boxes {tuple(shifted.shape)}, {criterion}")
        return kept


KERNEL = NmsKernel()


def emit_plain(kept, k_boxes, k_score, k_cls, top_k: int, max_det: int):
    """The emit in plain PyTorch: the stable top ``max_det`` of
    ``where(kept, k_score, -1)`` over (B, K) candidates, those with a score
    above 0 written, every other slot zeros. Returns ``(num, boxes, scores,
    labels)``."""
    order_score = torch.where(kept, k_score, torch.full_like(k_score, -1.0))
    if max_det > top_k:  # more output slots than candidates: pad
        pad = max_det - top_k
        order_score = torch.nn.functional.pad(order_score, (0, pad),
                                              value=-1.0)
        k_boxes = torch.nn.functional.pad(k_boxes, (0, 0, 0, pad))
        k_cls = torch.nn.functional.pad(k_cls, (0, pad))
    out_score, out_pos = _topk_stable(order_score, max_det)
    out_valid = out_score > 0
    out_boxes = torch.gather(k_boxes, -2,
                             out_pos[..., None].expand(*out_pos.shape, 4))
    out_boxes = torch.where(out_valid[..., None], out_boxes,
                            torch.zeros_like(out_boxes))
    out_cls = torch.where(out_valid, torch.gather(k_cls, -1, out_pos),
                          torch.zeros_like(out_pos, dtype=k_cls.dtype))
    out_score = torch.where(out_valid, out_score,
                            torch.zeros_like(out_score))
    num = out_valid.sum(-1).to(torch.int32)
    return num, out_boxes, out_score, out_cls


def suppress_and_emit_plain(k_boxes, k_score, k_cls, k_valid, iou_threshold,
                            top_k: int, max_det: int,
                            class_offset: float = _CLASS_OFFSET,
                            criterion: str = "iou",
                            fixed_iters: bool = False):
    """What the NMS kernel computes, in plain PyTorch (the CPU path, and the
    kernel's oracle on the card): class shift, greedy keep
    (:func:`greedy_keep_plain`, ``fixed_iters`` as in :func:`_greedy_keep`),
    then :func:`emit_plain`. Returns ``(num, boxes, scores, labels,
    kept)``."""
    shifted = k_boxes + (k_cls.float() * class_offset)[..., None]
    kept = greedy_keep_plain(shifted, k_valid, iou_threshold, criterion,
                             fixed_iters)
    return (*emit_plain(kept, k_boxes, k_score, k_cls, top_k, max_det),
            kept)


def _suppress_and_emit(k_boxes, k_score, k_cls, k_valid, iou_threshold,
                       top_k: int, max_det: int,
                       class_offset: float = _CLASS_OFFSET,
                       criterion: str = "iou", fixed_iters: bool = False):
    """Shared NMS tail over (B, K) score-ordered candidates: class shift,
    greedy suppression, emit the top ``max_det`` kept candidates. The
    candidates' scores must not increase along K (both callers sort them:
    ``fused_decode_nms`` by a stable top-k, ``merge_detections`` fully), as
    the JAX package's docstring says of its inputs. ``class_offset`` must
    exceed the largest box coordinate; ``criterion`` is the pairwise
    overlap measure, ``"iou"`` or ``"ios"``. Returns ``(num, boxes, scores,
    labels)``. CUDA tensors take the NMS kernel, one launch with no read
    (``fixed_iters`` changes nothing there); CPU tensors the plain version
    (:func:`suppress_and_emit_plain`, ``fixed_iters`` as in
    :func:`_greedy_keep`)."""
    if k_boxes.device.type == "cuda":
        out = KERNEL(k_boxes, k_score, k_cls, k_valid, iou_threshold,
                     max_det, class_offset, criterion)
    else:
        out = suppress_and_emit_plain(k_boxes, k_score, k_cls, k_valid,
                                      iou_threshold, top_k, max_det,
                                      class_offset, criterion, fixed_iters)
    return out[:4]


@functools.lru_cache(maxsize=64)
def _anchor_tables(level_hw, strides, device):
    """Flat per-anchor (cx, cy) cell centres and strides, row-major over
    (h, w) per level; uploaded once per ``(level_hw, strides, device)`` and
    shared (read only)."""
    centers, stride_tab = [], []
    for (h, w), s in zip(level_hw, strides):
        ys = np.arange(h, dtype=np.float32) + 0.5
        xs = np.arange(w, dtype=np.float32) + 0.5
        centers.append(np.stack([np.tile(xs, h), np.repeat(ys, w)], axis=-1))
        stride_tab.append(np.full(h * w, s, np.float32))
    return (torch.from_numpy(np.concatenate(centers)).to(device),
            torch.from_numpy(np.concatenate(stride_tab)).to(device))


def fused_decode_nms(level_outputs, score_threshold: float = 0.25,
                     iou_threshold: float = 0.5, top_k: int = 300,
                     max_det: int = 100, strides=(8, 16, 32),
                     fixed_iters: bool = False):
    """Decode + NMS fused: DFL box decoding only for the top-k candidates.

    ``level_outputs``: per level ``(box_bins (B, h, w, 4*reg_max),
    cls_logits (B, h, w, C))`` NHWC. Returns ``num (B,) int32, boxes
    (B, max_det, 4) f32, scores (B, max_det) f32, labels (B, max_det)
    int32`` in letterboxed coordinates. The tail is the NMS kernel on the
    card (one launch, no read) and the plain version on the CPU;
    ``fixed_iters``: the plain version without reads (the same result),
    which the kernel makes moot on the card.
    """
    reg_max = level_outputs[0][0].shape[-1] // 4
    level_hw = tuple((bb.shape[1], bb.shape[2]) for bb, _ in level_outputs)
    batch = level_outputs[0][0].shape[0]
    device = level_outputs[0][0].device

    bins = torch.cat([bb.reshape(batch, -1, 4 * reg_max)
                      for bb, _ in level_outputs], dim=1)
    logits = torch.cat([cl.reshape(batch, -1, cl.shape[-1])
                        for _, cl in level_outputs], dim=1)
    k = min(top_k, bins.shape[1])
    centers, stride_tab = _anchor_tables(level_hw, tuple(strides),
                                         device)
    dfl_bins = torch.arange(reg_max, dtype=torch.float32, device=device)

    best_logit = torch.amax(logits, dim=-1)
    best_cls = torch.argmax(logits, dim=-1).to(torch.int32)  # first maximum
    best_score = torch.sigmoid(best_logit.float())
    valid = best_score >= score_threshold
    cand_score = torch.where(valid, best_score,
                             torch.full_like(best_score, -1.0))

    k_score, k_idx = _topk_stable(cand_score, k)                # (B, K)
    k_bins = torch.gather(bins, 1, k_idx[..., None].expand(
        batch, k, bins.shape[-1])).float().reshape(batch, k, 4, reg_max)
    dist = torch.sum(torch.softmax(k_bins, dim=-1) * dfl_bins, dim=-1)
    ctr = centers[k_idx]                                        # (B, K, 2)
    st = stride_tab[k_idx]                                      # (B, K)
    k_boxes = torch.stack(
        [(ctr[..., 0] - dist[..., 0]) * st,
         (ctr[..., 1] - dist[..., 1]) * st,
         (ctr[..., 0] + dist[..., 2]) * st,
         (ctr[..., 1] + dist[..., 3]) * st], dim=-1)
    k_cls = torch.gather(best_cls, 1, k_idx)
    k_valid = k_score > 0
    return _suppress_and_emit(k_boxes, k_score, k_cls, k_valid,
                              iou_threshold, k, max_det,
                              fixed_iters=fixed_iters)
