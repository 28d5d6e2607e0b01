"""The assignment kernel (``csrc/assignment.cu``) and its wrapper.

One launch solves a masked minimum-cost matching (:meth:`AssignmentKernel.
min_cost_matching`), or a whole DeepSORT matching cascade over its levels
(:meth:`AssignmentKernel.matching_cascade`), for one problem (``cost (R,
C)``) or for a batch of B problems (``cost (B, R, C)``, a thread block a
problem: the streams of a multi-stream dispatch, as the JAX package vmaps
the step over them), on the current stream, and reads nothing back: the
tracking step around it stays on the device, and a CUDA graph can capture
it. Each launch adds one to ``KERNEL.launches``, whatever B is; the kernel
reads the tracker's int32 levels as they are and clamps them itself, so a
cascade is one launch and nothing else.

A batch must lie in memory as the kernel reads it: contiguous, with C a
multiple of 4 and a 16-byte-aligned start, so that every problem's rows
start where ``cp.async`` copies 16 bytes at a time. Any other batch raises;
the wrapper never copies one into shape.

The kernel computes exactly what the plain PyTorch versions in
``core/assignment.py`` compute (the CPU path and the kernel's oracle on the
card); ``core.assignment.min_cost_matching`` and ``matching_cascade`` pick
between the two by the tensors' device. There is no fallback from one to the
other: a CUDA tensor launches the kernel or raises.

Two designs are built from the one source: ``"lanes"`` (the default, every
path's: the live problem searched in one warp's registers) and ``"v1"`` (the
first design, kept for measurements and tests, on no path, one problem a
launch; its levels go through a clamp launch first, as they did when it was
the default).
``AssignmentKernel(probe=True)`` builds a second library with the phase
probe compiled in (``-DAICAM_ASG_PROBE``); :meth:`AssignmentKernel.
read_probe` returns its sums.

Replaces the JAX package's device loops (XLA, not Pallas) in
``aicamera_tpu/core/assignment.py``: ``solve_square``, ``min_cost_matching``
and ``matching_cascade``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import cuda_build
from .letterbox import _current_stream

__all__ = ["KERNEL", "MAX_N", "PROBE_SLOTS", "VARIANTS", "AssignmentKernel",
           "check_args"]

MAX_N = 256   # the largest max(R, C) the kernel takes
VARIANTS = ("lanes", "v1")   # the designs; the first is every path's
# the probe's sums over problems (blocks), in the order of
# csrc/assignment.cu's ProbeSlot: problems, thread 0's cycles by phase, then
# counts and the cycles of whole problems
PROBE_SLOTS = ("problems", "load", "stage", "feasibility", "levels", "init",
               "argmin", "augment", "accept", "output", "solves",
               "rows_augmented", "steps", "total")


def check_args(cost: torch.Tensor, row_mask: torch.Tensor,
               col_mask: torch.Tensor) -> None:
    """The argument checks the kernel relies on (device-independent):
    ``cost (R, C)`` or a batch ``(B, R, C)``, f32 with ``1 <= B, R, C`` and
    ``max(R, C) <= MAX_N``, bool masks of ``(R,)`` and ``(C,)`` (``(B, R)``
    and ``(B, C)``) on its device."""
    if cost.dtype != torch.float32:
        raise TypeError(f"cost must be float32 (got {cost.dtype})")
    if cost.ndim not in (2, 3) or min(cost.shape) < 1:
        raise ValueError(f"cost must be (R, C) or (B, R, C) with B, R, C >= "
                         f"1 (got {tuple(cost.shape)})")
    *batch, r, c = cost.shape
    if max(r, c) > MAX_N:
        raise ValueError(f"the assignment solver takes max(R, C) <= {MAX_N} "
                         f"(got {tuple(cost.shape)})")
    for name, mask, size in (("row_mask", row_mask, r),
                             ("col_mask", col_mask, c)):
        want = (*batch, size)
        if mask.dtype != torch.bool or tuple(mask.shape) != want:
            raise ValueError(f"{name} must be a {want} bool tensor (got "
                             f"{tuple(mask.shape)} {mask.dtype})")
        if mask.device != cost.device:
            raise ValueError(f"{name} is on {mask.device}, cost on "
                             f"{cost.device}")


class AssignmentKernel:
    """Builds, loads and launches ``csrc/assignment.cu``; counts launches
    (one a call, whatever the batch). ``probe=True``: the build with the
    phase probe (measurements only)."""

    name = "assignment"
    source = cuda_build.CSRC_DIR / "assignment.cu"
    replaces = ("aicamera_tpu/core/assignment.py:97 solve_square, "
                ":179 min_cost_matching, :229 matching_cascade")

    def __init__(self, probe: bool = False):
        self.launches = 0
        self.probe = probe
        self.defines = ("AICAM_ASG_PROBE",) if probe else ()
        self._lib = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = cuda_build.load_library(self.source, self.defines)
                ptr, i32 = ctypes.c_void_p, ctypes.c_int
                rest = [ptr] * 3 + [ctypes.c_float, i32] + [ptr] * 3
                lib.aicam_assignment.argtypes = [ptr, i32, i32, i32] + rest
                lib.aicam_assignment_v1.argtypes = [ptr, i32, i32] + rest
                for fn in (lib.aicam_assignment, lib.aicam_assignment_v1):
                    fn.restype = i32
                if self.probe:
                    lib.aicam_assignment_probe.argtypes = [ptr, i32]
                    lib.aicam_assignment_probe.restype = i32
                self._lib = lib
            return self._lib

    def read_probe(self, reset: bool = True) -> dict:
        """The probe's sums over problems since the last reset
        (``PROBE_SLOTS``: problems, cycles of thread 0 by phase, solves,
        rows augmented, augmenting steps, cycles of whole problems; a batch
        of B adds B problems); synchronous. ``reset`` zeroes them."""
        if not self.probe:
            raise RuntimeError("read_probe needs AssignmentKernel(probe=True)")
        lib = self.load()
        buf = (ctypes.c_ulonglong * len(PROBE_SLOTS))()
        got = lib.aicam_assignment_probe(buf, int(reset))
        if got != len(PROBE_SLOTS):
            raise RuntimeError(f"assignment probe read failed ({got})")
        return dict(zip(PROBE_SLOTS, buf))

    def _launch(self, variant, cost, row_mask, levels, col_mask, max_distance,
                depth, match, unmatched):
        if cost.device.type != "cuda":
            raise ValueError(f"the assignment kernel needs CUDA tensors (got "
                             f"{cost.device})")
        if variant not in VARIANTS:
            raise ValueError(f"variant must be one of {VARIANTS} (got "
                             f"{variant!r})")
        batched = cost.ndim == 3
        if batched:
            if variant == "v1":
                raise ValueError("the v1 design solves one problem a launch "
                                 "(got a batch)")
            b, r, c = cost.shape
            if not cost.is_contiguous() or c % 4 or cost.data_ptr() % 16:
                raise ValueError(
                    f"a batch of problems must be contiguous with C % 4 == 0 "
                    f"and a 16-byte-aligned start, so that every problem's "
                    f"rows are 16-byte aligned for cp.async (got "
                    f"{tuple(cost.shape)}, strides {cost.stride()}, start "
                    f"{cost.data_ptr() % 16} bytes past 16)")
        lib = self._lib or self.load()
        # held until the launch is enqueued
        cost, row_mask, col_mask = (x.contiguous()
                                    for x in (cost, row_mask, col_mask))
        if batched:
            fn, shape = lib.aicam_assignment, cost.shape
        elif variant == "v1":
            fn, shape = lib.aicam_assignment_v1, cost.shape
        else:
            fn, shape = lib.aicam_assignment, (1, *cost.shape)
        args = (cost.data_ptr(), *shape,
                row_mask.data_ptr(),
                None if levels is None else levels.data_ptr(),
                col_mask.data_ptr(), float(max_distance), int(depth),
                match.data_ptr(),
                None if unmatched is None else unmatched.data_ptr())
        dev = cost.device
        if dev.index == torch.cuda.current_device():
            err = fn(*args, _current_stream(dev))
        else:
            with torch.cuda.device(dev):
                err = fn(*args, _current_stream(dev))
        if err != 0:
            raise RuntimeError(f"assignment kernel launch failed: CUDA error "
                               f"{err} (cost {tuple(cost.shape)})")
        self.launches += 1

    def min_cost_matching(self, cost: torch.Tensor, row_mask: torch.Tensor,
                          col_mask: torch.Tensor, max_distance: float,
                          variant: str = "lanes") -> torch.Tensor:
        """``(R,)`` int64: each row's matched column, or -1 (``(B, R)`` for
        a batch, one launch)."""
        check_args(cost, row_mask, col_mask)
        match = torch.empty(cost.shape[:-1], dtype=torch.int64,
                            device=cost.device)
        self._launch(variant, cost, row_mask, None, col_mask, max_distance,
                     0, match, None)
        return match

    def matching_cascade(self, cost: torch.Tensor, track_level: torch.Tensor,
                         track_eligible: torch.Tensor,
                         det_valid: torch.Tensor, max_distance: float,
                         cascade_depth: int, variant: str = "lanes"):
        """``(match (T,) int64 or -1, det_unmatched (N,) bool)``: the whole
        cascade in one launch (``(B, T)`` and ``(B, N)`` for a batch: every
        problem's cascade in the one launch)."""
        check_args(cost, track_eligible, det_valid)
        if tuple(track_level.shape) != tuple(cost.shape[:-1]):
            raise ValueError(f"track_level must be {tuple(cost.shape[:-1])} "
                             f"(got {tuple(track_level.shape)})")
        if track_level.dtype != torch.int32:
            raise TypeError(f"track_level must be int32, as the tracker's "
                            f"time_since_update is (got {track_level.dtype})")
        if track_level.device != cost.device:
            raise ValueError(f"track_level is on {track_level.device}, cost "
                             f"on {cost.device}")
        if variant == "v1":
            # any level outside [1, depth] is no level: clamping keeps that
            # and is what the first design's kernel expects
            levels = torch.clamp(track_level, 0, cascade_depth + 1)
        else:
            levels = track_level.contiguous()   # the kernel clamps them
        match = torch.empty(cost.shape[:-1], dtype=torch.int64,
                            device=cost.device)
        unmatched = torch.empty((*cost.shape[:-2], cost.shape[-1]),
                                dtype=torch.bool, device=cost.device)
        self._launch(variant, cost, track_eligible, levels, det_valid,
                     max_distance, cascade_depth, match, unmatched)
        return match, unmatched


KERNEL = AssignmentKernel()
