"""The assignment kernel (``csrc/assignment.cu``) and its wrapper.

One launch solves one masked minimum-cost matching (:meth:`AssignmentKernel.
min_cost_matching`), or a whole DeepSORT matching cascade over its levels
(:meth:`AssignmentKernel.matching_cascade`), in one thread block, on the
current stream, and reads nothing back: the tracking step around it stays on
the device, and a CUDA graph can capture it. Each launch adds one to
``KERNEL.launches``.

The kernel computes exactly what the plain PyTorch versions in
``core/assignment.py`` compute (the CPU path and the kernel's oracle on the
card); ``core.assignment.min_cost_matching`` and ``matching_cascade`` pick
between the two by the tensors' device. There is no fallback from one to the
other: a CUDA tensor launches the kernel or raises.

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

__all__ = ["KERNEL", "MAX_N", "AssignmentKernel", "check_args"]

MAX_N = 256   # the largest max(R, C) the kernel takes


def check_args(cost: torch.Tensor, row_mask: torch.Tensor,
               col_mask: torch.Tensor) -> None:
    """The argument checks the kernel relies on (device-independent):
    ``cost (R, C)`` f32 with ``1 <= R, C`` and ``max(R, C) <= MAX_N``,
    bool masks of ``(R,)`` and ``(C,)`` on its device."""
    if cost.dtype != torch.float32:
        raise TypeError(f"cost must be float32 (got {cost.dtype})")
    if cost.ndim != 2 or min(cost.shape) < 1:
        raise ValueError(f"cost must be (R, C) with R, C >= 1 (got "
                         f"{tuple(cost.shape)})")
    r, c = cost.shape
    if max(r, c) > MAX_N:
        raise ValueError(f"the assignment solver takes max(R, C) <= {MAX_N} "
                         f"(got {tuple(cost.shape)})")
    for name, mask, size in (("row_mask", row_mask, r),
                             ("col_mask", col_mask, c)):
        if mask.dtype != torch.bool or tuple(mask.shape) != (size,):
            raise ValueError(f"{name} must be a ({size},) bool tensor (got "
                             f"{tuple(mask.shape)} {mask.dtype})")
        if mask.device != cost.device:
            raise ValueError(f"{name} is on {mask.device}, cost on "
                             f"{cost.device}")


class AssignmentKernel:
    """Builds, loads and launches ``csrc/assignment.cu``; counts launches."""

    name = "assignment"
    source = cuda_build.CSRC_DIR / "assignment.cu"
    replaces = ("aicamera_tpu/core/assignment.py:97 solve_square, "
                ":179 min_cost_matching, :229 matching_cascade")

    def __init__(self):
        self.launches = 0
        self._lib = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = cuda_build.load_library(self.source)
                lib.aicam_assignment.argtypes = (
                    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                    + [ctypes.c_void_p] * 3
                    + [ctypes.c_float, ctypes.c_int]
                    + [ctypes.c_void_p] * 3)
                lib.aicam_assignment.restype = ctypes.c_int
                self._lib = lib
            return self._lib

    def _launch(self, cost, row_mask, levels, col_mask, max_distance,
                depth, match, unmatched):
        if cost.device.type != "cuda":
            raise ValueError(f"the assignment kernel needs CUDA tensors (got "
                             f"{cost.device})")
        lib = self._lib or self.load()
        # held until the launch is enqueued
        cost, row_mask, col_mask = (x.contiguous()
                                    for x in (cost, row_mask, col_mask))
        args = (cost.data_ptr(), cost.shape[0], cost.shape[1],
                row_mask.data_ptr(),
                None if levels is None else levels.data_ptr(),
                col_mask.data_ptr(), float(max_distance),
                int(depth), match.data_ptr(),
                None if unmatched is None else unmatched.data_ptr())
        dev = cost.device
        if dev.index == torch.cuda.current_device():
            err = lib.aicam_assignment(*args, _current_stream(dev))
        else:
            with torch.cuda.device(dev):
                err = lib.aicam_assignment(*args, _current_stream(dev))
        if err != 0:
            raise RuntimeError(f"assignment kernel launch failed: CUDA error "
                               f"{err} (cost {tuple(cost.shape)})")
        self.launches += 1

    def min_cost_matching(self, cost: torch.Tensor, row_mask: torch.Tensor,
                          col_mask: torch.Tensor,
                          max_distance: float) -> torch.Tensor:
        """``(R,)`` int64: each row's matched column, or -1."""
        check_args(cost, row_mask, col_mask)
        match = torch.empty(cost.shape[0], dtype=torch.int64,
                            device=cost.device)
        self._launch(cost, row_mask, None, col_mask, max_distance, 0, match,
                     None)
        return match

    def matching_cascade(self, cost: torch.Tensor, track_level: torch.Tensor,
                         track_eligible: torch.Tensor,
                         det_valid: torch.Tensor, max_distance: float,
                         cascade_depth: int):
        """``(match (T,) int64 or -1, det_unmatched (N,) bool)``: the whole
        cascade in one launch."""
        check_args(cost, track_eligible, det_valid)
        t, nd = cost.shape
        if tuple(track_level.shape) != (t,):
            raise ValueError(f"track_level must be ({t},) (got "
                             f"{tuple(track_level.shape)})")
        # any level outside [1, depth] is no level: clamping keeps that and
        # fits every level in int32
        levels = torch.clamp(track_level, 0, cascade_depth + 1).to(
            torch.int32).contiguous()
        match = torch.empty(t, dtype=torch.int64, device=cost.device)
        unmatched = torch.empty(nd, dtype=torch.bool, device=cost.device)
        self._launch(cost, track_eligible, levels, det_valid, max_distance,
                     cascade_depth, match, unmatched)
        return match, unmatched


KERNEL = AssignmentKernel()
